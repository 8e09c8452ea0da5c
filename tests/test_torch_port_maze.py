"""The port's maze oracle and sampling against the JAX package.

Decisions and collision-check counts must be exactly equal to the JAX
device functions (``jit(vmap(...))`` on the CPU, over the JAX env's own
scene, the packed bitmap) and, in 3-D, to the JAX host oracle
(``MazeEnv._batch_edge_free``, float64 numpy). Sampling must give the same
accepted and rejected draws and the same counter in both stream modes.
Positions from the steering rule and the metric may differ from JAX in the
last bit (XLA on the CPU fuses multiply-adds): they are held within 1e-6.
"""

import jax
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.config import HostRNG as JaxHostRNG
from gnn_motion_planning_tpu.envs import maze as jax_maze
from gnn_motion_planning_tpu_torch.config import HostRNG
from gnn_motion_planning_tpu_torch.envs import maze

MAPS_2D = {"maze2easy 2000": (None, 2000), "maze2hard 0": ("maze_files/mazes_hard.npz", 0)}


def _jax_batch(fn, scene, *args):
    out = jax.jit(jax.vmap(lambda *a: fn(scene, *a)))(*args)
    return [np.asarray(x) for x in out]


def _port(fn, occ, *args):
    return [x.numpy() for x in fn(occ, *(torch.as_tensor(a) for a in args))]


def _envs(dim, map_file, index):
    jenv = jax_maze.MazeEnv(dim=dim, map_file=map_file)
    jenv.init_new_problem(index)
    env = maze.MazeEnv(dim=dim, map_file=map_file, device="cpu")
    env.init_new_problem(index)
    return jenv, env


def _points_2d(rng, n):
    """(n, 2) float32 points in [-1.05, 1.05]^2 (some invalid); a quarter on
    a cell boundary or one float32 step beside it."""

    p = rng.uniform(-1.05, 1.05, (n, 2)).astype(np.float32)
    m = n // 4
    edge = (-1 + 2 * rng.randint(0, 16, (m, 2)) / 15).astype(np.float32)
    step = rng.choice(np.array([-1, 0, 1], np.float32), (m, 2))
    p[:m] = np.nextafter(edge, edge + step)
    return p


def _edges_3d(rng, n):
    """(n, 3) float32 edge endpoints: half short hops (with the angle
    wrapped), half uniform pairs, a few slightly out of bounds."""

    lim = np.array([1.02, 1.02, 0.42])
    q0 = rng.uniform(-lim, lim, (n, 3)).astype(np.float32)
    q1 = rng.uniform(-lim, lim, (n, 3)).astype(np.float32)
    h = n // 2
    hop = q0[:h] + rng.uniform(-0.25, 0.25, (h, 3)).astype(np.float32)
    hop[:, 2] = np.where(np.abs(hop[:, 2]) > 0.4, hop[:, 2] - np.sign(hop[:, 2]) * 0.8, hop[:, 2])
    q1[:h] = hop
    return q0, q1


def test_static_tables_equal_jax():
    assert (maze._DEPTH_2D, maze._DEPTH_STICK, maze._K_MAX_3D) == (7, 3, 192)
    assert (maze._DEPTH_2D, maze._DEPTH_STICK, maze._K_MAX_3D) == (
        jax_maze._DEPTH_2D, jax_maze._DEPTH_STICK, jax_maze._K_MAX_3D)
    for depth, n in ((7, 127), (3, 7)):
        got, want = maze._preorder_tree(depth), jax_maze._preorder_tree(depth)
        assert len(got[0]) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which", sorted(MAPS_2D))
def test_2d_oracle_equals_jax(which):
    jenv, env = _envs(2, *MAPS_2D[which])
    rng = np.random.RandomState(len(which))
    pts = _points_2d(rng, 300)
    a, b = _points_2d(rng, 300), _points_2d(rng, 300)
    b[:60] = a[:60] + rng.uniform(-0.2, 0.2, (60, 2)).astype(np.float32)  # short edges
    # edges between free cell centres, which bisect deep before any stop
    cells = np.argwhere(env.map == 0)[rng.randint(0, (env.map == 0).sum(), (2, 60))]
    a[60:120], b[60:120] = ((cells + 0.5) * 2 / 15 - 1).astype(np.float32)
    occ = env.device_scene()
    scene = jenv.device_scene()
    for fn, jfn, args in ((maze.point_free_2d, jax_maze.point_free_2d, (pts,)),
                          (maze.edge_free_2d, jax_maze.edge_free_2d, (a, b))):
        free, cnt = _port(fn, occ, *args)
        want_free, want_cnt = _jax_batch(jfn, scene, *args)
        np.testing.assert_array_equal(free, want_free)
        np.testing.assert_array_equal(cnt, want_cnt)
        assert free.any() and not free.all() and (cnt == 0).any()  # free, blocked, invalid
    assert cnt.max() > 10  # edges that bisect deep


def test_negative_coordinates_read_as_free():
    """The bitmap lookup's semantics, not the raw grid's (which would wrap
    index -1 to the far row)."""

    occ = torch.ones(15, 15, dtype=torch.bool)
    xy = np.array([[-1.2, 0.0], [0.0, -1.2], [-1.05, 0.0], [1.5, 1.5]], np.float32)
    got = maze.occ_at(occ, torch.as_tensor(xy)).numpy()
    scene = jax_maze.make_occ_scene(np.ones((15, 15), np.int32))
    want = np.asarray(jax.vmap(lambda q: jax_maze._occ_at_flat(scene, q))(xy))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [False, False, True, True])


@pytest.fixture(scope="module")
def maze3():
    jenv, env = _envs(3, None, 2000)
    q0, q1 = _edges_3d(np.random.RandomState(3), 32)
    free, cnt = _port(maze.edge_free_3d, env.device_scene(), q0, q1)
    return jenv, env, q0, q1, free, cnt


def test_3d_oracle_equals_jax_device(maze3):
    jenv, env, q0, q1, free, cnt = maze3
    rng = np.random.RandomState(4)
    qs = rng.uniform([-1.02, -1.02, -0.42], [1.02, 1.02, 0.42], (256, 3)).astype(np.float32)
    sfree, scnt = _port(maze.stick_free_3d, env.device_scene(), qs)
    want = _jax_batch(jax_maze.stick_free_3d, jenv.device_scene(), qs)
    np.testing.assert_array_equal(sfree, want[0])
    np.testing.assert_array_equal(scnt, want[1])
    assert sfree.any() and not sfree.all() and (scnt == 0).any()

    want_free, want_cnt = _jax_batch(jax_maze.edge_free_3d, jenv.device_scene(), q0, q1)
    np.testing.assert_array_equal(free, want_free)
    np.testing.assert_array_equal(cnt, want_cnt)
    assert free.any() and not free.all() and cnt.max() > 20  # interior sticks ran


def test_3d_oracle_equals_jax_host_oracle(maze3):
    jenv, _, q0, q1, free, cnt = maze3
    c0 = jenv.collision_check_count
    want_free, want_cnt = jenv._batch_edge_free(q0.astype(np.float64), q1.astype(np.float64))
    assert jenv.collision_check_count == c0
    np.testing.assert_array_equal(free, want_free)
    np.testing.assert_array_equal(cnt, want_cnt)


@pytest.mark.parametrize("dim", [2, 3])
def test_steering_and_metric_match_jax(dim):
    rng = np.random.RandomState(dim)
    lim = maze.LIMITS[:dim]
    a = rng.uniform(-lim, lim, (200, dim)).astype(np.float32)
    b = rng.uniform(-lim, lim, (200, dim)).astype(np.float32)
    r = rng.uniform(0, 1.5, 200).astype(np.float32)
    kern = maze.maze_kernels(dim)
    got_d = kern.distance(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    got_i = kern.interpolate(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(r)).numpy()
    want_d = np.asarray(jax.jit(lambda x, y: jax_maze.maze_distance(x, y, dim))(a, b))
    want_i = np.asarray(jax.jit(jax.vmap(
        lambda x, y, t: jax_maze.maze_interpolate(x, y, t, dim)))(a, b, r))
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_i, want_i, rtol=0, atol=1e-6)
    jenv, env = _envs(dim, None, 2000)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    np.testing.assert_array_equal(env.distance(a64, b64), jenv.distance(a64, b64))
    np.testing.assert_allclose(got_d, jenv.distance(a64, b64), rtol=0, atol=1e-6)
    for x, y, t in zip(a64[:20], b64[:20], r[:20]):
        np.testing.assert_array_equal(env.interpolate(x, y, t), jenv.interpolate(x, y, t))
    if dim == 3:  # the angle wraps both ways
        assert (np.abs(b[:, 2] - a[:, 2]) > 0.4).sum() > 20


def test_kernel_bundle():
    for dim in (2, 3):
        kern = maze.maze_kernels(dim)
        assert kern.bounds is None and kern.edge_free_cheap is None
    with pytest.raises(ValueError):
        maze.maze_kernels(4)
    _, env = _envs(2, None, 2000)
    assert env.device_scene() is env.device_scene()
    assert env.device_scene().dtype == torch.bool and env.device_scene().shape == (15, 15)
    toks, mask = env.obs_tokens()
    assert toks.shape == (225, 2) and mask.sum() == (env.map == 1).sum()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("mode", ["owned stream", "global stream"])
def test_sampling_equals_jax(dim, mode):
    jenv, env = _envs(dim, None, 2001)
    out = []
    for e, rng in ((jenv, JaxHostRNG(1234)), (env, HostRNG(1234))):
        if mode == "owned stream":
            e.rng = rng
        else:
            np.random.seed(1234)
        free, neg = e.sample_n_points(100, need_negative=True)
        out.append((np.array(free), np.array(neg), e.collision_check_count))
    (jf, jn, jc), (f, n, c) = out
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(n, jn)
    assert c == jc and len(f) == 100 and len(n) > 0


def test_host_goal_test_equals_jax():
    jenv, env = _envs(3, None, 2000)
    goal = np.asarray(env.goal_state)
    for s in (goal, goal + 0.01, goal + 0.2, np.array([0.0, 0.0, 0.399])):
        assert env.in_goal_region(s) == jenv.in_goal_region(s)
    assert env.collision_check_count == jenv.collision_check_count > 0


@pytest.mark.cuda
def test_oracle_on_the_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python -m pytest -m cuda tests/test_torch_port_*.py")
    rng = np.random.RandomState(5)
    for dim, fns in ((2, (maze.point_free_2d, maze.edge_free_2d)),
                     (3, (maze.stick_free_3d, maze.edge_free_3d))):
        _, env = _envs(dim, None, 2000)
        occ = env.device_scene()
        if dim == 2:
            a, b = _points_2d(rng, 4096), _points_2d(rng, 4096)
        else:
            a, b = _edges_3d(rng, 256)
        for fn, args in ((fns[0], (a,)), (fns[1], (a, b))):
            want = fn(occ, *(torch.as_tensor(x) for x in args))
            got = fn(occ.cuda(), *(torch.as_tensor(x, device="cuda") for x in args))
            assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
