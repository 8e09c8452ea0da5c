"""The port's ur5, kuka14 and snake7 envs against the JAX package: URDF
parse and chains, FK with base transforms, ``seg_seg_sq_dist``, the
correctly rounded metric, the device oracles, the native dual-arm core and
the host sample streams.

Tolerances: chains, geometry tables, decisions, counts and sample streams
exactly; capsule endpoints within 1e-6; segment distances within 1e-6
(float32 values up to about 7; XLA contracts some products into fused
multiply-adds, the port does not).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.config import problem_rng as jax_problem_rng
from gnn_motion_planning_tpu.envs.geometry import seg_seg_sq_dist as jax_seg_seg_sq_dist
from gnn_motion_planning_tpu.envs.kinematics import capsules_world as jax_capsules_world
from gnn_motion_planning_tpu.envs.kuka2 import Kuka2Env as JaxKuka2Env
from gnn_motion_planning_tpu.envs.snake import SnakeEnv as JaxSnakeEnv
from gnn_motion_planning_tpu.envs.snake import _yaw_rot
from gnn_motion_planning_tpu.envs.ur5 import UR5Env as JaxUR5Env
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.envs.geometry import seg_seg_sq_dist
from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world, norm_last
from gnn_motion_planning_tpu_torch.envs.kuka2 import Kuka2Env
from gnn_motion_planning_tpu_torch.envs.snake import SnakeEnv, snake_capsules
from gnn_motion_planning_tpu_torch.envs.ur5 import UR5Env

CONFIGS = {"ur5": (UR5Env, JaxUR5Env), "kuka14": (Kuka2Env, JaxKuka2Env),
           "snake7": (SnakeEnv, JaxSnakeEnv)}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Pytest-xdist runs six test files at once on the CPU: two intra-op
    threads a file keep torch's workers from oversubscribing the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(CONFIGS))
def envs(request):
    """(name, port env, JAX env) on problem 2000."""

    port_cls, jax_cls = CONFIGS[request.param]
    tenv, jenv = port_cls(device="cpu"), jax_cls()
    tenv.init_new_problem(2000)
    jenv.init_new_problem(2000)
    return request.param, tenv, jenv


def _uniform(env, n, seed):
    pr = np.array(env.pose_range)
    return np.random.RandomState(seed).uniform(pr[:, 0], pr[:, 1], (n, env.config_dim))


def _jax_states_free(jenv):
    kern, scene = jenv.kernels(), jenv.device_scene()
    return jax.jit(jax.vmap(lambda q: kern.state_free(scene, q)))


def test_chains_and_tables_equal_jax(envs):
    name, tenv, jenv = envs
    ours = tenv.chain.numpy_arrays()
    for key, value in jenv.chain._asdict().items():
        np.testing.assert_array_equal(ours[key], np.asarray(value), err_msg=key)
    assert tenv.pose_range == [tuple(p) for p in jenv.pose_range]
    np.testing.assert_array_equal(tenv.bound, jenv.bound)
    assert str(tenv) == str(jenv)
    if name == "ur5":
        # the 43 capsules (6 a mesh, one for ee_link's box), 780 pairs
        assert ours["cap_r"].shape == (43,)
        for key, value in jenv.geom._asdict().items():
            np.testing.assert_array_equal(getattr(tenv.geom, key).numpy(), np.asarray(value),
                                          err_msg=key)
        assert int(tenv.geom.pair_mask.sum()) == len(tenv.geom.pair_i) == 780
    if name == "snake7":
        # 5 capsules and 5 spheres (p0 == p1)
        assert ours["cap_r"].shape == (10,)
        assert (ours["cap_p0"] == ours["cap_p1"]).all(axis=1).sum() == 5
        np.testing.assert_array_equal(tenv.pair_mask, np.asarray(jenv.pair_mask))
    for got, want in zip(tenv.obs_tokens(), jenv.obs_tokens()):
        np.testing.assert_array_equal(got, want)


def test_capsules_with_base_transforms_match_jax(envs):
    """FK rooted at a base: kuka14's arms at x = -0.5 and +0.5, snake7's
    base at (q0, q1, 0.5) with yaw q3 (endpoints within 1e-6)."""

    name, tenv, jenv = envs
    qs = _uniform(tenv, 64, 1).astype(np.float32)
    q = torch.as_tensor(qs)
    if name == "ur5":
        want = jax.vmap(lambda x: jax_capsules_world(jenv.chain, x))(jnp.asarray(qs))
        got = capsules_world(tenv.chain, q)
        pairs = [(got, want)]
    elif name == "kuka14":
        pairs = []
        for arm, base in ((slice(0, 7), jenv.base1), (slice(7, 14), jenv.base2)):
            want = jax.vmap(lambda x: jax_capsules_world(jenv.chain, x, base_trans=base))(
                jnp.asarray(qs[:, arm]))
            got = capsules_world(tenv.chain, q[:, arm],
                                 base_trans=torch.tensor(np.asarray(base)))
            pairs.append((got, want))
        assert float(np.asarray(pairs[0][1][0])[:, :, 0].mean()) < 0 < float(
            np.asarray(pairs[1][1][0])[:, :, 0].mean())
    else:
        def one(x):
            return jax_capsules_world(
                jenv.chain, jnp.stack([x[2], x[3], x[4], x[5]]),
                base_rot=_yaw_rot(x[3]).astype(jnp.float32),
                base_trans=jnp.array([x[0], x[1], 0.5]).astype(jnp.float32))
        want = jax.vmap(one)(jnp.asarray(qs))
        got = snake_capsules(tenv.chain, q)
        pairs = [(got, want)]
    for got, want in pairs:
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2][0]))


def test_seg_seg_sq_dist_matches_jax():
    """Random segments and degenerate ones (zero-length on either side or
    both, parallel), within 1e-6; broadcast as the oracles call it."""

    rng = np.random.RandomState(0)
    n = 4096
    p0, p1, q0, q1 = (rng.uniform(-1, 1, (n, 3)).astype(np.float32) for _ in range(4))
    p1[:256] = p0[:256]  # zero-length first segment
    q1[256:512] = q0[256:512]  # zero-length second
    p1[512:768], q1[512:768] = p0[512:768], q0[512:768]  # two points
    d = p1[768:1024] - p0[768:1024]  # parallel, offset and shorter
    q0[768:1024] = p0[768:1024] + rng.uniform(-0.3, 0.3, (256, 3)).astype(np.float32)
    q1[768:1024] = q0[768:1024] + 0.5 * d
    q0[1024:1280], q1[1024:1280] = p1[1024:1280], p0[1024:1280]  # the same, reversed
    want = np.asarray(jax.jit(jax.vmap(jax_seg_seg_sq_dist))(*map(jnp.asarray, (p0, p1, q0, q1))))
    got = seg_seg_sq_dist(*map(torch.as_tensor, (p0, p1, q0, q1))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (want[1024:1280] < 1e-10).all() and (want[:1024] > 0).any()

    a, b = torch.as_tensor(p0[:64]), torch.as_tensor(p1[:64])
    want = np.asarray(jax.jit(lambda a, b: jax_seg_seg_sq_dist(a[:, None], b[:, None], a[None], b[None]))(
        jnp.asarray(p0[:64]), jnp.asarray(p1[:64])))
    got = seg_seg_sq_dist(a[:, None], b[:, None], a[None], b[None]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _near_integer_pairs(d: int, eps: float, n: int, seed: int):
    """(a, b) float32 pairs whose length over ``eps`` lies within a few
    float32 steps of an integer, or exactly on one where float32 allows."""

    rng = np.random.RandomState(seed)
    a = rng.uniform(-2, 2, (n, d))
    u = rng.normal(size=(n, d))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    k = rng.randint(1, 40, n)
    b = a + u * (k * eps)[:, None]
    a, b = a.astype(np.float32), b.astype(np.float32)
    # one float32 step either way on one coordinate
    step = rng.randint(-1, 2, n).astype(np.float32)
    b[:, 0] = np.nextafter(b[:, 0], b[:, 0] + step)
    return a, b


@pytest.mark.parametrize("d", [6, 7, 13, 14])
def test_norm_last_equals_xla(d):
    """norm_last against ``jnp.sqrt(jnp.sum(x ** 2, -1))`` on random pairs
    and on pairs whose d / eps lies within an ulp of an integer: one pair at
    a time (the form of a search pop's edge check), and in batches of 31
    and 64 rows as XLA vectorises them (the projection's). Lengths, and
    K = int(d / eps), are equal on every pair."""

    eps = np.float32(0.1)
    rng = np.random.RandomState(d)
    a = rng.uniform(-3, 3, (2048, d)).astype(np.float32)
    b = rng.uniform(-3, 3, (2048, d)).astype(np.float32)
    na, nb = _near_integer_pairs(d, 0.1, 2048, d + 100)
    x = np.concatenate([b - a, nb - na])

    def jnorm(y):
        return jnp.sqrt(jnp.sum(y ** 2, axis=-1))

    want = np.asarray(jax.jit(lambda y: jax.lax.map(jnorm, y))(jnp.asarray(x)))
    got = torch.cat([norm_last(torch.as_tensor(x[i:i + 1])) for i in range(len(x))]).numpy()
    np.testing.assert_array_equal(got, want)
    k_want = np.asarray((jnp.asarray(want) / eps).astype(jnp.int32))
    np.testing.assert_array_equal((torch.as_tensor(got) / float(eps)).to(torch.int32).numpy(), k_want)
    near = np.abs(want[2048:] / eps - np.round(want[2048:] / eps)) < 1e-5
    assert near.sum() > 1000

    batch_norm = jax.jit(jnorm)
    for rows in (31, 64):
        for s0 in range(0, len(x) - rows + 1, rows):
            chunk = x[s0:s0 + rows]
            np.testing.assert_array_equal(norm_last(torch.as_tensor(chunk)).numpy(),
                                          np.asarray(batch_norm(jnp.asarray(chunk))))


def _near_contact(free_fn, qs, steps: int = 14):
    """Pairs of states on either side of the oracle's boundary, within
    2**-steps of the segment between a free and a colliding state (about
    1e-4 rad at 14 steps). Closer in, from 2**-17, float32 rounding decides:
    XLA contracts products of seg_box_sq_dist and seg_seg_sq_dist into
    fused multiply-adds, the kernel and the port's tensor ops do not, and 1
    to 5 of 512 decisions differ (ROADMAP.md section 3)."""

    ok = free_fn(qs)
    free, hit = qs[ok], qs[~ok]
    m = min(len(free), len(hit), 256)
    lo, hi = free[:m].astype(np.float64), hit[:m].astype(np.float64)
    for _ in range(steps):
        mid = 0.5 * (lo + hi)
        f = free_fn(mid.astype(np.float32))
        lo = np.where(f[:, None], mid, lo)
        hi = np.where(f[:, None], hi, mid)
    return np.concatenate([lo, hi]).astype(np.float32)


@pytest.mark.parametrize("index", [2000, 2001])
def test_state_oracle_equals_jax(envs, index):
    """2,048 states a problem: uniform in the limits with every 20th row
    outside them, and 512 on either side of a contact boundary, 2**-14 of
    a segment from it. Decisions and counts exactly."""

    name, tenv, jenv = envs
    tenv.init_new_problem(index)
    jenv.init_new_problem(index)
    kern, scene = tenv.kernels(), tenv.device_scene()

    def port(q):
        return kern.batch_state_free(scene, torch.as_tensor(q))

    qs = _uniform(tenv, 1536, index).astype(np.float32)
    qs[10::20] += np.float32(1.5) * (np.array(tenv.pose_range)[:, 1] - np.array(tenv.pose_range)[:, 0])
    near = _near_contact(lambda q: port(q)[0].numpy(), qs[(np.arange(1536) % 20) != 10])
    qs = np.concatenate([qs, near])
    got, got_cnt = port(qs)
    want, want_cnt = _jax_states_free(jenv)(jnp.asarray(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    n_near = len(near) // 2
    assert got[1536:1536 + n_near].all() and not got[1536 + n_near:].any()
    assert 0 < int(got[:1536].sum()) < 1536 - 77


def test_edge_oracle_equals_jax(envs):
    """64 fixed-step edges of problem 2000, half of them short hops from a
    free state: decisions and counts exactly (the step count K comes from
    the env's metric)."""

    name, tenv, jenv = envs
    tenv.init_new_problem(2000)
    jenv.init_new_problem(2000)
    kern, scene = tenv.kernels(), tenv.device_scene()
    qs = _uniform(tenv, 512, 5).astype(np.float32)
    free = kern.batch_state_free(scene, torch.as_tensor(qs))[0].numpy()
    qa = np.concatenate([qs[free][:32], qs[:32]])
    hop = np.random.RandomState(6).uniform(-1, 1, (32, tenv.config_dim)).astype(np.float32)
    qb = np.concatenate([qa[:32] + hop * np.float32(4 * tenv.RRT_EPS), qs[32:64]])
    jk, jscene = jenv.kernels(), jenv.device_scene()
    want, want_cnt = jax.jit(jax.vmap(lambda x, y: jk.edge_free(jscene, x, y)))(
        jnp.asarray(qa), jnp.asarray(qb))
    got, got_cnt = kern.edge_free(scene, torch.as_tensor(qa), torch.as_tensor(qb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert got.any() and (got_cnt > 3).any()


def test_sample_stream_equals_jax(envs):
    """500 accepted samples, the rejected draws and the counter, on
    problem 2000's stream (device oracle for ur5 and snake7, the native
    dual-arm core for kuka14)."""

    name, tenv, jenv = envs
    tenv.init_new_problem(2000)
    jenv.init_new_problem(2000)
    jenv.rng = jax_problem_rng(1234, 2000)
    tenv.rng = problem_rng(1234, 2000)
    c_j, c_t = jenv.collision_check_count, tenv.collision_check_count
    jf, jc = jenv.sample_n_points(500, need_negative=True)
    tf, tc = tenv.sample_n_points(500, need_negative=True)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    assert tenv.collision_check_count - c_t == jenv.collision_check_count - c_j
    assert len(tf) == 500 and len(tc) > 0


def test_native_dual_core_equals_jax():
    tenv, jenv = Kuka2Env(device="cpu"), JaxKuka2Env()
    tenv.init_new_problem(2001)
    jenv.init_new_problem(2001)
    qs = _uniform(tenv, 512, 7)
    got, got_cnt = tenv._native.states_free(qs)
    want, want_cnt = jenv._native.states_free(qs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    assert got.any() and not got.all()
    assert tenv._native.dof == 14


NEAR_STEPS = (17, 18, 19, 20)
NEAR_CONFIGS = ("ur5", "kuka14", "snake7", "kuka7")


@pytest.fixture(scope="module", params=NEAR_CONFIGS)
def near_envs(request):
    """(name, port env, JAX env) for the near-contact tests."""

    from gnn_motion_planning_tpu.envs.kuka import KukaEnv as JaxKukaEnv
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv

    port_cls, jax_cls = dict(CONFIGS, kuka7=(KukaEnv, JaxKukaEnv))[request.param]
    return request.param, port_cls(device="cpu"), jax_cls()


def _near_contact_steps(free_fn, qs, steps=NEAR_STEPS):
    """:func:`_near_contact` at each bisection depth of ``steps``: 512
    states a depth, 2**-depth of a segment from the oracle's boundary."""

    ok = free_fn(qs)
    free, hit = qs[ok], qs[~ok]
    m = min(len(free), len(hit), 256)
    lo, hi = free[:m].astype(np.float64), hit[:m].astype(np.float64)
    out = {}
    for k in range(1, max(steps) + 1):
        mid = 0.5 * (lo + hi)
        f = free_fn(mid.astype(np.float32))
        lo = np.where(f[:, None], mid, lo)
        hi = np.where(f[:, None], hi, mid)
        if k in steps:
            out[k] = np.concatenate([lo, hi]).astype(np.float32)
    return out


_COMPILED = {}


def _compiled(key, make):
    """A jitted JAX function built once per key for the whole module."""

    if key not in _COMPILED:
        _COMPILED[key] = make()
    return _COMPILED[key]


def _jax_endpoints(name, jenv, qs):
    """JAX's capsule endpoints (B, C, 3) twice; kuka14's are the first
    arm's capsules, then the second's."""

    if name == "snake7":
        def one(x):
            return jax_capsules_world(
                jenv.chain, jnp.stack([x[2], x[3], x[4], x[5]]),
                base_rot=_yaw_rot(x[3]).astype(jnp.float32),
                base_trans=jnp.array([x[0], x[1], 0.5]).astype(jnp.float32))[:2]
    elif name == "kuka14":
        def one(x):
            a = jax_capsules_world(jenv.chain, x[:7], base_trans=jenv.base1)
            b = jax_capsules_world(jenv.chain, x[7:], base_trans=jenv.base2)
            return jnp.concatenate([a[0], b[0]]), jnp.concatenate([a[1], b[1]])
    else:
        def one(x):
            return jax_capsules_world(jenv.chain, x)[:2]
    fn = _compiled(("fk", name), lambda: jax.jit(jax.vmap(one)))
    return tuple(np.array(t) for t in fn(jnp.asarray(qs)))


def _xla_box(p0, p1, centers, halfs):
    from gnn_motion_planning_tpu.envs.geometry import seg_box_sq_dist as jax_seg_box_sq_dist

    fn = _compiled("box", lambda: jax.jit(jax.vmap(
        lambda a, b, c, h: jax_seg_box_sq_dist(a[:, None, :], b[:, None, :], c[None], h[None]),
        in_axes=(0, 0, None, None))))
    return np.asarray(fn(p0, p1, centers, halfs))


def _xla_pairs(a0, a1, b0, b1):
    fn = _compiled("pairs", lambda: jax.jit(jax.vmap(
        lambda w, x, y, z: jax_seg_seg_sq_dist(w[:, None], x[:, None], y[None], z[None]))))
    return np.asarray(fn(a0, a1, b0, b1))


def _jax_oracle(name, jenv, qs):
    """JAX ``jit(vmap(state_free))`` on the env's current problem, compiled
    once per config (the scene is an argument)."""

    kern = jenv.kernels()
    fn = _compiled(("oracle", name), lambda: jax.jit(jax.vmap(
        lambda sc, q: kern.state_free(sc, q), in_axes=(None, 0))))
    return np.asarray(fn(jenv.device_scene(), jnp.asarray(qs))[0])


def kern_pairs(name, tenv, C):
    """The capsule pairs an oracle tests, as index arrays into the two
    capsule lists the JAX function takes (kuka14: arm against arm)."""

    if name == "kuka14":
        return np.nonzero(np.ones((C, C), bool))
    mask = tenv.geom.pair_mask.numpy() if name == "ur5" else tenv.pair_mask
    return np.nonzero(mask)


# near-contact decisions that differ with each package's own FK, at 2**-17
# to 2**-20 (2,048 states a problem; ROADMAP.md section 3): none. FK takes
# glibc's cos and sin (``kinematics.sincosf32``) and forms XLA's fused
# multiply-adds, so the endpoints are XLA's bit for bit
NEAR_RESIDUAL = {(name, index): 0 for name in ("ur5", "kuka14", "snake7", "kuka7")
                 for index in (2000, 2001)}


@pytest.mark.parametrize("index", [2000, 2001])
def test_near_contact_distances_equal_xla(near_envs, index):
    """States 2**-17 to 2**-20 of a segment from a contact boundary, 512 a
    depth (built as the 2**-14 states of test_state_oracle_equals_jax).

    (a) Fed the same endpoints (JAX's FK), the port's seg_box_sq_dist, its
    plain narrow phase (``ops/capsule.py``, the kernel's plain version) and
    seg_seg_sq_dist give squared distances bit-equal to XLA's compiled
    functions, in the call forms of the JAX oracles, so the decisions are
    equal. (b) With each package's own FK (the port's cos and sin are
    glibc's, its products contracted as XLA's), the oracles' decisions: at
    most NEAR_RESIDUAL, zero in every case, differs."""

    from gnn_motion_planning_tpu_torch.envs.geometry import seg_box_sq_dist, vector_tail
    from gnn_motion_planning_tpu_torch.ops.capsule import _seg_box_sq_dist_rows

    name, tenv, jenv = near_envs
    tenv.init_new_problem(index)
    jenv.init_new_problem(index)
    kern, scene = tenv.kernels(), tenv.device_scene()

    def port(q):
        return kern.batch_state_free(scene, torch.as_tensor(q))

    # kuka7's problems hold few boxes: most uniform states are free
    qs = _uniform(tenv, 16384 if name == "kuka7" else 2048, index).astype(np.float32)
    near = _near_contact_steps(lambda q: port(q)[0].numpy(), qs)
    states = np.concatenate([near[k] for k in NEAR_STEPS])
    assert len(states) == 512 * len(NEAR_STEPS)

    # (a) the same endpoints on both sides, the active boxes and the
    # listed pairs (the JAX oracles mask the others off)
    p0, p1 = _jax_endpoints(name, jenv, states)
    on = scene.mask.numpy()
    centers, halfs = scene.centers.numpy()[on], scene.halfs.numpy()[on]
    want = _xla_box(p0, p1, centers, halfs)
    T = torch.as_tensor
    got = seg_box_sq_dist(T(p0)[:, :, None], T(p1)[:, :, None], T(centers)[None, None],
                          T(halfs)[None, None]).numpy()
    np.testing.assert_array_equal(got, want)
    u = [T(p0)[:, :, None, i] - T(centers)[None, None, :, i] for i in range(3)]
    v = [(T(p1) - T(p0))[:, :, None, i].expand_as(u[0]) for i in range(3)]
    h = [T(halfs)[None, None, :, i].expand_as(u[0]) for i in range(3)]
    np.testing.assert_array_equal(_seg_box_sq_dist_rows(u, v, h).numpy(), want)

    if name != "kuka7":
        if name == "kuka14":
            C = p0.shape[1] // 2
            a0, a1, b0, b1 = p0[:, :C], p1[:, :C], p0[:, C:], p1[:, C:]
        else:
            C = p0.shape[1]
            a0, a1, b0, b1 = p0, p1, p0, p1
        i, j = kern_pairs(name, tenv, C)
        want = _xla_pairs(a0, a1, b0, b1)[:, i, j]
        tail = T(vector_tail(C))
        got = seg_seg_sq_dist(T(a0)[:, i], T(a1)[:, i], T(b0)[:, j], T(b1)[:, j],
                              a_fused=tail[i], e_fused=tail[j]).numpy()
        np.testing.assert_array_equal(got, want)

    # (b) each package's own FK: decisions that differ
    differ = int((port(states)[0].numpy() != _jax_oracle(name, jenv, states)).sum())
    print(f"{name} {index}: {differ} of {len(states)} near-contact decisions differ")
    assert differ <= NEAR_RESIDUAL[name, index]
