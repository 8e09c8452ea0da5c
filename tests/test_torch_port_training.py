"""The port's trainers (``training/{explorer,smoother,next}.py``) against the
JAX package's: losses and every gradient leaf against
``jax.value_and_grad``, one optimiser step against optax's, the host
sampling of the rollouts and labels, the three loops against the JAX
package's loss sequences, and checkpoints across the two packages.

Tolerances:

- losses: rtol 1e-5 (float32, summed in another order);
- gradients: every leaf within ``GRAD_RTOL * max|g_leaf| + GRAD_ATOL`` of
  JAX's (both float32 on the CPU; a max-aggregation tie splits its gradient
  evenly on both sides, which a case below pins);
- one optimiser step from the same gradients: rtol 1e-6, atol 1e-7 (a
  few float32 ulps of a weight, 1e-4 of the learning rate);
- the loops (``tests/data/torch_port_training_jax.json``): equal step
  counts and replay sizes, the first loss within 1e-5 relative, each later
  loss within 1e-3 (a float32 difference in an earlier step moves the
  weights a later forward sees);
- a port checkpoint in the JAX package: the forwards within
  tests/test_model_parity.py's atol max(1e-5, 1e-5 * scale), rtol 1e-4.

Regenerate the JAX fixture (the tiny loops and the full-width ones that
``chip_smoke.py`` phase 9 prints beside its own) with
``python tests/test_torch_port_training.py``.
"""

import functools
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.models.convert import params_from_numpy

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
FIXTURE = DATA / "torch_port_training_jax.json"
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-7
STEP_ATOL = 1e-7  # 1e-4 of the learning rate: a few float32 ulps of a weight

# the loops: the JAX package's own tiny settings (tests/test_training.py)
# and the full-width ones of chip_smoke.py phase 9; the PRM graphs are the
# committed slices of assets/data/pkl (graph i pairs with problem i)
RUNS = {
    "explorer_maze2easy": dict(trainer="explorer", config="maze2easy",
                               data="tests/data/torch_port_prm_maze2_6.pkl",
                               kwargs=dict(epoch=6, iter=2, batch_size=4)),
    "smoother_maze2easy": dict(trainer="smoother", config="maze2easy",
                               kwargs=dict(epoch=3, data_iter=1, train_iter=2, batch_size=2)),
    "next_maze2easy": dict(trainer="next", config="maze2easy",
                           kwargs=dict(T=40, n_problems=3, train_every=2)),
    "explorer_kuka7": dict(trainer="explorer", config="kuka7",
                           data="tests/data/torch_port_prm_kuka7_8.pkl",
                           kwargs=dict(epoch=8, iter=2, batch_size=8)),
    "smoother_kuka7": dict(trainer="smoother", config="kuka7",
                           kwargs=dict(epoch=4, data_iter=1, train_iter=2, batch_size=2)),
}
TINY_RUNS = ("explorer_maze2easy", "smoother_maze2easy", "next_maze2easy")
FULL_RUNS = ("explorer_kuka7", "smoother_kuka7")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(got, want) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _grads_close(got: dict, want: dict):
    """Every leaf of ``want`` ({name: array}) in ``got`` within the stated
    tolerance -> the worst |diff| / max|g| over the leaves."""

    assert sorted(got) == sorted(want)
    worst = 0.0
    for name, w in want.items():
        g = np.asarray(got[name])
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = float(np.abs(w).max())
        diff = float(np.abs(g - w).max())
        assert diff <= GRAD_RTOL * scale + GRAD_ATOL, (name, diff, scale)
        worst = max(worst, diff / max(scale, 1e-30))
    return worst


def _port_grads(module) -> dict:
    """{state-dict name: gradient} of every trained leaf (zero where the
    loss does not reach it, as jax.grad gives)."""

    return {k: np.zeros(v.shape, np.float32) if v.grad is None else v.grad.numpy()
            for k, v in module.state_dict(keep_vars=True).items() if v.is_floating_point()}


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


def _explorer_case(seed: int = 0, B: int = 2, N: int = 24, E: int = 96, M: int = 4):
    """A batch at small width from a numpy seed, the (src, dst) pairs
    distinct (as in a PRM graph or an RGG). Node N - 3 is a copy of node 0,
    neither has an in-edge, and their edges into node N - 1 are its only
    ones: that node's max aggregation is a tie in every channel at every
    loop."""

    rng = np.random.RandomState(seed)
    d = 2
    v = rng.uniform(-1, 1, (B, N, d)).astype(np.float32)
    v[:, N - 3] = v[:, 0]
    node_valid = np.ones((B, N), bool)
    node_valid[:, -2] = False
    pairs = [(s, t) for s in range(N) for t in range(N) if t not in (0, N - 3, N - 1)]
    src = np.zeros((B, E), np.int64)
    dst = np.zeros((B, E), np.int64)
    for b in range(B):
        pick = rng.choice(len(pairs), E - 2, replace=False)
        src[b, 2:], dst[b, 2:] = np.array(pairs)[pick].T
    src[:, 0], src[:, 1], dst[:, :2] = 0, N - 3, N - 1
    e_alive = np.ones((B, E), bool)
    e_alive[:, -8:] = False
    obstacles = rng.uniform(-0.5, 0.5, (B, M, 2)).astype(np.float32)
    obs_mask = np.array([[True, True, True, False]] * B)
    frontier = rng.rand(B, N, N) < 0.2
    frontier[:, N - 1, [0, N - 3]] = True  # the tied edges' scores reach the loss
    target = np.array([rng.choice(np.flatnonzero(f)) for f in frontier.reshape(B, -1)])
    goal = v[:, 1]
    loop = np.full(B, 4, np.int64)
    return (v, node_valid, goal, src, dst, e_alive, obstacles, obs_mask, frontier, target, loop)


def _jax_explorer(seed: int = 0):
    import jax

    from gnn_motion_planning_tpu.models.explorer import ExplorerConfig, init_explorer_params

    cfg = ExplorerConfig(workspace_size=2, config_size=2, embed_size=16, obs_size=2)
    params = jax.tree.map(np.asarray, init_explorer_params(jax.random.PRNGKey(seed), cfg))
    return cfg, params


@functools.lru_cache(maxsize=None)
def _jax_explorer_loss(loop: int):
    """JAX's loss and gradients (numpy) on ``_explorer_case`` at ``loop``."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.training import explorer as jex

    jcfg, params = _jax_explorer()
    fn = jax.jit(jax.value_and_grad(jex.frontier_cross_entropy), static_argnums=(1, 3))
    loss, grads = fn(params, jcfg, jex.ExplorerBatch(*(jnp.asarray(a) for a in _explorer_case())),
                     loop)
    return float(loss), jax.tree.map(np.asarray, grads)


@functools.lru_cache(maxsize=None)
def _jax_smoother_loss(loop: int):
    """JAX's loss and gradients (numpy) on ``_smoother_case`` at ``loop``."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.training.smoother import smoother_mse as jax_mse

    jcfg, params = _jax_smoother()
    fn = jax.jit(jax.value_and_grad(jax_mse), static_argnums=(1, 3))
    loss, grads = fn(params, jcfg, tuple(jnp.asarray(a) for a in _smoother_case()), loop)
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("loop", [2, 4])
def test_frontier_cross_entropy_and_grads_equal_jax(loop):
    import jax

    from gnn_motion_planning_tpu_torch.models.convert import flatten
    from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
    from gnn_motion_planning_tpu_torch.training import explorer as tex

    jcfg, params = _jax_explorer()
    case = _explorer_case()
    want, jgrads = _jax_explorer_loss(loop)
    model = params_from_numpy(Explorer(ExplorerConfig(*jcfg)), params)
    got = tex.frontier_cross_entropy(model, tex.ExplorerBatch(*(torch.as_tensor(a) for a in case)),
                                     loop)
    got.backward()
    assert _rel(float(got.detach()), float(want)) <= 1e-5
    _grads_close(_port_grads(model), flatten(jax.tree.map(np.asarray, jgrads)))
    # the tied node's aggregation reaches the loss
    assert np.abs(model.process.lin_0[0].weight.grad.numpy()).max() > 0


def test_segment_max_tie_splits_the_gradient_evenly():
    """jax.grad of segment_max and torch's scatter_reduce amax backward both
    give a tie's gradient in equal shares: (0.5, 0.5, 0)."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.ops.segment import masked_segment_max as jax_max
    from gnn_motion_planning_tpu_torch.ops.segment import masked_segment_max

    data = np.array([[2.0], [2.0], [1.0]], np.float32)
    ids, alive = np.array([0, 0, 0]), np.array([True, True, True])
    want = jax.grad(lambda x: jax_max(x, jnp.asarray(ids), jnp.asarray(alive), 1).sum())(
        jnp.asarray(data))
    x = torch.as_tensor(data).requires_grad_(True)
    masked_segment_max(x, torch.as_tensor(ids), torch.as_tensor(alive), 1).sum().backward()
    np.testing.assert_array_equal(np.asarray(want)[:, 0], [0.5, 0.5, 0.0])
    np.testing.assert_array_equal(x.grad.numpy()[:, 0], [0.5, 0.5, 0.0])


def _jax_smoother(seed: int = 0):
    """Small-width smoother params with BatchNorm's running statistics off
    identity, so their gradients are not trivial."""

    import jax

    from gnn_motion_planning_tpu.models.smoother import SmootherConfig
    from gnn_motion_planning_tpu.training.smoother import init_smoother_params

    cfg = SmootherConfig(workspace_size=2, config_size=2, obs_size=6, embed_size=16)
    params = jax.tree.map(np.asarray, init_smoother_params(jax.random.PRNGKey(seed), cfg))
    rng = np.random.RandomState(seed)
    bn = params["node_code"]["1"]
    bn["running_mean"] = rng.normal(0, 0.1, 16).astype(np.float32)
    bn["running_var"] = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    bn["weight"] = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    return cfg, params


def _smoother_case(seed: int = 0, B: int = 2, L: int = 16, S: int = 48):
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges

    rng = np.random.RandomState(seed)
    rows = []
    for b, n_path in enumerate((9, 12)[:B]):
        path = np.repeat(rng.uniform(-1, 1, (1, 2)), L, 0).astype(np.float32)
        path[:n_path] = rng.uniform(-1, 1, (n_path, 2))
        mask = np.arange(L) < n_path
        env_nodes = rng.uniform(-1, 1, (S, 2)).astype(np.float32)
        env_valid = np.arange(S) < 40
        n_free = 20 + b
        target = path + rng.normal(0, 0.05, path.shape).astype(np.float32)
        rows.append((path, mask, env_nodes, env_valid, np.int64(n_free),
                     *base_chain_edges(L, n_path), target))
    return tuple(np.stack(c) for c in zip(*rows))


@pytest.mark.parametrize("loop", [2, 4])
def test_smoother_mse_and_grads_equal_jax(loop):
    """BatchNorm's running statistics are leaves on both sides."""

    import jax

    from gnn_motion_planning_tpu_torch.models.convert import flatten
    from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig
    from gnn_motion_planning_tpu_torch.training.optim import trainable_leaves
    from gnn_motion_planning_tpu_torch.training.smoother import smoother_mse

    jcfg, params = _jax_smoother()
    case = _smoother_case()
    want, jgrads = _jax_smoother_loss(loop)
    model = params_from_numpy(Smoother(SmootherConfig(*jcfg)), params)
    trainable_leaves(model)
    got = smoother_mse(model, tuple(torch.as_tensor(a) for a in case), loop)
    got.backward()
    assert _rel(float(got.detach()), float(want)) <= 1e-5
    grads = _port_grads(model)
    assert "node_code.1.running_var" in grads
    assert np.abs(grads["node_code.1.running_mean"]).max() > 0
    _grads_close(grads, flatten(jax.tree.map(np.asarray, jgrads)))


NEXT_SMALL = dict(env_width=7, cap=4, dim=2, point_dim=0, nd=2, g=4, iters=3)


def _next_case(seed: int = 0, L: int = 12, n: int = 9):
    """Small NEXT params (numpy, the NextNet's names and shapes) and one
    padded path."""

    from gnn_motion_planning_tpu_torch.models.convert import nest, to_flat
    from gnn_motion_planning_tpu_torch.models.next_model import NextConfig, NextNet

    rng = np.random.RandomState(seed)
    shapes = to_flat(NextNet(NextConfig(**NEXT_SMALL), 2))
    flat = {}
    for k, v in shapes.items():
        fan_in = float(np.prod(v.shape[1:])) if v.ndim >= 2 else 10.0
        flat[k] = rng.normal(0, fan_in ** -0.5, v.shape).astype(np.float32)
    w = NEXT_SMALL["env_width"]
    states = rng.uniform(-1, 1, (L, 2)).astype(np.float32)
    maze_map = (rng.rand(1, w, w) < 0.3).astype(np.float32)
    goal = rng.uniform(-1, 1, (1, 2)).astype(np.float32)
    actions = rng.normal(0, 0.1, (L, 2)).astype(np.float32)
    values = -rng.uniform(0, 2, L).astype(np.float32)
    mask = np.arange(L) < n
    return nest(flat), (states, maze_map, goal, actions, values, mask)


def test_next_loss_and_grads_equal_jax():
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.models.next_model import NextConfig as JaxNextConfig
    from gnn_motion_planning_tpu.training.next import make_next_loss as jax_loss
    from gnn_motion_planning_tpu_torch.models.convert import flatten
    from gnn_motion_planning_tpu_torch.models.next_model import NextConfig, NextNet
    from gnn_motion_planning_tpu_torch.training.next import make_next_loss

    params, case = _next_case()
    want, jgrads = jax.jit(jax.value_and_grad(jax_loss(JaxNextConfig(**NEXT_SMALL))))(
        jax.tree.map(jnp.asarray, params), *(jnp.asarray(a) for a in case))
    net = params_from_numpy(NextNet(NextConfig(**NEXT_SMALL), 2), params)
    got = make_next_loss()(net, *(torch.as_tensor(a) for a in case))
    got.backward()
    assert _rel(float(got.detach()), float(want)) <= 1e-5
    _grads_close(_port_grads(net), flatten(jax.tree.map(np.asarray, jgrads)))


# ---------------------------------------------------------------------------
# one optimiser step
# ---------------------------------------------------------------------------


def _step_both(model, params, steps, opt_jax, opt_port):
    """Both optimisers from the same gradients, step by step: ``steps`` is
    a list of (JAX gradient tree, None for a leaf without a gradient;
    learning rate, set as the plateau rule sets it, or None) -> (port
    params, JAX params) as flat numpy dicts."""

    import jax
    import jax.numpy as jnp
    import optax

    from gnn_motion_planning_tpu_torch.models.convert import flatten, to_flat
    from gnn_motion_planning_tpu_torch.training.optim import apply_step, set_lr, trainable_leaves

    leaves = trainable_leaves(model)
    opt = opt_port(leaves)
    names = list(to_flat(model))
    jp = jax.tree.map(jnp.asarray, params)
    state = opt_jax.init(jp)
    for grads, lr in steps:
        if lr is not None:
            set_lr(opt, lr)
            state.hyperparams["learning_rate"] = jnp.asarray(lr)
        flat = flatten(grads)
        for name, leaf in zip(names, leaves):
            g = flat[name]
            # a copy: zero_grad clears the gradient in place
            leaf.grad = None if g is None else torch.tensor(np.asarray(g, np.float32))
        apply_step(opt, leaves)
        jg = jax.tree.map(lambda g, p: jnp.zeros_like(p) if g is None else jnp.asarray(g),
                          grads, jp, is_leaf=lambda x: x is None)
        updates, state = opt_jax.update(jg, state, jp)
        jp = optax.apply_updates(jp, updates)
    return to_flat(model), flatten(jax.tree.map(np.asarray, jp))


def _assert_steps_equal(got: dict, want: dict):
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-6, atol=STEP_ATOL, err_msg=name)


def test_adam_step_equals_optax():
    """Two Adam steps of the explorer from the same gradients, one leaf
    without a gradient (torch would skip it; optax moves its moments)."""

    import jax
    import optax

    from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
    from gnn_motion_planning_tpu_torch.training.optim import adam

    jcfg, params = _jax_explorer()
    g1 = jax.tree.map(np.array, _jax_explorer_loss(2)[1])
    g2 = jax.tree.map(lambda g: -0.5 * g + 1e-3, g1)
    g1["goal_encoder"] = None  # a leaf the loss does not reach
    got, want = _step_both(params_from_numpy(Explorer(ExplorerConfig(*jcfg)), params), params,
                           [(g1, None), (g2, None)], optax.adam(1e-3, eps=1e-8),
                           lambda leaves: adam(leaves, 1e-3, eps=1e-8))
    _assert_steps_equal(got, want)
    assert not np.array_equal(got["goal_encoder"], params["goal_encoder"])


def test_sgd_momentum_decay_step_equals_optax():
    """Steps of the smoother's optimiser (decayed weights 1e-4, then SGD
    with momentum 0.9) from the same gradients, the second at a tenth of
    the rate as the plateau rule sets it; BatchNorm's running statistics
    move as JAX moves them, the variance even without a gradient."""

    import jax
    import optax

    from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig
    from gnn_motion_planning_tpu_torch.training.optim import sgd_decayed

    jcfg, params = _jax_smoother()
    g1 = jax.tree.map(np.array, _jax_smoother_loss(2)[1])
    g2 = jax.tree.map(lambda g: 0.3 * g, g1)
    g1["node_code"]["1"]["running_var"] = None

    def step_both(steps):
        opt_jax = optax.inject_hyperparams(lambda learning_rate: optax.chain(
            optax.add_decayed_weights(1e-4), optax.sgd(learning_rate, momentum=0.9)))(
            learning_rate=1e-3)
        return _step_both(params_from_numpy(Smoother(SmootherConfig(*jcfg)), params), params,
                          steps, opt_jax,
                          lambda leaves: sgd_decayed(leaves, 1e-3, momentum=0.9, weight_decay=1e-4))

    got, want = step_both([(g1, None)])
    _assert_steps_equal(got, want)
    bn = params["node_code"]["1"]
    # no gradient: the variance still decays, by lr * 1e-4 * var
    np.testing.assert_allclose(got["node_code.1.running_var"],
                               bn["running_var"] * (1 - 1e-3 * 1e-4), rtol=1e-7)
    assert not np.array_equal(got["node_code.1.running_mean"], bn["running_mean"])
    _assert_steps_equal(*step_both([(g1, None), (g2, 1e-4)]))


# ---------------------------------------------------------------------------
# host sampling: rollouts, oracle targets, labels, random starts
# ---------------------------------------------------------------------------


def test_host_rollout_and_policy_data_equal_jax():
    from gnn_motion_planning_tpu.planners.dijkstra import dijkstra_dense as jax_dijkstra
    from gnn_motion_planning_tpu.training import explorer as jex
    from gnn_motion_planning_tpu_torch.planners.dijkstra import dijkstra_dense
    from gnn_motion_planning_tpu_torch.training import explorer as tex

    graphs = tex.load_graphs(str(DATA / "torch_port_prm_maze2_6.pkl"))
    rng = np.random.RandomState(3)
    n_cases = 0
    for points, neighbors, edge_cost, _, _ in graphs[:3]:
        n = len(points)
        cost_arr = np.full((n, n), np.inf)
        ei, ec = [], []
        for x in neighbors:
            for y, c in zip(neighbors[x], edge_cost[x]):
                cost_arr[x, y] = c
                ei.append((y, x))
                ec.append(c)
        ei, ec = np.array(ei, np.int64), np.array(ec)
        for _ in range(4):
            goal = int(rng.randint(n))
            dist, prev = dijkstra_dense(n, ei, ec, goal)
            jd, jp = jax_dijkstra(n, ei, ec, goal)
            np.testing.assert_array_equal(dist, jd)
            np.testing.assert_array_equal(prev, jp)
            policy = rng.uniform(-1, 1, (n, n)).astype(np.float32) * (rng.rand(n, n) < 0.1)
            start = int(rng.choice(np.flatnonzero(np.isfinite(dist))))
            got = tex.host_rollout(cost_arr, policy, start, goal, 1000)
            want = jex.host_rollout(cost_arr, policy, start, goal, 1000)
            assert got[0] == want[0] and got[1] == want[1]
            np.testing.assert_array_equal(got[2], want[2])
            step = int(rng.randint(0, got[0] + 1))
            try:
                want = jex.host_policy_data(cost_arr, dist, prev, policy, start, goal, step)
            except Exception as e:  # the trainer skips such a sample: so must the port
                with pytest.raises(type(e)):
                    tex.host_policy_data(cost_arr, dist, prev, policy, start, goal, step)
                continue
            got = tex.host_policy_data(cost_arr, dist, prev, policy, start, goal, step)
            assert got[0] == want[0] and got[1] == want[1]
            np.testing.assert_array_equal(got[2][0], want[2][0])
            np.testing.assert_array_equal(got[2][1], want[2][1])
            n_cases += 1
    assert n_cases >= 6


@pytest.mark.parametrize("config", ["maze2easy", "kuka7"])
def test_get_label_and_random_init_goal_equal_jax(config):
    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu.config import HostRNG as JaxRNG
    from gnn_motion_planning_tpu.training.next import get_label as jax_get_label
    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.config import HostRNG
    from gnn_motion_planning_tpu_torch.training.next import get_label

    jenv, tenv = jax_str2env(config)[0], str2env(config, device="cpu")[0]
    for index in (0, 1):
        jenv.init_new_problem(index)
        tenv.init_new_problem(index)
        jenv.rng, tenv.rng = JaxRNG(index + 7), HostRNG(index + 7)
        jenv.set_random_init_goal()
        tenv.set_random_init_goal()
        np.testing.assert_array_equal(tenv.init_state, jenv.init_state)
        np.testing.assert_array_equal(tenv.goal_state, jenv.goal_state)
        assert tenv.rng.get_state()[2] == jenv.rng.get_state()[2]
    rng = np.random.RandomState(5)
    if config == "kuka7":
        lo, hi = np.array(tenv.pose_range).T
    else:
        lo, hi = -np.ones(2), np.ones(2)
    path = rng.uniform(lo, hi, (7, len(lo)))
    path[3] = path[2] + 1e-3  # one step shorter than RRT_EPS
    (ga, gv), (wa, wv) = get_label(path, tenv), jax_get_label(path, jenv)
    np.testing.assert_array_equal(ga, wa)
    np.testing.assert_array_equal(gv, wv)


def test_snake_set_random_init_goal_is_not_ported():
    """Named for the error it raised before snake7's host protocol was
    ported (JAX envs/snake.py:589): it now draws two distinct free samples
    from the problem's stream, JAX's start and goal."""

    from gnn_motion_planning_tpu.config import problem_rng as jax_rng
    from gnn_motion_planning_tpu.envs.snake import SnakeEnv as JaxSnakeEnv
    from gnn_motion_planning_tpu_torch.config import problem_rng
    from gnn_motion_planning_tpu_torch.envs.snake import SnakeEnv

    env, jenv = SnakeEnv(device="cpu"), JaxSnakeEnv()
    env.init_new_problem(0)
    jenv.init_new_problem(0)
    env.rng, jenv.rng = problem_rng(1234, 0), jax_rng(1234, 0)
    env.set_random_init_goal()
    jenv.set_random_init_goal()
    np.testing.assert_array_equal(env.init_state, jenv.init_state)
    np.testing.assert_array_equal(env.goal_state, jenv.goal_state)
    assert np.abs(env.init_state - env.goal_state).sum() != 0


# ---------------------------------------------------------------------------
# initialisation, registry, logs and checkpoints
# ---------------------------------------------------------------------------


def test_fresh_models_from_a_seed():
    """``str2name(load=False)``: torch's default initialisation from the
    seed (the distribution of the JAX package's init, not its numbers);
    NEXT's from-scratch init: He normal weights, zero biases."""

    from torch import nn

    from gnn_motion_planning_tpu_torch.api.registry import str2models, str2name
    from gnn_motion_planning_tpu_torch.models.next_model import NextConfig, NextNet
    from gnn_motion_planning_tpu_torch.models.next_model import init_next_from_scratch

    env, explorer, ckpt, smoother, _, data = str2name("kuka7", device="cpu", get_data=True,
                                                      load=False)
    assert data == "data/pkl/kuka_prm_4000.pkl" and ckpt == "data/weights/weights_kuka.pt"
    loaded, _ = str2models("kuka7", "cpu")
    assert not torch.equal(explorer.encoder.weight, loaded.encoder.weight)
    for m in list(explorer.modules()) + list(smoother.modules()):
        if isinstance(m, nn.Linear):
            bound = m.in_features ** -0.5
            assert float(m.weight.abs().max()) <= bound
            assert float(m.weight.abs().max()) > 0.9 * bound
    g = explorer.goal_encoder
    assert 0 <= float(g.min()) and float(g.max()) < 1
    bn = smoother.node_code[1]
    assert torch.equal(bn.running_var, torch.ones(128)) and torch.equal(bn.running_mean, torch.zeros(128))
    again = str2models("kuka7", "cpu", load=False)[0]
    assert all(torch.equal(a, b) for a, b in zip(explorer.state_dict().values(),
                                                  again.state_dict().values()))
    net = init_next_from_scratch(NextNet(NextConfig(), 2), seed=3)
    for name, p in net.named_parameters():
        if p.dim() >= 2 and p.numel() >= 4096:
            std = (2.0 / float(np.prod(p.shape[1:]))) ** 0.5
            assert abs(float(p.std()) / std - 1) < 0.1, name
        elif p.dim() < 2:
            assert float(p.abs().max()) == 0, name
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            str2name("kuka7", load=False)


def test_registry_routes_equal_jax(monkeypatch):
    """``GMP_WEIGHTS=scratch`` loads the from-scratch twins the JAX package
    loads; a missing ``_pure.pt`` raises on both sides."""

    from gnn_motion_planning_tpu.api.registry import str2models as jax_str2models
    from gnn_motion_planning_tpu_torch.api.registry import str2models, str2name
    from gnn_motion_planning_tpu_torch.models.convert import flatten, to_flat

    monkeypatch.setenv("GMP_WEIGHTS", "scratch")
    explorer, smoother = str2models("kuka7", "cpu")
    jax_explorer, jax_smoother = jax_str2models("kuka7")
    for got, want in ((explorer, jax_explorer.params), (smoother, jax_smoother.params)):
        want = flatten(want)
        for k, v in to_flat(got).items():
            np.testing.assert_array_equal(v, np.asarray(want[k], np.float32), err_msg=k)
    monkeypatch.delenv("GMP_WEIGHTS")
    loaded, _ = str2models("kuka7", "cpu")
    assert not torch.equal(loaded.encoder.weight, explorer.encoder.weight)
    with pytest.raises(FileNotFoundError):
        jax_str2models("maze2easy", use_obstacle=False)
    with pytest.raises(FileNotFoundError, match="weights_maze_pure.pt"):
        str2name("maze2easy", device="cpu", use_obstacle=False)


def test_scalar_logs_read_alike(tmp_path):
    from gnn_motion_planning_tpu.utils.metrics import ScalarLogger as JaxLogger
    from gnn_motion_planning_tpu.utils.metrics import read_scalars as jax_read
    from gnn_motion_planning_tpu_torch.utils.metrics import ScalarLogger, read_scalars

    with ScalarLogger(tmp_path / "port", use_tensorboard=False) as log:
        for i in range(3):
            log.add_scalar("train/loss", 1.0 / (i + 1), i)
    with JaxLogger(tmp_path / "jax", use_tensorboard=False) as log:
        for i in range(3):
            log.add_scalar("train/loss", 1.0 / (i + 1), i)
    for d in ("port", "jax"):
        assert read_scalars(tmp_path / d) == jax_read(tmp_path / d) == {
            "train/loss": [(0, 1.0), (1, 0.5), (2, 1.0 / 3)]}


def test_port_checkpoint_loads_into_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.models.explorer import explorer_forward as jax_explorer_forward
    from gnn_motion_planning_tpu.models.smoother import smoother_forward as jax_smoother_forward
    from gnn_motion_planning_tpu.parallel.checkpoint import load_params_npz as jax_load
    from gnn_motion_planning_tpu_torch.models.explorer import (
        Explorer, ExplorerConfig, explorer_forward, init_explorer_params)
    from gnn_motion_planning_tpu_torch.models.smoother import (
        Smoother, SmootherConfig, init_smoother_params, smoother_forward)
    from gnn_motion_planning_tpu_torch.parallel.checkpoint import export_params_npz

    jcfg, _ = _jax_explorer()
    model = init_explorer_params(Explorer(ExplorerConfig(*jcfg)), seed=5)
    export_params_npz(tmp_path / "e.npz", model)
    case = _explorer_case()
    fwd = jax.jit(jax_explorer_forward, static_argnums=(1,), static_argnames=("loop",))
    want = np.asarray(fwd(jax_load(tmp_path / "e.npz"), jcfg,
                          *(jnp.asarray(a[0]) for a in case[:8]), loop=4))
    with torch.no_grad():
        got = explorer_forward(model, *(torch.as_tensor(a[0]) for a in case[:8]), loop=4).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=max(1e-5, 1e-5 * scale), rtol=1e-4)

    scfg, _ = _jax_smoother()
    smoother = init_smoother_params(Smoother(SmootherConfig(*scfg)), seed=5)
    with torch.no_grad():
        smoother.node_code[1].running_var.fill_(1.5)
    export_params_npz(tmp_path / "s.npz", smoother)
    tree = jax_load(tmp_path / "s.npz")
    assert float(tree["node_code"]["1"]["running_var"][0]) == 1.5
    args = [a[0] for a in _smoother_case()]
    fwd = jax.jit(jax_smoother_forward, static_argnums=(1,), static_argnames=("loop",))
    want = np.asarray(fwd(tree, scfg, *(jnp.asarray(a) for a in args[:8]), loop=2))
    with torch.no_grad():
        got = smoother_forward(smoother, *(torch.as_tensor(a) for a in args[:4]), int(args[4]),
                               *(torch.as_tensor(a) for a in args[5:8]), loop=2).numpy()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, atol=max(1e-5, 1e-5 * scale), rtol=1e-4)


def test_train_state_round_trip(tmp_path):
    """Params, optimiser state, step and the host stream come back, so a
    resumed run continues the same stream and the same moments."""

    from gnn_motion_planning_tpu_torch.config import HostRNG
    from gnn_motion_planning_tpu_torch.models.smoother import (
        Smoother, SmootherConfig, init_smoother_params)
    from gnn_motion_planning_tpu_torch.parallel.checkpoint import (
        restore_train_state, save_train_state)
    from gnn_motion_planning_tpu_torch.training.optim import apply_step, sgd_decayed, trainable_leaves
    from gnn_motion_planning_tpu_torch.training.smoother import smoother_mse

    scfg, _ = _jax_smoother()
    batch = tuple(torch.as_tensor(a) for a in _smoother_case())

    def fresh():
        m = init_smoother_params(Smoother(SmootherConfig(*scfg)), seed=1)
        leaves = trainable_leaves(m)
        return m, leaves, sgd_decayed(leaves)

    def step(m, leaves, opt):
        smoother_mse(m, batch, 2).backward()
        apply_step(opt, leaves)

    a, la, oa = fresh()
    rng = HostRNG(9)
    step(a, la, oa)
    rng.uniform(0, 1, 5)
    save_train_state(tmp_path, 1, a, oa, rng.get_state())
    step(a, la, oa)
    want_draw = rng.uniform(0, 1, 3)

    b, lb, ob = fresh()
    _, _, step_n, state = restore_train_state(tmp_path, b, ob)
    assert step_n == 1
    step(b, lb, ob)
    rng_b = HostRNG(0)
    rng_b.set_state(state)
    np.testing.assert_array_equal(rng_b.uniform(0, 1, 3), want_draw)
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(va, vb, rtol=0, atol=0, msg=k)


# ---------------------------------------------------------------------------
# the three loops against the JAX package's
# ---------------------------------------------------------------------------


def _data_path(spec) -> str:
    return str(REPO / spec["data"])


def run_port(name: str, device, tmp):
    """One run of ``RUNS[name]`` through the port -> (losses, stats)."""

    from gnn_motion_planning_tpu_torch.api.registry import str2name

    spec = RUNS[name]
    kw = spec["kwargs"]
    stats: dict = {}
    if spec["trainer"] == "next":
        from gnn_motion_planning_tpu_torch.training.next import train_next

        _, losses = train_next(spec["config"], model_path=str(Path(tmp) / "next.npz"),
                               device=device, stats=stats, **kw)
    else:
        env, explorer, _, smoother, _ = str2name(spec["config"], device=device)
        if spec["trainer"] == "explorer":
            from gnn_motion_planning_tpu_torch.training.explorer import train_explorer

            _, losses = train_explorer(data_path=_data_path(spec), model=explorer,
                                       model_path=str(Path(tmp) / "e.npz"), env=env,
                                       device=device, **kw)
        else:
            from gnn_motion_planning_tpu_torch.training.smoother import train_smoother

            _, losses = train_smoother(model_explore=explorer, model=smoother,
                                       model_path=str(Path(tmp) / "s.npz"), env=env,
                                       device=device, stats=stats, **kw)
    return losses, stats.get("replay")


def run_jax(name: str, tmp) -> dict:
    """One run of ``RUNS[name]`` through the JAX package -> its fixture
    entry: the losses, ``steps`` (the number of losses the trainer returns:
    one a step, the smoother's one an epoch) and the replay size (the
    smoother's: the oracle-smoothed paths; NEXT's: its successes and BIT*
    fallbacks)."""

    from gnn_motion_planning_tpu.api.registry import str2name

    spec = RUNS[name]
    kw = spec["kwargs"]
    replay = None
    if spec["trainer"] == "next":
        from gnn_motion_planning_tpu.planners import bit_star, tsa
        from gnn_motion_planning_tpu.training.next import train_next

        counts = {"success": 0, "fallback": 0}
        plan, best = tsa.NEXT_plan, bit_star.BITStar.get_best_path

        def counted_plan(*a, **k):
            out = plan(*a, **k)
            counts["success"] += bool(out[1])
            return out

        def counted_best(self):
            counts["fallback"] += 1
            return best(self)

        tsa.NEXT_plan, bit_star.BITStar.get_best_path = counted_plan, counted_best
        try:
            _, losses = train_next(spec["config"], model_path=str(Path(tmp) / "next.npz"), **kw)
        finally:
            tsa.NEXT_plan, bit_star.BITStar.get_best_path = plan, best
        replay = counts["success"] + counts["fallback"]
    else:
        env, explorer, _, smoother, _ = str2name(spec["config"])
        if spec["trainer"] == "explorer":
            from gnn_motion_planning_tpu.training.explorer import train_explorer

            _, losses = train_explorer(data_path=_data_path(spec), model=explorer,
                                       model_path=str(Path(tmp) / "e.npz"), env=env, **kw)
        else:
            from gnn_motion_planning_tpu.planners import oracle_smoother
            from gnn_motion_planning_tpu.training.smoother import train_smoother

            ratio, calls = oracle_smoother.joint_smoother_ratio, []

            def counted(*a, **k):
                calls.append(1)
                return ratio(*a, **k)

            oracle_smoother.joint_smoother_ratio = counted
            try:
                _, losses = train_smoother(model_explore=explorer, model=smoother,
                                           model_path=str(Path(tmp) / "s.npz"), env=env, **kw)
            finally:
                oracle_smoother.joint_smoother_ratio = ratio
            replay = len(calls)
    return dict(losses=[float(x) for x in losses], steps=len(losses), replay=replay)


def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def check_loop(name: str, losses, replay, want: dict) -> float:
    """Equal steps and replay, the first loss within 1e-5 relative, the
    later ones within 1e-3 -> the largest relative difference."""

    assert len(losses) == want["steps"], (name, len(losses), want["steps"])
    assert replay == want["replay"], (name, replay, want["replay"])
    rel = [_rel(g, w) for g, w in zip(losses, want["losses"])]
    assert rel and rel[0] <= 1e-5, (name, rel)
    assert max(rel) <= 1e-3, (name, rel)
    return max(rel)


@pytest.mark.parametrize("name", TINY_RUNS)
def test_loop_equals_jax_fixture(name, tmp_path):
    losses, replay = run_port(name, "cpu", tmp_path)
    check_loop(name, losses, replay, fixture()["runs"][name])
    assert (tmp_path / {"explorer": "e.npz", "smoother": "s.npz", "next": "next.npz"}[
        RUNS[name]["trainer"]]).exists()


@pytest.mark.slow
@pytest.mark.parametrize("name", FULL_RUNS)
def test_full_width_loop_equals_jax_fixture(name, tmp_path):
    losses, replay = run_port(name, "cpu", tmp_path)
    check_loop(name, losses, replay, fixture()["runs"][name])


def test_fixture_settings_are_the_runs():
    assert fixture()["settings"] == RUNS


def write_fixture():
    import tempfile

    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in RUNS:
            runs[name] = run_jax(name, tmp)
            print(name, runs[name], flush=True)
    FIXTURE.write_text(json.dumps({"settings": RUNS, "runs": runs}, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import os

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixture()
