"""The port's graph build, segment ops and the two GNNs against the JAX
package, on real kuka7 nodes with the shipped weights."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.api.registry import str2models as jax_str2models
from gnn_motion_planning_tpu.graphs.knn import build_rgg_edges as jax_build_rgg_edges
from gnn_motion_planning_tpu.models.explorer import explorer_forward as jax_explorer_forward
from gnn_motion_planning_tpu.models.smoother import smoother_forward as jax_smoother_forward
from gnn_motion_planning_tpu.ops.segment import masked_segment_max as jax_seg_max
from gnn_motion_planning_tpu.ops.segment import masked_segment_sum as jax_seg_sum
from gnn_motion_planning_tpu.planners.gnn_smooth import base_chain_edges as jax_base_chain_edges
from gnn_motion_planning_tpu_torch.api.registry import str2models
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges, k_scaled
from gnn_motion_planning_tpu_torch.models.convert import params_from_numpy
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, explorer_forward
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, smoother_forward
from gnn_motion_planning_tpu_torch.ops.segment import masked_segment_max, masked_segment_sum
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges
from gnn_motion_planning_tpu_torch.utils.assets import asset_path


@pytest.fixture(scope="module")
def problem():
    """Problem 2000's node set as explore() builds it (batch samples)."""

    env = KukaEnv(device="cpu")
    env.rng = problem_rng(1234, 2000)
    env.init_new_problem(2000)

    def nodes(batch):
        free, coll = env.sample_n_points(batch, need_negative=True)
        free = [env.init_state, env.goal_state] + list(free)
        coll = list(coll)[: len(free)]
        F, C = len(free), len(coll)
        v = np.zeros((2 * F, env.config_dim), np.float32)
        v[:F] = np.asarray(free, np.float32)
        v[F : F + C] = np.asarray(coll, np.float32)
        valid = np.arange(2 * F) < F + C
        return v, valid, F

    toks, mask = env.obs_tokens()
    return env, nodes, toks, mask


@pytest.fixture(scope="module")
def models():
    jax_explorer, jax_smoother = jax_str2models("kuka7")
    explorer, smoother = str2models("kuka7", device="cpu")
    return jax_explorer, jax_smoother, explorer, smoother


def _edges_np(e):
    return tuple(np.asarray(x) for x in (e.src, e.dst, e.alive))


def test_rgg_edges_equal_jax(problem):
    _, nodes, _, _ = problem
    v, valid, F = nodes(500)
    k1 = k_scaled(30, F)
    want = _edges_np(jax_build_rgg_edges(jnp.asarray(v), jnp.asarray(valid), F, k1))
    got = build_rgg_edges(torch.as_tensor(v), torch.as_tensor(valid), F, k1)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.astype(g.numpy().dtype))
    assert want[2].sum() > 10 * F


@pytest.mark.parametrize("op", ["max", "sum"])
def test_segment_ops_match_jax(op):
    rng = np.random.RandomState(4)
    data = rng.randn(300, 16).astype(np.float32)
    ids = rng.randint(0, 40, 300)
    alive = rng.rand(300) > 0.2
    ids[:5] = 39  # segment 39 gets only dead or few edges
    alive[ids == 39] = False
    jfn, tfn = (jax_seg_max, masked_segment_max) if op == "max" else (jax_seg_sum, masked_segment_sum)
    want = np.asarray(jfn(jnp.asarray(data), jnp.asarray(ids), jnp.asarray(alive), 40))
    got = tfn(torch.as_tensor(data), torch.as_tensor(ids), torch.as_tensor(alive), 40).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[39] == 0).all()


@pytest.mark.parametrize("route", ["pt", "numpy"])
def test_explorer_forward_matches_jax(problem, models, route):
    _, nodes, toks, mask = problem
    jax_explorer, _, explorer, _ = models
    if route == "numpy":
        explorer = params_from_numpy(Explorer(explorer.cfg), jax_explorer.params).eval()
    v, valid, F = nodes(100)
    goal = v[1]
    edges = build_rgg_edges(torch.as_tensor(v), torch.as_tensor(valid), F, k_scaled(30, F))
    want = np.asarray(jax_explorer_forward(
        jax_explorer.params, jax_explorer.cfg, jnp.asarray(v), jnp.asarray(valid),
        jnp.asarray(goal), *(jnp.asarray(x.numpy()) for x in edges),
        jnp.asarray(toks), jnp.asarray(mask), loop=5,
    ))
    got = explorer_forward(
        explorer, torch.as_tensor(v), torch.as_tensor(valid), torch.as_tensor(goal),
        *edges, torch.as_tensor(toks), torch.as_tensor(mask), loop=5,
    ).detach().numpy()  # the forward carries gradients
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    live = np.zeros_like(want, bool)
    src, dst, alive = (x.numpy() for x in edges)
    live[dst[alive], src[alive]] = True
    assert np.argmax(np.where(live, got, -np.inf)) == np.argmax(np.where(live, want, -np.inf))


@pytest.mark.parametrize("route", ["pt", "numpy"])
def test_smoother_forward_matches_jax(problem, models, route):
    _, nodes, _, _ = problem
    _, jax_smoother, _, smoother = models
    if route == "numpy":
        smoother = params_from_numpy(Smoother(smoother.cfg), jax_smoother.params).eval()
    v, valid, F = nodes(500)
    L, n_path, d = 64, 9, v.shape[1]
    path = np.repeat(v[1:2], L, axis=0)
    path[:n_path] = np.linspace(v[0], v[1], n_path).astype(np.float32)
    mask = np.arange(L) < n_path
    env_nodes = np.zeros((1000, d), np.float32)
    env_valid = np.zeros(1000, bool)
    env_nodes[:500], env_valid[:500] = v[:500], True
    n_coll = int(valid[F:].sum())
    env_nodes[500 : 500 + n_coll], env_valid[500 : 500 + n_coll] = v[F : F + n_coll], True
    base = base_chain_edges(L, n_path)
    for g, w in zip(base, jax_base_chain_edges(L, n_path)):
        np.testing.assert_array_equal(g, w)
    want = np.asarray(jax_smoother_forward(
        jax_smoother.params, jax_smoother.cfg, jnp.asarray(path), jnp.asarray(mask),
        jnp.asarray(env_nodes), jnp.asarray(env_valid), jnp.int32(500),
        *(jnp.asarray(b) for b in base), loop=1,
    ))
    got = smoother_forward(
        smoother, torch.as_tensor(path), torch.as_tensor(mask), torch.as_tensor(env_nodes),
        torch.as_tensor(env_valid), 500, *(torch.as_tensor(b) for b in base), loop=1,
    ).detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert not np.allclose(got[1 : n_path - 1], path[1 : n_path - 1])  # interior rewritten


CONFIGS = ["maze2easy", "maze3", "kuka13", "ur5", "snake7", "kuka14"]


@pytest.fixture(scope="module", params=CONFIGS)
def config_case(request):
    """A config's problem-2000 node set (batch 100 and 500) and obstacle
    tokens, with the JAX package's and the port's shipped models (ur5's
    smoother at its scale, 2 pi, on both sides)."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2env

    name = request.param
    env, _ = str2env(name, device="cpu")
    env.rng = problem_rng(1234, 2000)
    env.init_new_problem(2000)

    def nodes(batch):
        free, coll = env.sample_n_points(batch, need_negative=True)
        free = [env.init_state, env.goal_state] + list(free)
        coll = list(coll)[: len(free)]
        F, C = len(free), len(coll)
        v = np.zeros((2 * F, env.config_dim), np.float32)
        v[:F] = np.asarray(free, np.float32)
        v[F : F + C] = np.asarray(coll, np.float32)
        return v, np.arange(2 * F) < F + C, F

    scale = smoother_scale(name, env)
    jax_explorer, jax_smoother = jax_str2models(name, scale=scale)
    explorer, smoother = str2models(name, device="cpu", scale=scale)
    return name, nodes, env.obs_tokens(), (jax_explorer, jax_smoother, explorer, smoother)


def test_config_explorer_forward_matches_jax(config_case):
    """The maze2 and maze3 explorers (width 32, 2-D obstacle tokens),
    kuka13's, ur5's, kuka14's and snake7's (the fine-tuned
    weights_snake_ft.npz, 2-D obstacle tokens), at test_model_parity's
    tolerance with the same argmax."""

    _, nodes, (toks, mask), (jax_explorer, _, explorer, _) = config_case
    v, valid, F = nodes(100)
    edges = build_rgg_edges(torch.as_tensor(v), torch.as_tensor(valid), F, k_scaled(30, F))
    want = np.asarray(jax_explorer_forward(
        jax_explorer.params, jax_explorer.cfg, jnp.asarray(v), jnp.asarray(valid),
        jnp.asarray(v[1]), *(jnp.asarray(x.numpy()) for x in edges),
        jnp.asarray(toks), jnp.asarray(mask), loop=5,
    ))
    got = explorer_forward(
        explorer, torch.as_tensor(v), torch.as_tensor(valid), torch.as_tensor(v[1]),
        *edges, torch.as_tensor(toks), torch.as_tensor(mask), loop=5,
    ).detach().numpy()  # the forward carries gradients
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    live = np.zeros_like(want, bool)
    src, dst, alive = (x.numpy() for x in edges)
    live[dst[alive], src[alive]] = True
    assert np.argmax(np.where(live, got, -np.inf)) == np.argmax(np.where(live, want, -np.inf))
    assert explorer.cfg.embed_size == 32


def test_config_smoother_forward_matches_jax(config_case):
    """maze2's smoother (smooth_2d_attv3.pt), maze3's (the scratch-trained
    smooth_3d_scratch.npz, the shipped smooth_3d_att.pt being the legacy
    architecture), kuka13's, ur5's (at scale 2 pi), kuka14's and snake7's,
    at the same tolerance."""

    name, nodes, _, (_, jax_smoother, _, smoother) = config_case
    v, valid, F = nodes(500)
    L, n_path, d = 64, 9, v.shape[1]
    path = np.repeat(v[1:2], L, axis=0)
    path[:n_path] = np.linspace(v[0], v[1], n_path).astype(np.float32)
    mask = np.arange(L) < n_path
    env_nodes = np.zeros((1000, d), np.float32)
    env_valid = np.zeros(1000, bool)
    env_nodes[:500], env_valid[:500] = v[:500], True
    n_coll = min(int(valid[F:].sum()), 500)  # model_smooth keeps 500
    env_nodes[500 : 500 + n_coll], env_valid[500 : 500 + n_coll] = v[F : F + n_coll], True
    base = base_chain_edges(L, n_path)
    want = np.asarray(jax_smoother_forward(
        jax_smoother.params, jax_smoother.cfg, jnp.asarray(path), jnp.asarray(mask),
        jnp.asarray(env_nodes), jnp.asarray(env_valid), jnp.int32(500),
        *(jnp.asarray(b) for b in base), loop=1,
    ))
    got = smoother_forward(
        smoother, torch.as_tensor(path), torch.as_tensor(mask), torch.as_tensor(env_nodes),
        torch.as_tensor(env_valid), 500, *(torch.as_tensor(b) for b in base), loop=1,
    ).detach().numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert not np.allclose(got[1 : n_path - 1], path[1 : n_path - 1])  # interior rewritten
    if name == "maze3":
        with np.load(asset_path("weights_jax/smooth_3d_scratch.npz")) as f:
            w = f["smooth_node.weight"]
        np.testing.assert_array_equal(smoother.smooth_node.weight.detach().numpy(), w)
    assert smoother.cfg.scale == jax_smoother.cfg.scale
    assert (smoother.cfg.scale > 6.28) == (name == "ur5")
