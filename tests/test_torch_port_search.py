"""The port's greedy search round and smoothing projections against the
JAX package, given the same nodes, edges, scores and paths."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.envs.kuka import KukaEnv as JaxKukaEnv
from gnn_motion_planning_tpu.planners.gnn_explore import make_explore_round_core as jax_round_core
from gnn_motion_planning_tpu.planners.gnn_smooth import make_projection_core as jax_projection
from gnn_motion_planning_tpu.planners.gnn_smooth import make_projection_core_flat as jax_projection_flat
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges, k_scaled
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack, make_explore_round_core
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import (
    make_projection_core,
    make_projection_core_flat,
)


@pytest.fixture(scope="module")
def envs():
    jenv, tenv = JaxKukaEnv(), KukaEnv(device="cpu")
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    return jenv, tenv


@pytest.fixture(scope="module")
def round_inputs(envs):
    """Problem 2000 with 60 samples and seeded random scores: a search that
    rejects edges, reaches the goal region late or not at all."""

    _, tenv = envs
    tenv.rng = problem_rng(1234, 2000)
    free, coll = tenv.sample_n_points(60, need_negative=True)
    free = [tenv.init_state, tenv.goal_state] + list(free)
    coll = list(coll)[: len(free)]
    F, C, d = len(free), len(coll), tenv.config_dim
    N = 2 * F
    v = np.zeros((N, d), np.float32)
    v[:F] = np.asarray(free, np.float32)
    v[F : F + C] = np.asarray(coll, np.float32)
    node_valid = np.arange(N) < F + C
    collided = (np.arange(N) >= F) & node_valid
    edges = build_rgg_edges(torch.as_tensor(v), torch.as_tensor(node_valid), F, k_scaled(30, F))
    scores = np.random.RandomState(5).randn(N, N).astype(np.float32)
    return v, node_valid, collided, edges, scores


def _jax_round(jenv, v, node_valid, collided, edges, scores):
    core = jax.jit(jax_round_core(jenv.kernels(), float(jenv.RRT_EPS)))
    N = v.shape[0]
    from gnn_motion_planning_tpu.graphs.knn import EdgeList

    jedges = EdgeList(*(jnp.asarray(x.numpy().astype(np.int32) if x.dtype != torch.bool else x.numpy()) for x in edges))
    return core(
        jenv.device_scene(), jnp.asarray(v), jnp.asarray(v[1]), jnp.asarray(scores), jedges,
        jnp.asarray(collided), jnp.asarray(node_valid), jnp.zeros(N, bool).at[0].set(True),
        jnp.zeros(N, jnp.int32), jnp.zeros(N, jnp.float32), jnp.zeros((N, N), bool),
    )


@pytest.mark.parametrize("chunk", [1, 32])
def test_round_core_equals_jax(envs, round_inputs, chunk):
    jenv, tenv = envs
    v, node_valid, collided, edges, scores = round_inputs
    want = _jax_round(jenv, v, node_valid, collided, edges, scores)
    N = v.shape[0]
    explored = torch.zeros(N, dtype=torch.bool)
    explored[0] = True
    core = make_explore_round_core(tenv.kernels(), float(tenv.RRT_EPS), chunk=chunk)
    got = core(
        tenv.device_scene(), torch.as_tensor(v), torch.as_tensor(v[1]), torch.as_tensor(scores),
        edges, torch.as_tensor(collided), torch.as_tensor(node_valid), explored,
        torch.zeros(N, dtype=torch.int64), torch.zeros(N), torch.zeros((N, N), dtype=torch.bool),
    )
    assert got.success == bool(want.success)
    assert got.success_node == int(want.success_node)
    assert got.n_checks == int(want.n_checks)
    assert got.n_pops == int(want.n_pops)
    assert got.n_pops > 10
    np.testing.assert_array_equal(got.explored.numpy(), np.asarray(want.explored))
    np.testing.assert_array_equal(got.prev.numpy(), np.asarray(want.prev))
    np.testing.assert_array_equal(got.edge_dead.numpy(), np.asarray(want.edge_dead))
    np.testing.assert_allclose(got.costs.numpy(), np.asarray(want.costs), rtol=1e-6)
    if got.success:
        path = backtrack(got.prev.numpy(), got.success_node)
        assert path[0] == 0 and path[-1] == got.success_node


def _projection_inputs(tenv, L=64, n_path=12, seed=6):
    rng = np.random.RandomState(seed)
    a, b = tenv.init_state.astype(np.float32), tenv.goal_state.astype(np.float32)
    path = np.repeat(b[None], L, axis=0)
    path[:n_path] = np.linspace(a, b, n_path).astype(np.float32)
    proposal = path + rng.normal(0, 0.6, path.shape).astype(np.float32)
    proposal[0], proposal[n_path - 1 :] = path[0], path[n_path - 1 :]
    return path, proposal, n_path


@pytest.mark.parametrize("flat", [True, False])
def test_projection_equals_jax(envs, flat):
    """Same accept decisions and count; waypoints within 1e-6 (XLA on the
    CPU fuses multiply-adds such as ``a + t * v`` into FMAs, torch rounds
    each op, so a steered waypoint can differ in its last bit)."""

    jenv, tenv = envs
    path, proposal, n_path = _projection_inputs(tenv)
    eps = float(tenv.RRT_EPS)
    jproj = (jax_projection_flat if flat else jax_projection)(jenv.kernels(), eps)
    want_path, want_cnt, want_ovf = jax.jit(jproj)(
        jenv.device_scene(), jnp.asarray(path), jnp.asarray(proposal), jnp.int32(n_path)
    )
    proj = (make_projection_core_flat if flat else make_projection_core)(tenv.kernels(), eps)
    got_path, got_cnt, got_ovf = proj(
        tenv.device_scene(), torch.as_tensor(path), torch.as_tensor(proposal), n_path
    )
    np.testing.assert_allclose(got_path.numpy(), np.asarray(want_path), rtol=0, atol=1e-6)
    assert got_cnt == int(want_cnt) and got_cnt > 0
    assert got_ovf == bool(want_ovf)
    assert not np.array_equal(got_path.numpy(), path)  # some waypoint moved


def test_flat_projection_overflow_flag(envs):
    """A step needing more than ``slots`` states raises the flag, as the JAX
    flat core does (the caller then redoes at the full budget)."""

    jenv, tenv = envs
    path, proposal, n_path = _projection_inputs(tenv)
    eps = float(tenv.RRT_EPS)
    want = jax.jit(jax_projection_flat(jenv.kernels(), eps, slots=64))(
        jenv.device_scene(), jnp.asarray(path), jnp.asarray(proposal), jnp.int32(n_path)
    )
    got = make_projection_core_flat(tenv.kernels(), eps, slots=64)(
        tenv.device_scene(), torch.as_tensor(path), torch.as_tensor(proposal), n_path
    )
    assert got[2] and bool(want[2])
