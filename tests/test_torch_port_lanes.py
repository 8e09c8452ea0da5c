"""The port's lane axis against the JAX package's ``jax.vmap``: the kernel's
plain versions with a lane axis of per-problem scenes, the env oracles over
stacked scenes, the lane-batched chunked greedy search, and
``explore_batch`` at 4 and 8 lanes against JAX's batched program
(``tests/data/torch_port_lanes_jax_rows.json``; regenerate with ``python
tests/test_torch_port_lanes.py``).

Tolerances: decisions, counts, search trees and costs exactly; an
``explore_batch`` row's checks exactly and its cost within 1e-3 (the
protocol rows' tolerance). ur5's wide cases are slow (1.5 and 5.5 minutes
on this CPU); kuka7's cover the same code at 4 and 8 lanes.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.graphs.knn import EdgeList as JaxEdgeList
from gnn_motion_planning_tpu.planners.gnn_explore import (
    make_explore_round_batch_chunked as jax_round_chunked,
)
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.envs.base import stack_scenes
from gnn_motion_planning_tpu_torch.envs.kinematics import lane_capsules
from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges_lanes, k_scaled
from gnn_motion_planning_tpu_torch.ops import capsule
from gnn_motion_planning_tpu_torch.ops.capsule import pack_chain
from gnn_motion_planning_tpu_torch.planners.gnn_explore import make_explore_round_batch_chunked

PROBLEMS = (2000, 2001, 2002)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _envs(name):
    """(port env, JAX env) of a config, port on the CPU."""

    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    return str2env(name, device="cpu")[0], jax_str2env(name)[0]


def _scenes(tenv, jenv, problems=PROBLEMS):
    ts, js = [], []
    for i in problems:
        tenv.init_new_problem(i)
        jenv.init_new_problem(i)
        ts.append(tenv.device_scene())
        js.append(jenv.device_scene())
    return stack_scenes(ts), jax.tree.map(lambda *xs: jnp.stack(xs), *js)


def _states(env, n, seed):
    """n states a lane for 3 lanes: uniform in the sampling range, every
    ninth out of it."""

    from gnn_motion_planning_tpu_torch.api.serve import sample_range

    pr = sample_range(env)
    qs = np.random.RandomState(seed).uniform(pr[:, 0], pr[:, 1], (3, n, env.config_dim))
    qs[:, ::9] += 1.5 * (pr[:, 1] - pr[:, 0])
    return qs.astype(np.float32)


def test_plain_box_entry_equals_separate_lanes():
    """Entry A's plain version over 3 lanes of different scenes (different
    active counts) equals 3 calls of one lane each."""

    from gnn_motion_planning_tpu_torch.envs.kuka import BoxScene, KukaEnv

    env = KukaEnv(device="cpu")
    rng = np.random.RandomState(3)
    scenes = []
    for n_on in (1, 3, 6):
        mask = np.zeros(16, bool)
        mask[rng.choice(16, n_on, replace=False)] = True
        scenes.append(BoxScene(
            torch.as_tensor(rng.uniform((-0.8, -0.8, 0), (0.8, 0.8, 1.2), (16, 3)).astype(np.float32)),
            torch.as_tensor(rng.uniform(0.02, 0.1, (16, 3)).astype(np.float32)),
            torch.as_tensor(mask)))
    lo, hi = env.chain.lower.numpy(), env.chain.upper.numpy()
    qs = torch.as_tensor(rng.uniform(lo, hi, (3, 200, lo.shape[0])).astype(np.float32))
    p0, p1 = lane_capsules(env.chain, qs)
    stacked = stack_scenes(scenes)
    got = capsule.capsules_hit(p0, p1, env.chain.cap_r, *stacked)
    for lane, sc in enumerate(scenes):
        one = capsule.capsules_hit(p0[lane:lane + 1], p1[lane:lane + 1], env.chain.cap_r,
                                   *(t[None] for t in sc))
        assert torch.equal(got[lane], one[0])
    assert 0 < int(got.sum()) < got.numel()
    assert len({int(n) for n in got.sum(dim=1)}) == 3  # the lanes' scenes differ


def test_plain_chain_entry_equals_separate_lanes():
    """Entry B's plain version over 3 lanes (kuka7 problems 2000-2002, whose
    active box counts differ) equals 3 calls of one lane each."""

    tenv, jenv = _envs("kuka7")
    stacked, _ = _scenes(tenv, jenv)
    assert len(set(stacked.mask.sum(dim=1).tolist())) > 1
    packed = pack_chain(tenv.chain)
    qs = torch.as_tensor(_states(tenv, 96, 1))
    free, cnt = capsule.chain_states_free(qs, packed, stacked)
    for lane in range(3):
        one = type(stacked)(*(t[lane:lane + 1] for t in stacked))
        f1, c1 = capsule.chain_states_free(qs[lane:lane + 1], packed, one)
        assert torch.equal(free[lane], f1[0]) and torch.equal(cnt[lane], c1[0])


@pytest.mark.parametrize("name", ["kuka7", "ur5", "kuka14", "snake7", "maze2easy", "maze3"])
def test_lane_oracles_equal_jax_vmap(name):
    """``batch_state_free`` and ``edge_free`` over a stacked scene of 3
    problems against JAX's ``jax.vmap`` of the same oracle over the stacked
    JAX scenes: decisions and counts exactly."""

    tenv, jenv = _envs(name)
    tscene, jscene = _scenes(tenv, jenv)
    tk, jk = tenv.kernels(), jenv.kernels()
    qs = _states(tenv, 64, 2)
    got, got_cnt = tk.batch_state_free(tscene, torch.as_tensor(qs))
    want, want_cnt = jax.jit(jax.vmap(lambda sc, q: jax.vmap(lambda x: jk.state_free(sc, x))(q)))(
        jscene, jnp.asarray(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert got.any() and not got.all()

    # 16 edges a lane: hops of 2.5 steps from free states, and long ones
    free = got.numpy()
    qa = np.stack([np.concatenate([np.concatenate([qs[i][free[i]], qs[i]])[:8], qs[i][:8]])
                   for i in range(3)])
    hop = np.random.RandomState(4).normal(size=qa.shape)
    hop /= np.linalg.norm(hop, axis=-1, keepdims=True)
    qb = (qa + hop * 2.5 * tenv.RRT_EPS).astype(np.float32)
    qb[:, 8:] = qs[:, 20:28]
    got, got_cnt = tk.edge_free(tscene, torch.as_tensor(qa), torch.as_tensor(qb))
    want, want_cnt = jax.jit(jax.vmap(lambda sc, a, b: jax.vmap(lambda x, y: jk.edge_free(sc, x, y))(a, b)))(
        jscene, jnp.asarray(qa), jnp.asarray(qb))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))
    assert got.any() and (got_cnt > 3).any()


def _search_inputs(tenv, batch=50):
    """3 lanes of problems 2000-2002: the first round's nodes from each
    problem's stream, its RGG and seeded random scores."""

    vs, valids, colls, goals = [], [], [], []
    for i in PROBLEMS:
        tenv.rng = problem_rng(1234, i)
        tenv.init_new_problem(i)
        free, coll = tenv.sample_n_points(batch, need_negative=True)
        free = [tenv.init_state, tenv.goal_state] + list(free)
        coll = list(coll)[: len(free)]
        F, C = len(free), len(coll)
        N = 2 * F
        v = np.zeros((N, tenv.config_dim), np.float32)
        v[:F] = np.asarray(free, np.float32)
        if C:
            v[F:F + C] = np.asarray(coll, np.float32)
        vs.append(v)
        valids.append(np.arange(N) < F + C)
        colls.append((np.arange(N) >= F) & (np.arange(N) < F + C))
        goals.append(v[1])
    v, valid, coll, goal = (np.stack(x) for x in (vs, valids, colls, goals))
    F = batch + 2
    edges = build_rgg_edges_lanes(torch.as_tensor(v), torch.as_tensor(valid), F, k_scaled(30, F))
    scores = np.random.RandomState(5).randn(3, 2 * F, 2 * F).astype(np.float32)
    return v, valid, coll, goal, edges, scores


@pytest.mark.parametrize("name", ["maze2easy", "kuka7"])
def test_lane_search_equals_jax_chunked(name):
    """The lane-batched search against JAX ``make_explore_round_batch_chunked``
    fed the same policy, at chunk 4 (pausing and resuming across calls) and
    at chunk 64: per lane and per call ``done`` and ``n_checks``; at the end
    ``success``, ``success_node``, ``explored``, ``prev`` exactly and
    ``costs`` bit-equal."""

    tenv, jenv = _envs(name)
    tscene, jscene = _scenes(tenv, jenv)
    v, valid, coll, goal, edges, scores = _search_inputs(tenv)
    L, N = v.shape[:2]
    jedges = JaxEdgeList(*(jnp.asarray(x.numpy().astype(np.int32) if x.dtype != torch.bool else x.numpy())
                           for x in edges))
    jfn = jax_round_chunked(jenv.kernels(), float(jenv.RRT_EPS))
    tfn = make_explore_round_batch_chunked(tenv.kernels(), float(tenv.RRT_EPS))
    for chunk in (4, 64):
        explored0 = np.zeros((L, N), bool)
        explored0[:, 0] = True
        jst = (jnp.asarray(explored0), jnp.zeros((L, N), jnp.int32), jnp.zeros((L, N), jnp.float32),
               jnp.zeros((L, N, N), bool))
        tst = (torch.as_tensor(explored0), torch.zeros((L, N), dtype=torch.int64),
               torch.zeros((L, N)), torch.zeros((L, N, N), dtype=torch.bool))
        done = np.zeros(L, bool)
        final = {}
        calls = 0
        while not done.all():
            want = jfn(jscene, jnp.asarray(v), jnp.asarray(goal), jnp.asarray(scores), jedges,
                       jnp.asarray(coll), jnp.asarray(valid), *jst, jnp.asarray(done), chunk=chunk)
            got = tfn(tscene, torch.as_tensor(v), torch.as_tensor(goal), torch.as_tensor(scores),
                      edges, torch.as_tensor(coll), torch.as_tensor(valid), *tst,
                      torch.as_tensor(done), chunk=chunk)
            np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
            np.testing.assert_array_equal(got.n_checks.numpy(), np.asarray(want.n_checks))
            for lane in np.nonzero(got.done.numpy() & ~done)[0]:
                final[lane] = (got, want)
            done = got.done.numpy().copy()
            jst = (want.explored, want.prev, want.costs, want.edge_dead)
            tst = (got.explored, got.prev, got.costs, got.edge_dead)
            calls += 1
        assert calls > 1 if chunk == 4 else True
        for lane, (got, want) in final.items():
            assert bool(got.success[lane]) == bool(want.success[lane])
            assert int(got.success_node[lane]) == int(want.success_node[lane])
            np.testing.assert_array_equal(got.explored[lane].numpy(), np.asarray(want.explored[lane]))
            np.testing.assert_array_equal(got.prev[lane].numpy(), np.asarray(want.prev[lane]))
            np.testing.assert_array_equal(got.costs[lane].numpy(), np.asarray(want.costs[lane]))
        assert len(final) == L


# ---------------------------------------------------------------------------
# explore_batch at 4 and 8 lanes against JAX's batched program
# ---------------------------------------------------------------------------

WIDE_FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_lanes_jax_rows.json"
# lanes -> problems (one group each); a cut protocol (batch 100, t_max 100)
WIDE = {"lanes": [4, 8], "first": 2000, "batch": 100, "t_max": 100, "k": 30, "seed": 1234}


def _wide_rows(results, indexes, path_cost):
    return [dict(index=int(i), success=bool(r["success"]), c_explore=int(r["c_explore"]),
                 c_smooth=int(r["c_smooth"]), cost=float(path_cost(r["smooth_path"])))
            for i, r in zip(indexes, results)]


def jax_wide_rows(config: str, lanes: int) -> list:
    """JAX's ``explore_batch`` rows of one group of ``lanes`` problems."""

    from gnn_motion_planning_tpu.api.batched import explore_batch as jax_explore_batch
    from gnn_motion_planning_tpu.api.eval_gnn import path_cost
    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu.api.registry import str2models as jax_str2models

    env = jax_str2env(config)[0]
    scale = float(np.max(env.bound)) if config == "ur5" else 1.0
    model, model_s = jax_str2models(config, scale=scale)
    indexes = list(range(WIDE["first"], WIDE["first"] + lanes))
    results = jax_explore_batch(env, model, model_s, indexes, lanes=lanes, batch=WIDE["batch"],
                                t_max=WIDE["t_max"], k=WIDE["k"], seed=WIDE["seed"])
    return _wide_rows(results, indexes, path_cost)


@pytest.mark.parametrize("config,lanes", [
    ("kuka7", 4),
    ("kuka7", 8),
    pytest.param("ur5", 4, marks=pytest.mark.slow),
    pytest.param("ur5", 8, marks=pytest.mark.slow),
])
def test_explore_batch_wide_lanes_equal_jax(config, lanes):
    """One group of 4 or 8 lanes (5-8 joints, so XLA's batched program
    flattens lanes into rows) gives JAX's rows, lane for lane."""

    import json

    from gnn_motion_planning_tpu_torch.api.batched import explore_batch
    from gnn_motion_planning_tpu_torch.api.eval_gnn import path_cost
    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2env, str2models

    env = str2env(config, device="cpu")[0]
    model, model_s = str2models(config, "cpu", smoother_scale(config, env))
    indexes = list(range(WIDE["first"], WIDE["first"] + lanes))
    got = _wide_rows(explore_batch(env, model, model_s, indexes, lanes=lanes,
                                   batch=WIDE["batch"], t_max=WIDE["t_max"], k=WIDE["k"],
                                   seed=WIDE["seed"]), indexes, path_cost)
    fixture = json.loads(WIDE_FIXTURE.read_text())
    assert fixture["settings"] == WIDE
    want = fixture["rows"][f"{config}_{lanes}"]
    for g, w in zip(got, want):
        for key in ("index", "success", "c_explore", "c_smooth"):
            assert g[key] == w[key], (key, g, w)
        assert abs(g["cost"] - w["cost"]) < 1e-3, (g, w)
    assert len(got) == len(want) == lanes and any(r["success"] for r in got)


def write_wide_fixture():
    import json

    rows = {}
    for config in ("kuka7", "ur5"):
        for lanes in WIDE["lanes"]:
            rows[f"{config}_{lanes}"] = jax_wide_rows(config, lanes)
            print(config, lanes, rows[f"{config}_{lanes}"], flush=True)
    WIDE_FIXTURE.write_text(json.dumps({
        "about": "gnn_motion_planning_tpu.api.batched.explore_batch, one group of `lanes` "
                 "problems from `first`, JAX on the CPU; written by "
                 "tests/test_torch_port_lanes.py::write_wide_fixture",
        "settings": WIDE, "rows": rows,
    }, indent=1) + "\n")


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    jax.config.update("jax_platforms", "cpu")
    write_wide_fixture()
