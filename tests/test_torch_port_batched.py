"""The port's lane-batched sweep, ``api/batched.py::eval_gnn_batched``,
against the port's scalar ``eval_gnn`` and the JAX package's rows.

Batched and scalar runs of the same problems must agree exactly: success,
checks (all, and exploration's), cost, and the raw and smoothed paths
waypoint for waypoint (the port's form of tests/test_batched_eval.py).
Against the JAX rows: success and counts exactly, cost within 1e-3 (as
tests/test_torch_port_eval.py holds the scalar rows).
"""

import json

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn, eval_gnn_batched, explore_batch
from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2env, str2models

SEED = 1234
SMALL = dict(batch=100, t_max=100, k=30)
PROTOCOL = dict(batch=500, t_max=500, k=30)
MAZE = [2000, 2001, 2002, 2003]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _setup(name):
    env = str2env(name, device="cpu")[0]
    return env, *str2models(name, "cpu", smoother_scale(name, env))


def _assert_same(a, b):
    """Two sweeps' return tuples: metrics and every path equal."""

    assert a[0] == b[0]  # successes
    assert a[1] == b[1] and a[7] == b[7]  # checks, exploration checks
    assert a[3] == b[3] or (np.isnan(a[3]) and np.isnan(b[3]))  # cost
    for paths_a, paths_b in ((a[5], b[5]), (a[6], b[6])):
        for pa, pb in zip(paths_a, paths_b):
            assert len(pa) == len(pb)
            for qa, qb in zip(pa, pb):
                np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))


@pytest.fixture(scope="module")
def maze_scalar():
    env, model, model_s = _setup("maze2easy")
    return eval_gnn("maze2easy", SEED, env, MAZE, model, model_s, **SMALL)


@pytest.mark.parametrize("chunk", [64, 4])
def test_batched_equals_scalar(maze_scalar, chunk):
    """maze2easy 2000-2003, one group of 4 lanes: at chunk 64 most lanes
    finish in one call; at chunk 4 every lane pauses and resumes many
    times, finished lanes dropping out between calls."""

    env, model, model_s = _setup("maze2easy")
    stats = []
    got = eval_gnn_batched("maze2easy", SEED, env, MAZE, model, model_s, lanes=4,
                           chunk=chunk, stats=stats, **SMALL)
    _assert_same(maze_scalar, got)
    rounds = stats[0]["search_rounds"]
    assert rounds[0][0] == 4
    if chunk == 4:
        assert len(rounds) > 10 and rounds[-1][0] < 4


def test_lane_grouping_does_not_change_results():
    """The same five problems in groups of 2 and in one group of 5."""

    env, model, model_s = _setup("maze2easy")
    idx = [2000, 2001, 2002, 2003, 2004]
    a = eval_gnn_batched("maze2easy", SEED, env, idx, model, model_s, lanes=2, **SMALL)
    b = eval_gnn_batched("maze2easy", SEED, env, idx, model, model_s, lanes=5, **SMALL)
    _assert_same(a, b)


def test_kuka7_protocol_rows_equal_jax_fixture():
    """kuka7 2000-2004 in one group of 5 lanes at the reference protocol
    against the JAX rows of tests/data/torch_port_kuka7_jax_rows.json."""

    from test_torch_port_eval import FIXTURE

    env, model, model_s = _setup("kuka7")
    rows = []
    eval_gnn_batched("kuka7", SEED, env, [2000, 2001, 2002, 2003, 2004], model, model_s,
                     lanes=5, rows=rows, **PROTOCOL)
    want = json.loads(FIXTURE.read_text())["rows"]
    for got, ref in zip(rows, want):
        assert (got["index"], got["success"], got["c_explore"], got["c_smooth"]) == (
            ref["index"], ref["success"], ref["c_explore"], ref["c_smooth"])
        assert abs(got["cost"] - ref["cost"]) < 1e-3


def test_smoother_without_params_raises():
    """Smoothing without a model smoother is JAX's oracle smoother
    (``planners/oracle_smoother.py``, ported since this test was named for
    the error the sweep raised before): the batched sweep runs it lane by
    lane on each lane's own stream, and every problem's result equals the
    scalar ``explore`` with ``smoother="oracle"``, paths and counts."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore
    from gnn_motion_planning_tpu_torch.config import problem_rng

    env, model, _ = _setup("maze2easy")
    got = explore_batch(env, model, None, [2000, 2001], lanes=2, seed=SEED, **SMALL)
    for idx, g in zip([2000, 2001], got):
        env.rng = problem_rng(SEED, idx)
        env.init_new_problem(idx)
        w = explore(env, model, None, True, smoother="oracle", **SMALL)
        assert (g["success"], g["c_explore"], g["c_smooth"]) == (
            w["success"], w["c_explore"], w["c_smooth"])
        for key in ("path", "smooth_path"):
            assert len(g[key]) == len(w[key])
            for qa, qb in zip(g[key], w[key]):
                np.testing.assert_array_equal(np.asarray(qa), np.asarray(qb))


@pytest.mark.slow
def test_kuka14_batched_equals_scalar_with_fallback():
    """kuka14 2000-2007 at the reference protocol, 8 lanes: batched equals
    scalar per problem, and problem 2006, whose first round fails, goes
    through the scalar fallback (tests/test_batched_eval.py:187-200)."""

    env, model, model_s = _setup("kuka14")
    idx = list(range(2000, 2008))
    a = eval_gnn("kuka14", SEED, env, idx, model, model_s, **PROTOCOL)
    stats = []
    b = eval_gnn_batched("kuka14", SEED, env, idx, model, model_s, lanes=8, stats=stats,
                         **PROTOCOL)
    _assert_same(a, b)
    assert any(s.get("scalar_fallbacks", 0) >= 1 for s in stats)
