"""The baselines of the paper's comparison in the port (``api/eval_baselines
.py``: BIT*, LazySP, RRT*, NEXT) against the JAX package's, problem by
problem, and the env host protocol they call.

Rows: each problem run alone through ``eval_<method>(config, 1234, env,
[index])`` at the drivers' defaults (batch 50, T 1000; BIT* with its 300 s
budget). Success and collision checks must be equal, path cost within 1e-6
(NEXT: 1e-5, and recorded near-ties; see ``NEXT_NEAR_TIES``).
The JAX rows are fixtures (``tests/data/torch_port_baselines_<config>_jax_
rows.json``); rewrite one with ``python tests/test_torch_port_baselines.py
<config>``. They record each JAX row's seconds: every fixture problem
finishes far inside BIT*'s 300 s budget (the test checks it), so no row
depends on the machine's speed. One case runs live against the JAX package
(LazySP on maze2easy 2000, at a cut budget), so the fixture path is itself
held.

The host protocol: ``_edge_fp``, ``_state_fp``, ``step`` and
``get_robot_points`` give JAX's decisions, counts, ``collision_point`` and
points on 256 edges and states of ur5, kuka7, kuka14 and maze2easy.
"""

import contextlib
import io
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

SEED = 1234
METHODS = ("bit", "lazysp", "rrt", "next")
PROBLEMS = {"maze2easy": [2000, 2001], "kuka7": [2000], "ur5": [2000], "snake7": [2000]}
BUDGET_S = 300  # eval_bit's time_budget (JAX api/eval_baselines.py:49)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def fixture_path(config: str) -> Path:
    return (Path(__file__).resolve().parent / "data"
            / f"torch_port_baselines_{config}_jax_rows.json")


def row(module, method: str, config: str, env, index: int, **kw) -> dict:
    """One problem's row from a package's ``eval_<method>`` (its metric
    block silenced): success, checks, cost and the wall seconds."""

    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        r = getattr(module, "eval_" + method)(config, SEED, env, [index], **kw)
    return dict(index=int(index), method=method, success=int(r[0]), checks=float(r[1]),
                cost=None if np.isnan(r[3]) else float(r[3]), seconds=time.time() - t0)


# NEXT's states come from the model's float32 forward, held to XLA's within
# atol 1e-5 times its scale (tests/test_torch_port_next.py), and each node
# steps from its parent, so its path costs carry that difference: 1e-5 there
# (the other planners' arithmetic is the host's, exactly the JAX package's)
NEXT_COST_TOL = 1e-5
# NEXT rows whose checks differ from JAX's at a recorded near-tie (ROADMAP.md
# section 3): (config, index) -> the port's checks on this CPU at two
# threads. kuka7 2000: the last insert (node 39, from node 24) lies within
# 5e-6 (the model's difference, accumulated down the tree) of a multiple of
# RRT_EPS from its parent, and the fixed-step rule takes 8 interior steps
# where JAX takes 9; every decision before it is the same. ur5 2000 (T =
# 1000, both fail): the first count differs at node 59 (from node 23, one
# interior step fewer, states within 1e-5), and down the 1,000-node tree the
# states drift apart (1e-4 by node 966), 7,410 against
# 7,407. snake7 2000 (T = 1000, both fail): the first count differs at node
# 24 (from node 22, one check more; states within 5.3e-7), 6,664 against
# 6,665
NEXT_NEAR_TIES = {("kuka7", 2000): 257.0, ("ur5", 2000): 7410.0, ("snake7", 2000): 6664.0}


def assert_rows_equal(got: dict, want: dict, config: str = ""):
    key = (want["method"], want["index"])
    assert got["success"] == want["success"], key
    if want["method"] == "next" and (config, want["index"]) in NEXT_NEAR_TIES:
        assert got["checks"] == NEXT_NEAR_TIES[config, want["index"]], key
    else:
        assert got["checks"] == want["checks"], key
    tol = NEXT_COST_TOL if want["method"] == "next" else 1e-6
    if want["cost"] is None:
        assert got["cost"] is None, key
    else:
        assert abs(got["cost"] - want["cost"]) < tol, key


def _jax_env(config):
    from gnn_motion_planning_tpu.api.registry import str2env

    return str2env(config)[0]


def _port_env(config):
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    return str2env(config, device="cpu")[0]


def write(config: str):
    """Run the JAX package's four baselines on the config's problems and
    write the fixture."""

    import gnn_motion_planning_tpu.api.eval_baselines as jax_baselines

    env = _jax_env(config)
    rows = [row(jax_baselines, m, config, env, i) for m in METHODS for i in PROBLEMS[config]]
    cut = {}
    budgets = sorted({CUT_T.get(config), CARD_T.get(config)} - {None})
    if budgets:
        cut["cut_rows"] = [dict(row(jax_baselines, m, config, env, i, t_max=t), t_max=t)
                           for t in budgets
                           for c, m in sorted(SLOW) if c == config for i in PROBLEMS[config]]
    fixture_path(config).write_text(json.dumps({
        "about": "JAX eval_bit/eval_lazysp/eval_rrt/eval_next, each problem alone, "
                 f"seed {SEED}, batch 50, T 1000; tests/test_torch_port_baselines.py",
        "rows": rows,
        **cut,
    }, indent=1) + "\n")


# ur5's RRT* and NEXT exhaust T = 1000 on problem 2000 (5,317 and 7,407
# checks), each check a call of the device oracle (some 35 ms on this
# CPU): a minute or more each, so they are slow; chip_smoke.py phase 8 runs
# them on the card. So are snake7's (3,899 and 6,665 checks, about a minute
# each), whose rows are also held at a cut budget, T = CUT_T, by a test
# that is not slow
SLOW = {("ur5", "rrt"), ("ur5", "next"), ("snake7", "rrt"), ("snake7", "next")}
CUT_T = {"snake7": 20}  # under node 24, NEXT's near-tie below
# the card's cut budget for the same rows: chip_smoke.py phase 8 runs
# NEXT at T = 200 on ur5 and snake7 (reported there)
CARD_T = {"snake7": 200, "ur5": 200}
# snake7's cases run in tests/test_torch_port_snake.py, through the check_*
# functions below (each file stays under a minute)
HERE = [c for c in PROBLEMS if c != "snake7"]
CASES = [pytest.param(c, m, marks=[pytest.mark.slow] if (c, m) in SLOW else [])
         for c in HERE for m in METHODS]


@pytest.mark.parametrize("config,method", CASES)
def test_baseline_rows_equal_jax_fixture(config, method):
    check_fixture_rows(config, method)


def check_fixture_rows(config: str, method: str):
    import gnn_motion_planning_tpu_torch.api.eval_baselines as baselines

    rows = json.loads(fixture_path(config).read_text())["rows"]
    assert [(r["method"], r["index"]) for r in rows] == [
        (m, i) for m in METHODS for i in PROBLEMS[config]]
    # every JAX row finished far inside BIT*'s budget: no row hit it
    assert max(r["seconds"] for r in rows) < BUDGET_S / 5
    env = _port_env(config)
    for w in (r for r in rows if r["method"] == method):
        got = row(baselines, method, config, env, w["index"])
        assert got["seconds"] < BUDGET_S / 2
        assert_rows_equal(got, w, config)


def check_cut_rows(config: str):
    """The slow methods' rows at T = CUT_T (the same planners and oracles,
    a smaller tree)."""

    import gnn_motion_planning_tpu_torch.api.eval_baselines as baselines

    rows = [r for r in json.loads(fixture_path(config).read_text())["cut_rows"]
            if r["t_max"] == CUT_T[config]]
    assert sorted((r["method"], r["index"]) for r in rows) == sorted(
        (m, i) for c, m in SLOW if c == config for i in PROBLEMS[config])
    env = _port_env(config)
    for w in rows:
        got = row(baselines, w["method"], config, env, w["index"], t_max=w["t_max"])
        assert_rows_equal(got, w)


@pytest.mark.parametrize("config,index", [
    pytest.param(c, i, marks=[pytest.mark.slow] if (c, "next") in SLOW else [])
    for c, i in NEXT_NEAR_TIES if c in HERE])
def test_next_near_tie_is_the_model_forward(config, index):
    check_near_tie(config, index)


def check_near_tie(config: str, index: int):
    """The second witness of each ``NEXT_NEAR_TIES`` row: the port's NEXT
    planner, env and draws, with the JAX package's model forward (its
    ``net_forward``, FK augmentation included) in place of the port's, give
    the JAX row exactly, checks and cost. So the row differs only through
    the model's float32 forward."""

    import gnn_motion_planning_tpu.api.eval_baselines as jax_baselines
    import gnn_motion_planning_tpu_torch.api.eval_baselines as baselines

    env = _port_env(config)
    model, _ = baselines.str2next(config, env)
    jax_model, _ = jax_baselines.str2next(config, _jax_env(config))
    port_set_problem = model.set_problem

    def set_problem(problem):
        port_set_problem(problem)
        jax_model.set_problem(problem)

    model.set_problem = set_problem
    model.net_forward = jax_model.net_forward  # policy and pred_value call it
    baselines._seed_env(SEED, env)
    with contextlib.redirect_stdout(io.StringIO()):
        r = baselines._eval_tree_planner(env, [index], False, 1000, model, 0.1)
    want = next(w for w in json.loads(fixture_path(config).read_text())["rows"]
                if w["method"] == "next" and w["index"] == index)
    got = dict(index=index, method="next", success=int(r[0]), checks=float(r[1]),
               cost=None if np.isnan(r[3]) else float(r[3]))
    assert got["checks"] == want["checks"] != NEXT_NEAR_TIES[config, index]
    assert got["success"] == want["success"]
    if want["cost"] is None:
        assert got["cost"] is None
    else:
        assert abs(got["cost"] - want["cost"]) < 1e-6


def test_lazysp_live_against_jax():
    """LazySP on maze2easy 2000 in both packages in this run, at a cut
    budget (batch 20, T 200): the rows and the returned paths."""

    import gnn_motion_planning_tpu.api.eval_baselines as jax_baselines
    import gnn_motion_planning_tpu_torch.api.eval_baselines as baselines

    kw = dict(batch=20, t_max=200)
    want = row(jax_baselines, "lazysp", "maze2easy", _jax_env("maze2easy"), 2000, **kw)
    got = row(baselines, "lazysp", "maze2easy", _port_env("maze2easy"), 2000, **kw)
    assert_rows_equal(got, want)
    assert want["success"] == 1


HOST = ["ur5", "kuka7", "kuka14", "maze2easy"]


@pytest.mark.parametrize("config", HOST)
def test_env_host_protocol_equals_jax(config):
    check_host_protocol(config)


def check_host_protocol(config: str):
    """256 states and 128 edges between them (half of them short steps from
    a state, so both free and colliding edges occur) on problem 2000:
    ``_state_fp``, ``_edge_fp`` and ``step`` decide, count and record
    ``collision_point`` as JAX's; ``get_robot_points`` and the problem map
    are JAX's."""

    jenv, tenv = _jax_env(config), _port_env(config)
    pj, pt = jenv.init_new_problem(2000), tenv.init_new_problem(2000)
    np.testing.assert_array_equal(np.asarray(pt["map"]), np.asarray(pj["map"]))
    lo, hi = np.asarray(tenv.bound, float).reshape(2, -1)
    rs = np.random.RandomState(7)
    qs = rs.uniform(lo, hi, (256, tenv.config_dim))
    near = qs[:64] + rs.normal(0, 0.05 * (hi - lo), (64, tenv.config_dim))
    ends = np.concatenate([near, qs[64:128]])
    for env in (jenv, tenv):
        env.collision_check_count = 0
    for q in qs:
        assert tenv._state_fp(q) == jenv._state_fp(q)
        assert tenv.collision_check_count == jenv.collision_check_count
        np.testing.assert_array_equal(np.asarray(tenv.collision_point),
                                      np.asarray(jenv.collision_point))
    for a, b in zip(qs[:128], ends):
        assert tenv._edge_fp(a, b) == jenv._edge_fp(a, b)
        assert tenv.collision_check_count == jenv.collision_check_count
        np.testing.assert_array_equal(np.asarray(tenv.collision_point),
                                      np.asarray(jenv.collision_point))
    for a, b in zip(qs[128:192], qs[192:]):
        got = tenv.step(a.copy(), new_state=b.copy())
        want = jenv.step(a.copy(), new_state=b.copy())
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2:] == want[2:]
        assert tenv.collision_check_count == jenv.collision_check_count
    if config != "maze2easy":
        for q in qs[:32]:
            np.testing.assert_array_equal(np.asarray(tenv.get_robot_points(q)),
                                          np.asarray(jenv.get_robot_points(q)))
        np.testing.assert_array_equal(tenv.robot_points(qs[:32]), np.asarray(
            [jenv.get_robot_points(q) for q in qs[:32]]))


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in sys.argv[1:] or list(PROBLEMS):
        write(name)
