"""The port's oracle smoother (``planners/oracle_smoother.py``) against the
JAX package's, and the protocol paths that reach it: ``explore(...,
smoother="oracle")`` and the batched sweep without a model smoother.

Held exactly: the smoothed paths waypoint for waypoint, the collision
checks, and the position of the env's random stream afterwards (the
smoothers' draws), on maze2easy (the host grid oracle) and ur5 (the device
oracle, entry A's plain version here). Rows: success and checks equal, cost
within 1e-6.

``write`` records the JAX rows of ``explore(..., smoother="oracle")`` on
ur5 2000-2001 at the protocol (``tests/data/torch_port_oracle_smoother_ur5_
jax_rows.json``), which ``chip_smoke.py`` phase 8 prints beside the port's
batched rows on the card: ``python tests/test_torch_port_oracle_smoother.py``.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

SEED = 1234
PROTOCOL = dict(batch=500, t_max=500, k=30)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _envs(config):
    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    jenv, tenv = jax_str2env(config)[0], str2env(config, device="cpu")[0]
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    return jenv, tenv


def _path(env, n, seed):
    """n waypoints from the problem's start to its goal, jittered (the
    smoothers take any path; some of its edges collide)."""

    a, b = np.asarray(env.init_state, float), np.asarray(env.goal_state, float)
    lo, hi = np.asarray(env.bound, float).reshape(2, -1)
    jitter = np.random.RandomState(seed).normal(0, 0.05 * (hi - lo), (n, len(a)))
    jitter[[0, -1]] = 0
    return [a + (b - a) * t + j for t, j in zip(np.linspace(0, 1, n), jitter)]


def _same_paths(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g, np.float64), np.asarray(w, np.float64))


SMOOTHERS = {
    # name: (config, path length, keywords); ur5's device oracle is slow on
    # the CPU, so its rounds are fewer
    "maze2easy": ("maze2easy", 12, dict(iter=2, random_iter=100, prune_iter=100)),
    "ur5": ("ur5", 8, dict(iter=1, random_iter=15, prune_iter=2)),
}


@pytest.mark.parametrize("case", list(SMOOTHERS))
def test_smoothers_equal_jax(case):
    from gnn_motion_planning_tpu.config import HostRNG as JaxHostRNG
    from gnn_motion_planning_tpu.planners import oracle_smoother as jax_sm
    from gnn_motion_planning_tpu_torch.config import HostRNG
    from gnn_motion_planning_tpu_torch.planners import oracle_smoother as sm

    config, n, kw = SMOOTHERS[case]
    jenv, tenv = _envs(config)
    path = _path(tenv, n, 3)
    calls = [
        ("random_path_smoother",
         lambda m, env: m.random_path_smoother(list(path), env.RRT_EPS, env,
                                               iter=kw["random_iter"])),
        ("prune_path", lambda m, env: m.prune_path(list(path), env, iter=kw["prune_iter"])),
        ("joint_smoother", lambda m, env: m.joint_smoother(list(path), env, **kw)),
    ]
    for name, call in calls:
        out = []
        for m, env, rng in ((jax_sm, jenv, JaxHostRNG(77)), (sm, tenv, HostRNG(77))):
            env.rng = rng
            env.collision_check_count = 0
            out.append((call(m, env), env.collision_check_count, env.rng.get_state()))
        (want, want_c, want_s), (got, got_c, got_s) = out
        _same_paths(got, want)
        assert got_c == want_c, name
        assert np.array_equal(got_s[1], want_s[1]) and got_s[2] == want_s[2], name


def _jax_rows(indexes, config="maze2easy"):
    """JAX ``explore(..., smoother="oracle")`` rows: (success, c_explore,
    c_smooth, cost) a problem, on per-problem streams."""

    from gnn_motion_planning_tpu.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu.api.registry import str2env, str2models
    from gnn_motion_planning_tpu.config import problem_rng

    env = str2env(config)[0]
    model, _ = str2models(config)
    rows = []
    for idx in indexes:
        env.rng = problem_rng(SEED, idx)
        env.init_new_problem(idx)
        r = explore(env, model, None, True, smoother="oracle", **PROTOCOL)
        rows.append((bool(r["success"]), int(r["c_explore"]), int(r["c_smooth"]),
                     path_cost(r["smooth_path"])))
    return rows


UR5_FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_oracle_smoother_ur5_jax_rows.json"
UR5_PROBLEMS = [2000, 2001]


def write():
    rows = _jax_rows(UR5_PROBLEMS, "ur5")
    UR5_FIXTURE.write_text(json.dumps({
        "about": "JAX explore(ur5, smoother='oracle'), batch 500, t_max 500, k 30, seed 1234, "
                 "per-problem streams; tests/test_torch_port_oracle_smoother.py",
        "rows": [dict(index=i, success=r[0], c_explore=r[1], c_smooth=r[2], cost=r[3])
                 for i, r in zip(UR5_PROBLEMS, rows)],
    }, indent=1) + "\n")


def test_explore_oracle_smoother_rows_equal_jax():
    """maze2easy 2000-2001 at the protocol: the scalar ``explore`` with
    ``smoother="oracle"`` and ``explore_batch`` without a model smoother
    give JAX's rows (JAX's batched rows equal its scalar ones)."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore, explore_batch, path_cost
    from gnn_motion_planning_tpu_torch.api.registry import str2env, str2models
    from gnn_motion_planning_tpu_torch.config import problem_rng

    want = _jax_rows([2000, 2001])
    env = str2env("maze2easy", device="cpu")[0]
    model, _ = str2models("maze2easy", "cpu")
    scalar = []
    for idx in (2000, 2001):
        env.rng = problem_rng(SEED, idx)
        env.init_new_problem(idx)
        scalar.append(explore(env, model, None, True, smoother="oracle", **PROTOCOL))
    batched = explore_batch(env, model, None, [2000, 2001], lanes=2, seed=SEED, **PROTOCOL)
    for w, s, b in zip(want, scalar, batched):
        assert w[0] and w[2] > 0
        for r in (s, b):
            assert (r["success"], r["c_explore"], r["c_smooth"]) == w[:3]
            assert abs(path_cost(r["smooth_path"]) - w[3]) < 1e-6


@pytest.mark.slow
def test_ur5_oracle_smoother_rows_equal_jax_fixture():
    """ur5 2000-2001 at the protocol, ``explore_batch`` without a model
    smoother: the JAX fixture rows. Slow: every check of ur5's oracle
    smoother is a call of the device oracle, some 35 ms on this CPU."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore_batch, path_cost
    from gnn_motion_planning_tpu_torch.api.registry import str2env, str2models

    want = json.loads(UR5_FIXTURE.read_text())["rows"]
    env = str2env("ur5", device="cpu")[0]
    model, _ = str2models("ur5", "cpu")
    got = explore_batch(env, model, None, UR5_PROBLEMS, lanes=2, seed=SEED, **PROTOCOL)
    for w, r in zip(want, got):
        assert (r["success"], r["c_explore"], r["c_smooth"]) == (
            w["success"], w["c_explore"], w["c_smooth"])
        assert abs(path_cost(r["smooth_path"]) - w["cost"]) < 1e-6


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
