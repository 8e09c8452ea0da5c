"""The strict fallback in the port (``planners/strict_fallback.py`` and
``explore(..., strict_fallback=True)``) and ``validate_path_strict``
against the JAX package's, on the CPU.

- The stub tests of ``tests/test_strict_fallback.py`` and the soundness
  tests of ``tests/test_strict.py``, mirrored on the port's modules.
- ``validate_path_strict``: counts equal to JAX's on seeded paths.
- kuka14 problem 2170, the ``oracle_conservatism`` witness
  (``assets/benchmarks/strict_fallback_kuka14.json``): every edge JAX's
  fallback re-admitted is free under the port's hull check, and its
  capsule ``_edge_fp`` decides as JAX's; at a cut budget (batch and t_max
  50) 2170 is recovered and 2118 given up, each with JAX's row, node path
  and sequence of hull verifications; the whole run at the reference
  protocol is slow (some 90 s here) and gives JAX's row.

JAX's rows are in ``tests/data/torch_port_strict_jax.json`` (written by
``python tests/test_torch_port_strict.py``).
"""

import json

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.graphs.knn import EdgeList
from gnn_motion_planning_tpu_torch.planners import strict_fallback as sf
from test_torch_port_strict import (
    CUT,
    FIXTURE,
    WITNESS,
    _jax_env,
    _port_env,
    uniform_states,
    witness_row,
    witness_run,
)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class StubEnv:
    RRT_EPS = 0.1
    config_dim = 2

    def __init__(self, v, capsule_free_pairs):
        self.collision_check_count = 0
        self._v = v
        self._free = {tuple(sorted(p)) for p in capsule_free_pairs}

    def _pair(self, a, b):
        return tuple(
            sorted(
                int(np.argmin(np.linalg.norm(self._v - np.asarray(p), axis=1)))
                for p in (a, b)
            )
        )

    def _edge_fp(self, a, b):
        self.collision_check_count += 1
        return self._pair(a, b) in self._free


def _edge_list(pairs, n):
    src = np.array([a for a, b in pairs] + [b for a, b in pairs], np.int32)
    dst = np.array([b for a, b in pairs] + [a for a, b in pairs], np.int32)
    return EdgeList(src, dst, np.ones(len(src), bool))


def test_fallback_readmits_hull_free_edges(monkeypatch):
    # nodes: 0=init, 1=goal, 2=detour. Direct edge (0,1) is capsule-dead
    # AND hull-hit; (0,2) is capsule-dead but hull-free (the conservatism
    # case); (2,1) is unchecked and capsule-free.
    v = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 0.4]], np.float32)
    edges = _edge_list([(0, 1), (0, 2), (2, 1)], 3)
    dead = np.zeros((3, 3), bool)
    dead[0, 1] = dead[1, 0] = True
    dead[0, 2] = dead[2, 0] = True

    env = StubEnv(v, capsule_free_pairs={(2, 1)})
    hull_free = {(0, 2)}  # by node pair

    def fake_validate(e, seg, checker):
        pair = tuple(sorted(
            int(np.argmin(np.linalg.norm(v - np.asarray(p), axis=1))) for p in seg))
        return 0 if pair in hull_free else 3

    import gnn_motion_planning_tpu_torch.envs.strict as strict_mod

    monkeypatch.setattr(strict_mod, "strict_checker", lambda e: "stub-checker")
    monkeypatch.setattr(strict_mod, "validate_path_strict", fake_validate)

    c0 = env.collision_check_count
    path = sf.strict_fallback_path(env, v, 3, edges, dead)
    assert path == [0, 2, 1]
    # accounting: two hull verifications (direct edge rejected, detour
    # accepted) at >= 2 states each, plus one capsule check for (2,1)
    assert env.collision_check_count - c0 >= 2 * 2 + 1


def test_fallback_gives_up_when_nothing_certifies(monkeypatch):
    v = np.array([[0.0, 0.0], [1.0, 0.0]], np.float32)
    edges = _edge_list([(0, 1)], 2)
    dead = np.ones((2, 2), bool)
    env = StubEnv(v, capsule_free_pairs=set())

    import gnn_motion_planning_tpu_torch.envs.strict as strict_mod

    monkeypatch.setattr(strict_mod, "strict_checker", lambda e: "stub")
    monkeypatch.setattr(strict_mod, "validate_path_strict", lambda e, seg, c: 5)
    assert sf.strict_fallback_path(env, v, 2, edges, dead) is None


@pytest.mark.parametrize("config", ["maze2easy", "snake7"])
def test_fallback_none_for_exact_oracle_envs(config):
    """Maze and snake oracles are exact: strict_checker(env) is None and
    the stage declines."""

    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    env = _port_env(config)
    assert strict_checker(env) is None
    v = np.zeros((2, env.config_dim), np.float32)
    assert sf.strict_fallback_path(
        env, v, 2, _edge_list([(0, 1)], 2), np.zeros((2, 2), bool)) is None


def test_strict_free_on_known_free_configs():
    """Dataset starts and goals are free (reference kuka_env.py:85): the
    sound strict checker never flags them."""

    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    env = _port_env("kuka7")
    strict = strict_checker(env)
    assert strict_checker(env) is strict  # cached on the env
    for idx in range(2000, 2016):
        env.init_new_problem(idx)
        qs = np.stack([env.init_state, env.goal_state]).astype(np.float32)
        hits = strict(env.device_scene(), torch.as_tensor(qs))
        assert not hits.any(), f"strict hit on known-free config, problem {idx}"


def test_strict_detects_gross_contact():
    """A box swallowing the robot's base is a strict hit."""

    from gnn_motion_planning_tpu_torch.envs.kuka import make_box_scene
    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    env = _port_env("kuka7")
    scene = make_box_scene([((1.0, 1.0, 1.0), (0.0, 0.0, 0.5))], "cpu")
    q = torch.zeros(env.config_dim, dtype=torch.float32)
    assert bool(strict_checker(env)(scene, q))


@pytest.mark.parametrize("config", ["kuka7", "ur5", "kuka14"])
def test_validate_path_strict_counts_equal_jax(config):
    """Two seeded 4-waypoint paths of problem 2000 (their states at
    RRT_EPS, some of them strict hits)."""

    from gnn_motion_planning_tpu.envs.strict import strict_checker as jax_checker
    from gnn_motion_planning_tpu.envs.strict import validate_path_strict as jax_validate
    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker, validate_path_strict

    jenv, tenv = _jax_env(config), _port_env(config)
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    qs = uniform_states(tenv, 8, seed=5).astype(np.float64)
    counts = []
    for path in (qs[:4], qs[4:]):
        want = jax_validate(jenv, path, jax_checker(jenv))
        got = validate_path_strict(tenv, path, strict_checker(tenv))
        assert got == want
        counts.append(got)
    assert sum(counts) > 0
    assert validate_path_strict(tenv, qs[:1], strict_checker(tenv)) == 0


@pytest.fixture(scope="module")
def kuka14():
    from gnn_motion_planning_tpu_torch.api.registry import str2name

    env, model, _, model_s, _ = str2name("kuka14", device="cpu")
    return env, model, model_s


def test_readmitted_edges_hull_free(kuka14):
    """Every edge JAX's fallback re-admitted on 2170 (at the protocol and
    at the cut budget): the port's hull check passes it and counts one
    check a state, and its capsule ``_edge_fp`` decides as JAX's. The
    fallback hull-verifies every edge the failed search popped, free or
    not; the recovered paths rest on the capsule-blocked edge into the
    goal (238 -> 1 at the protocol, 3 -> 1 at the cut budget)."""

    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    env = kuka14[0]
    fx = json.loads(FIXTURE.read_text())
    rows = [fx["witness"]] + [r for r in fx["cut"] if r["index"] == WITNESS]
    env.init_new_problem(WITNESS)
    strict = strict_checker(env)
    blocked = []
    for r in rows:
        assert len(r["readmitted"]) == len(r["readmitted_states"]) >= 3
        for (i, j), (a, b), free in zip(r["readmitted"], r["readmitted_states"],
                                        r["readmitted_capsule_free"]):
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            assert env._edge_fp(a, b) == free
            c0 = env.collision_check_count
            assert sf._hull_verify_edge(env, strict, a, b)
            d = float(np.linalg.norm(b.astype(np.float64) - a))
            assert env.collision_check_count - c0 == max(int(d / env.RRT_EPS), 1) + 1
            if not free:
                blocked.append((i, j))
        assert tuple(r["idx_path"][-2:]) in blocked


def assert_witness_row(got: dict, want: dict):
    for key in ("success", "strict_certified", "checks", "c_explore", "c_smooth",
                "n_nodes", "idx_path", "hull_verified", "readmitted_capsule_free"):
        assert got[key] == want[key], key
    assert abs(got["cost"] - want["cost"]) < 1e-3
    assert abs(got["raw_cost"] - want["raw_cost"]) < 1e-3


def run_port(kuka14, index, protocol=None):
    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu_torch.config import problem_rng
    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker, validate_path_strict

    env, model, model_s = kuka14
    res, rec = witness_run(explore, problem_rng, env, model, model_s, sf, index, protocol)
    if res["success"]:
        # the certified path: finite, from start to goal, no strict hit
        path = np.asarray(res["path"])
        assert np.isfinite(path).all()
        np.testing.assert_array_equal(path[0], np.asarray(env.init_state, np.float32))
        np.testing.assert_array_equal(path[-1], np.asarray(env.goal_state, np.float32))
        assert validate_path_strict(env, res["path"], strict_checker(env)) == 0
    return witness_row(env, index, res, rec, path_cost), res


@pytest.mark.parametrize("index", [2170, 2118])
def test_fallback_at_cut_budget_equals_jax(kuka14, index):
    want = next(r for r in json.loads(FIXTURE.read_text())["cut"] if r["index"] == index)
    got, _ = run_port(kuka14, index, CUT)
    assert_witness_row(got, want)
    assert got["success"] == (index == WITNESS)


@pytest.mark.slow
def test_witness_2170_equals_jax(kuka14):
    """The whole 2170 run at the reference protocol: recovered and
    strict-certified, with JAX's checks (12,884), node path and cost."""

    want = json.loads(FIXTURE.read_text())["witness"]
    got, res = run_port(kuka14, WITNESS)
    assert_witness_row(got, want)
    assert res["success"] and res["strict_certified"]
