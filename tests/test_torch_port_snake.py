"""snake7's host protocol in the port (``envs/snake.py``: the problem dict,
``set_problem_data``, ``get_robot_points`` and ``set_random_init_goal``)
against the JAX package's ``SnakeEnv``, on problems 2000-2001; and, through
``tests/test_torch_port_baselines.py``'s checks, its edge and state checks
and the four baselines' rows on problem 2000 against
``tests/data/torch_port_baselines_snake7_jax_rows.json`` (RRT* and NEXT at
T = 1000 are slow; both are held at T = 20 by a test that is not, and
NEXT's recorded near-tie by its second witness, slow)."""

import numpy as np
import pytest
import torch

from test_torch_port_baselines import (
    METHODS,
    SLOW,
    check_cut_rows,
    check_fixture_rows,
    check_host_protocol,
    check_near_tie,
)
from test_torch_port_strict import _jax_env, _port_env

PROBLEMS = [2000, 2001]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def envs():
    return _jax_env("snake7"), _port_env("snake7")


def assert_problem_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want) == ["goal_state", "init_state", "map"]
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))


@pytest.mark.parametrize("index", PROBLEMS)
def test_init_new_problem_returns_jax_problem(envs, index):
    jenv, tenv = envs
    for env in envs:
        env.collision_check_count = 5
        env.collision_point = np.ones(7)
    want, got = jenv.init_new_problem(index), tenv.init_new_problem(index)
    assert_problem_equal(got, want)
    assert_problem_equal(tenv.get_problem(), jenv.get_problem())
    assert tenv.collision_check_count == jenv.collision_check_count == 0
    assert tenv.collision_point is None and jenv.collision_point is None
    np.testing.assert_array_equal(tenv.obstacles, jenv.obstacles)
    assert tenv.episode_i == jenv.episode_i


def test_set_problem_data_equals_jax(envs):
    jenv, tenv = envs
    pb = jenv.init_new_problem(2001)
    occ = np.asarray(pb["map"]).copy()
    occ[0, 0] = 1 - occ[0, 0]
    for env in envs:
        env.set_problem_data(occ, pb["goal_state"], pb["init_state"])
    assert_problem_equal(tenv.get_problem(), jenv.get_problem())
    np.testing.assert_array_equal(tenv.obstacles, jenv.obstacles)
    # the new map is the one checked: a state free in one map and the other
    q = np.asarray(pb["init_state"], np.float64)
    assert tenv._state_fp(q) == jenv._state_fp(q)


def test_get_robot_points_equals_jax(envs):
    jenv, tenv = envs
    qs = np.random.RandomState(1).uniform(-3, 3, (16, 7))
    for q in list(qs) + [list(qs[0])]:
        want, got = jenv.get_robot_points(q), tenv.get_robot_points(q)
        assert type(got) is type(want)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(tenv.robot_points(qs), qs[:, :2])


@pytest.mark.parametrize("index", PROBLEMS)
def test_set_random_init_goal_equals_jax(envs, index):
    """Two free samples from the problem's stream, as JAX's draws them."""

    from gnn_motion_planning_tpu.config import problem_rng as jax_rng
    from gnn_motion_planning_tpu_torch.config import problem_rng

    jenv, tenv = envs
    jenv.init_new_problem(index)
    tenv.init_new_problem(index)
    jenv.rng, tenv.rng = jax_rng(1234, index), problem_rng(1234, index)
    for env in envs:
        env._accept_rate = None
        env.set_random_init_goal()
    np.testing.assert_array_equal(tenv.init_state, jenv.init_state)
    np.testing.assert_array_equal(tenv.goal_state, jenv.goal_state)
    assert tenv.collision_check_count == jenv.collision_check_count
    assert tenv.rng.uniform(0, 1) == jenv.rng.uniform(0, 1)


@pytest.mark.parametrize("method", [
    pytest.param(m, marks=[pytest.mark.slow] if ("snake7", m) in SLOW else []) for m in METHODS])
def test_baseline_rows_equal_jax_fixture(method):
    check_fixture_rows("snake7", method)


def test_baseline_rows_at_cut_budget_equal_jax_fixture():
    check_cut_rows("snake7")


@pytest.mark.slow
def test_next_near_tie_is_the_model_forward():
    check_near_tie("snake7", 2000)


def test_env_host_protocol_equals_jax():
    check_host_protocol("snake7")
