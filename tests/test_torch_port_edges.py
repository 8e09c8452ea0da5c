"""The batched edge oracle of the port's envs (``env._batch_edge_free``,
which the RGG audit calls) against the JAX package's, live on the CPU:
free and counts equal on 300 edges (two chunks of 256, the last one
padded) of problem 2000, for maze2easy (its host loop), kuka7 (entry B's
plain version), ur5, kuka14 and snake7 (entry A's), and the env's check
count untouched.
"""

import numpy as np
import pytest
import torch

from test_torch_port_strict import _jax_env, _port_env


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def seeded_edges(env, n: int = 300, seed: int = 3):
    """``n`` edges: two in three short steps from a uniform state (free and
    blocked ones both occur), one in three between two uniform states."""

    lo, hi = np.asarray(env.bound, float).reshape(2, -1)
    rs = np.random.RandomState(seed)
    a = rs.uniform(lo, hi, (n, env.config_dim))
    b = a + rs.normal(0, 0.1 * (hi - lo), a.shape)
    b[::3] = rs.uniform(lo, hi, (len(b[::3]), env.config_dim))
    return a, b


@pytest.mark.parametrize("config", ["maze2easy", "kuka7", "ur5", "kuka14", "snake7"])
def test_batch_edge_free_equals_jax(config):
    jenv, tenv = _jax_env(config), _port_env(config)
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    a, b = seeded_edges(tenv)
    want_free, want_cnt = jenv._batch_edge_free(a, b)
    tenv.collision_check_count = 11
    free, cnt = tenv._batch_edge_free(a, b)
    assert tenv.collision_check_count == 11
    np.testing.assert_array_equal(free, want_free)
    np.testing.assert_array_equal(cnt, want_cnt)
    assert 0 < free.sum() < len(free)
