"""The RGG audit in the port (``graphs/audit.py``) against the JAX
package's, on the CPU.

The three cases of ``tests/test_graph_audit.py``, on the port's module;
``protocol_rgg_connected`` on maze2easy 2000 and kuka7 2000 gives the JAX
package's dicts; and the strict audit's cross-tabulation
(``envs/strict.py::audit_counts``, ``tools/strict_verifier.py::audit``'s
loop) gives the JAX package's counts on 1,024 configurations of each arm
env (``tests/data/torch_port_strict_jax.json``, written by ``python
tests/test_torch_port_strict.py``). The batched edge oracle the RGG audit
calls is held in ``tests/test_torch_port_edges.py``.
"""

import json

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.graphs.audit import (
    checked_free_edges,
    component_from,
    protocol_rgg_connected,
    shortest_feasible_path,
)
from gnn_motion_planning_tpu_torch.graphs.knn import EdgeList
from test_torch_port_strict import AUDIT_SMALL, FIXTURE, RGG_CASES, STRICT_CONFIGS, _port_env


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_component_and_shortest_path():
    # 0-2-1 feasible, 0-1 direct blocked, node 3 isolated
    v = np.array([[0, 0], [1, 0], [0.5, 0.5], [9, 9]], np.float32)
    a = np.array([0, 0, 2])
    b = np.array([1, 2, 1])
    ok = np.array([False, True, True])
    comp = component_from(4, a, b, ok)
    assert comp[1] and comp[2] and not comp[3]
    assert shortest_feasible_path(v, 4, a, b, ok) == [0, 2, 1]
    # fully blocked -> disconnected
    ok0 = np.zeros(3, bool)
    assert not component_from(4, a, b, ok0)[1]
    assert shortest_feasible_path(v, 4, a, b, ok0) is None


@pytest.mark.parametrize("config,index", RGG_CASES)
def test_protocol_rgg_connected_equals_jax(config, index):
    """A solved problem's protocol RGG is connected, and the port's report
    is the JAX package's, key for key (it re-seeds the env itself)."""

    want = next(r for r in json.loads(FIXTURE.read_text())["rgg"]
                if (r["config"], r["index"]) == (config, index))
    env = _port_env(config)
    rep = protocol_rgg_connected(env, 1234, index)
    assert rep["connected"], rep
    assert rep["init_degree_free"] > 0 and rep["goal_degree_free"] > 0
    assert rep["edges_free"] <= rep["edges_checked"]
    assert rep == {k: v for k, v in want.items() if k not in ("config", "index")}


def test_checked_free_edges_uses_free_prefix_only():
    env = _port_env("maze2easy")
    env.init_new_problem(2000)
    v = np.array([[0.0, 0.0], [0.1, 0.0], [0.9, 0.9], [0.95, 0.9]], np.float32)
    edges = EdgeList(
        np.array([0, 2, 1], np.int32),
        np.array([1, 3, 0], np.int32),
        np.ones(3, bool),
    )
    a, b, ok = checked_free_edges(env, v, 2, edges)  # only nodes 0,1 free
    assert list(a) == [0] and list(b) == [1]


@pytest.mark.parametrize("config", STRICT_CONFIGS)
def test_audit_counts_equal_jax(config):
    from gnn_motion_planning_tpu_torch.envs.strict import audit_counts

    want = json.loads(FIXTURE.read_text())["audit_small"][config]
    got = audit_counts(_port_env(config), AUDIT_SMALL)
    assert got == want
    assert got["capsule_free"] + got["capsule_collide"] == got["n_configs"] == AUDIT_SMALL
