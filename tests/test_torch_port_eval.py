"""The whole slice: the port's ``eval_gnn`` on kuka7 against the JAX
package's, problem by problem, and the JAX rows that ``chip_smoke.py``
prints beside its own.

``jax_rows`` and ``write_jax_rows`` serve every config's fixture
(``tests/data/torch_port_<config>_jax_rows.json``). Regenerate one with
``python tests/test_torch_port_eval.py <config>`` (kuka7 by default).
"""

import json
import sys
from pathlib import Path

import pytest

SEED = 1234
PROTOCOL = dict(batch=500, t_max=500, k=30)


def fixture_path(config: str) -> Path:
    return Path(__file__).resolve().parent / "data" / f"torch_port_{config}_jax_rows.json"


FIXTURE = fixture_path("kuka7")


def protocol(config: str) -> dict:
    """The reference protocol with the config's own overrides (snake7:
    t_max 2000, JAX api/registry.py::scalar_overrides)."""

    from gnn_motion_planning_tpu_torch.api.registry import scalar_overrides

    return {**PROTOCOL, **scalar_overrides(config)}


def jax_rows(indexes, config: str = "kuka7"):
    """Per-problem (success, c_explore, c_smooth, cost) from the JAX
    package, with per-problem streams, at ``protocol(config)`` and with
    ur5's smoother at its scale (JAX api/registry.py:306)."""

    import numpy as np

    from gnn_motion_planning_tpu.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu.api.registry import str2env, str2models
    from gnn_motion_planning_tpu.config import problem_rng

    env, _ = str2env(config)
    scale = float(np.max(env.bound)) if config == "ur5" else 1.0
    model, model_s = str2models(config, scale=scale)
    rows = []
    for index in indexes:
        env.rng = problem_rng(SEED, int(index))
        env.init_new_problem(int(index))
        r = explore(env, model, model_s, True, **protocol(config))
        rows.append(dict(
            index=int(index), success=bool(r["success"]), c_explore=int(r["c_explore"]),
            c_smooth=int(r["c_smooth"]), cost=path_cost(r["smooth_path"]),
        ))
    return rows


def write_jax_rows(config: str = "kuka7", n: int = 5):
    """The first ``n`` test problems of ``config`` (its str2env indexes)."""

    from gnn_motion_planning_tpu_torch.api.registry import str2env

    indexes = [int(i) for i in str2env(config, device="cpu")[1][:n]]
    path = fixture_path(config)
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({
        "about": f"gnn_motion_planning_tpu.api.eval_gnn.explore on {config}, seed 1234, "
                 f"batch 500, k 30, t_max {protocol(config)['t_max']} (the config's "
                 "scalar_overrides applied), JAX on the CPU; written by "
                 "tests/test_torch_port_eval.py::write_jax_rows",
        "rows": jax_rows(indexes, config),
    }, indent=1) + "\n")


@pytest.fixture(scope="module")
def port_rows():
    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    env, indexes = str2env("kuka7", device="cpu")
    rows = []
    out = eval_gnn("kuka7", SEED, env, indexes[:2], rows=rows, **PROTOCOL)
    assert out[0] == sum(r["success"] for r in rows)
    return rows


def test_eval_gnn_equals_jax(port_rows):
    want = jax_rows([r["index"] for r in port_rows])
    for got, ref in zip(port_rows, want):
        for key in ("index", "success", "c_explore", "c_smooth"):
            assert got[key] == ref[key], (key, got, ref)
        assert abs(got["cost"] - ref["cost"]) < 1e-3, (got, ref)
    assert all(r["success"] for r in port_rows)


def test_fixture_rows_are_the_jax_rows(port_rows):
    """The fixture's head is what the JAX package gives now (and what the
    port gives on the CPU)."""

    fixture = {r["index"]: r for r in json.loads(FIXTURE.read_text())["rows"]}
    assert sorted(fixture) == [2000, 2001, 2002, 2003, 2004]
    assert FIXTURE.stat().st_size < 5000
    for got in port_rows:
        ref = fixture[got["index"]]
        assert (got["success"], got["c_explore"], got["c_smooth"]) == (
            ref["success"], ref["c_explore"], ref["c_smooth"])
        assert abs(got["cost"] - ref["cost"]) < 1e-3


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    write_jax_rows(*sys.argv[1:2])
