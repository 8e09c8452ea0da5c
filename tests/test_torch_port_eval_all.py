"""The port's grand sweep (``api/eval_all.py``) against the JAX package's
on Maze_2D_Easy, one problem, all five methods: the same table, the same
result keys, and per method the same success and collision checks, path
cost within 1e-6 (1e-3 for the GNN method, whose smoother runs a model
forward: the tolerance of tests/test_torch_port_eval.py); the result
pickles and reads back.

``write`` records the JAX package's rows of the sweep that
``chip_smoke.py`` phase 8 runs on the card (Maze_2D_Easy and Kuka_7D, one
problem, five methods) in ``tests/data/torch_port_eval_all_jax_rows.json``:
``python tests/test_torch_port_eval_all.py``.
"""

import contextlib
import io
import json
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

METHODS = ["GNN", "NEXT", "BIT*", "RRT*", "LazySP"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_env_table_equals_jax():
    from gnn_motion_planning_tpu.api.eval_all import METHODS as JAX_METHODS
    from gnn_motion_planning_tpu.api.eval_all import default_env_table as jax_table
    from gnn_motion_planning_tpu_torch.api.eval_all import METHODS as PORT_METHODS
    from gnn_motion_planning_tpu_torch.api.eval_all import default_env_table

    assert list(PORT_METHODS) == list(JAX_METHODS) == METHODS
    ours, theirs = default_env_table("cpu"), jax_table()
    assert [r[0] for r in ours] == [r[0] for r in theirs]
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a[2], b[2])


def test_eval_all_maze2easy_equals_jax(tmp_path):
    from gnn_motion_planning_tpu.api.eval_all import eval_all as jax_eval_all
    from gnn_motion_planning_tpu_torch.api.eval_all import eval_all

    kw = dict(env_names=["Maze_2D_Easy"], method_names=METHODS, n_problems=1)
    with contextlib.redirect_stdout(io.StringIO()), contextlib.redirect_stderr(io.StringIO()):
        want = jax_eval_all(out_path=str(tmp_path / "jax.p"), **kw)
        got = eval_all(out_path=str(tmp_path / "port.p"), device="cpu", **kw)
    assert list(got) == list(want)
    assert len(got) == 2 * len(METHODS)
    for key in want:
        if key[2] == "Avg":
            continue
        g, w = got[key], want[key]
        assert (g[0], g[1]) == (w[0], w[1]), key
        tol = 1e-3 if key[1] == "GNN" else 1e-6
        assert abs(g[3] - w[3]) < tol or (np.isnan(g[3]) and np.isnan(w[3])), key
    with open(tmp_path / "port.p", "rb") as f:
        back = pickle.load(f)
    assert list(back) == list(got)
    for key in got:
        assert back[key][:2] == got[key][:2]


FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_eval_all_jax_rows.json"
CHIP_ENVS = ["Maze_2D_Easy", "Kuka_7D"]


def rows_of(result: dict) -> list:
    """[env, method, success, checks, cost] of each (env, method, seed)
    entry of an ``eval_all`` result (cost None where nothing was solved)."""

    return [[env, method, int(r[0]), float(r[1]), None if np.isnan(r[3]) else float(r[3])]
            for (env, method, seed), r in result.items() if seed != "Avg"]


def write():
    from gnn_motion_planning_tpu.api.eval_all import eval_all as jax_eval_all

    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        result = jax_eval_all(env_names=CHIP_ENVS, method_names=METHODS, n_problems=1,
                              out_path=f"{tmp}/result.p")
    FIXTURE.write_text(json.dumps({
        "about": "JAX eval_all(env_names=%s, all five methods, n_problems=1), seed 1234; "
                 "tests/test_torch_port_eval_all.py" % CHIP_ENVS,
        "rows": rows_of(result),
    }, indent=1) + "\n")


def test_fixture_rows_cover_the_chip_sweep():
    rows = json.loads(FIXTURE.read_text())["rows"]
    assert [(r[0], r[1]) for r in rows] == [(e, m) for e in CHIP_ENVS for m in METHODS]


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
