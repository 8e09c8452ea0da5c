"""The maze and kuka13 slice end to end: the port's ``eval_gnn`` and
``explore`` on maze2easy, maze2hard, maze3 and kuka13 against the JAX
package, problem by problem, and the registry's routes.

Rows must agree in success, ``c_explore`` and ``c_smooth`` exactly, and in
smoothed path cost within 1e-3. Per-problem streams (``config.problem_rng``)
are held live against JAX ``explore`` on maze2easy and against the
committed JAX rows (``tests/data/torch_port_<config>_jax_rows.json``,
written by ``tests/test_torch_port_eval.py::write_jax_rows``) on the rest;
the global stream (``env.rng = None``, ``tools/ref_headtohead.py::run_ours``)
against the head-to-head files' ``ours_rows``, which equal the upstream
planner's.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_eval import PROTOCOL, SEED, fixture_path, jax_rows

REPO = Path(__file__).resolve().parents[1]


def _agree(got, ref, cost_key="cost"):
    assert (got["success"], got["c_explore"], got["c_smooth"]) == (
        ref["success"], ref["c_explore"], ref["c_smooth"]), (got, ref)
    assert abs(got["cost"] - ref[cost_key]) < 1e-3, (got, ref)


def _port_rows(config, indexes):
    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    env, _ = str2env(config, device="cpu")
    rows = []
    out = eval_gnn(config, SEED, env, indexes, rows=rows, **PROTOCOL)
    assert out[0] == sum(r["success"] for r in rows)
    assert all(np.isfinite(p).all() for p in out[6] if len(p))
    return rows


def test_maze2easy_rows_equal_jax_live():
    rows = _port_rows("maze2easy", [2000, 2001])
    for got, ref in zip(rows, jax_rows([2000, 2001], "maze2easy")):
        assert got["index"] == ref["index"]
        _agree(got, ref)
    assert all(r["success"] for r in rows)


@pytest.mark.parametrize("config, index", [("maze2hard", 0), ("maze3", 2000), ("kuka13", 2000)])
def test_rows_equal_jax_fixture(config, index):
    fixture = {r["index"]: r for r in json.loads(fixture_path(config).read_text())["rows"]}
    (got,) = _port_rows(config, [index])
    _agree(got, fixture[index])
    assert got["success"]


@pytest.mark.parametrize("config", ["maze2easy", "maze2hard", "maze3", "kuka13"])
def test_fixture_is_small_and_whole(config):
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    path = fixture_path(config)
    data = json.loads(path.read_text())
    _, indexes = str2env(config, device="cpu")
    assert [r["index"] for r in data["rows"]] == [int(i) for i in indexes[:5]]
    assert config in data["about"] and path.stat().st_size < 5000


def _global_stream_rows_equal_headtohead(config, n):
    """run_ours's protocol: one np.random stream seeded once, the problems
    in order, ``env.rng = None`` (the reference's maze_env.py:85-100)."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.config import set_random_seed

    env, model, _, model_s, _ = str2name(config, device="cpu")
    want = json.loads((REPO / f"assets/benchmarks/headtohead_{config}.json").read_text())["ours_rows"]
    indexes = [r["index"] for r in want[:n]]
    set_random_seed(SEED)
    for index, ref in zip(indexes, want):
        assert ref["index"] == index
        env.rng = None
        env.init_new_problem(index)
        r = explore(env, model, model_s, True, loop=5, **PROTOCOL)
        got = dict(success=r["success"], c_explore=r["c_explore"], c_smooth=r["c_smooth"],
                   cost=path_cost(r["smooth_path"]))
        _agree(got, ref, cost_key="cost_smooth")
        assert abs(path_cost(r["path"]) - ref["cost_raw"]) < 1e-3


@pytest.mark.parametrize("config, n", [("maze2easy", 2), ("maze2hard", 1)])
def test_global_stream_rows_equal_headtohead(config, n):
    _global_stream_rows_equal_headtohead(config, n)


@pytest.mark.slow
@pytest.mark.parametrize("config", ["maze2easy", "maze2hard"])
def test_global_stream_all_headtohead_rows(config):
    """All 250 rows of each head-to-head file (about 10-15 minutes each on
    a CPU, hence slow)."""

    _global_stream_rows_equal_headtohead(config, 250)


def test_str2env_matches_jax():
    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    for name, dim in (("maze2easy", 2), ("maze2hard", 2), ("maze3", 3), ("kuka13", 13)):
        env, indexes = str2env(name, device="cpu")
        jenv, jindexes = jax_str2env(name)
        np.testing.assert_array_equal(indexes, jindexes)
        assert env.config_dim == jenv.config_dim == dim and str(env) == str(jenv)
        env.init_new_problem(int(indexes[3]))
        jenv.init_new_problem(int(indexes[3]))
        np.testing.assert_array_equal(env.init_state, jenv.init_state)
        np.testing.assert_array_equal(env.goal_state, jenv.goal_state)
        assert env.device == torch.device("cpu")


@pytest.mark.parametrize("name", ["maze4", "kuka15", "snake5", "ur10"])
def test_unported_names_raise(name):
    """Every name of the JAX registry is ported; any other name raises."""

    from gnn_motion_planning_tpu_torch.api import registry

    for fn in (registry.str2env, registry.str2models, registry.str2name):
        with pytest.raises(KeyError):
            fn(name, device="cpu")


def test_missing_maze3_smoother_raises_with_its_path(monkeypatch):
    """maze3's shipped smoother is the legacy architecture; its
    scratch-trained twin is ``weights_jax/smooth_3d_scratch.npz``. Named
    for the error the port raised before the oracle smoother was ported:
    without the twin there is now no smoother (None), and ``explore``
    smooths with the oracle smoother, as the JAX package does
    (api/registry.py:230-253)."""

    from gnn_motion_planning_tpu_torch.api import registry

    assert registry._scratch_npz("data/weights/smooth_3d_attv3.pt") == "weights_jax/smooth_3d_scratch.npz"
    monkeypatch.setattr(registry, "_scratch_npz", lambda ckpt: "weights_jax/absent_scratch.npz")
    assert registry.str2models("maze3", device="cpu")[1] is None
    # a checkpoint of the current architecture
    assert registry.str2models("maze2easy", device="cpu")[1] is not None


def test_planner_picks_the_core_by_bounds():
    from gnn_motion_planning_tpu_torch.api.eval_gnn import get_planner
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    maze_planner = get_planner(str2env("maze2easy", device="cpu")[0])
    arm_planner = get_planner(str2env("kuka13", device="cpu")[0])
    assert maze_planner.project_cheap is maze_planner.project_full
    assert "make_projection_core_flat" in arm_planner.project_cheap.__qualname__


@pytest.mark.parametrize("amplitude", [0.05, 0.15])
def test_maze_projection_equals_jax(amplitude):
    """The mazes' projection core (the full sweep) gives the path, count and
    overflow flag of the core the JAX package builds for them
    (api/planner_bundle.py:94-108: ``cheap=True`` without an
    ``edge_free_cheap``)."""

    import jax.numpy as jnp

    from gnn_motion_planning_tpu.envs import maze as jax_maze
    from gnn_motion_planning_tpu.planners.gnn_smooth import make_projection_core as jax_core
    from gnn_motion_planning_tpu_torch.envs import maze
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import make_projection_core

    env = maze.MazeEnv(dim=2, device="cpu")
    env.init_new_problem(2003)
    jenv = jax_maze.MazeEnv(dim=2)
    jenv.init_new_problem(2003)
    L, n = 64, 12
    rng = np.random.RandomState(0)
    old = np.repeat(np.asarray(env.goal_state, np.float32)[None], L, axis=0)
    old[:n] = np.linspace(env.init_state, env.goal_state, n).astype(np.float32)
    new = old.copy()
    new[1 : n - 1] += rng.uniform(-amplitude, amplitude, (n - 2, 2)).astype(np.float32)
    path, count, overflow = make_projection_core(maze.maze_kernels(2), maze.RRT_EPS)(
        env.device_scene(), torch.as_tensor(old), torch.as_tensor(new), n)
    jpath, jcount, joverflow = jax_core(jax_maze.maze_kernels(2), jax_maze.RRT_EPS, cheap=True)(
        jenv.device_scene(), jnp.asarray(old), jnp.asarray(new), n)
    assert (count, overflow) == (int(jcount), bool(joverflow)) and count > n
    np.testing.assert_allclose(path.numpy(), np.asarray(jpath), rtol=0, atol=1e-6)
