"""The last modules of the port against the JAX package: ``graphs/rgg.py``,
``training/smoother.py::init_smoother_params``, the scratch trainer
(``tools/torch_port_train_scratch.py``), ``utils/debug.py``, the small
surfaces (``config.py``'s dataclasses, ``kinematics.end_effector``,
``geometry.point_box_sq_dist``, ``convert.load_torch_checkpoint`` and
``load_params``, ``eval_baselines.path_cost``, ``MazeEnv.obs_map`` and
``free_map``, ``KukaEnv.set_problem_data``) and ``utils/plot.py`` with the
envs' ``plot`` (tests/test_env_plot.py's cases).

Tolerances: graphs, attributes, paths, maps and shapes exactly; FK and
distances within 1e-6 (float32, another summation order); the scratch
trainer's losses as tests/test_torch_port_training.py holds a loop (the
first within 1e-5 relative, later ones 1e-3) against
``tests/data/torch_port_scratch_jax.json`` (regenerate with ``PYTHONPATH=.
python tests/test_torch_port_rest.py``); plot frames of equal shape with
at most 1 % of the pixels different.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_strict import _jax_env, _port_env

REPO = Path(__file__).resolve().parents[1]
SCRATCH_FIXTURE = REPO / "tests" / "data" / "torch_port_scratch_jax.json"
# the explorer from a fresh init on the committed maze2 slice: 2 steps
SCRATCH = dict(config="maze2easy", epoch=6, iters=5, data="tests/data/torch_port_prm_maze2_6.pkl")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# graphs/rgg.py
# ---------------------------------------------------------------------------


def test_rgg_equals_jax():
    from gnn_motion_planning_tpu.graphs import rgg as jrgg
    from gnn_motion_planning_tpu_torch.graphs import rgg

    for n, dim in ((100, 2), (500, 3), (200, 7)):
        assert rgg.radius(n, dim) == jrgg.radius(n, dim)
    assert rgg.EdgeAttribute.Free == jrgg.EdgeAttribute.Free == 1
    out = []
    for mod, env in ((jrgg, _jax_env("maze2easy")), (rgg, _port_env("maze2easy"))):
        env.init_new_problem(2000)
        env.rng = None
        np.random.seed(4)
        g = mod.Graph(env).initialize(80)
        problem = g.random_problem(np.random.RandomState(9))
        out.append((g.V, g.E, g.E_attr, problem, env.collision_check_count))
    want, got = out
    assert got[0] == want[0] and got[1] == want[1] and got[2] == want[2]
    assert got[3] == want[3] and got[3] is not None
    assert got[4] == want[4]
    assert sum(a == rgg.EdgeAttribute.Free for a in got[2].values()) > 0


# ---------------------------------------------------------------------------
# the smoother's fresh init and the scratch trainer
# ---------------------------------------------------------------------------


def test_init_smoother_params_shapes_equal_jax():
    import jax

    from gnn_motion_planning_tpu.models.smoother import SmootherConfig as JaxCfg
    from gnn_motion_planning_tpu.training.smoother import init_smoother_params as jax_init
    from gnn_motion_planning_tpu_torch.models.convert import flatten, to_flat
    from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig
    from gnn_motion_planning_tpu_torch.training.smoother import init_smoother_params

    cfg = (7, 7, 6, 128)
    want = flatten(jax.tree.map(np.asarray, jax_init(jax.random.PRNGKey(0), JaxCfg(*cfg))))
    model = init_smoother_params(Smoother(SmootherConfig(*cfg)), 1234)
    got = to_flat(model)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    again = to_flat(init_smoother_params(Smoother(SmootherConfig(*cfg)), 1234))
    assert all(np.array_equal(got[k], again[k]) for k in got)


def _load_tool():
    sys.path.insert(0, str(REPO / "tools"))
    import torch_port_train_scratch

    return torch_port_train_scratch


def test_scratch_trainer_equals_jax_and_reads_back(tmp_path):
    from gnn_motion_planning_tpu_torch.api.registry import str2models
    from gnn_motion_planning_tpu_torch.models.convert import load_npz, to_flat
    from test_torch_port_training import check_loop

    tool = _load_tool()
    out, model, losses = tool.train_explorer_scratch(
        SCRATCH["config"], SCRATCH["epoch"], SCRATCH["iters"], data_path=REPO / SCRATCH["data"],
        out_dir=tmp_path, device="cpu")
    assert out == tmp_path / tool.SCRATCH_NAMES[("explorer", "maze2easy")]
    fixture = json.loads(SCRATCH_FIXTURE.read_text())
    assert fixture["settings"] == SCRATCH
    check_loop("scratch explorer", losses, None, fixture["run"])
    summary = json.loads((tmp_path / "train_logs" / "maze2easy_explorer_scratch" /
                          "summary.json").read_text())
    assert summary["steps"] == len(losses) == 2
    # the checkpoint reads back into a fresh model: the trained floats
    trained = to_flat(model)
    reloaded = to_flat(load_npz(str2models("maze2easy", "cpu", load=False)[0], out))
    assert sorted(reloaded) == sorted(trained)
    assert all(np.array_equal(reloaded[k], trained[k]) for k in reloaded)


def jax_scratch_run() -> dict:
    """JAX's ``train_explorer`` at the tool's settings, from the port's
    fresh init (the same initial weights on both sides)."""

    import tempfile

    from gnn_motion_planning_tpu.api.registry import str2name as jax_str2name
    from gnn_motion_planning_tpu.training.explorer import train_explorer
    from gnn_motion_planning_tpu_torch.api.registry import str2models
    from gnn_motion_planning_tpu_torch.models.convert import nest, to_flat

    env, model, _, _, _ = jax_str2name(SCRATCH["config"])
    fresh = to_flat(str2models(SCRATCH["config"], "cpu", load=False)[0])
    model = model._replace(params=nest(fresh))
    with tempfile.TemporaryDirectory() as tmp:
        _, losses = train_explorer(epoch=SCRATCH["epoch"], data_path=str(REPO / SCRATCH["data"]),
                                   model=model, model_path=str(Path(tmp) / "e.npz"), env=env,
                                   iter=SCRATCH["iters"])
    return dict(losses=[float(x) for x in losses], steps=len(losses), replay=None)


# ---------------------------------------------------------------------------
# utils/debug.py (tests/test_debug_utils.py's cases)
# ---------------------------------------------------------------------------


def test_debug_utils(tmp_path):
    from gnn_motion_planning_tpu_torch.envs.maze import edge_free_2d
    from gnn_motion_planning_tpu_torch.utils.debug import (
        assert_finite,
        jit_eager_consistent,
        profile_trace,
    )

    env = _port_env("maze2easy")
    env.init_new_problem(2000)
    occ = env.device_scene()
    a = torch.tensor([[-0.8, -0.8], [0.1, 0.2]])
    b = torch.tensor([[0.7, 0.6], [0.15, 0.9]])
    assert jit_eager_consistent(edge_free_2d, occ, a, b)
    with pytest.raises(FloatingPointError):
        assert_finite({"x": torch.tensor([1.0, float("nan")])})
    with pytest.raises(FloatingPointError):
        assert_finite([np.array([np.inf])], "arr")
    tree = {"x": torch.tensor([1.0, 2.0]), "n": torch.tensor([1, 2])}
    assert assert_finite(tree) is tree
    with profile_trace(str(tmp_path / "trace")) as d:
        edge_free_2d(occ, a, b)
    trace = Path(d) / "trace.json"
    assert trace.exists() and "edge_free" in trace.read_text() or trace.stat().st_size > 0


# ---------------------------------------------------------------------------
# the small surfaces
# ---------------------------------------------------------------------------


def test_config_dataclasses_equal_jax():
    from gnn_motion_planning_tpu import config as jconfig
    from gnn_motion_planning_tpu_torch import config

    for name in ("train_config", "nn_config", "planner_config"):
        assert dataclasses.asdict(getattr(config, name)) == dataclasses.asdict(
            getattr(jconfig, name))
    for cls in ("TrainConfig", "NNConfig", "PlannerConfig"):
        assert dataclasses.asdict(getattr(config, cls)()) == dataclasses.asdict(
            getattr(jconfig, cls)())


def test_end_effector_and_point_box_equal_jax():
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.envs.geometry import point_box_sq_dist as jax_pbox
    from gnn_motion_planning_tpu.envs.kinematics import end_effector as jax_ee
    from gnn_motion_planning_tpu_torch.envs.geometry import point_box_sq_dist
    from gnn_motion_planning_tpu_torch.envs.kinematics import end_effector

    jenv, tenv = _jax_env("kuka7"), _port_env("kuka7")
    qs = np.random.RandomState(2).uniform(-2, 2, (16, 7)).astype(np.float32)
    for link in (-1, 3):
        want = np.asarray(jax.vmap(lambda q: jax_ee(jenv.chain, q, link))(jnp.asarray(qs)))
        got = end_effector(tenv.chain, torch.as_tensor(qs), link).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    p = np.random.RandomState(3).uniform(-2, 2, (64, 3)).astype(np.float32)
    c, h = np.float32([0.1, -0.2, 0.3]), np.float32([0.5, 0.4, 0.3])
    want = np.asarray(jax_pbox(jnp.asarray(p), jnp.asarray(c), jnp.asarray(h)))
    got = point_box_sq_dist(*(torch.as_tensor(x) for x in (p, c, h))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert (got == 0).any() and (got > 0).any()


def test_checkpoint_readers_equal_jax():
    from gnn_motion_planning_tpu.models.convert import load_torch_checkpoint as jax_load
    from gnn_motion_planning_tpu_torch.models.convert import (
        flatten,
        load_params,
        load_torch_checkpoint,
    )
    from gnn_motion_planning_tpu_torch.utils.assets import asset_path

    rel = "data/weights/weights_maze.pt"
    want = flatten(jax_load(asset_path(rel)))
    for got in (flatten(load_torch_checkpoint(asset_path(rel))), flatten(load_params(rel))):
        assert sorted(got) == sorted(want)
        assert all(np.array_equal(got[k], want[k]) and got[k].dtype == np.float32 for k in want)


def test_path_cost_and_maze_maps_equal_jax():
    from gnn_motion_planning_tpu.api.eval_baselines import path_cost as jax_cost
    from gnn_motion_planning_tpu_torch.api.eval_baselines import path_cost

    path = np.random.RandomState(1).normal(size=(7, 3))
    assert path_cost(path) == jax_cost(path) and path_cost(path[:1]) == jax_cost(path[:1]) == 0.0
    jenv, tenv = _jax_env("maze2easy"), _port_env("maze2easy")
    for env in (jenv, tenv):
        env.init_new_problem(2001)
    for res in (jenv.voxel_r, 0.05):
        for g, w in zip(tenv.obs_map(res), jenv.obs_map(res)):
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(np.asarray(tenv.free_map()), np.asarray(jenv.free_map()))


def test_kuka_set_problem_data_equals_jax():
    jenv, tenv = _jax_env("kuka7"), _port_env("kuka7")
    obstacles, start, goal, path = tenv.problems[2001]
    for env in (jenv, tenv):
        env.set_problem_data(obstacles, goal, start, path)
    assert tenv.index == jenv.index == -1
    for q in (np.asarray(start), np.asarray(goal), np.zeros(7)):
        assert tenv._state_fp(q) == jenv._state_fp(q)
    assert tenv._edge_fp(np.asarray(start), np.asarray(goal)) == jenv._edge_fp(
        np.asarray(start), np.asarray(goal))
    assert tenv.collision_check_count == jenv.collision_check_count


# ---------------------------------------------------------------------------
# utils/plot.py and the envs' plot (tests/test_env_plot.py's cases)
# ---------------------------------------------------------------------------


def test_importing_plot_loads_no_matplotlib():
    code = ("import sys; import gnn_motion_planning_tpu_torch.utils.plot; "
            "assert 'matplotlib' not in sys.modules and 'PIL' not in sys.modules")
    import subprocess

    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("name", [
    "maze2easy", "kuka7",
    pytest.param("maze3", marks=pytest.mark.slow),
    pytest.param("kuka14", marks=pytest.mark.slow),
    pytest.param("ur5", marks=pytest.mark.slow),
    pytest.param("snake7", marks=pytest.mark.slow),
])
def test_plot_frames_equal_jax(name, tmp_path):
    frames = []
    for env in (_jax_env(name), _port_env(name)):
        env.init_new_problem(2000)
        path = [np.asarray(env.init_state, float), np.asarray(env.goal_state, float)]
        args = (env.map, path) if name == "snake7" else (path,)
        frames.append(env.plot(*args, make_gif=True))
    want, got = frames
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and g.ndim == 3 and g.shape[-1] == 4
        assert (g != w).any(-1).mean() <= 0.01
    out = tmp_path / f"{name}.png"
    env = _port_env(name)
    env.init_new_problem(2000)
    path = [np.asarray(env.init_state, float), np.asarray(env.goal_state, float)]
    args = (env.map, path) if name == "snake7" else (path,)
    assert env.plot(*args, make_gif=False, save_path=str(out)) == []
    assert out.exists() and out.stat().st_size > 0


def test_merge_pic_and_plot_edges(tmp_path):
    from gnn_motion_planning_tpu_torch.utils.plot import merge_pic, plot_edges

    env = _port_env("maze2easy")
    problem = env.init_new_problem(2000)
    edges = [(env.init_state, env.goal_state)]
    figs = [plot_edges([env.init_state], edges, problem) for _ in range(3)]
    out = merge_pic(figs, 2, save_path=str(tmp_path / "m.png"))
    assert Path(out).stat().st_size > 0
    assert plot_edges(None, {}, problem, save_path=str(tmp_path / "e.png")) == str(
        tmp_path / "e.png")


if __name__ == "__main__":
    import os

    sys.path.insert(0, str(REPO))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    SCRATCH_FIXTURE.write_text(json.dumps({
        "about": "gnn_motion_planning_tpu.training.explorer.train_explorer at the settings, "
                 "from the port's fresh init, JAX on the CPU; written by "
                 "tests/test_torch_port_rest.py",
        "settings": SCRATCH, "run": jax_scratch_run()}, indent=1) + "\n")
