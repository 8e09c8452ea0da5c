"""The ur5, kuka14 and snake7 slice end to end: the port's ``eval_gnn`` and
``explore`` against the JAX rows (``tests/data/torch_port_<config>_jax_rows
.json``, written by ``tests/test_torch_port_eval.py::write_jax_rows`` at
each config's protocol: snake7 at t_max 2000), and the registry.

Rows must agree in success, ``c_explore`` and ``c_smooth`` exactly, and in
smoothed path cost within 1e-3.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_port_eval import PROTOCOL, SEED, fixture_path, protocol

NEW_CONFIGS = ["ur5", "kuka14", "snake7"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Pytest-xdist runs six test files at once on the CPU: two intra-op
    threads a file keep torch's workers from oversubscribing the cores."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _fixture(config):
    return {r["index"]: r for r in json.loads(fixture_path(config).read_text())["rows"]}


def _agree(got, ref):
    assert (got["success"], got["c_explore"], got["c_smooth"]) == (
        ref["success"], ref["c_explore"], ref["c_smooth"]), (got, ref)
    assert abs(got["cost"] - ref["cost"]) < 1e-3, (got, ref)


@pytest.mark.parametrize("config", ["ur5", "kuka14"])
def test_problem_2000_equals_jax_fixture(config):
    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    env, indexes = str2env(config, device="cpu")
    rows = []
    out = eval_gnn(config, SEED, env, indexes[:1], rows=rows, **protocol(config))
    assert out[0] == 1 and np.isfinite(np.asarray(out[6][0])).all()
    _agree(rows[0], _fixture(config)[2000])


def test_snake7_2004_resample_rounds_equal_jax_fixture():
    """snake7 problem 2004 at its override t_max 2000 fails its first round
    at 500 samples and succeeds in a later one: the round state (explored,
    prev, costs, edge_dead) is padded and carried as in JAX."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.config import problem_rng

    env, model, _, model_s, _ = str2name("snake7", device="cpu")
    env.rng = problem_rng(SEED, 2004)
    env.init_new_problem(2004)
    assert protocol("snake7")["t_max"] == 2000
    r = explore(env, model, model_s, True, **protocol("snake7"))
    n_free = len(r["v"]) // 2
    assert n_free - 2 > PROTOCOL["batch"], "solved in the first round"
    got = dict(success=r["success"], c_explore=r["c_explore"], c_smooth=r["c_smooth"],
               cost=path_cost(r["smooth_path"]))
    _agree(got, _fixture("snake7")[2004])


@pytest.mark.parametrize("config", NEW_CONFIGS)
def test_fixture_is_small_and_whole(config):
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    path = fixture_path(config)
    data = json.loads(path.read_text())
    _, indexes = str2env(config, device="cpu")
    assert [r["index"] for r in data["rows"]] == [int(i) for i in indexes[:5]]
    assert config in data["about"] and path.stat().st_size < 5000
    assert f"t_max {protocol(config)['t_max']}" in data["about"]


def test_registry_names_equal_jax():
    """Every name of the JAX registry's str2env resolves in the port, with
    the same test indexes and the same scalar overrides."""

    from gnn_motion_planning_tpu.api import registry as jax_registry
    from gnn_motion_planning_tpu_torch.api import registry

    names = ["maze2easy", "maze2hard", "maze3", "kuka7", "ur5", "snake7", "kuka14", "kuka13"]
    assert sorted(registry._CONFIGS) == sorted(names)
    for name in names:
        lo, hi = registry._CONFIGS[name][2]
        assert registry.scalar_overrides(name) == jax_registry.scalar_overrides(name)
        assert registry.EVAL_OVERRIDES.get(name) == jax_registry.EVAL_OVERRIDES.get(name)
        assert (lo, hi) == ((0, 1000) if name == "maze2hard" else (2000, 3000))
    with pytest.raises(KeyError):
        registry.str2env("kuka15", device="cpu")


def test_smoother_scale_and_snake_explorer_route():
    """ur5's smoother works at max(env.bound) = 2 pi as the JAX str2name
    sets it; snake7's explorer is the fine-tuned npz; a missing npz
    raises, naming its path."""

    from gnn_motion_planning_tpu.api.registry import str2name as jax_str2name
    from gnn_motion_planning_tpu_torch.api import registry

    env, _, _, smoother, _ = registry.str2name("ur5", device="cpu")
    jax_smoother = jax_str2name("ur5", load=False)[3]
    assert smoother.cfg.scale == jax_smoother.cfg.scale == pytest.approx(2 * np.pi)
    assert registry.smoother_scale("kuka14", env) == 1.0

    explorer, _ = registry.str2models("snake7", device="cpu")
    shipped = registry.read_checkpoint(registry._SPECS["snake7"]["explorer_ckpt"])
    state = explorer.state_dict()
    with np.load(registry.REPO / "assets" / "weights_jax" / "weights_snake_ft.npz") as f:
        keys = [k for k in f.files if k in state]
        assert len(keys) == len(state)
        for key in keys:
            np.testing.assert_array_equal(state[key].numpy(), f[key], err_msg=key)
    assert any(not np.array_equal(state[k].numpy(), shipped[k].numpy()) for k in keys)

    spec = dict(registry._SPECS["snake7"], explorer_ft="weights_snake_missing.npz")
    with pytest.raises(FileNotFoundError, match="weights_snake_missing.npz"):
        registry._load_explorer(spec)
