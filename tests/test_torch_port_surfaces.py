"""The package surfaces of the port against the JAX package's, on the CPU:
``api.__all__``, ``envs.strs`` and the lazy env map,
``registry.eval_overrides``, ``eval_gnn_pure``, ``_load_smoother``'s None
where maze3's twin is missing, and ``parallel/sharded_eval.py``
(``shard_indexes``, ``resumable_eval`` resumed after its first chunk).

The JAX rows of ``eval_gnn_pure`` and JAX's ``resumable_eval`` summary on
maze2easy 2000-2001 are a fixture (``tests/data/torch_port_surfaces_jax.
json``); rewrite it with ``python tests/test_torch_port_surfaces.py``.
"""

import contextlib
import io
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "torch_port_surfaces_jax.json"
SEED = 1234
PROBLEMS = [2000, 2001]
CONFIGS = ["maze2easy", "maze2hard", "maze3", "kuka7", "kuka13", "ur5", "snake7", "kuka14"]
# resumable_eval's summary keys that are not wall time
SUMMARY_KEYS = ("n_problems", "success", "collision", "path_cost")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pure_row(eval_gnn_pure, env, model, model_s, index: int) -> dict:
    """One problem through ``eval_gnn_pure`` (its metric block silenced)."""

    with contextlib.redirect_stdout(io.StringIO()):
        r = eval_gnn_pure("maze2easy", SEED, env, [index], model, model_s)
    return dict(index=index, success=int(r[0]), collision=float(r[1]),
                collision_explore=float(r[7]), cost=float(r[3]))


def resumed_summary(resumable_eval, eval_gnn, env, tmp: Path, models) -> tuple:
    """``resumable_eval`` over maze2easy 2000 alone, then over 2000-2001,
    one problem a chunk: the second call resumes past the first chunk.
    Returns (summary, the problems the second call evaluated)."""

    out = tmp / "sweep.p"
    calls = []

    def method(name, seed, env_, part, **kw):
        calls.append([int(i) for i in part])
        return eval_gnn(name, seed, env_, part, *models, **kw)

    with contextlib.redirect_stdout(io.StringIO()):
        resumable_eval(method, "maze2easy", SEED, env, PROBLEMS[:1], str(out), chunk=1)
        calls.clear()
        summary = resumable_eval(method, "maze2easy", SEED, env, PROBLEMS, str(out), chunk=1)
    return summary, calls


def write(tmp: Path):
    """Run the JAX package on the CPU and write the fixture."""

    from gnn_motion_planning_tpu.api.eval_gnn import eval_gnn, eval_gnn_pure
    from gnn_motion_planning_tpu.api.registry import str2env, str2name
    from gnn_motion_planning_tpu.parallel.sharded_eval import resumable_eval

    env = str2env("maze2easy")[0]
    _, model, _, model_s, _ = str2name("maze2easy")
    pure = [pure_row(eval_gnn_pure, env, model, model_s, i) for i in PROBLEMS]
    summary, calls = resumed_summary(resumable_eval, eval_gnn, env, tmp, (model, model_s))
    FIXTURE.write_text(json.dumps({
        "about": "JAX package on the CPU, maze2easy, seed 1234, the protocol's defaults: "
                 "eval_gnn_pure with the shipped explorer passed in, one problem a call; "
                 "resumable_eval(eval_gnn, chunk=1) over 2000, then resumed over "
                 "2000-2001; tests/test_torch_port_surfaces.py",
        "pure_rows": pure, "resumed_calls": calls,
        "summary": {k: summary[k] for k in SUMMARY_KEYS},
    }, indent=1) + "\n")


def test_api_all_equals_jax():
    import gnn_motion_planning_tpu.api as jax_api
    import gnn_motion_planning_tpu_torch.api as api

    assert api.__all__ == jax_api.__all__
    for name in api.__all__:
        assert callable(getattr(api, name)), name


def test_envs_lazy_map_and_strs():
    import gnn_motion_planning_tpu.envs as jax_envs
    import gnn_motion_planning_tpu_torch.envs as envs

    assert envs.strs == jax_envs.strs
    assert envs.__all__ == jax_envs.__all__
    for name, module in envs._LAZY.items():
        assert module == jax_envs._LAZY[name].replace(
            "gnn_motion_planning_tpu.", "gnn_motion_planning_tpu_torch.")
        cls = getattr(envs, name)
        assert cls.__name__ == name and cls.__module__ == module
    with pytest.raises(AttributeError):
        envs.NoSuchEnv  # noqa: B018


@pytest.mark.parametrize("config", CONFIGS)
def test_eval_overrides_equal_jax(config):
    from gnn_motion_planning_tpu.api.registry import eval_overrides as jax_overrides
    from gnn_motion_planning_tpu.api.registry import scalar_overrides as jax_scalar
    from gnn_motion_planning_tpu_torch.api.registry import eval_overrides, scalar_overrides

    assert eval_overrides(config) == jax_overrides(config)
    assert scalar_overrides(config) == jax_scalar(config)
    got = eval_overrides(config)
    got["t_max"] = -1  # a copy: the table stays as it was
    assert eval_overrides(config) == jax_overrides(config)


def test_eval_gnn_pure_rows_equal_jax():
    """The shipped maze2easy explorer without its obstacle encoder (no
    ``_pure.pt`` is shipped), passed in, problem by problem; the caller's
    module keeps its config."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn_pure
    from gnn_motion_planning_tpu_torch.api.registry import str2name

    env, model, _, model_s, _ = str2name("maze2easy", device="cpu")
    want = json.loads(FIXTURE.read_text())["pure_rows"]
    for w in want:
        got = pure_row(eval_gnn_pure, env, model, model_s, w["index"])
        assert (got["success"], got["collision"], got["collision_explore"]) == (
            w["success"], w["collision"], w["collision_explore"]), w["index"]
        assert abs(got["cost"] - w["cost"]) < 1e-3, w["index"]
    assert model.cfg.use_obstacles


def test_load_smoother_none_without_twin(monkeypatch, tmp_path):
    """maze3's shipped smoother is the legacy architecture; with its
    scratch twin missing there is no smoother (JAX: params None), and
    ``explore`` smooths with the oracle smoother."""

    import gnn_motion_planning_tpu_torch.api.registry as registry
    from gnn_motion_planning_tpu_torch.models.smoother import Smoother

    assert isinstance(registry._load_smoother(registry._SPECS["maze3"], 1.0), Smoother)
    monkeypatch.setattr(registry, "REPO", tmp_path)
    assert registry._load_smoother(registry._SPECS["maze3"], 1.0) is None
    _, smoother = registry.str2models("maze3", "cpu")
    assert smoother is None
    # a spec whose checkpoint loads is untouched by the missing twin
    assert isinstance(registry._load_smoother(registry._SPECS["maze2"], 1.0), Smoother)


def test_explore_without_smoother_takes_the_oracle_smoother():
    """``explore`` with ``model_s=None`` smooths through the oracle
    smoother (maze2easy 2000 at a cut budget), as the JAX package's does
    with params None."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.config import problem_rng

    env, model, _, _, _ = str2name("maze2easy", device="cpu")
    env.rng = problem_rng(SEED, 2000)
    env.init_new_problem(2000)
    r = explore(env, model, None, smooth=True, batch=100, t_max=300)
    assert r["success"] and not r["strict_certified"]
    assert r["c_smooth"] > 0 and len(r["smooth_path"]) >= 2


@pytest.mark.parametrize("n,shards", [(10, 3), (1000, 4), (7, 7), (3, 5)])
def test_shard_indexes_equal_jax(n, shards):
    from gnn_motion_planning_tpu.parallel.sharded_eval import shard_indexes as jax_shard
    from gnn_motion_planning_tpu_torch.parallel.sharded_eval import shard_indexes

    idx = np.arange(2000, 2000 + n)
    parts = [shard_indexes(idx, shards, i) for i in range(shards)]
    for i, part in enumerate(parts):
        np.testing.assert_array_equal(part, jax_shard(idx, shards, i))
    np.testing.assert_array_equal(np.concatenate(parts), idx)


def test_resumable_eval_resumed_equals_jax(tmp_path):
    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.parallel.sharded_eval import resumable_eval

    env, model, _, model_s, _ = str2name("maze2easy", device="cpu")
    summary, calls = resumed_summary(resumable_eval, eval_gnn, env, tmp_path, (model, model_s))
    want = json.loads(FIXTURE.read_text())
    assert calls == want["resumed_calls"] == [[2001]]
    for k in SUMMARY_KEYS:
        assert math.isclose(summary[k], want["summary"][k], rel_tol=0, abs_tol=1e-3 if k == "path_cost" else 0), k
    assert json.loads((tmp_path / "sweep.json").read_text()) == summary


if __name__ == "__main__":
    import tempfile

    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    with tempfile.TemporaryDirectory() as d:
        write(Path(d))
