"""The cheap projection in the port (``envs/base.py::make_fixed_step_edge_free
(with_overflow=True)`` at ``K_CHEAP``, the arms' ``edge_free_cheap``,
``planners/gnn_smooth.py::make_projection_core(cheap=True)``, and
``GMP_FLAT_PROJ=0`` in ``api/planner_bundle.py``) against the JAX package.

Only ur5 and snake7 have an ``edge_free_cheap`` in either package: kuka7,
kuka13 and kuka14 budget at most 41 interior points at full size, under
``K_CHEAP + 16``, so the budget kernel there is held by building it over
each package's state oracle.

Tolerances: decisions, counts and overflow flags exactly; a projected
waypoint within 1e-6 (tests/test_torch_port_search.py); the rows of
``GMP_FLAT_PROJ=0`` as the protocol rows (cost within 1e-3).

Regenerate the JAX rows (``tests/data/torch_port_cheap_jax.json``, which
``chip_smoke.py`` phase 11 prints beside its own) with
``python tests/test_torch_port_cheap.py`` (a few minutes).
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_port_strict import _jax_env, _port_env

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_cheap_jax.json"
ROWS = {"kuka7": [2000, 2001], "ur5": [2000, 2001]}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _edges(env, n: int, seed: int):
    """Seeded edges within the limits: short ones about a joint apart, long
    ones toward the opposite limits, and edges between the farthest pairs
    of free samples (whose first interior points are often free, so a budget
    can run out)."""

    from gnn_motion_planning_tpu_torch.config import set_random_seed

    rng = np.random.RandomState(seed)
    pr = np.array(env.pose_range)
    a = rng.uniform(pr[:, 0], pr[:, 1], (n, env.config_dim))
    short = a + rng.normal(0, 0.5, a.shape)
    far = np.where(a > 0, pr[:, 0], pr[:, 1]) * rng.uniform(0.8, 1.0, a.shape)
    b = np.concatenate([short[: n // 2], far[n // 2 :]])
    b = np.clip(b, pr[:, 0], pr[:, 1])
    env.rng = set_random_seed(seed)
    free = np.asarray(env.sample_n_points(n))
    d = np.linalg.norm(free[:, None] - free[None], axis=-1)
    a = np.concatenate([a, free])
    b = np.concatenate([b, free[d.argmax(1)]])
    return a.astype(np.float32), b.astype(np.float32)


def _jax_cheap(jenv, k_pts):
    """JAX's budget kernel of the env: its own ``edge_free_cheap`` at
    K_CHEAP where it has one, else built the same way over its oracle."""

    from gnn_motion_planning_tpu.envs.base import K_CHEAP, make_fixed_step_edge_free

    kern = jenv.kernels()
    if k_pts == K_CHEAP and kern.edge_free_cheap is not None:
        return kern.edge_free_cheap
    lower, upper = kern.bounds
    return make_fixed_step_edge_free(kern.state_free, kern.distance, lower, upper,
                                     float(jenv.RRT_EPS), k_pts, with_overflow=True)


def _port_cheap(tenv, k_pts):
    from gnn_motion_planning_tpu_torch.envs.base import K_CHEAP, make_fixed_step_edge_free

    kern = tenv.kernels()
    if k_pts == K_CHEAP and kern.edge_free_cheap is not None:
        return kern.edge_free_cheap
    lower, upper = kern.bounds
    return make_fixed_step_edge_free(kern.batch_state_free, kern.distance, lower, upper,
                                     float(tenv.RRT_EPS), k_pts, with_overflow=True)


@pytest.mark.parametrize("config,k_pts", [
    ("kuka7", 128), ("kuka7", 8), ("ur5", 128), ("kuka14", 8), ("snake7", 128),
])
def test_edge_free_cheap_equals_jax(config, k_pts):
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu_torch.envs.base import K_CHEAP

    jenv, tenv = _jax_env(config), _port_env(config)
    has = config in ("ur5", "snake7")
    assert (tenv.kernels().edge_free_cheap is not None) == has
    assert (jenv.kernels().edge_free_cheap is not None) == has
    for env in (jenv, tenv):
        pb = env.init_new_problem(2000)
        if config == "snake7":  # an open maze: long free edges, and the self pairs
            env.set_problem_data(np.zeros((15, 15)), pb["init_state"], pb["goal_state"])
    eps = float(tenv.RRT_EPS)
    a, b = _edges(tenv, 64, 5)
    # edges longer than the budget's k_pts x RRT_EPS exist where the limits allow
    longer = bool((np.linalg.norm(b - a, axis=1) > k_pts * eps).any())
    assert longer == (config != "kuka7" or k_pts < K_CHEAP)
    jf = _jax_cheap(jenv, k_pts)
    want = jax.jit(jax.vmap(lambda x, y: jf(jenv.device_scene(), x, y)))(jnp.asarray(a),
                                                                         jnp.asarray(b))
    got = _port_cheap(tenv, k_pts)(tenv.device_scene(), torch.as_tensor(a), torch.as_tensor(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    free, cnt, ovf = (g.numpy() for g in got)
    assert ovf.any() == longer and (~ovf).any() and free.any()
    # where no overflow, the full kernel decides and counts the same
    full_free, full_cnt = tenv.kernels().edge_free(tenv.device_scene(), torch.as_tensor(a),
                                                   torch.as_tensor(b))
    np.testing.assert_array_equal(free[~ovf], full_free.numpy()[~ovf])
    np.testing.assert_array_equal(cnt[~ovf], full_cnt.numpy()[~ovf])


def _long_paths(tenv, L: int = 16):
    """Paths a -> b -> a over the two farthest-apart pairs of 64 free
    samples (ur5: 19-21 rad, longer than the K_CHEAP budget's 12.8), the
    middle node's proposal moved a little: a sweep whose checks can run
    past the budget."""

    from gnn_motion_planning_tpu_torch.config import set_random_seed

    tenv.rng = set_random_seed(1)
    free = np.asarray(tenv.sample_n_points(64))
    d = np.linalg.norm(free[:, None] - free[None], axis=-1)
    for k in (0, 3):
        i, j = np.unravel_index(np.argsort(d, axis=None)[-1 - 2 * k], d.shape)
        path = np.repeat(free[i][None].astype(np.float32), L, 0)
        path[1] = free[j]
        proposal = path + np.random.RandomState(k).normal(0, 0.3, path.shape).astype(np.float32)
        proposal[0], proposal[2:] = path[0], path[2:]
        yield path, proposal, 3


@pytest.mark.parametrize("config", ["ur5", "snake7"])
def test_cheap_projection_core_equals_jax(config):
    """``make_projection_core(cheap=True)``: JAX's path, count and overflow,
    and the full sweep's path and count where it does not overflow (snake7
    in an open maze, so long edges stay free)."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.planners.gnn_smooth import make_projection_core as jax_core
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import make_projection_core
    from test_torch_port_search import _projection_inputs

    jenv, tenv = _jax_env(config), _port_env(config)
    for env in (jenv, tenv):
        pb = env.init_new_problem(2000)
        if config == "snake7":
            env.set_problem_data(np.zeros((15, 15)), pb["init_state"], pb["goal_state"])
    eps = float(tenv.RRT_EPS)
    jcore = jax.jit(jax_core(jenv.kernels(), eps, cheap=True))
    cheap = make_projection_core(tenv.kernels(), eps, cheap=True)
    full = make_projection_core(tenv.kernels(), eps)
    flags = []
    cases = list(_long_paths(tenv))
    if config == "snake7":  # both long paths overflow there: a short sweep too
        cases.append(_projection_inputs(tenv, L=16, n_path=6))
    for path, proposal, n in cases:
        want = jcore(jenv.device_scene(), jnp.asarray(path), jnp.asarray(proposal), jnp.int32(n))
        args = (tenv.device_scene(), torch.as_tensor(path), torch.as_tensor(proposal), n)
        got = cheap(*args)
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
        assert got[1] == int(want[1]) and got[2] == bool(want[2])
        if not got[2]:
            ref = full(*args)
            assert got[1] == ref[1]
            np.testing.assert_array_equal(got[0].numpy(), ref[0].numpy())
        flags.append(got[2])
    assert any(flags) and not all(flags)


def test_planner_takes_the_cheap_sweep_under_the_flag(monkeypatch):
    from gnn_motion_planning_tpu_torch.api.planner_bundle import Planner

    monkeypatch.setenv("GMP_FLAT_PROJ", "0")
    ur5 = Planner(_port_env("ur5"))
    kuka7 = Planner(_port_env("kuka7"))
    assert "make_projection_core" in ur5.project_cheap.__qualname__
    assert ur5.project_cheap is not ur5.project_full
    assert kuka7.project_cheap is kuka7.project_full
    monkeypatch.delenv("GMP_FLAT_PROJ")
    assert "make_projection_core_flat" in Planner(_port_env("ur5")).project_cheap.__qualname__


def fixture() -> dict:
    return json.loads(FIXTURE.read_text())


def test_kuka7_row_under_flag_equals_jax(monkeypatch):
    """``eval_gnn`` on kuka7 2000 with ``GMP_FLAT_PROJ=0`` gives JAX's row
    under the same flag (and the protocol row: the sweeps decide alike)."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from test_torch_port_eval import PROTOCOL, SEED

    monkeypatch.setenv("GMP_FLAT_PROJ", "0")
    rows = []
    eval_gnn("kuka7", SEED, _port_env("kuka7"), [2000], rows=rows, **PROTOCOL)
    want = fixture()["rows"]["kuka7"][0]
    got = rows[0]
    for key in ("index", "success", "c_explore", "c_smooth"):
        assert got[key] == want[key], (key, got, want)
    assert abs(got["cost"] - want["cost"]) < 1e-3


def test_fixture_settings():
    assert fixture()["settings"] == {k: list(v) for k, v in ROWS.items()}


def write_fixture():
    from test_torch_port_eval import jax_rows

    os.environ["GMP_FLAT_PROJ"] = "0"
    rows = {config: jax_rows(idx, config) for config, idx in ROWS.items()}
    FIXTURE.write_text(json.dumps({
        "about": "gnn_motion_planning_tpu.api.eval_gnn.explore with GMP_FLAT_PROJ=0, seed 1234, "
                 "the reference protocol, JAX on the CPU; written by "
                 "tests/test_torch_port_cheap.py::write_fixture",
        "settings": ROWS, "rows": rows,
    }, indent=1) + "\n")


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    write_fixture()
