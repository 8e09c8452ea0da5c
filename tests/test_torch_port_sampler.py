"""The port's opt-in samplers and snake7's grid window against the JAX
package (the port of tests/test_arm_envs.py:102-370): the 3 x 3 grid scene
against the full scan, the "straight", "corridor" and "endpoint" biases,
the corridor cache, chunk invariance, and the global stream
(``env.rng = None`` under ``np.random.seed``).

Tolerances: decisions, samples, counts and stream positions exactly; the
corridor table (float64 on both sides) exactly; an ``eval_gnn`` row under a
bias as the protocol rows (cost within 1e-3) against
``tests/data/torch_port_bias_jax_rows.json`` (regenerate with
``PYTHONPATH=. python tests/test_torch_port_sampler.py``).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.config import set_random_seed
from test_torch_port_strict import _jax_env, _port_env


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def snakes():
    return _jax_env("snake7"), _port_env("snake7")


@pytest.fixture(scope="module")
def kukas():
    return _jax_env("kuka7"), _port_env("kuka7")


def _wall_problem():
    """A vertical wall at i = 7 with a single gap at j = 3; init in cell
    (2, 7), goal in cell (12, 7) (tests/test_arm_envs.py:194-201)."""

    occ = np.zeros((15, 15))
    occ[7, :] = 1
    occ[7, 3] = 0
    init = np.zeros(7)
    init[:2] = (1.4 * 2 - 10.5, 1.4 * 7 - 10.5)
    goal = np.zeros(7)
    goal[:2] = (1.4 * 12 - 10.5, 1.4 * 7 - 10.5)
    return occ, init, goal


def _boundary_states(tenv, n: int, seed: int) -> np.ndarray:
    """States whose first capsule's midpoint lies on a cell boundary (half
    way between two cell centres in x, as near as float32 FK puts it), the
    base shifted to put it there."""

    from gnn_motion_planning_tpu_torch.envs.snake import snake_capsules

    rng = np.random.RandomState(seed)
    pr = np.array(tenv.pose_range)
    qs = rng.uniform(pr[:, 0], pr[:, 1], (n, 7))
    p0, p1, _ = snake_capsules(tenv.chain, torch.as_tensor(qs, dtype=torch.float32))
    mid = (0.5 * (p0[:, 0, :2] + p1[:, 0, :2])).double().numpy()
    k = rng.randint(1, 13, (n, 2))
    target = 1.4 * (k + 0.5) - 10.5
    qs[:, :2] += target - mid
    return np.clip(qs, pr[:, 0], pr[:, 1]).astype(np.float32)


def test_grid_scene_equals_full_scan_and_jax(snakes):
    """The grid window decides as the full 225-cell scan (entry A's plain
    version) and as JAX's ``snake_state_free_grid``, on uniform states and
    on states whose capsule midpoint sits on a cell boundary."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.envs import snake as jsnake
    from gnn_motion_planning_tpu_torch.envs.snake import SnakeGridScene, make_snake_grid_scene

    jenv, tenv = snakes
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    jscene = jsnake.make_snake_grid_scene(jenv.map)
    grid = make_snake_grid_scene(tenv.map, "cpu")
    assert isinstance(grid, SnakeGridScene)
    np.testing.assert_array_equal(grid.cells.numpy(), np.asarray(jscene.cells))
    np.testing.assert_array_equal(grid.row_masks.numpy(), np.asarray(jscene.row_masks))
    assert np.array_equal(np.float32(1.4 * np.arange(15) - 10.5)[np.arange(15)],
                          jsnake._COORDS)

    pr = np.array(tenv.pose_range)
    qs = np.concatenate([
        np.random.RandomState(7).uniform(pr[:, 0], pr[:, 1], (1024, 7)).astype(np.float32),
        _boundary_states(tenv, 512, 3),
    ])
    f_jax = jax.jit(jax.vmap(lambda q: jsnake.snake_state_free_grid(
        jenv.chain, jenv.pair_mask, jscene, q, jenv.lower, jenv.upper)[0]))
    want = np.asarray(f_jax(jnp.asarray(qs)))
    oracle = tenv.kernels().batch_state_free
    got, n = oracle(grid, torch.as_tensor(qs))
    full, _ = oracle(tenv.device_scene(), torch.as_tensor(qs))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(full.numpy(), got.numpy())
    assert 0 < int(got.sum()) < len(qs) and int(n.sum()) == len(qs)


def _sample_both(jenv, tenv, reset, n: int = 50, seed: int = 7):
    """The same request on both packages from one seed -> (JAX samples,
    negatives, count, next draws), then the port's."""

    out = []
    for env in (jenv, tenv):
        reset(env)
        env.rng = set_random_seed(seed)
        c0 = env.collision_check_count
        a, na = env.sample_n_points(n, need_negative=True)
        out.append((np.asarray(a), np.asarray(na), env.collision_check_count - c0,
                    env.rng.uniform(0.0, 1.0, 3)))
    return out


def _assert_streams_equal(want, got):
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_straight_bias_equals_jax(snakes):
    from gnn_motion_planning_tpu_torch.envs.snake import SnakeEnv

    jenv, tenv = snakes
    occ = np.zeros((15, 15))
    occ[7, 7] = 1
    draws = np.random.RandomState(0).uniform(-1, 1, (64, 7))
    for env in snakes:
        env.sampler_bias = None
        env.set_problem_data(occ, np.zeros(7), np.ones(7) * 0.1)
    np.testing.assert_array_equal(tenv._bias_draws(draws), draws)  # off: the identity

    u = np.random.RandomState(1).uniform(-np.pi, np.pi, (90, 7))
    u[:, :2] *= 9.0 / np.pi
    for env in snakes:
        env.sampler_bias = "straight"
    assert SnakeEnv._BIAS_EVERY == type(jenv)._BIAS_EVERY
    for off in (0, 1, 5):
        np.testing.assert_array_equal(tenv._bias_draws(u, offset=off),
                                      jenv._bias_draws(u, offset=off))

    def reset(env):
        env.set_problem_data(occ, np.zeros(7), np.ones(7) * 0.1)

    want, got = _sample_both(jenv, tenv, reset)
    _assert_streams_equal(want, got)
    # the port's own replay: the same samples and stream position again
    _assert_streams_equal(got, _sample_both(tenv, tenv, reset)[1])
    for env in snakes:
        env.sampler_bias = None


def test_corridor_bias_and_cache_equal_jax(snakes):
    jenv, tenv = snakes
    occ, init, goal = _wall_problem()
    for env in snakes:
        env.set_problem_data(occ, init, goal)
        env.sampler_bias = "corridor"
    (jc, jd), (tc, td) = jenv._corridor_cells(), tenv._corridor_cells()
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_array_equal(td, jd)
    assert any(np.allclose(c, (1.4 * 7 - 10.5, 1.4 * 3 - 10.5)) for c in tc)  # the gap

    u = np.random.RandomState(1).uniform(-np.pi, np.pi, (64, 7))
    u[:, :2] *= 9.0 / np.pi
    np.testing.assert_array_equal(tenv._bias_draws(u), jenv._bias_draws(u))
    # a block biased whole equals its rows biased one at a time at their offsets
    rows = np.stack([tenv._bias_draws(u[i : i + 1], offset=i)[0] for i in range(64)])
    np.testing.assert_array_equal(tenv._bias_draws(u, offset=0), rows)

    # the cache: the same map object with new endpoints recomputes; endpoints
    # moved by hand (set_random_init_goal's way) are noticed too
    init2, goal2 = np.zeros(7), np.zeros(7)
    init2[:2] = (1.4 * 2 - 10.5, 1.4 * 3 - 10.5)
    goal2[:2] = (1.4 * 2 - 10.5, 1.4 * 11 - 10.5)
    tenv.set_problem_data(occ, init2, goal2)
    c2, _ = tenv._corridor_cells()
    assert c2.shape != tc.shape or not np.array_equal(c2, tc)
    tenv.init_state, tenv.goal_state = init, goal
    np.testing.assert_array_equal(tenv._corridor_cells()[0], tc)

    def reset(env):
        env.set_problem_data(occ, init, goal)

    _assert_streams_equal(*_sample_both(jenv, tenv, reset))
    for env in snakes:
        env.sampler_bias = None


def test_endpoint_bias_equals_jax(kukas):
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv

    jenv, tenv = kukas
    for env in kukas:
        env.init_new_problem(2000)
    pr = np.array(tenv.pose_range)
    draws = np.random.RandomState(0).uniform(pr[:, 0], pr[:, 1], (32, 7))
    np.testing.assert_array_equal(tenv._bias_draws(draws), draws)
    for env in kukas:
        env.sampler_bias = "endpoint"
    assert KukaEnv._ENDPOINT_EVERY == type(jenv)._ENDPOINT_EVERY
    for off in (0, 3, 6):
        np.testing.assert_array_equal(tenv._bias_draws(draws, offset=off),
                                      jenv._bias_draws(draws, offset=off))
    rows = np.stack([tenv._bias_draws(draws[i : i + 1], offset=i)[0] for i in range(32)])
    np.testing.assert_array_equal(tenv._bias_draws(draws, offset=0), rows)

    def reset(env):
        env.init_new_problem(2000)

    _assert_streams_equal(*_sample_both(jenv, tenv, reset))
    tenv.sampler_bias = "bogus"
    with pytest.raises(ValueError):
        tenv._bias_draws(draws)
    for env in kukas:
        env.sampler_bias = None


@pytest.mark.parametrize("rate", [None, 0.05, 0.9])
def test_biased_stream_does_not_depend_on_the_chunking(snakes, rate):
    """The device-oracle sampler sizes its chunks by the accept rate; the
    accepted stream and the counts are the same whatever it starts from."""

    _, tenv = snakes
    occ, init, goal = _wall_problem()
    tenv.sampler_bias = "corridor"

    def run(r):
        tenv.set_problem_data(occ, init, goal)
        tenv._accept_rate = r
        tenv.rng = set_random_seed(11)
        a, na = tenv.sample_n_points(300, need_negative=True)
        return np.asarray(a), len(na), tenv.collision_check_count, tenv._draw_pos

    want = run(None)
    got = run(rate)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    tenv.sampler_bias = None
    tenv._accept_rate = None


@pytest.mark.parametrize("config", ["kuka7", "snake7"])
def test_global_stream_equals_jax(config, kukas, snakes):
    """``env.rng = None``: one draw at a time from numpy's global stream,
    one check a draw, as JAX's loop."""

    jenv, tenv = kukas if config == "kuka7" else snakes
    out = []
    for env in (jenv, tenv):
        env.init_new_problem(2000)
        env.rng = None
        np.random.seed(5)
        free, coll = env.sample_n_points(20, need_negative=True)
        out.append((np.asarray(free), np.asarray(coll), env.collision_check_count,
                    np.random.uniform(0, 1, 2)))
    _assert_streams_equal(*out)
    assert out[1][2] == len(out[1][0]) + len(out[1][1])


def test_sample_empty_points_and_aug_path_equal_jax(kukas):
    jenv, tenv = kukas
    out = []
    for env in kukas:
        env.init_new_problem(2001)
        env.rng = set_random_seed(3)
        out.append((env.sample_empty_points(), env.collision_check_count, env.aug_path()))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert out[1][1] == out[0][1]
    assert len(out[1][2]) == len(out[0][2]) > 2
    for g, w in zip(out[1][2], out[0][2]):
        np.testing.assert_array_equal(g, w)


def test_ur5_problem_with_config_equals_jax():
    jenv, tenv = _jax_env("ur5"), _port_env("ur5")
    obstacles, start, goal, _ = tenv.problems[2000]
    want = jenv.init_new_problem_with_config(start, goal, obstacles)
    got = tenv.init_new_problem_with_config(start, goal, obstacles)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
    assert tenv.index == jenv.index == -1
    q = np.asarray(start, np.float64)
    assert tenv._state_fp(q) == jenv._state_fp(q)


# ---------------------------------------------------------------------------
# eval_gnn rows under each bias (tests/data/torch_port_bias_jax_rows.json,
# which chip_smoke.py phase 11 prints beside its own)
# ---------------------------------------------------------------------------

BIAS_FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port_bias_jax_rows.json"
BIAS_CASES = (("kuka13", "endpoint"), ("snake7", "straight"), ("snake7", "corridor"))
BIAS_PROBLEM = 2000


def jax_bias_row(config: str, bias: str) -> dict:
    from gnn_motion_planning_tpu.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu.api.registry import str2env, str2models
    from gnn_motion_planning_tpu.config import problem_rng
    from test_torch_port_eval import SEED, protocol

    env = str2env(config)[0]
    env.sampler_bias = bias
    model, model_s = str2models(config)
    env.rng = problem_rng(SEED, BIAS_PROBLEM)
    env.init_new_problem(BIAS_PROBLEM)
    r = explore(env, model, model_s, True, **protocol(config))
    return dict(index=BIAS_PROBLEM, success=bool(r["success"]), c_explore=int(r["c_explore"]),
                c_smooth=int(r["c_smooth"]), cost=path_cost(r["smooth_path"]))


@pytest.mark.parametrize("config,bias", BIAS_CASES)
def test_biased_rows_equal_jax_fixture(config, bias):
    import json

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from test_torch_port_eval import SEED, protocol

    env = _port_env(config)
    env.sampler_bias = bias
    rows = []
    eval_gnn(config, SEED, env, [BIAS_PROBLEM], rows=rows, **protocol(config))
    want = json.loads(BIAS_FIXTURE.read_text())["rows"][f"{config}_{bias}"]
    for key in ("index", "success", "c_explore", "c_smooth"):
        assert rows[0][key] == want[key], (key, rows[0], want)
    assert abs(rows[0]["cost"] - want["cost"]) < 1e-3


if __name__ == "__main__":
    import json
    import os
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    rows = {}
    for config, bias in BIAS_CASES:
        rows[f"{config}_{bias}"] = jax_bias_row(config, bias)
        print(config, bias, rows[f"{config}_{bias}"], flush=True)
    BIAS_FIXTURE.write_text(json.dumps({
        "about": "gnn_motion_planning_tpu.api.eval_gnn.explore with env.sampler_bias set, "
                 "seed 1234, the config's protocol, JAX on the CPU; written by "
                 "tests/test_torch_port_sampler.py", "rows": rows}, indent=1) + "\n")
