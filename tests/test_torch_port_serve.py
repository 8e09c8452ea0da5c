"""The port's serving path, ``api/serve.py`` and ``Planner.serve_round`` /
``serve_full``, against the JAX package's.

Given JAX's own draws (``jax.random.uniform(key, (M, d), minval, maxval)``),
the port's ``serve_round`` gives JAX's nodes, sampling counts, search
result and path exactly. The fused ``serve_full`` gives the checks of the
two-call composition it fuses (serve_round -> host backtrack ->
model_smooth) exactly, the path within 1e-6 and the smoothed path within
1e-5 (tests/test_batched_eval.py:115-184 holds the JAX package's to the
same).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn_serve, explore_serve, model_smooth
from gnn_motion_planning_tpu_torch.api.planner_bundle import get_planner
from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2env, str2models
from gnn_motion_planning_tpu_torch.api.serve import sample_range, serve_generator
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.graphs.knn import k_scaled
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack

SEED, BATCH, INDEX = 1234, 100, 2000


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _env(index=INDEX):
    env = str2env("maze2easy", device="cpu")[0]
    env.rng = problem_rng(SEED, index)
    env.init_new_problem(index)
    return env


@pytest.fixture(scope="module")
def models():
    env = str2env("maze2easy", device="cpu")[0]
    return str2models("maze2easy", "cpu", smoother_scale("maze2easy", env))


def _inputs(env):
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    toks, mask = env.obs_tokens()
    return (env.device_scene(), t(env.init_state), t(env.goal_state), t(toks),
            torch.as_tensor(mask))


def test_serve_round_equals_jax_given_its_draws(models):
    """maze2easy problem 2000 at batch 100: JAX's ``serve_round`` from a key,
    the port's from the draws that key gives."""

    from gnn_motion_planning_tpu.api.eval_gnn import get_planner as jax_get_planner
    from gnn_motion_planning_tpu.api.registry import str2name

    jenv, jmodel, _, _, _ = str2name("maze2easy")
    jenv.init_new_problem(INDEX)
    pr = sample_range(_env())
    key = jax.random.PRNGKey(7)
    M = 4 * BATCH
    jres, jv, jprefix, jn_coll, jenough = jax_get_planner(jenv).serve_round(
        jmodel.params, jmodel.cfg, jenv.device_scene(), key, jnp.asarray(pr[:, 0]),
        jnp.asarray(pr[:, 1]), jnp.asarray(np.asarray(jenv.init_state, np.float32)),
        jnp.asarray(np.asarray(jenv.goal_state, np.float32)),
        jnp.asarray(jenv.obs_tokens()[0]), jnp.asarray(jenv.obs_tokens()[1]),
        batch=BATCH, k1=k_scaled(30, BATCH + 2), loop=5, oversample=4)
    draws = np.asarray(jax.random.uniform(key, (M, 2), minval=jnp.asarray(pr[:, 0]),
                                          maxval=jnp.asarray(pr[:, 1]), dtype=jnp.float32))

    env = _env()
    scene, init, goal, toks, mask = _inputs(env)
    res, v, prefix, n_coll, enough = get_planner(env).serve_round(
        models[0], scene, torch.as_tensor(draws), init, goal, toks, mask, BATCH,
        k_scaled(30, BATCH + 2), 5)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    assert (int(prefix), int(n_coll), bool(enough)) == (int(jprefix), int(jn_coll), bool(jenough))
    assert res.success == bool(jres.success) and res.success
    assert res.n_checks == int(jres.n_checks)
    assert backtrack(res.prev.numpy(), res.success_node) == backtrack(
        np.asarray(jres.prev), int(jres.success_node))


def test_serve_full_equals_two_call_composition(models):
    """The fused serve path against serve_round -> host backtrack ->
    model_smooth on the same draws: checks exactly, the path within 1e-6,
    the smoothed path within 1e-5."""

    model, model_s = models
    env = _env()
    c0 = env.collision_check_count
    r = explore_serve(env, model, model_s, serve_generator(SEED, INDEX, "cpu"), batch=BATCH)
    assert r["success"]
    fused_checks = env.collision_check_count - c0

    env2 = _env()
    gen = serve_generator(SEED, INDEX, "cpu")
    from gnn_motion_planning_tpu_torch.api.serve import draw

    scene, init, goal, toks, mask = _inputs(env2)
    res, v, prefix, n_coll, enough = get_planner(env2).serve_round(
        model, scene, draw(env2, gen, 4 * BATCH), init, goal, toks, mask, BATCH,
        k_scaled(30, BATCH + 2), 5)
    assert bool(enough) and res.success
    v_np = v.numpy()
    path = [v_np[i] for i in backtrack(res.prev.numpy(), res.success_node)]
    F = BATCH + 2
    env2.collision_check_count = 0
    smooth = model_smooth(model_s, [v_np[i] for i in range(F)],
                          [v_np[F + i] for i in range(int(n_coll))], path, env2)
    assert fused_checks == int(prefix) + res.n_checks + env2.collision_check_count
    np.testing.assert_allclose(np.asarray(r["path"]), np.asarray(path), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r["smooth_path"]), np.asarray(smooth), rtol=0, atol=1e-5)


def test_eval_gnn_serve_plans_and_counts(models):
    """maze2easy 2000-2002 at batch 100: all solved, checks counted
    (tests/test_batched_eval.py:101-112)."""

    env = str2env("maze2easy", device="cpu")[0]
    rows = []
    r = eval_gnn_serve("maze2easy", SEED, env, [2000, 2001, 2002], *models, batch=BATCH,
                       rows=rows)
    assert r[0] == 3
    assert r[1] > 0 and all(row["c_explore"] > 0 for row in rows)
    assert np.isfinite(r[3]) and r[5] <= r[6]


def test_serve_generator_is_deterministic():
    """The same (seed, index) gives the same draws; another index others."""

    env = _env()
    a = torch.rand(8, generator=serve_generator(SEED, 2000, "cpu"))
    b = torch.rand(8, generator=serve_generator(SEED, 2000, "cpu"))
    c = torch.rand(8, generator=serve_generator(SEED, 2001, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    from gnn_motion_planning_tpu_torch.api.serve import draw

    d = draw(env, serve_generator(SEED, 2000, "cpu"), 64)
    assert d.shape == (64, 2) and bool((d.abs() <= 1).all())
