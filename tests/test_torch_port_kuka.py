"""The port's kuka7 env against the JAX package: URDF parse and chain,
FK and capsules, the native float64 core, the host sample stream and the
batched device oracle."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.config import problem_rng as jax_problem_rng
from gnn_motion_planning_tpu.envs.kinematics import capsules_world as jax_capsules_world
from gnn_motion_planning_tpu.envs.kuka import KukaEnv as JaxKukaEnv
from gnn_motion_planning_tpu.envs.kuka import chain_state_free
from gnn_motion_planning_tpu.utils.geomcore import GeomChain as JaxGeomChain
from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
from gnn_motion_planning_tpu_torch.utils import geomcore


@pytest.fixture(scope="module")
def envs():
    jenv = JaxKukaEnv()
    tenv = KukaEnv(device="cpu")
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    return jenv, tenv


def _configs(env, n, seed):
    pr = np.array(env.pose_range)
    return np.random.RandomState(seed).uniform(pr[:, 0], pr[:, 1], (n, env.config_dim))


def test_chain_arrays_equal_jax(envs):
    jenv, tenv = envs
    ours = tenv.chain.numpy_arrays()
    for name, value in jenv.chain._asdict().items():
        np.testing.assert_array_equal(ours[name], np.asarray(value), err_msg=name)
    assert tenv.pose_range == jenv.pose_range
    assert tenv._k_max() == jenv._k_max()


def test_capsules_world_matches_jax(envs):
    jenv, tenv = envs
    qs = _configs(tenv, 64, 1).astype(np.float32)
    want = jax.vmap(lambda q: jax_capsules_world(jenv.chain, q))(jnp.asarray(qs))
    got = capsules_world(tenv.chain, torch.as_tensor(qs))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2][0]))


def test_native_core_build_equals_jax_core(envs):
    jenv, tenv = envs
    assert "build/torch_port" in str(geomcore.build_shared_library(
        geomcore.SRC, "geomcore", ["g++"], geomcore.FLAGS))
    jax_native = JaxGeomChain(jenv.chain, jenv.RRT_EPS)
    centers = np.stack([np.asarray(b, np.float64) for _, b in jenv.obstacles])
    halfs = np.stack([np.asarray(h, np.float64) for h, _ in jenv.obstacles])
    jax_native.set_scene(centers, halfs)
    qs = _configs(tenv, 256, 2)
    got, got_cnt = tenv._native.states_free(qs)
    want, want_cnt = jax_native.states_free(qs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_cnt, want_cnt)
    assert got.any() and not got.all()


def test_sample_stream_equals_jax(envs):
    jenv, tenv = envs
    jenv.rng = jax_problem_rng(1234, 2000)
    tenv.rng = problem_rng(1234, 2000)
    c_j, c_t = jenv.collision_check_count, tenv.collision_check_count
    jf, jc = jenv.sample_n_points(500, need_negative=True)
    tf, tc = tenv.sample_n_points(500, need_negative=True)
    np.testing.assert_array_equal(np.asarray(tf), np.asarray(jf))
    np.testing.assert_array_equal(np.asarray(tc), np.asarray(jc))
    assert tenv.collision_check_count - c_t == jenv.collision_check_count - c_j
    assert len(tf) == 500 and len(tc) > 0


def test_device_oracle_equals_jax(envs):
    """Batched state checks and fixed-step edge checks (decisions and
    counts) against the JAX f32 kernels, out-of-limit states included."""

    jenv, tenv = envs
    qs = _configs(tenv, 128, 3).astype(np.float32)
    qs[::9] += 7.0  # out of the joint limits: one check, never free
    jk, tk = jenv.kernels(), tenv.kernels()
    scene = jenv.device_scene()
    want, want_cnt = jax.vmap(lambda q: chain_state_free(jenv.chain, scene, q))(jnp.asarray(qs))
    got, got_cnt = tk.batch_state_free(tenv.device_scene(), torch.as_tensor(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))

    qa, qb = qs[:64], qs[64:]
    want_e, want_ec = jax.vmap(lambda a, b: jk.edge_free(scene, a, b))(jnp.asarray(qa), jnp.asarray(qb))
    got_e, got_ec = tk.edge_free(tenv.device_scene(), torch.as_tensor(qa), torch.as_tensor(qb))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_ec.numpy(), np.asarray(want_ec))
    assert got_e.any() and (got_ec > 2).any()


def test_cheap_edge_budget_equals_jax(envs):
    """The K_CHEAP-style variant (``with_overflow``): at a budget of 4
    interior points, decisions, counts and overflow flags as in JAX."""

    from gnn_motion_planning_tpu.envs.base import make_fixed_step_edge_free as jax_edge_fn
    from gnn_motion_planning_tpu_torch.envs.base import make_fixed_step_edge_free

    jenv, tenv = envs
    qs = _configs(tenv, 128, 4).astype(np.float32)
    qa, qb = qs[:64], qs[64:]
    jk, tk = jenv.kernels(), tenv.kernels()
    jscene, tscene = jenv.device_scene(), tenv.device_scene()
    lo, hi = tenv.chain.lower, tenv.chain.upper
    j_edge = jax_edge_fn(jk.state_free, jk.distance, jenv.chain.lower, jenv.chain.upper,
                         jenv.RRT_EPS, 4, with_overflow=True)
    t_edge = make_fixed_step_edge_free(tk.batch_state_free, tk.distance, lo, hi,
                                       tenv.RRT_EPS, 4, with_overflow=True)
    want = jax.vmap(lambda a, b: j_edge(jscene, a, b))(jnp.asarray(qa), jnp.asarray(qb))
    got = t_edge(tscene, torch.as_tensor(qa), torch.as_tensor(qb))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].any() and not got[2].all()


def test_obs_tokens_equal_jax(envs):
    jenv, tenv = envs
    for g, w in zip(tenv.obs_tokens(), jenv.obs_tokens()):
        np.testing.assert_array_equal(g, w)


def test_no_device_means_cuda():
    from gnn_motion_planning_tpu_torch import resolve_device

    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            KukaEnv()
