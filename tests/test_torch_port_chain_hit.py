"""The fused collision oracle ``ops/capsule.py::chain_states_free`` against
the JAX package, on the kuka7 and kuka13 chains in problem 2000's scene.

On the CPU the wrapper runs its plain version, ``chain_states_free_reference``,
which reads the chain back from the same packed buffers the CUDA kernel
reads (``ops/capsule.py::pack_chain``), so these tests cover the packing
too. Its decisions and check counts must equal the JAX package's exactly:
``vmap(chain_state_free)`` (the XLA path) and ``batch_state_free`` with
``GMP_PALLAS_CAPSULE=1`` (the Pallas kernel in interpret mode, as
tests/test_pallas_capsule.py runs it). The inputs are those of
tests/test_torch_port_kuka.py::test_device_oracle_equals_jax: 128
configurations, every ninth out of the limits, and the interpolated states
of 64 edges between them. The kernel itself needs the card: that test skips
without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.envs.kuka import KukaEnv as JaxKukaEnv
from gnn_motion_planning_tpu.envs.kuka import chain_state_free
from gnn_motion_planning_tpu.envs.kuka import make_chain_kernels as jax_make_chain_kernels
from gnn_motion_planning_tpu_torch.envs.base import make_fixed_step_edge_free, one_lane
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
from gnn_motion_planning_tpu_torch.ops import capsule
from gnn_motion_planning_tpu_torch.ops.capsule import (
    PackedChain,
    pack_chain,
    packed_lengths,
    unpack_chain,
)

ARMS = {
    "kuka7": ("kuka_iiwa/model_0.urdf", "maze_files/kukas_7_3000.pkl"),
    "kuka13": ("kuka_iiwa/model_3.urdf", "maze_files/kukas_13_3000.pkl"),
}


@pytest.fixture(scope="module", params=sorted(ARMS))
def envs(request):
    kuka_file, map_file = ARMS[request.param]
    jenv = JaxKukaEnv(kuka_file=kuka_file, map_file=map_file)
    tenv = KukaEnv(kuka_file=kuka_file, map_file=map_file, device="cpu")
    jenv.init_new_problem(2000)
    tenv.init_new_problem(2000)
    return jenv, tenv


def _configs(env, n, seed):
    pr = np.array(env.pose_range)
    return np.random.RandomState(seed).uniform(pr[:, 0], pr[:, 1], (n, env.config_dim))


def _oracle_inputs(tenv):
    """128 configurations, every ninth out of the limits, as 64 edges."""

    qs = _configs(tenv, 128, 3).astype(np.float32)
    qs[::9] += 7.0  # out of the joint limits: one check, never free
    return qs


def _edge_states(tenv, qa, qb):
    """Every state the port's fixed-step edge check hands its oracle for the
    edges qa -> qb, and the edge results with the plain fused oracle."""

    packed = pack_chain(tenv.chain)
    seen = []

    def oracle(scene, qs):
        seen.append(qs)
        return _lane_reference(qs, packed, scene)

    tk = tenv.kernels()
    edge_free = make_fixed_step_edge_free(
        oracle, tk.distance, tenv.chain.lower, tenv.chain.upper, tenv.RRT_EPS, tenv._k_max()
    )
    result = edge_free(tenv.device_scene(), torch.as_tensor(qa), torch.as_tensor(qb))
    return torch.cat(seen).numpy(), result


def _lane_reference(qs, packed, scene):
    free, cnt = capsule.chain_states_free_reference(qs[None], packed, one_lane(scene))
    return free[0], cnt[0]


def _all_states(tenv):
    qs = _oracle_inputs(tenv)
    states, _ = _edge_states(tenv, qs[:64], qs[64:])
    return np.concatenate([qs, states])


def _reference(tenv, qs):
    free, cnt = _lane_reference(
        torch.as_tensor(qs), pack_chain(tenv.chain), tenv.device_scene()
    )
    return free.numpy(), cnt.numpy()


def _chains_equal(a, b):
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), name
        else:
            assert x == y, name


def test_pack_round_trip_is_exact(envs):
    _, tenv = envs
    packed = pack_chain(tenv.chain)
    J, C, dof = packed.sizes
    assert (J, C, dof) == (tenv.chain.origin_rot.shape[0], tenv.chain.cap_r.shape[0],
                           tenv.config_dim)
    assert packed.floats.dtype == torch.float32 and packed.ints.dtype == torch.int32
    assert (packed.floats.numel(), packed.ints.numel()) == packed_lengths(J, C, dof)
    assert packed_lengths(J, C, dof) == (15 * J + 7 * C + 2 * dof, 2 * J + C)
    _chains_equal(unpack_chain(packed), tenv.chain)


def test_reference_equals_jax_state_free(envs):
    """Against vmap(chain_state_free), the XLA path, state by state."""

    jenv, tenv = envs
    qs = _all_states(tenv)
    scene = jenv.device_scene()
    want, want_cnt = jax.vmap(lambda q: chain_state_free(jenv.chain, scene, q))(jnp.asarray(qs))
    got, got_cnt = _reference(tenv, qs)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_cnt, np.asarray(want_cnt))
    assert got.any() and (got_cnt.astype(bool) & ~got).any() and not got_cnt.all()


def test_reference_equals_jax_pallas_kernel(envs, monkeypatch):
    """Against the JAX package's batch_state_free through the Pallas kernel
    (GMP_PALLAS_CAPSULE=1 runs it in the interpreter on the CPU)."""

    jenv, tenv = envs
    monkeypatch.setenv("GMP_PALLAS_CAPSULE", "1")
    jk = jax_make_chain_kernels(jenv.chain, jenv.RRT_EPS, jenv._k_max())
    assert jk.batch_state_free is not None
    qs = _all_states(tenv)
    want, want_cnt = jk.batch_state_free(jenv.device_scene(), jnp.asarray(qs))
    got, got_cnt = _reference(tenv, qs)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_cnt, np.asarray(want_cnt))


def test_edges_through_reference_equal_jax(envs):
    """The fixed-step edge check over the plain fused oracle against the JAX
    edge check: decisions and counts."""

    jenv, tenv = envs
    qs = _oracle_inputs(tenv)
    qa, qb = qs[:64], qs[64:]
    want_e, want_ec = jax.vmap(lambda a, b: jenv.kernels().edge_free(jenv.device_scene(), a, b))(
        jnp.asarray(qa), jnp.asarray(qb)
    )
    _, (got_e, got_ec) = _edge_states(tenv, qa, qb)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
    np.testing.assert_array_equal(got_ec.numpy(), np.asarray(want_ec))
    assert got_e.any() and (got_ec > 2).any()


def test_nan_and_limit_edges_equal_jax(envs):
    """NaN is out of the limits (no check, never free); a joint exactly at
    its limit is in."""

    jenv, tenv = envs
    qs = _configs(tenv, 8, 5).astype(np.float32)
    lo, hi = tenv.chain.lower.numpy(), tenv.chain.upper.numpy()
    qs[0, 1] = np.nan
    qs[1] = np.nan
    qs[2, 0], qs[3, -1] = lo[0], hi[-1]
    qs[4] = np.clip(qs[4], lo, hi)
    qs[5, 2] = np.inf
    scene = jenv.device_scene()
    want, want_cnt = jax.vmap(lambda q: chain_state_free(jenv.chain, scene, q))(jnp.asarray(qs))
    got, got_cnt = _reference(tenv, qs)
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got_cnt, np.asarray(want_cnt))
    np.testing.assert_array_equal(got_cnt[[0, 1, 5]], 0)
    np.testing.assert_array_equal(got_cnt[[2, 3]], 1)


def test_cpu_oracle_equals_reference(envs):
    """The env's own oracle (``kernels().batch_state_free``, which runs
    ``chain_states_free``) against the reference env's state check, the
    JAX package's ``kernels().state_free``, on every state."""

    jenv, tenv = envs
    qs = _all_states(tenv)
    jk, scene = jenv.kernels(), jenv.device_scene()
    want, want_cnt = jax.vmap(lambda q: jk.state_free(scene, q))(jnp.asarray(qs))
    got, got_cnt = tenv.kernels().batch_state_free(tenv.device_scene(), torch.as_tensor(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_cnt.numpy(), np.asarray(want_cnt))


def test_cpu_tensors_take_the_plain_version_without_counting(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built or loaded the kernel")

    monkeypatch.setattr(capsule, "load_library", no_build)
    env = KukaEnv(device="cpu")
    env.init_new_problem(2000)
    qs = torch.as_tensor(_oracle_inputs(env))
    packed = pack_chain(env.chain)
    before = dict(capsule.LAUNCHES)
    got = capsule.chain_states_free(qs[None], packed, one_lane(env.device_scene()))
    want = capsule.chain_states_free_reference(qs[None], packed, one_lane(env.device_scene()))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert capsule.LAUNCHES == before


def test_other_devices_raise():
    env = KukaEnv(device="cpu")
    env.init_new_problem(2000)
    qs = torch.zeros(1, 4, env.config_dim, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        capsule.chain_states_free(qs, pack_chain(env.chain), one_lane(env.device_scene()))


@pytest.mark.cuda
def test_fused_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python -m pytest -m cuda tests/test_torch_port_*.py")
    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world

    for kuka_file, map_file in ARMS.values():
        env = KukaEnv(kuka_file=kuka_file, map_file=map_file, device="cuda")
        env.init_new_problem(2000)
        packed, scene = pack_chain(env.chain), one_lane(env.device_scene())
        C = packed.sizes[1]
        # B = 4096 runs groups of 16 lanes a configuration, 31 and 1 whole warps
        for batch in (4096, 31, 1):
            qs = _configs(env, batch, batch).astype(np.float32)
            qs[10::20] += 7.0
            q = torch.as_tensor(qs, device="cuda")[None]
            ends = (torch.empty(1, batch, C, 3, device="cuda"),
                    torch.empty(1, batch, C, 3, device="cuda"))
            want = capsule.chain_states_free_reference(q, packed, scene)
            for endpoints in (None, ends):
                n0 = capsule.LAUNCHES["chain_states_free"]
                got = capsule.chain_states_free(q, packed, scene, endpoints=endpoints)
                assert capsule.LAUNCHES["chain_states_free"] == n0 + 1
                assert all(torch.equal(g, w) for g, w in zip(got, want))
            # the same ops in the same order; 1e-5 m leaves room for the last
            # bits of cosf and sinf, whose code is built with other flags in torch
            p0, p1, _ = capsules_world(env.chain, q[0])
            p0, p1 = p0[None], p1[None]
            assert torch.allclose(ends[0], p0, rtol=0, atol=1e-5)
            assert torch.allclose(ends[1], p1, rtol=0, atol=1e-5)
    # the most boxes a launch takes, 16 of them active, above the floor and
    # small enough that some states are free: at B = 4096 the kuka13 chain's
    # block needs more than 48 KB of shared memory and opts in
    rng = np.random.RandomState(7)
    O = capsule.MAX_BOXES
    mask = np.zeros(O, bool)
    mask[rng.choice(O, 16, replace=False)] = True
    many = type(scene)(*(torch.as_tensor(a, device="cuda")[None] for a in (
        rng.uniform((-1, -1, 0), (1, 1, 1), (O, 3)).astype(np.float32),
        rng.uniform(0.05, 0.15, (O, 3)).astype(np.float32), mask)))
    q = torch.as_tensor(_configs(env, 4096, 7).astype(np.float32), device="cuda")[None]
    got = capsule.chain_states_free(q, packed, many)
    want = capsule.chain_states_free_reference(q, packed, many)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want[0].any() and not want[0].all()
    J, C, dof = 17, 24, 7
    n_floats, n_ints = packed_lengths(J, C, dof)
    too_long = PackedChain(torch.zeros(n_floats, device="cuda"),
                           torch.zeros(n_ints, dtype=torch.int32, device="cuda"), (J, C, dof))
    with pytest.raises(ValueError, match="at most"):
        capsule.chain_states_free(torch.zeros(1, 1, dof, device="cuda"), too_long, scene)
