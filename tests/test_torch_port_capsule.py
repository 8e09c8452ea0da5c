"""The port's capsule-vs-AABB kernel module against the JAX package.

``gnn_motion_planning_tpu_torch/ops/capsule.py`` holds the CUDA kernel's
wrapper and its plain PyTorch version. On the CPU the wrapper runs the plain
version; its contact decisions must equal the JAX package's Pallas kernel
(interpret mode, as tests/test_pallas_capsule.py runs it) and its XLA path
exactly. The kernel itself needs the card: that test skips without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.envs.geometry import seg_box_sq_dist as jax_seg_box_sq_dist
from gnn_motion_planning_tpu.ops.pallas_capsule import capsules_hit as jax_capsules_hit
from gnn_motion_planning_tpu_torch.envs.geometry import seg_box_sq_dist
from gnn_motion_planning_tpu_torch.ops import capsule


def _xla_hit(p0, p1, r, centers, halfs, mask):
    d2 = jax_seg_box_sq_dist(
        p0[:, :, None, :], p1[:, :, None, :], centers[None, None], halfs[None, None]
    )
    contact = (d2 < (r[None, :, None] ** 2)) & mask[None, None, :]
    return jnp.any(contact, axis=(1, 2))


def _random_scene(seed, B=200, C=5, O=7):
    rng = np.random.RandomState(seed)
    p0 = rng.uniform(-1, 1, (B, C, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.5, 0.5, (B, C, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.15, C).astype(np.float32)
    centers = rng.uniform(-0.8, 0.8, (O, 3)).astype(np.float32)
    halfs = rng.uniform(0.05, 0.4, (O, 3)).astype(np.float32)
    mask = rng.rand(O) > 0.3
    return p0, p1, r, centers, halfs, mask


def _kuka7_scene(B=96):
    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv

    env = KukaEnv(device="cpu")
    env.init_new_problem(2000)
    lo, hi = env.chain.lower.numpy(), env.chain.upper.numpy()
    qs = np.random.RandomState(0).uniform(lo, hi, (B, lo.shape[0])).astype(np.float32)
    p0, p1, r = capsules_world(env.chain, torch.as_tensor(qs))
    sc = env.device_scene()
    return tuple(t.numpy() for t in (p0, p1, r, sc.centers, sc.halfs, sc.mask))


def _jax_decisions(args):
    jargs = [jnp.asarray(a) for a in args]
    pallas = np.asarray(jax_capsules_hit(*jargs, block=128, interpret=True))
    xla = np.asarray(_xla_hit(*jargs))
    return pallas, xla


@pytest.mark.parametrize("scene", ["random0", "random1", "kuka7"])
def test_plain_version_equals_jax_kernel(scene):
    args = _kuka7_scene() if scene == "kuka7" else _random_scene(int(scene[-1]))
    pallas, xla = _jax_decisions(args)
    got = capsule.capsules_hit(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_array_equal(pallas, xla)
    np.testing.assert_array_equal(got, pallas)
    if scene != "kuka7":
        assert got.any() and not got.all()  # a non-degenerate scene


def test_degenerate_segments_equal_jax_kernel():
    rng = np.random.RandomState(2)
    B, C, O = 64, 3, 4
    p0 = rng.uniform(-1, 1, (B, C, 3)).astype(np.float32)
    args = (p0, p0.copy(), np.full(C, 0.1, np.float32),
            rng.uniform(-1, 1, (O, 3)).astype(np.float32),
            np.full((O, 3), 0.2, np.float32), np.ones(O, bool))
    pallas, _ = _jax_decisions(args)
    got = capsule.capsules_hit(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, pallas)


def test_seg_box_sq_dist_matches_jax():
    p0, p1, _, centers, halfs, _ = _random_scene(3, B=50, C=4, O=6)
    args = (p0[:, :, None, :], p1[:, :, None, :], centers[None, None], halfs[None, None])
    want = np.asarray(jax_seg_box_sq_dist(*(jnp.asarray(a) for a in args)))
    got = seg_box_sq_dist(*(torch.as_tensor(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_cpu_tensors_take_the_plain_version_without_counting(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call built or loaded the kernel")

    monkeypatch.setattr(capsule, "load_library", no_build)
    args = [torch.as_tensor(a) for a in _random_scene(0)]
    before = dict(capsule.LAUNCHES)
    got = capsule.capsules_hit(*args)
    assert torch.equal(got, capsule.capsules_hit_reference(*args))
    assert capsule.LAUNCHES == before


def test_other_devices_raise():
    args = [torch.as_tensor(a).to("meta") for a in _random_scene(0)]
    with pytest.raises(ValueError, match="no kernel"):
        capsule.capsules_hit(*args)


def test_lane_width_follows_the_batch():
    """Whole warps a configuration below LANES_16_FROM, groups of 16 from
    there on: both widths the kernels are built for, and both used."""

    edge = capsule.LANES_16_FROM
    widths = {b: capsule.lanes_for(b) for b in (1, 31, edge - 1, edge, 1 << 20)}
    assert set(widths.values()) == set(capsule.LANE_CHOICES) == {16, 32}
    assert widths[edge - 1] == 32 and widths[edge] == 16


@pytest.mark.cuda
def test_kernel_equals_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run: python -m pytest -m cuda tests/test_torch_port_*.py")
    # B = 200 runs whole warps a configuration, B = 4096 groups of 16 lanes
    for args in (_random_scene(0), _random_scene(1), _kuka7_scene(4096)):
        t = [torch.as_tensor(a, device="cuda") for a in args]
        n0 = capsule.LAUNCHES["capsules_hit"]
        got = capsule.capsules_hit(*t)
        assert capsule.LAUNCHES["capsules_hit"] == n0 + 1
        assert torch.equal(got, capsule.capsules_hit_reference(*t))
