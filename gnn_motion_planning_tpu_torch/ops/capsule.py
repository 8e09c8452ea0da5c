"""Batched capsule-vs-AABB contact decisions: the port of the TPU kernel
``gnn_motion_planning_tpu/ops/pallas_capsule.py::capsules_hit`` and of the
forward kinematics that XLA fused around it.

Two entry points share one narrow phase in ``csrc/capsules_hit.cu``, built
at first use with plain ``nvcc`` and bound with ``ctypes``:

- ``capsules_hit`` answers, for each of B configurations, whether any of
  its C capsules (segment p0 -> p1, radius r) comes closer than r to any
  active axis-aligned box;
- ``chain_states_free`` takes the joint configurations themselves and
  returns ``(free, n_checks)`` as ``envs/kuka.py``'s ``batch_state_free``
  does: joint limits, forward kinematics and the narrow phase in one launch.

For a CUDA tensor each launches its kernel; for a CPU tensor each runs its
plain PyTorch version (``capsules_hit_reference``,
``chain_states_free_reference``). There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

This module owns the layout in which ``chain_states_free`` reads a chain
(``PackedChain``, ``pack_chain``, ``unpack_chain``, ``packed_lengths``); the
kernel's source mirrors it. The plain version of a kernel that fuses
forward kinematics is ``envs/kinematics.py::capsules_world`` followed by the
plain narrow phase, so this module imports that leaf module, and nothing
else of ``envs``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path
from typing import NamedTuple, Tuple

import torch

from gnn_motion_planning_tpu_torch.envs.kinematics import ChainParams, capsules_world
from gnn_motion_planning_tpu_torch.utils.build import build_shared_library

_EPS = 1e-12
CSRC = Path(__file__).resolve().parents[1] / "csrc" / "capsules_hit.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]
# the most each launch takes; a block's shared memory then stays under the
# H100's 227 KB: 6 floats a box, and for chain_states_free the chain and,
# for each of up to 16 configurations, 12 (J + 1) + 9 J + 6 C floats
MAX_BOXES = 1024
MAX_JOINTS = 16
MAX_CAPSULES = 64
# lanes that work on one configuration: 16 or 32 (a whole warp). Up to a
# few thousand configurations the card has warps to spare, and a warp each
# hides latency best; at 4096 a warp each fills nearly every resident warp
# slot of the 132 SMs, issue sets the pace, and groups of 16 win by leaving
# fewer lanes idle in the last round (kuka7: 72 pairs, 5 rounds of 16 or 3
# of 32). Measured on the card: chip_smoke.py phase 3, "lanes sweep";
# PERF.md section 6.
LANE_CHOICES = (16, 32)
LANES_16_FROM = 4096

# fp32 operations counted from the kernel, each add, multiply, divide,
# compare, select, min, max, abs, cos and sin being one:
# per (state, capsule, active box) in the narrow phase
OPS_PER_PAIR = 680
# per joint in FK: Rodrigues (cos, sin, 1 - c, 9 entries: 34 + 2), two
# 3x3 products (2 x 45), R @ origin_trans + t (18)
OPS_PER_JOINT = 144
# per capsule: two R @ p + t (2 x 18) and v = p1 - p0 (3)
OPS_PER_CAPSULE = 39
# per joint angle: two limit comparisons and the and
OPS_PER_DOF = 3

# kernel launches since the last reset, by entry point
LAUNCHES = {"capsules_hit": 0, "chain_states_free": 0}

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def load_library():
    """Build (once per source) and load the kernel's shared library."""

    global _lib
    if _lib is None:
        path = build_shared_library(CSRC, "capsules_hit", [_nvcc()], NVCC_FLAGS)
        lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.capsules_hit_launch.restype = i32
        lib.capsules_hit_launch.argtypes = [ptr] * 6 + [i32, i32, i32, ptr, i32, ptr]
        lib.chain_states_free_launch.restype = i32
        lib.chain_states_free_launch.argtypes = (
            [ptr, i32, i32, ptr, ptr, i32, i32, ptr, ptr, ptr, i32] + [ptr] * 4 + [i32, ptr]
        )
        _lib = lib
    return _lib


class PackedChain(NamedTuple):
    """A ChainParams in two flat buffers on the chain's device, the form in
    which the fused kernel reads it.

    floats (float32): origin_rot (J*9) | origin_trans (J*3) | axis (J*3) |
        cap_p0 (C*3) | cap_p1 (C*3) | cap_r (C) | lower (dof) | upper (dof)
    ints (int32): q_index (J) | parent_frame (J) | cap_link (C)
    sizes: (J, C, dof), kept on the host so that a launch reads nothing
        back from the device.
    """

    floats: torch.Tensor
    ints: torch.Tensor
    sizes: Tuple[int, int, int]


def _float_parts(J: int, C: int, dof: int):
    return [9 * J, 3 * J, 3 * J, 3 * C, 3 * C, C, dof, dof]


def packed_lengths(J: int, C: int, dof: int) -> Tuple[int, int]:
    """(floats, ints) lengths of a PackedChain of J joints, C capsules and
    dof joint angles."""

    return sum(_float_parts(J, C, dof)), 2 * J + C


def pack_chain(chain: ChainParams) -> PackedChain:
    J, C, dof = chain.origin_rot.shape[0], chain.cap_r.shape[0], chain.lower.shape[0]
    floats = torch.cat([
        t.reshape(-1).to(torch.float32)
        for t in (chain.origin_rot, chain.origin_trans, chain.axis, chain.cap_p0,
                  chain.cap_p1, chain.cap_r, chain.lower, chain.upper)
    ])
    dev = chain.cap_link.device
    ints = torch.cat([
        torch.tensor(chain.q_index + chain.parent_frame, dtype=torch.int32, device=dev),
        chain.cap_link.to(torch.int32),
    ])
    return PackedChain(floats, ints, (J, C, dof))


def unpack_chain(packed: PackedChain) -> ChainParams:
    J, C, dof = packed.sizes
    rot, trans, axis, p0, p1, r, lower, upper = torch.split(
        packed.floats, _float_parts(J, C, dof)
    )
    ints = packed.ints.tolist()
    return ChainParams(
        origin_rot=rot.reshape(J, 3, 3),
        origin_trans=trans.reshape(J, 3),
        axis=axis.reshape(J, 3),
        cap_link=packed.ints[2 * J:].to(torch.long),
        cap_p0=p0.reshape(C, 3),
        cap_p1=p1.reshape(C, 3),
        cap_r=r,
        lower=lower,
        upper=upper,
        q_index=tuple(ints[:J]),
        parent_frame=tuple(ints[J:2 * J]),
    )


def _seg_box_contact(u, v, h, r2):
    """contact for (…) capsule-box pairs, per-axis lists of tensors.

    Mirrors pallas_capsule.py::_seg_box_contact_rows: the same candidate set
    (t = 0, 1 and the ±h crossing of each axis), the same _EPS guards, the
    same bracket, vertex and order of mins.
    """

    zeros = torch.zeros_like(u[0])
    ones = torch.ones_like(u[0])
    cands = [zeros, ones]
    for i in range(3):
        ok = v[i].abs() > _EPS
        safe = torch.where(ok, v[i], 1.0)
        cands.append(torch.where(ok, (h[i] - u[i]) / safe, 0.0).clamp(0.0, 1.0))
        cands.append(torch.where(ok, (-h[i] - u[i]) / safe, 0.0).clamp(0.0, 1.0))

    def f(t):
        acc = zeros
        for i in range(3):
            d = torch.clamp_min((u[i] + t * v[i]).abs() - h[i], 0.0)
            acc = acc + d * d
        return acc

    def g(t):
        acc = zeros
        for i in range(3):
            w = u[i] + t * v[i]
            e = torch.clamp_min(w.abs() - h[i], 0.0)
            acc = acc + 2.0 * torch.sign(w) * e * v[i]
        return acc

    t_lo, t_hi = zeros, ones
    for t in cands:
        gt = g(t)
        t_lo = torch.maximum(t_lo, torch.where(gt < 0, t, 0.0))
        t_hi = torch.minimum(t_hi, torch.where(gt > 0, t, 1.0))
    t_hi = torch.maximum(t_hi, t_lo)

    mid = 0.5 * (t_lo + t_hi)
    num, den = zeros, zeros
    for i in range(3):
        wm = u[i] + mid * v[i]
        active = wm.abs() > h[i]
        s = torch.sign(wm)
        alpha = torch.where(active, s * v[i], 0.0)
        beta = torch.where(active, s * u[i] - h[i], 0.0)
        num = num + alpha * beta
        den = den + alpha * alpha
    t_star = torch.minimum(torch.maximum(-num / torch.clamp_min(den, _EPS), t_lo), t_hi)

    d2 = f(cands[0])
    for t in cands[1:] + [t_lo, t_hi, t_star]:
        d2 = torch.minimum(d2, f(t))
    return d2 < r2


def capsule_contacts(p0, p1, r, centers, halfs, mask):
    """(B, C, A) bool: contact of every capsule with every active box, the
    A active boxes in index order."""

    # inactive boxes never make contact: evaluate the active ones only
    active = mask.nonzero().flatten()
    centers, halfs = centers[active], halfs[active]
    v = p1 - p0  # (B, C, 3)
    u = [p0[:, :, None, i] - centers[None, None, :, i] for i in range(3)]  # (B, C, A)
    vv = [v[:, :, None, i].expand_as(u[0]) for i in range(3)]
    h = [halfs[None, None, :, i] for i in range(3)]
    r2 = (r * r)[None, :, None]
    return _seg_box_contact(u, vv, h, r2)


def capsules_hit_reference(p0, p1, r, centers, halfs, mask):
    """Plain PyTorch version: (B,) bool from (B, C, 3) endpoints, (C,) radii,
    (O, 3) centres and half-extents and an (O,) active-box mask."""

    return capsule_contacts(p0, p1, r, centers, halfs, mask).flatten(1).any(dim=1)


def chain_states_free_reference(qs, packed: PackedChain, scene):
    """Plain PyTorch version of ``chain_states_free``: the chain is read back
    from its packed buffers, then limits, ``capsules_world`` and
    ``capsules_hit_reference`` as ``envs/kuka.py``'s CPU path runs them."""

    chain = unpack_chain(packed)
    valid = ((qs >= chain.lower) & (qs <= chain.upper)).all(dim=1)
    p0, p1, r = capsules_world(chain, qs)
    hit = capsules_hit_reference(p0, p1, r, scene.centers, scene.halfs, scene.mask)
    return valid & ~hit, valid.to(torch.int32)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name: str, device, *args) -> None:
    """Launch entry point ``name`` on the device's current stream; raise on a
    launch error, count a launch otherwise."""

    lib = load_library()
    with torch.cuda.device(device):  # the launch goes to the current device
        err = getattr(lib, f"{name}_launch")(
            *args, torch.cuda.current_stream(device).cuda_stream
        )
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def lanes_for(batch: int) -> int:
    """Lanes a configuration, in both kernels, for a batch of ``batch``."""

    return 16 if batch >= LANES_16_FROM else 32


def capsules_hit(p0, p1, r, centers, halfs, mask):
    """(B,) bool: does any capsule of a configuration touch an active box?

    p0, p1: (B, C, 3) float32; r: (C,) float32; centers, halfs: (O, 3)
    float32; mask: (O,) bool. CPU tensors take the plain version; CUDA
    tensors launch the kernel (and count the launch).
    """

    if p0.device.type == "cpu":
        return capsules_hit_reference(p0, p1, r, centers, halfs, mask)
    if p0.device.type != "cuda":
        raise ValueError(f"capsules_hit has no kernel for {p0.device}")
    B, C = p0.shape[0], p0.shape[1]
    O = centers.shape[0]
    dev = p0.device
    _check("p0", p0, torch.float32, (B, C, 3), dev)
    _check("p1", p1, torch.float32, (B, C, 3), dev)
    _check("r", r, torch.float32, (C,), dev)
    _check("centers", centers, torch.float32, (O, 3), dev)
    _check("halfs", halfs, torch.float32, (O, 3), dev)
    _check("mask", mask, torch.bool, (O,), dev)
    if O > MAX_BOXES:
        raise ValueError(f"capsules_hit takes at most {MAX_BOXES} boxes, got {O}")
    out = torch.empty(B, dtype=torch.bool, device=dev)
    if B == 0:
        return out
    _launch("capsules_hit", dev, p0.data_ptr(), p1.data_ptr(), r.data_ptr(),
            centers.data_ptr(), halfs.data_ptr(), mask.data_ptr(), B, C, O, out.data_ptr(),
            lanes_for(B))
    return out


def chain_states_free(qs, packed: PackedChain, scene, endpoints=None):
    """(free (B,) bool, n_checks (B,) int32) for joint configurations qs.

    qs: (B, dof) float32; packed: ``pack_chain`` of the robot; scene: centers, halfs (O, 3) float32 and mask (O,) bool. A
    configuration is valid when every joint lies within its limits (NaN is
    not); free = valid and no capsule touches an active box; n_checks =
    valid. CPU tensors take the plain version; CUDA tensors launch the fused
    kernel (and count the launch).
    ``endpoints``, two (B, C, 3) float32
    CUDA tensors or None, receive the kernel's capsule endpoints for every
    configuration: a diagnostic, None on the main path.
    """

    if qs.device.type == "cpu":
        return chain_states_free_reference(qs, packed, scene)
    if qs.device.type != "cuda":
        raise ValueError(f"chain_states_free has no kernel for {qs.device}")
    J, C, dof = packed.sizes
    B, O = qs.shape[0], scene.centers.shape[0]
    dev = qs.device
    _check("qs", qs, torch.float32, (B, dof), dev)
    n_floats, n_ints = packed_lengths(J, C, dof)
    _check("packed floats", packed.floats, torch.float32, (n_floats,), dev)
    _check("packed ints", packed.ints, torch.int32, (n_ints,), dev)
    _check("centers", scene.centers, torch.float32, (O, 3), dev)
    _check("halfs", scene.halfs, torch.float32, (O, 3), dev)
    _check("mask", scene.mask, torch.bool, (O,), dev)
    if J > MAX_JOINTS or dof > J or C > MAX_CAPSULES or O > MAX_BOXES:
        raise ValueError(
            f"chain_states_free takes at most {MAX_JOINTS} joints, {MAX_CAPSULES} "
            f"capsules and {MAX_BOXES} boxes, got J={J} dof={dof} C={C} O={O}"
        )
    ptr0 = ptr1 = None
    if endpoints is not None:
        for name, t in zip(("endpoints p0", "endpoints p1"), endpoints):
            _check(name, t, torch.float32, (B, C, 3), dev)
        ptr0, ptr1 = endpoints[0].data_ptr(), endpoints[1].data_ptr()
    free = torch.empty(B, dtype=torch.bool, device=dev)
    n_checks = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return free, n_checks
    _launch("chain_states_free", dev, qs.data_ptr(), B, dof, packed.floats.data_ptr(),
            packed.ints.data_ptr(), J, C, scene.centers.data_ptr(), scene.halfs.data_ptr(),
            scene.mask.data_ptr(), O, free.data_ptr(), n_checks.data_ptr(), ptr0, ptr1,
            lanes_for(B))
    return free, n_checks
