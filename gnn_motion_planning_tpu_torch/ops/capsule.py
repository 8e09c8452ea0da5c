"""Batched capsule-vs-AABB contact decisions: the port of the TPU kernel
``gnn_motion_planning_tpu/ops/pallas_capsule.py::capsules_hit`` and of the
forward kinematics that XLA fused around it.

Two entry points share one narrow phase in ``csrc/capsules_hit.cu``, built
at first use with plain ``nvcc`` and bound with ``ctypes``:

- ``capsules_hit`` answers, for each of B configurations in each of L
  lanes, whether any of its C capsules (segment p0 -> p1, radius r) comes
  closer than r to any active axis-aligned box of its lane's scene;
- ``chain_states_free`` takes the joint configurations themselves and
  returns ``(free, n_checks)`` as ``envs/kuka.py``'s ``batch_state_free``
  does: joint limits, forward kinematics and the narrow phase in one launch.

A lane is one problem with its own boxes: the port of ``jax.vmap`` over a
``pallas_call``, which gives the Pallas kernel a grid axis of problems. A
single problem is one lane. For a CUDA tensor each entry launches its
kernel once for all lanes; for a CPU tensor each runs its
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

from gnn_motion_planning_tpu_torch.envs.geometry import near_pairs
from gnn_motion_planning_tpu_torch.envs.kinematics import ChainParams, capsules_world, fma32
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
        lib.capsules_hit_launch.argtypes = [ptr] * 6 + [i32] * 4 + [ptr, i32, ptr]
        lib.chain_states_free_launch.restype = i32
        lib.chain_states_free_launch.argtypes = (
            [ptr, i32, i32, i32, ptr, ptr, i32, i32, ptr, ptr, ptr, i32] + [ptr] * 4 + [i32, ptr]
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


def _seg_box_sq_dist_rows(u, v, h):
    """Squared distance for (…) capsule-box pairs, per-axis lists of tensors.

    Mirrors pallas_capsule.py::_seg_box_contact_rows: the same candidate set
    (t = 0, 1 and the ±h crossing of each axis), the same _EPS guards, the
    same bracket, vertex and order of mins; and rounds as XLA's CPU code
    rounds ``envs/geometry.py::seg_box_sq_dist`` (that module's docstring):
    ``u + t v`` and the sums of f, f' and the vertex denominator as fused
    multiply-adds (``fma32``), the vertex numerator in order.
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
        d = [torch.clamp_min(fma32(t, v[i], u[i]).abs() - h[i], 0.0) for i in range(3)]
        return fma32(d[2], d[2], fma32(d[0], d[0], d[1] * d[1]))

    def g(t):
        x = []
        for i in range(3):
            w = fma32(t, v[i], u[i])
            x.append(2.0 * torch.sign(w) * torch.clamp_min(w.abs() - h[i], 0.0))
        return fma32(x[2], v[2], fma32(x[1], v[1], x[0] * v[0]))

    t_lo, t_hi = zeros, ones
    for t in cands:
        gt = g(t)
        t_lo = torch.maximum(t_lo, torch.where(gt < 0, t, 0.0))
        t_hi = torch.minimum(t_hi, torch.where(gt > 0, t, 1.0))
    t_hi = torch.maximum(t_hi, t_lo)

    mid = 0.5 * (t_lo + t_hi)
    alpha, beta = [], []
    for i in range(3):
        wm = fma32(mid, v[i], u[i])
        active = wm.abs() > h[i]
        s = torch.sign(wm)
        alpha.append(torch.where(active, s * v[i], 0.0))
        beta.append(torch.where(active, s * u[i] - h[i], 0.0))
    num = (alpha[0] * beta[0] + alpha[1] * beta[1]) + alpha[2] * beta[2]
    den = fma32(alpha[2], alpha[2], fma32(alpha[1], alpha[1], alpha[0] * alpha[0]))
    t_star = torch.minimum(torch.maximum(-num / torch.clamp_min(den, _EPS), t_lo), t_hi)

    d2 = f(cands[0])
    for t in cands[1:] + [t_lo, t_hi, t_star]:
        d2 = torch.minimum(d2, f(t))
    return d2


def _active_boxes(centers, halfs, mask):
    """Each lane's active boxes first, in index order: (L, A, 3) twice and
    (L, A) bool, A the most any lane has."""

    order = torch.sort((~mask).to(torch.int8), dim=1, stable=True).indices
    A = int(mask.sum(dim=1).max()) if mask.numel() else 0
    idx = order[:, :A]
    take = lambda t: torch.gather(t, 1, idx[..., None].expand(-1, -1, 3))  # noqa: E731
    return take(centers), take(halfs), torch.gather(mask, 1, idx)


def capsule_contacts(p0, p1, r, centers, halfs, mask):
    """(L, B, C, A) bool: contact of every capsule with every active box of
    its lane, the A active boxes in index order (lanes with fewer active
    boxes are padded with boxes that never make contact).

    Only the pairs ``envs/geometry.py::near_pairs`` keeps go through the
    exact test; every other pair is farther apart than the radius.
    """

    # inactive boxes never make contact: evaluate the active ones only
    centers, halfs, on = _active_boxes(centers, halfs, mask)
    L, B, C = p0.shape[:3]
    A = centers.shape[1]
    lo = torch.minimum(p0, p1)[:, :, :, None, :]  # (L, B, C, 1, 3)
    hi = torch.maximum(p0, p1)[:, :, :, None, :]
    reach = torch.where(on[:, None, None, :], r[None, None, :, None], -torch.inf)
    idx = near_pairs(lo, hi, (centers - halfs)[:, None, None], (centers + halfs)[:, None, None],
                     reach)
    out = torch.zeros((L, B, C, A), dtype=torch.bool, device=p0.device)
    lane, b, c, a = idx
    q0, q1 = p0[lane, b, c], p1[lane, b, c]  # (K, 3)
    ctr, half = centers[lane, a], halfs[lane, a]
    u = [q0[:, i] - ctr[:, i] for i in range(3)]
    v = [q1[:, i] - q0[:, i] for i in range(3)]
    h = [half[:, i] for i in range(3)]
    rc = r[c]
    out[idx] = _seg_box_sq_dist_rows(u, v, h) < rc * rc
    return out


def capsules_hit_reference(p0, p1, r, centers, halfs, mask):
    """Plain PyTorch version: (L, B) bool from (L, B, C, 3) endpoints, (C,)
    radii, each lane's (L, O, 3) centres and half-extents and (L, O)
    active-box mask."""

    return capsule_contacts(p0, p1, r, centers, halfs, mask).flatten(2).any(dim=2)


def chain_states_free_reference(qs, packed: PackedChain, scene):
    """Plain PyTorch version of ``chain_states_free``: the chain is read back
    from its packed buffers, then limits, ``capsules_world`` and
    ``capsules_hit_reference`` as ``envs/kuka.py``'s CPU path runs them."""

    chain = unpack_chain(packed)
    L, B, dof = qs.shape
    valid = ((qs >= chain.lower) & (qs <= chain.upper)).all(dim=-1)
    p0, p1, r = capsules_world(chain, qs.reshape(L * B, dof))
    C = p0.shape[1]
    hit = capsules_hit_reference(p0.reshape(L, B, C, 3), p1.reshape(L, B, C, 3), r,
                                 scene.centers, scene.halfs, scene.mask)
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


def lanes_for(total: int) -> int:
    """Lanes a configuration, in both kernels, for a launch of ``total``
    configurations (lanes of problems times configurations a lane)."""

    return 16 if total >= LANES_16_FROM else 32


def _check_scene(centers, halfs, mask, L, dev):
    O = centers.shape[-2] if centers.dim() == 3 else -1
    _check("centers", centers, torch.float32, (L, O, 3), dev)
    _check("halfs", halfs, torch.float32, (L, O, 3), dev)
    _check("mask", mask, torch.bool, (L, O), dev)
    return O


def capsules_hit(p0, p1, r, centers, halfs, mask):
    """(L, B) bool: does any capsule of a configuration touch an active box
    of its lane's scene?

    p0, p1: (L, B, C, 3) float32, B configurations in each of L lanes (one
    problem a lane; a single problem is L = 1); r: (C,) float32; centers,
    halfs: (L, O, 3) float32; mask: (L, O) bool. CPU tensors take the plain
    version; CUDA tensors launch the kernel once for all lanes (and count
    the launch).
    """

    if p0.device.type == "cpu":
        return capsules_hit_reference(p0, p1, r, centers, halfs, mask)
    if p0.device.type != "cuda":
        raise ValueError(f"capsules_hit has no kernel for {p0.device}")
    if p0.dim() != 4:
        raise ValueError(f"p0 must be (L, B, C, 3), got {tuple(p0.shape)}")
    L, B, C = p0.shape[:3]
    dev = p0.device
    _check("p0", p0, torch.float32, (L, B, C, 3), dev)
    _check("p1", p1, torch.float32, (L, B, C, 3), dev)
    _check("r", r, torch.float32, (C,), dev)
    O = _check_scene(centers, halfs, mask, L, dev)
    if O > MAX_BOXES:
        raise ValueError(f"capsules_hit takes at most {MAX_BOXES} boxes, got {O}")
    out = torch.empty((L, B), dtype=torch.bool, device=dev)
    if L * B == 0:
        return out
    _launch("capsules_hit", dev, p0.data_ptr(), p1.data_ptr(), r.data_ptr(),
            centers.data_ptr(), halfs.data_ptr(), mask.data_ptr(), L, B, C, O,
            out.data_ptr(), lanes_for(L * B))
    return out


def chain_states_free(qs, packed: PackedChain, scene, endpoints=None):
    """(free (L, B) bool, n_checks (L, B) int32) for joint configurations qs.

    qs: (L, B, dof) float32, B configurations in each of L lanes; packed:
    ``pack_chain`` of the robot; scene: each lane's centers, halfs
    (L, O, 3) float32 and mask (L, O) bool. A configuration is valid when
    every joint lies within its limits (NaN is not); free = valid and no
    capsule touches an active box of its lane; n_checks = valid. CPU
    tensors take the plain version; CUDA tensors launch the fused kernel
    once for all lanes (and count the launch). ``endpoints``, two
    (L, B, C, 3) float32 CUDA tensors or None, receive the kernel's capsule
    endpoints for every configuration: a diagnostic, None on the main path.
    """

    if qs.device.type == "cpu":
        return chain_states_free_reference(qs, packed, scene)
    if qs.device.type != "cuda":
        raise ValueError(f"chain_states_free has no kernel for {qs.device}")
    J, C, dof = packed.sizes
    if qs.dim() != 3:
        raise ValueError(f"qs must be (L, B, dof), got {tuple(qs.shape)}")
    L, B = qs.shape[:2]
    dev = qs.device
    _check("qs", qs, torch.float32, (L, B, dof), dev)
    n_floats, n_ints = packed_lengths(J, C, dof)
    _check("packed floats", packed.floats, torch.float32, (n_floats,), dev)
    _check("packed ints", packed.ints, torch.int32, (n_ints,), dev)
    O = _check_scene(scene.centers, scene.halfs, scene.mask, L, dev)
    if J > MAX_JOINTS or dof > J or C > MAX_CAPSULES or O > MAX_BOXES:
        raise ValueError(
            f"chain_states_free takes at most {MAX_JOINTS} joints, {MAX_CAPSULES} "
            f"capsules and {MAX_BOXES} boxes, got J={J} dof={dof} C={C} O={O}"
        )
    ptr0 = ptr1 = None
    if endpoints is not None:
        for name, t in zip(("endpoints p0", "endpoints p1"), endpoints):
            _check(name, t, torch.float32, (L, B, C, 3), dev)
        ptr0, ptr1 = endpoints[0].data_ptr(), endpoints[1].data_ptr()
    free = torch.empty((L, B), dtype=torch.bool, device=dev)
    n_checks = torch.empty((L, B), dtype=torch.int32, device=dev)
    if L * B == 0:
        return free, n_checks
    _launch("chain_states_free", dev, qs.data_ptr(), L, B, dof, packed.floats.data_ptr(),
            packed.ints.data_ptr(), J, C, scene.centers.data_ptr(), scene.halfs.data_ptr(),
            scene.mask.data_ptr(), O, free.data_ptr(), n_checks.data_ptr(), ptr0, ptr1,
            lanes_for(L * B))
    return free, n_checks
