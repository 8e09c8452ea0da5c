"""Batched capsule-vs-AABB contact decisions: the port of the TPU kernel
``gnn_motion_planning_tpu/ops/pallas_capsule.py::capsules_hit``.

``capsules_hit`` answers, for each of B configurations, whether any of its
C capsules (segment p0 -> p1, radius r) comes closer than r to any active
axis-aligned box. For a CUDA tensor it launches the hand-written kernel in
``csrc/capsules_hit.cu``, built at first use with plain ``nvcc`` and bound
with ``ctypes``; for a CPU tensor it runs ``capsules_hit_reference``, the
plain PyTorch version of the same arithmetic. There is no fallback from one
to the other: a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
from pathlib import Path

import torch

from gnn_motion_planning_tpu_torch.utils.build import build_shared_library

_EPS = 1e-12
CSRC = Path(__file__).resolve().parents[1] / "csrc" / "capsules_hit.cu"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
]
MAX_BOXES = 1024  # dynamic shared memory: 7 floats per box
# fp32 operations per (state, capsule, active box), counted from the kernel
# (each add, multiply, divide, compare, select, min, max and abs is one)
OPS_PER_PAIR = 680

# kernel launches since the last reset, by kernel name
LAUNCHES = {"capsules_hit": 0}

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
        lib.capsules_hit_launch.restype = ctypes.c_int
        lib.capsules_hit_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    return _lib


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


def capsules_hit_reference(p0, p1, r, centers, halfs, mask):
    """Plain PyTorch version: (B,) bool from (B, C, 3) endpoints, (C,) radii,
    (O, 3) centres and half-extents and an (O,) active-box mask."""

    # inactive boxes never make contact: evaluate the active ones only
    active = mask.nonzero().flatten()
    centers, halfs = centers[active], halfs[active]
    v = p1 - p0  # (B, C, 3)
    u = [p0[:, :, None, i] - centers[None, None, :, i] for i in range(3)]  # (B, C, A)
    vv = [v[:, :, None, i].expand_as(u[0]) for i in range(3)]
    h = [halfs[None, None, :, i] for i in range(3)]
    r2 = (r * r)[None, :, None]
    return _seg_box_contact(u, vv, h, r2).flatten(1).any(dim=1)


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


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
    out = torch.zeros(B, dtype=torch.int32, device=dev)
    if B == 0 or C == 0 or O == 0:
        return out.bool()
    lib = load_library()
    with torch.cuda.device(dev):  # the launch goes to the current device
        err = lib.capsules_hit_launch(
            p0.data_ptr(), p1.data_ptr(), r.data_ptr(), centers.data_ptr(),
            halfs.data_ptr(), mask.data_ptr(), B, C, O, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"capsules_hit kernel launch failed: cudaError {err}")
    LAUNCHES["capsules_hit"] += 1
    return out.bool()
