"""Batched forward kinematics over serial chains, in float32.

Port of gnn_motion_planning_tpu/envs/kinematics.py. The chain is a set of
static tensors on the env's device; FK is a Python loop over the joints,
batched over configurations. The 3x3 products are written out as
elementwise multiplies and in-order sums (no TF32, no fused multiply-add),
so FK gives the same bits on the CPU and the card.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.urdf import RobotModel, rpy_to_matrix


class ChainParams(NamedTuple):
    """Static kinematic-tree arrays: J joints (topo order), frame 0 = root
    link, frame j+1 = child of topo joint j, C capsules."""

    origin_rot: torch.Tensor  # (J, 3, 3)
    origin_trans: torch.Tensor  # (J, 3)
    axis: torch.Tensor  # (J, 3) unit
    cap_link: torch.Tensor  # (C,) frame index
    cap_p0: torch.Tensor  # (C, 3)
    cap_p1: torch.Tensor  # (C, 3)
    cap_r: torch.Tensor  # (C,)
    lower: torch.Tensor  # (dof,)
    upper: torch.Tensor  # (dof,)
    q_index: Tuple[int, ...]  # (J,) index into the config vector, -1 if fixed
    parent_frame: Tuple[int, ...]  # (J,) frame index of the parent link

    def numpy_arrays(self) -> dict:
        """Host copies of every array (the native core's input)."""

        out = {
            k: v.detach().cpu().numpy()
            for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)
        }
        out["q_index"] = np.asarray(self.q_index, np.int32)
        out["parent_frame"] = np.asarray(self.parent_frame, np.int32)
        return out


def chain_from_model(model: RobotModel, device) -> ChainParams:
    origin_rot = np.stack([rpy_to_matrix(j.origin_rpy) for j in model.joints])
    origin_trans = np.stack([j.origin_xyz for j in model.joints])
    axis = np.stack(
        [j.axis / max(np.linalg.norm(j.axis), 1e-12) for j in model.joints]
    )
    q_index = [-1] * len(model.joints)
    for qi, ji in enumerate(model.movable):
        q_index[ji] = qi
    frame_of = {name: i for i, name in enumerate(model.link_order)}
    pr = model.pose_range()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ChainParams(
        origin_rot=f32(origin_rot),
        origin_trans=f32(origin_trans),
        axis=f32(axis),
        cap_link=torch.as_tensor(
            [frame_of[c.link] for c in model.capsules], dtype=torch.long, device=device
        ),
        cap_p0=f32(np.stack([c.p0 for c in model.capsules])),
        cap_p1=f32(np.stack([c.p1 for c in model.capsules])),
        cap_r=f32([c.radius for c in model.capsules]),
        lower=f32(pr[:, 0]),
        upper=f32(pr[:, 1]),
        q_index=tuple(q_index),
        parent_frame=tuple(frame_of[j.parent] for j in model.joints),
    )


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, ((x0 + x1) + x2) + ...

    A fixed order keeps small reductions (3 coordinates, 7 joints) the same
    on every device, where ``torch.sum`` may split them into partial sums.
    """

    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, the value of a fused
    multiply-add (CUDA's ``fmaf``, and what XLA's CPU code forms where it
    contracts a product into a sum), on every device.

    The product of two float32 is exact in float64; the sum is split into
    its float64 rounding and the exact remainder (Knuth's two-sum), and the
    float64 result is rounded to odd before the final rounding to float32,
    so that the double rounding is exact (53 bits >= 24 + 2). ``a`` may be a Python number.
    """

    a = a.double() if isinstance(a, torch.Tensor) else float(a)
    p = a * b.double()
    c = c.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)).add_(p - bb)
    # round to odd: truncate toward zero, then set the last bit if inexact
    inexact = err != 0
    toward_zero = inexact & ((err > 0) != (s > 0))
    bits = (s.view(torch.int64) - toward_zero.to(torch.int64)) | inexact.to(torch.int64)
    return bits.view(torch.float64).float()


def dot3_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3 entries) of ``x * y`` as XLA's CPU code
    forms a product-sum reduction it does not vectorise across rows:
    ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""

    acc = x[..., 0] * y[..., 0]
    acc = fma32(x[..., 1], y[..., 1], acc)
    return fma32(x[..., 2], y[..., 2], acc)


def norm_last(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(x ** 2))``, rounded as
    XLA's CPU code rounds it, so that lengths, and the step counts
    ``int(d / eps)`` taken from them, are the JAX package's.

    XLA sums the squares in index order, each step a fused multiply-add,
    except where it vectorises: rows of 5 to 8 entries it takes four at a
    time in vector registers, each step a multiply and an add, and only the
    rows left over past a multiple of four get fused multiply-adds. Rows
    run along the second-to-last axis; an axis before it (lanes of
    problems) repeats the rule, so each lane rounds as its own call does. Fused steps are formed here in
    float64 and rounded once (the square of a float32 is exact there); the
    sqrt too, since torch's float32 sqrt on the CPU is not correctly
    rounded. The CPU and the card give the same bits.
    """

    d = x.shape[-1]
    x64 = x.double()
    acc = (x64[..., 0] * x64[..., 0]).float()
    for i in range(1, d):
        acc = (acc.double() + x64[..., i] * x64[..., i]).float()
    if 5 <= d <= 8 and x.dim() >= 2:
        plain = x[..., 0] * x[..., 0]
        for i in range(1, d):
            plain = plain + x[..., i] * x[..., i]
        rows = x.shape[-2]
        vector = torch.arange(rows, device=x.device) < rows // 4 * 4
        acc = torch.where(vector, plain, acc)
    return torch.sqrt(acc.double()).float()


def matmul3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3, 3) with in-order sums."""

    return sum_last(a[..., :, None, :] * b.transpose(-1, -2)[..., None, :, :])


def matvec3(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) with in-order sums."""

    return sum_last(a * x[..., None, :])


def _axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation about a unit axis, batched over ``angle`` (B,)."""

    x, y, z = axis[0], axis[1], axis[2]
    c, s = torch.cos(angle), torch.sin(angle)
    C = 1.0 - c
    rows = [
        [x * x * C + c, x * y * C - z * s, x * z * C + y * s],
        [y * x * C + z * s, y * y * C + c, y * z * C - x * s],
        [z * x * C - y * s, z * y * C + x * s, z * z * C + c],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def fk_link_frames(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None):
    """World (R, t) of every link frame for configurations q (B, dof):
    (B, J+1, 3, 3) and (B, J+1, 3). The root frame is ``base_rot`` (3, 3)
    or (B, 3, 3) and ``base_trans`` (3,) or (B, 3); identity and the
    origin when None."""

    B = q.shape[0]
    if base_rot is None:
        base_rot = torch.eye(3, dtype=torch.float32, device=q.device)
    if base_trans is None:
        base_trans = torch.zeros(3, dtype=torch.float32, device=q.device)
    Rs = [base_rot.expand(B, 3, 3)]
    ts = [base_trans.expand(B, 3)]
    zero = torch.zeros(B, dtype=torch.float32, device=q.device)
    for j, (pf, qi) in enumerate(zip(chain.parent_frame, chain.q_index)):
        R, t = Rs[pf], ts[pf]
        angle = q[:, qi] if qi >= 0 else zero
        Rq = _axis_angle(chain.axis[j], angle)
        Rs.append(matmul3(matmul3(R, chain.origin_rot[j].expand(B, 3, 3)), Rq))
        ts.append(matvec3(R, chain.origin_trans[j].expand(B, 3)) + t)
    return torch.stack(Rs, dim=1), torch.stack(ts, dim=1)


def capsules_world(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None):
    """Capsule endpoints in the world frame for q (B, dof): (B, C, 3) twice,
    and the radii (C,). ``base_rot`` and ``base_trans`` place the root
    frame, as in :func:`fk_link_frames`."""

    Rs, ts = fk_link_frames(chain, q, base_rot, base_trans)
    R = Rs[:, chain.cap_link]  # (B, C, 3, 3)
    t = ts[:, chain.cap_link]  # (B, C, 3)
    p0 = matvec3(R, chain.cap_p0.expand_as(t)) + t
    p1 = matvec3(R, chain.cap_p1.expand_as(t)) + t
    return p0, p1, chain.cap_r


def lane_capsules(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None):
    """Capsule endpoints of configurations q (L, B, dof) in lanes: (L, B, C,
    3) twice, contiguous, from one :func:`capsules_world` over all L B
    configurations (``base_rot`` and ``base_trans`` per configuration, with
    the same leading axes, or shared)."""

    L, B, dof = q.shape

    def flat(t):
        per_config = t is not None and t.dim() >= 3 and tuple(t.shape[:2]) == (L, B)
        return t.reshape((L * B,) + tuple(t.shape[2:])) if per_config else t

    p0, p1, _ = capsules_world(chain, q.reshape(L * B, dof), flat(base_rot), flat(base_trans))
    C = p0.shape[1]
    return p0.reshape(L, B, C, 3).contiguous(), p1.reshape(L, B, C, 3).contiguous()
