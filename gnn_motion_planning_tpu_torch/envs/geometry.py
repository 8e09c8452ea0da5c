"""Segment-vs-AABB and segment-vs-segment squared distances (port of
gnn_motion_planning_tpu/envs/geometry.py).

The same candidate sets, guards and order of operations as the JAX
functions, broadcasting over leading batch dimensions; and the contact test
over a list of capsule pairs that the arm oracles build on them.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.kinematics import sum_last

EPS = 1e-12


def seg_box_sq_dist(p0, p1, center, half):
    """Exact min squared distance between segment [p0, p1] and an AABB.

    f(t) = Σ_i max(|u_i + v_i t| - h_i, 0)² is convex piecewise-quadratic:
    the minimum is at an endpoint/breakpoint candidate, or at the vertex of
    the active-set quadratic inside the bracket where f' changes sign.
    """

    u = p0 - center
    v = p1 - p0
    u, v = torch.broadcast_tensors(u, v)
    half = half.expand_as(u)
    big = v.abs() > EPS
    safe_v = torch.where(big, v, torch.ones_like(v))
    t_a = torch.where(big, (half - u) / safe_v, torch.zeros_like(v))
    t_b = torch.where(big, (-half - u) / safe_v, torch.zeros_like(v))
    zeros = torch.zeros_like(u[..., :1])
    cands = torch.cat(
        [zeros, torch.ones_like(zeros), t_a.clamp(0.0, 1.0), t_b.clamp(0.0, 1.0)],
        dim=-1,
    )  # (..., 8)

    def f(t):
        p = u[..., None, :] + t[..., :, None] * v[..., None, :]
        d = torch.clamp_min(p.abs() - half[..., None, :], 0.0)
        return sum_last(d * d)

    w = u[..., None, :] + cands[..., :, None] * v[..., None, :]  # (..., 8, 3)
    excess = torch.clamp_min(w.abs() - half[..., None, :], 0.0)
    g = sum_last(2.0 * torch.sign(w) * excess * v[..., None, :])  # (..., 8)
    t_lo = torch.where(g < 0, cands, 0.0).amax(dim=-1)
    t_hi = torch.where(g > 0, cands, 1.0).amin(dim=-1)
    t_hi = torch.maximum(t_hi, t_lo)

    mid = 0.5 * (t_lo + t_hi)
    wm = u + mid[..., None] * v
    active = wm.abs() > half
    s = torch.sign(wm)
    alpha = torch.where(active, s * v, 0.0)
    beta = torch.where(active, s * u - half, 0.0)
    denom = sum_last(alpha * alpha)
    t_star = -sum_last(alpha * beta) / torch.clamp_min(denom, EPS)
    t_star = torch.minimum(torch.maximum(t_star, t_lo), t_hi)

    f_all = torch.cat([f(cands), f(torch.stack([t_lo, t_hi, t_star], dim=-1))], dim=-1)
    return f_all.amin(dim=-1)


def seg_seg_sq_dist(p0, p1, q0, q1, eps: float = EPS):
    """Min squared distance between segments [p0, p1] and [q0, q1] (closed
    form, Ericson, Real-Time Collision Detection 5.1.9), broadcastable: the
    JAX function's guards, and its order: s from the unclamped solve gives
    t, t is clamped, then s is always solved again from the clamped t."""

    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    a = sum_last(d1 * d1)
    e = sum_last(d2 * d2)
    f = sum_last(d2 * r)
    c = sum_last(d1 * r)
    b = sum_last(d1 * d2)
    denom = a * e - b * b

    ok = denom > eps
    s = torch.where(ok, ((b * f - c * e) / torch.where(ok, denom, 1.0)).clamp(0.0, 1.0), 0.0)
    ok = e > eps
    t = torch.where(ok, (b * s + f) / torch.where(ok, e, 1.0), 0.0)
    t = t.clamp(0.0, 1.0)
    ok = a > eps
    s = torch.where(ok, ((b * t - c) / torch.where(ok, a, 1.0)).clamp(0.0, 1.0), 0.0)

    diff = (p0 + s[..., None] * d1) - (q0 + t[..., None] * d2)
    return sum_last(diff * diff)


def pair_contacts(p0, p1, i, j, r2):
    """(B,) bool: does any listed capsule pair (i[k], j[k]) of a
    configuration come closer than sqrt(r2[k])? p0, p1: (B, C, 3) capsule
    endpoints; i, j: (P,) capsule indexes; r2: (P,) squared contact
    distances. The pairs a JAX oracle masks out are simply not listed."""

    d2 = seg_seg_sq_dist(p0[:, i], p1[:, i], p0[:, j], p1[:, j])
    return (d2 < r2).any(dim=1)


def contact_pairs(pair_mask: np.ndarray, r: np.ndarray, device):
    """The pairs of a mask as index lists, row-major, and the squared sums
    of their radii, formed in float32 as ``(r_i + r_j) ** 2``."""

    i, j = np.nonzero(pair_mask)
    r = np.asarray(r, np.float32)
    s = r[i] + r[j]
    return tuple(torch.as_tensor(a, device=device) for a in (i, j, s * s))
