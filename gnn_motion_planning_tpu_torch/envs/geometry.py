"""Segment-vs-AABB squared distance (port of envs/geometry.py).

The same candidate set, guards and order of operations as
gnn_motion_planning_tpu/envs/geometry.py::seg_box_sq_dist, broadcasting
over leading batch dimensions.
"""

from __future__ import annotations

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
