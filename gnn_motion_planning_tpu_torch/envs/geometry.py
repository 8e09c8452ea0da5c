"""Segment-vs-AABB and segment-vs-segment squared distances (port of
gnn_motion_planning_tpu/envs/geometry.py).

The same candidate sets, guards and order of operations as the JAX
functions, broadcasting over leading batch dimensions; and the contact test
over a list of capsule pairs that the arm oracles build on them.

Rounding follows XLA's CPU code for the JAX package's oracles
(``jit(vmap(state_free))``). XLA's backend contracts a product into the sum
that consumes it, as one fused multiply-add, wherever both sit in one loop
body; read off the compiled programs (``--xla_dump_to``: the fusions'
``ir-with-opt.ll`` and object code) the contractions are:

* seg_box_sq_dist: ``u + t v`` (every candidate point, the bracket
  midpoint); f'(t)'s sum, ``fma(v2, g2, fma(v1, g1, v0 g0))``; f(t)'s sum
  of squares, ``fma(d2, d2, fma(d0, d0, d1 d1))``; the vertex denominator
  ``sum(alpha ** 2)`` as f'(t)'s. The vertex numerator ``sum(alpha beta)``
  stays three rounded products added in order (XLA moves the active-set
  select between the products and the sum).
* seg_seg_sq_dist: the dot products ``d2.r``, ``d1.r``, ``d1.d2`` and the
  final ``|diff|^2`` as f'(t)'s sum; ``a e - b b``, ``b f - c e``, ``b s +
  f``, ``b t - c``, ``p0 + s d1`` and ``q0 + t d2`` each one fused
  multiply-add on the first product. The squared lengths ``a = |d1|^2``
  and ``e = |d2|^2`` are computed once per capsule in a loop that XLA
  vectorises eight capsules at a time, without contraction, and only the
  capsules it leaves to its scalar loop get the fused sum (``fused_len``,
  :func:`vector_tail`).

Fused steps go through ``kinematics.fma32`` (one rounding, on every
device), so the CPU, the card and XLA give the same bits.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.kinematics import dot3_fused, fma32

EPS = 1e-12
# two segments whose bounding boxes lie farther apart than their contact
# distance plus this (metres) cannot touch, whatever the rounding
_FAR_MARGIN = 1e-3
# how many capsules of a length-C list XLA's CPU code runs in its vector
# loop of squared lengths (the rest, its scalar tail, take the fused sum),
# read off the compiled oracles (module docstring) for the lists the
# oracles have: snake7 (10), one kuka14 arm (24), ur5 (43); the tests hold
# each against XLA
_VECTORISED = {10: 0, 24: 24, 43: 40}


def point_box_sq_dist(p, center, half):
    """Squared distance from points to an AABB's surface, 0 inside (JAX
    envs/geometry.py:18-22): the squares summed in order."""

    d = torch.clamp_min((p - center).abs() - half, 0.0)
    return (d * d).sum(dim=-1)


def _sum_sq_pair_first(d):
    """``fma(d2, d2, fma(d0, d0, d1 * d1))`` over the last axis."""

    return fma32(d[..., 2], d[..., 2], fma32(d[..., 0], d[..., 0], d[..., 1] * d[..., 1]))


def seg_box_sq_dist(p0, p1, center, half):
    """Exact min squared distance between segment [p0, p1] and an AABB.

    f(t) = sum_i max(|u_i + v_i t| - h_i, 0)^2 is convex piecewise-quadratic:
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
    u8, v8, h8 = u[..., None, :], v[..., None, :], half[..., None, :]

    def f(t):
        d = torch.clamp_min(fma32(t[..., :, None], v8, u8).abs() - h8, 0.0)
        return _sum_sq_pair_first(d)

    w = fma32(cands[..., :, None], v8, u8)  # (..., 8, 3)
    excess = torch.clamp_min(w.abs() - h8, 0.0)
    g = dot3_fused(2.0 * torch.sign(w) * excess, v8.expand_as(w))  # (..., 8)
    t_lo = torch.where(g < 0, cands, 0.0).amax(dim=-1)
    t_hi = torch.where(g > 0, cands, 1.0).amin(dim=-1)
    t_hi = torch.maximum(t_hi, t_lo)

    mid = 0.5 * (t_lo + t_hi)
    wm = fma32(mid[..., None], v, u)
    active = wm.abs() > half
    s = torch.sign(wm)
    alpha = torch.where(active, s * v, 0.0)
    beta = torch.where(active, s * u - half, 0.0)
    denom = dot3_fused(alpha, alpha)
    ab = alpha * beta
    t_star = -((ab[..., 0] + ab[..., 1]) + ab[..., 2]) / torch.clamp_min(denom, EPS)
    t_star = torch.minimum(torch.maximum(t_star, t_lo), t_hi)

    f_all = torch.cat([f(cands), f(torch.stack([t_lo, t_hi, t_star], dim=-1))], dim=-1)
    return f_all.amin(dim=-1)


def sq_len(d, fused):
    """|d|^2 over the last axis: in order without contraction, or, where
    ``fused`` (broadcast to the batch shape), as f'(t)'s fused sum."""

    sq = d * d
    plain = (sq[..., 0] + sq[..., 1]) + sq[..., 2]
    if fused is False:
        return plain
    return torch.where(torch.as_tensor(fused, device=d.device), dot3_fused(d, d), plain)


def vector_tail(n: int) -> np.ndarray:
    """(n,) bool: the entries of a length-n capsule list that XLA's CPU
    code runs outside its vector loop (``fused_len``), for the lengths
    recorded in ``_VECTORISED``; any other length raises, as the split
    depends on the compiled loop and is not guessed."""

    if n not in _VECTORISED:
        raise ValueError(
            f"no record of how XLA's CPU code splits a loop over {n} capsules; read it "
            "off the compiled oracle (module docstring) and add it to _VECTORISED")
    return np.arange(n) >= _VECTORISED[n]


def seg_seg_sq_dist(p0, p1, q0, q1, eps: float = EPS, a_fused=False, e_fused=False):
    """Min squared distance between segments [p0, p1] and [q0, q1] (closed
    form, Ericson, Real-Time Collision Detection 5.1.9), broadcastable: the
    JAX function's guards, and its order: s from the unclamped solve gives
    t, t is clamped, then s is always solved again from the clamped t.
    ``a_fused`` and ``e_fused`` (bool, or bool tensors of the batch shape)
    say which squared lengths take the fused sum (module docstring)."""

    d1 = p1 - p0
    d2 = q1 - q0
    r = p0 - q0
    d1, d2, r = torch.broadcast_tensors(d1, d2, r)
    # products of one kind go through one fused multiply-add over stacked
    # operands: the same values, fewer tensor ops on a card
    a, e = sq_len(torch.stack([d1, d2]), _stack_flags(a_fused, e_fused, d1)).unbind(0)
    f, c, b = dot3_fused(torch.stack([d2, d1, d1]), torch.stack([r, r, d2])).unbind(0)
    denom, num = fma32(torch.stack([a, b]), torch.stack([e, f]),
                       torch.stack([-(b * b), -(c * e)])).unbind(0)

    ok = denom > eps
    s = torch.where(ok, (num / torch.where(ok, denom, 1.0)).clamp(0.0, 1.0), 0.0)
    ok = e > eps
    t = torch.where(ok, fma32(b, s, f) / torch.where(ok, e, 1.0), 0.0)
    t = t.clamp(0.0, 1.0)
    ok = a > eps
    s = torch.where(ok, (fma32(b, t, -c) / torch.where(ok, a, 1.0)).clamp(0.0, 1.0), 0.0)

    p0, q0 = torch.broadcast_tensors(p0, q0)
    cp, cq = fma32(torch.stack([s, t])[..., None], torch.stack([d1, d2]),
                   torch.stack([p0, q0])).unbind(0)
    diff = cp - cq
    return dot3_fused(diff, diff)


def _stack_flags(a_fused, e_fused, like):
    """The ``fused`` argument of :func:`sq_len` for stacked (d1, d2)."""

    if a_fused is False and e_fused is False:
        return False
    shape = like.shape[:-1]
    flag = lambda x: torch.as_tensor(x, device=like.device).expand(shape)  # noqa: E731
    return torch.stack([flag(a_fused), flag(e_fused)])


def near_pairs(lo_a, hi_a, lo_b, hi_b, reach):
    """The pairs of axis-aligned boxes [lo_a, hi_a] and [lo_b, hi_b]
    (broadcast, xyz on the last axis) whose gap is at most ``reach``
    (broadcast to the pairs' shape) plus ``_FAR_MARGIN``, as index tensors
    (``nonzero``): the only pairs of segments inside these boxes that can
    come within ``reach`` of each other. Both narrow phases run their exact
    test on these pairs alone, on every device: each pair's value does not
    depend on the others, so the decisions are the exact test's over all
    pairs."""

    gap = torch.maximum(lo_b - hi_a, lo_a - hi_b).amax(dim=-1)
    return (gap <= reach + _FAR_MARGIN).nonzero(as_tuple=True)


def pair_contacts(p0, p1, pairs):
    """(..., B) bool: does any listed capsule pair of a configuration come
    closer than its contact distance? p0, p1: (..., B, C, 3) capsule
    endpoints; ``pairs``: :func:`contact_pairs`. The pairs a JAX oracle
    masks out are simply not listed; of the listed ones only those
    :func:`near_pairs` keeps go through the exact test."""

    i, j, r2, a_fused, e_fused = pairs
    lead, C = p0.shape[:-2], p0.shape[-2]
    p0, p1 = p0.reshape(-1, C, 3), p1.reshape(-1, C, 3)
    lo, hi = torch.minimum(p0, p1), torch.maximum(p0, p1)
    row, k = near_pairs(lo[:, i], hi[:, i], lo[:, j], hi[:, j], torch.sqrt(r2))
    d2 = seg_seg_sq_dist(p0[row, i[k]], p1[row, i[k]], p0[row, j[k]], p1[row, j[k]],
                         a_fused=a_fused[k], e_fused=e_fused[k])
    hit = torch.zeros(p0.shape[0], dtype=torch.bool, device=p0.device)
    hit[row[d2 < r2[k]]] = True
    return hit.reshape(lead)


def contact_pairs(pair_mask: np.ndarray, r: np.ndarray, device, fused_len=None):
    """The pairs of a mask as index lists, row-major, the squared sums of
    their radii, formed in float32 as ``(r_i + r_j) ** 2``, and which of
    their squared lengths take the fused sum: ``fused_len`` (C,) bool per
    capsule, by default :func:`vector_tail` of all C capsules (the JAX
    oracle tests one list of capsules against itself)."""

    i, j = np.nonzero(pair_mask)
    r = np.asarray(r, np.float32)
    s = r[i] + r[j]
    if fused_len is None:
        fused_len = vector_tail(pair_mask.shape[0])
    return tuple(torch.as_tensor(a, device=device)
                 for a in (i, j, s * s, fused_len[i], fused_len[j]))
