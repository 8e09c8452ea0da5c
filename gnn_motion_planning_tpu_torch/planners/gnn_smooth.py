"""GNN smoothing: model proposals projected onto the free space (port of
gnn_motion_planning_tpu/planners/gnn_smooth.py).

Each Gauss-Seidel step of the projection hoists all edge checks out of the
sequential accept chain: one batched check evaluates, for every path slot,
both variants of the previous node (kept or accepted) and the next segment.
The chain itself (64 booleans, an int count and a float32 sum) is then
resolved on the host with the same float32 accumulation order, which is
also where the step's ``converged`` test has to be read anyway. Paths of
several problems (lanes, ``api/batched.py``) go through one projection
together; one path is the same code with one lane.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import BIG, EnvKernels, one_lane
from gnn_motion_planning_tpu_torch.envs.kinematics import norm_last

_CONVERGED = np.float32(1e-5)


def _resolve(okA, cA, okB, cB, ok2, c2, interior, dnorm, count, ovA, ovB, ov2):
    """Sequential accept scan (gnn_smooth.py:95-111) on host arrays:
    returns (accepted (L,) bool, count, diff float32, overflow). A check's
    overflow (the cheap budget's) counts only where its result is used."""

    L = len(okA)
    accepted = np.zeros(L, bool)
    prev_acc = False
    overflow = False
    diff = np.float32(0.0)
    for i in range(L):
        ok1 = okB[i] if prev_acc else okA[i]
        c1 = cB[i] if prev_acc else cA[i]
        ov1 = ovB[i] if prev_acc else ovA[i]
        acc = bool(interior[i] and ok1 and ok2[i])
        if interior[i]:
            count += int(c1) + (int(c2[i]) if ok1 else 0)
            overflow |= bool(ov1 or (ok1 and ov2[i]))
        if acc:
            diff = np.float32(diff + dnorm[i])
        accepted[i] = acc
        prev_acc = acc
    return accepted, count, diff, overflow


def _candidates(kernels, path, new_path, rrt_eps, n_path):
    """Per lane (leading axis P): the steered candidates, both variants of
    each slot's previous node, the next node and the interior mask."""

    L = path.shape[1]
    dev = path.device
    dist = norm_last(path - new_path)
    steer = kernels.interpolate(path, new_path, rrt_eps / torch.clamp_min(dist, 1e-30))
    cand = torch.where((dist < rrt_eps)[..., None], new_path, steer)
    i = torch.arange(L, device=dev)
    prev_old = path[:, torch.clamp_min(i - 1, 0)]
    prev_cand = cand[:, torch.clamp_min(i - 1, 0)]
    nxt = path[:, torch.clamp_max(i + 1, L - 1)]
    interior = (i >= 1) & (i <= n_path[:, None] - 2)
    return cand, prev_old, prev_cand, nxt, interior


def _outer_steps(old_path, new_path, n_path, rrt_eps) -> list:
    live = torch.arange(old_path.shape[1], device=old_path.device) < n_path[:, None]
    disp = norm_last(old_path - new_path)
    k = torch.ceil(torch.where(live, disp, 0.0).amax(dim=1) / rrt_eps).to(torch.int32)
    return k.tolist()


def _flat_checks(kernels, scene, qa, qb, e_int, rrt_eps, slots):
    """The flat-packed edge checks of one sweep step for every lane: per
    edge its two endpoints and K = int(d / eps) interior points, interior
    path nodes only, packed into ``slots`` states a lane and checked in one
    oracle call. Returns (ok (P, E), count (P, E), overflow (P,))."""

    lower, upper = kernels.bounds
    P, E = qa.shape[:2]
    dev = qa.device
    s = torch.arange(slots, device=dev).expand(P, slots).contiguous()
    valid_e = ((qa >= lower) & (qa <= upper)).all(-1) & ((qb >= lower) & (qb <= upper)).all(-1)
    d_e = kernels.distance(qa, qb)
    K_e = torch.where(e_int, (d_e / rrt_eps).to(torch.int64), 0)
    n_slot = torch.where(e_int, K_e + 2, 0)  # [qa, qb, interior...]
    cum = torch.cumsum(n_slot, 1)
    offs = cum - n_slot
    total = cum[:, -1]

    eid = torch.clamp_max(torch.searchsorted(cum, s, right=True), E - 1)
    t = s - offs.gather(1, eid)
    in_use = s < total[:, None]
    take = lambda x: torch.gather(x, 1, eid[..., None].expand(-1, -1, x.shape[-1]))  # noqa: E731
    qa_s, qb_s = take(qa), take(qb)
    Kf = torch.clamp_min(K_e.gather(1, eid), 1).to(qa.dtype)
    coeff = (t - 2).to(qa.dtype) / Kf
    pt = torch.where(
        (t == 0)[..., None],
        qa_s,
        torch.where((t == 1)[..., None], qb_s, qa_s + coeff[..., None] * (qb_s - qa_s)),
    )
    free_s, _ = kernels.batch_state_free(scene, pt)
    free_s = free_s | ~in_use

    off_c = torch.clamp_max(offs, slots - 1)
    fa = free_s.gather(1, off_c)
    fb = free_s.gather(1, torch.clamp_max(off_c + 1, slots - 1))
    fail = in_use & (t >= 2) & ~free_s
    ff = torch.full((P, E), BIG, dtype=torch.int64, device=dev).scatter_reduce(
        1, eid, torch.where(fail, t - 2, BIG), "amin", include_self=True
    )
    int_free = ff == BIG
    int_cnt = torch.where(int_free, K_e, ff + 1)
    ok_e = valid_e & fa & fb & int_free
    zero = torch.zeros_like(int_cnt)
    cnt_e = torch.where(
        valid_e, 1 + torch.where(fa, 1 + torch.where(fb, int_cnt, zero), zero), zero
    )
    return ok_e, cnt_e, total > slots


def make_projection_lanes(kernels: EnvKernels, rrt_eps: float, flat: bool, slots: int = 4096,
                          cheap: bool = False):
    """proposed_path_smootherv2 (smoother.py:194-216) for P paths at once,
    each with its own scene lane (JAX ``jax.vmap(project_core)``,
    planner_bundle.py:365): ``project(scene, old_path (P, L, d), new_path,
    n_path (P,)) -> (paths (P, L, d), counts [P], overflow [P])``.

    Each Gauss-Seidel step hoists all edge checks of the sequential accept
    chain out of it: for every slot both variants of the previous node
    (kept or accepted) and the next segment, in one oracle call for all
    paths. The chain itself is resolved on the host, where the step's
    ``converged`` test is read anyway. A path stops at its own step count
    or convergence, as under ``vmap``.

    ``flat`` (envs with kernel bounds, JAX ``make_projection_core_flat``,
    gnn_smooth.py:151-308) checks only the states the sweep counts, packed
    into ``slots`` states a path; a path whose step needs more raises its
    overflow flag, and the caller redoes it at the full budget. Otherwise
    every edge goes through the env's full ``edge_free`` or, with ``cheap``
    where the env has one, its ``edge_free_cheap`` at the K_CHEAP budget
    (JAX ``make_projection_core(cheap=True)``, gnn_smooth.py:31-44): equal
    decisions and counts unless a check whose result is used overflowed,
    which sets the path's flag.
    """

    if flat:
        assert kernels.bounds is not None, "flat projection needs kernel bounds"
    edge_cheap = kernels.edge_free_cheap if cheap else None

    def project(scene, old_path, new_path, n_path):
        P, L = old_path.shape[:2]
        dev = old_path.device
        n_path = torch.as_tensor(n_path, device=dev).reshape(P)
        steps = _outer_steps(old_path, new_path, n_path, rrt_eps)
        path = old_path
        counts, overflow = [0] * P, [False] * P
        running = [k > 0 for k in steps]
        for step in range(max(steps, default=0)):
            if not any(running):
                break
            cand, prev_old, prev_cand, nxt, interior = _candidates(
                kernels, path, new_path, rrt_eps, n_path
            )
            qa = torch.cat([prev_old, prev_cand, nxt], dim=1)  # (P, 3L, d)
            qb = cand.repeat(1, 3, 1)
            if flat:
                ok, cnt, ovf = _flat_checks(kernels, scene, qa, qb, interior.repeat(1, 3),
                                            rrt_eps, slots)
            elif edge_cheap is not None:
                ok, cnt, ovf_e = edge_cheap(scene, qa, qb)
                ovf = torch.zeros(P, dtype=torch.bool, device=dev)
            else:
                ok, cnt = kernels.edge_free(scene, qa, qb)
                ovf = torch.zeros(P, dtype=torch.bool, device=dev)
            if edge_cheap is None or flat:
                ovf_e = torch.zeros_like(ok)
            dnorm = norm_last(cand - new_path)
            host = torch.cat([
                ok.to(torch.float64), cnt.to(torch.float64), dnorm.to(torch.float64),
                interior.to(torch.float64), ovf_e.to(torch.float64), ovf.to(torch.float64)[:, None],
            ], dim=1).cpu().numpy()
            accepted = np.zeros((P, L), bool)
            for i in range(P):
                if not running[i]:
                    continue
                h = host[i]
                okh, cnth = h[: 3 * L] > 0.5, h[3 * L : 6 * L].astype(np.int64)
                ovh = h[8 * L : 11 * L] > 0.5
                accepted[i], counts[i], diff, ovf_i = _resolve(
                    okh[:L], cnth[:L], okh[L : 2 * L], cnth[L : 2 * L], okh[2 * L :],
                    cnth[2 * L :], h[7 * L : 8 * L] > 0.5,
                    h[6 * L : 7 * L].astype(np.float32), counts[i],
                    ovh[:L], ovh[L : 2 * L], ovh[2 * L :],
                )
                overflow[i] |= bool(h[-1] > 0.5) or ovf_i
                running[i] = step + 1 < steps[i] and not diff < _CONVERGED
            acc = torch.as_tensor(accepted, device=dev)
            path = torch.where(acc[..., None], cand, path)
        return path, counts, overflow

    return project


def _first_lane(project, scene, old_path, new_path, n_path: int):
    """One path through a projection of P paths (P = 1)."""

    path, counts, overflow = project(one_lane(scene), old_path[None], new_path[None], [n_path])
    return path[0], counts[0], overflow[0]


def make_projection_core(kernels: EnvKernels, rrt_eps: float, cheap: bool = False):
    """proposed_path_smootherv2 (smoother.py:194-216) for one path: returns
    ``(path, count, overflow)``. At the full edge budget (overflow always
    False) it is the redo path when a faster projection overflows, and the
    only core of envs without kernel bounds (the mazes). With ``cheap``
    (and an env with ``edge_free_cheap``) every check runs at the K_CHEAP
    budget: the same path and count whenever overflow comes back False
    (JAX gnn_smooth.py:31-44)."""

    lanes = make_projection_lanes(kernels, rrt_eps, flat=False, cheap=cheap)

    def project(scene, old_path, new_path, n_path: int):
        return _first_lane(lanes, scene, old_path, new_path, n_path)

    return project


def make_projection_core_flat(kernels: EnvKernels, rrt_eps: float, slots: int = 4096):
    """Flat-packed projection sweep for one path (gnn_smooth.py:151-308):
    the semantics of :func:`make_projection_core`, checking only the states
    the reference sweep counts packed into one ``slots``-wide batch per
    step, which the capsule kernel takes whole. A step needing more than
    ``slots`` states raises the overflow flag."""

    lanes = make_projection_lanes(kernels, rrt_eps, flat=True, slots=slots)

    def project(scene, old_path, new_path, n_path: int):
        return _first_lane(lanes, scene, old_path, new_path, n_path)

    return project


def pad_to_bucket(n: int, step: int = 16) -> int:
    return max(step, ((n + step - 1) // step) * step)


def base_chain_edges(l_pad: int, n_path: int):
    """Path chain (both directions) + self loops with alive mask
    (smoother.py:238-241), as numpy arrays."""

    src, dst, alive = [], [], []
    for i in range(1, l_pad):
        src += [i, i - 1]
        dst += [i - 1, i]
        alive += [i < n_path, i < n_path]
    for i in range(l_pad):
        src.append(i)
        dst.append(i)
        alive.append(i < n_path)
    return np.asarray(src, np.int64), np.asarray(dst, np.int64), np.asarray(alive, bool)
