"""GNN smoothing: model proposals projected onto the free space (port of
gnn_motion_planning_tpu/planners/gnn_smooth.py).

Each Gauss-Seidel step of the projection hoists all edge checks out of the
sequential accept chain: one batched check evaluates, for every path slot,
both variants of the previous node (kept or accepted) and the next segment.
The chain itself (64 booleans, an int count and a float32 sum) is then
resolved on the host with the same float32 accumulation order, which is
also where the step's ``converged`` test has to be read anyway.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import BIG, EnvKernels
from gnn_motion_planning_tpu_torch.envs.kinematics import sum_last

_CONVERGED = np.float32(1e-5)


def _norm(x):
    return torch.sqrt(sum_last(x * x))


def _resolve(okA, cA, okB, cB, ok2, c2, interior, dnorm, count):
    """Sequential accept scan (gnn_smooth.py:272-282) on host arrays:
    returns (accepted (L,) bool, count, diff float32)."""

    L = len(okA)
    accepted = np.zeros(L, bool)
    prev_acc = False
    diff = np.float32(0.0)
    for i in range(L):
        ok1 = okB[i] if prev_acc else okA[i]
        c1 = cB[i] if prev_acc else cA[i]
        acc = bool(interior[i] and ok1 and ok2[i])
        if interior[i]:
            count += int(c1) + (int(c2[i]) if ok1 else 0)
        if acc:
            diff = np.float32(diff + dnorm[i])
        accepted[i] = acc
        prev_acc = acc
    return accepted, count, diff


def _candidates(kernels, path, new_path, rrt_eps, n_path):
    L = path.shape[0]
    dev = path.device
    dist = _norm(path - new_path)
    steer = kernels.interpolate(path, new_path, rrt_eps / torch.clamp_min(dist, 1e-30))
    cand = torch.where((dist < rrt_eps)[:, None], new_path, steer)
    i = torch.arange(L, device=dev)
    prev_old = path[torch.clamp_min(i - 1, 0)]
    prev_cand = cand[torch.clamp_min(i - 1, 0)]
    nxt = path[torch.clamp_max(i + 1, L - 1)]
    interior = (i >= 1) & (i <= n_path - 2)
    return cand, prev_old, prev_cand, nxt, interior


def _outer_steps(old_path, new_path, n_path, rrt_eps) -> int:
    live = torch.arange(old_path.shape[0], device=old_path.device) < n_path
    disp = _norm(old_path - new_path)
    return int(torch.ceil(torch.where(live, disp, 0.0).amax() / rrt_eps).to(torch.int32))


def make_projection_core(kernels: EnvKernels, rrt_eps: float):
    """proposed_path_smootherv2 (smoother.py:194-216) at the full edge
    budget: returns ``(path, count, overflow)``, overflow always False. The
    redo path when the flat projection overflows, and the only core of envs
    without kernel bounds (the mazes)."""

    def project(scene, old_path, new_path, n_path: int):
        L = old_path.shape[0]
        K = _outer_steps(old_path, new_path, n_path, rrt_eps)
        path, count = old_path, 0
        for _ in range(K):
            cand, prev_old, prev_cand, nxt, interior = _candidates(
                kernels, path, new_path, rrt_eps, n_path
            )
            ok, cnt = kernels.edge_free(scene, torch.cat([prev_old, prev_cand, nxt]), cand.repeat(3, 1))
            ok, cnt = ok.cpu().numpy(), cnt.cpu().numpy()
            dnorm = _norm(cand - new_path).cpu().numpy()
            accepted, count, diff = _resolve(
                ok[:L], cnt[:L], ok[L : 2 * L], cnt[L : 2 * L], ok[2 * L :], cnt[2 * L :],
                interior.cpu().numpy(), dnorm, count,
            )
            acc = torch.as_tensor(accepted, device=path.device)
            path = torch.where(acc[:, None], cand, path)
            if diff < _CONVERGED:
                break
        return path, count, False

    return project


def make_projection_core_flat(kernels: EnvKernels, rrt_eps: float, slots: int = 4096):
    """Flat-packed projection sweep (gnn_smooth.py:151-308): the same
    semantics as :func:`make_projection_core`, checking only the states the
    reference sweep counts — per edge its two endpoints and K = int(d/eps)
    interior points, interior path nodes only — packed into one
    ``slots``-wide batch per step, which the capsule kernel takes whole. A
    step needing more than ``slots`` states raises the overflow flag, and
    the caller redoes the projection with the full kernel."""

    assert kernels.bounds is not None, "flat projection needs kernel bounds"
    lower, upper = kernels.bounds

    def project(scene, old_path, new_path, n_path: int):
        L = old_path.shape[0]
        dev = old_path.device
        K_outer = _outer_steps(old_path, new_path, n_path, rrt_eps)
        s = torch.arange(slots, device=dev)
        path, count, overflow = old_path, 0, False
        for _ in range(K_outer):
            cand, prev_old, prev_cand, nxt, interior = _candidates(
                kernels, path, new_path, rrt_eps, n_path
            )
            qa = torch.cat([prev_old, prev_cand, nxt])  # (3L, d)
            qb = cand.repeat(3, 1)
            e_int = interior.repeat(3)
            valid_e = ((qa >= lower) & (qa <= upper)).all(-1) & ((qb >= lower) & (qb <= upper)).all(-1)
            d_e = kernels.distance(qa, qb)
            K_e = torch.where(e_int, (d_e / rrt_eps).to(torch.int64), 0)
            n_slot = torch.where(e_int, K_e + 2, 0)  # [qa, qb, interior...]
            cum = torch.cumsum(n_slot, 0)
            offs = cum - n_slot
            total = cum[-1]

            eid = torch.clamp_max(torch.searchsorted(cum, s, right=True), 3 * L - 1)
            t = s - offs[eid]
            in_use = s < total
            qa_s = qa[eid]
            disp_s = (qb - qa)[eid]
            Kf = torch.clamp_min(K_e[eid], 1).to(qa.dtype)
            coeff = (t - 2).to(qa.dtype) / Kf
            pt = torch.where(
                (t == 0)[:, None],
                qa_s,
                torch.where((t == 1)[:, None], qb[eid], qa_s + coeff[:, None] * disp_s),
            )
            free_s, _ = kernels.batch_state_free(scene, pt)
            free_s = free_s | ~in_use

            off_c = torch.clamp_max(offs, slots - 1)
            fa = free_s[off_c]
            fb = free_s[torch.clamp_max(off_c + 1, slots - 1)]
            fail = in_use & (t >= 2) & ~free_s
            ff = torch.full((3 * L,), BIG, dtype=torch.int64, device=dev).scatter_reduce(
                0, eid, torch.where(fail, t - 2, BIG), "amin", include_self=True
            )
            int_free = ff == BIG
            int_cnt = torch.where(int_free, K_e, ff + 1)
            ok_e = valid_e & fa & fb & int_free
            zero = torch.zeros_like(int_cnt)
            cnt_e = torch.where(
                valid_e, 1 + torch.where(fa, 1 + torch.where(fb, int_cnt, zero), zero), zero
            )
            dnorm = _norm(cand - new_path)

            host = torch.cat([
                ok_e.to(torch.float64), cnt_e.to(torch.float64), dnorm.to(torch.float64),
                interior.to(torch.float64), (total > slots).to(torch.float64).reshape(1),
            ]).cpu().numpy()
            ok, cnt = host[: 3 * L] > 0.5, host[3 * L : 6 * L].astype(np.int64)
            dn = host[6 * L : 7 * L].astype(np.float32)
            intr = host[7 * L : 8 * L] > 0.5
            overflow |= bool(host[-1] > 0.5)
            accepted, count, diff = _resolve(
                ok[:L], cnt[:L], ok[L : 2 * L], cnt[L : 2 * L], ok[2 * L :], cnt[2 * L :],
                intr, dn, count,
            )
            acc = torch.as_tensor(accepted, device=dev)
            path = torch.where(acc[:, None], cand, path)
            if diff < _CONVERGED:
                break
        return path, count, overflow

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
