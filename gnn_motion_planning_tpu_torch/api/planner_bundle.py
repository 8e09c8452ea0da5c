"""The planner of one env: every search, projection and model entry point the
GNN planning drivers use (port of gnn_motion_planning_tpu/api/planner_bundle.py).

One object per env instance (cached on the env by :func:`get_planner`): the
scalar round core and projection cores of the protocol path
(``api/eval_gnn.py``), their lane-group forms for the batched sweep
(``api/batched.py``, which takes the RGG build and the model forwards over
a lane group from ``graphs/knn.py`` and ``models/``), and the serving
entry points (``api/serve.py``):
``serve_round`` (sampling from given draws, RGG build, explorer forward and
greedy search) and ``serve_full`` (that, then the path backtrack and every
smoothing iteration). The JAX package compiles each of these into one device
program; here they are methods that queue tensor ops and kernel launches,
reading the host where the search and the projection do.

JAX's ``fused_round`` and ``round1_full`` (single-dispatch fusions of work
the protocol path already does op by op) are not ported; ``fused_smooth``
is ported only as the full-budget redo of a lane whose cheap projection
overflowed (:meth:`Planner.smooth_full`).
"""

from __future__ import annotations

import os

import torch

from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges
from gnn_motion_planning_tpu_torch.models.explorer import explorer_forward
from gnn_motion_planning_tpu_torch.models.smoother import smoother_forward
from gnn_motion_planning_tpu_torch.planners.gnn_explore import (
    make_explore_round_batch_chunked,
    make_explore_round_core,
)
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import (
    base_chain_edges,
    make_projection_core,
    make_projection_core_flat,
    make_projection_lanes,
)


class Planner:
    """The env's round cores and projection cores, built once per env."""

    def __init__(self, env):
        kernels = env.kernels()
        eps = float(env.RRT_EPS)
        self.state_free = kernels.batch_state_free
        self.round_core = make_explore_round_core(kernels, eps)
        self.round_lanes = make_explore_round_batch_chunked(kernels, eps)
        # the fast projection first, the full one redoing the work on
        # overflow (JAX api/planner_bundle.py:83-108): the flat sweep where
        # the kernels have bounds (the arms) unless GMP_FLAT_PROJ=0, else
        # the dense sweep at the K_CHEAP budget where the env has a cheap
        # edge check (ur5, snake7), else the full sweep (the mazes; kuka7,
        # kuka13 and kuka14, whose full budget is already small)
        flat = kernels.bounds is not None and os.environ.get("GMP_FLAT_PROJ", "auto") != "0"
        self.project_full = make_projection_core(kernels, eps)
        self.project_lanes_full = make_projection_lanes(kernels, eps, flat=False)
        if flat:
            self.project_cheap = make_projection_core_flat(kernels, eps)
            self.project_lanes_cheap = make_projection_lanes(kernels, eps, flat=True)
        elif kernels.edge_free_cheap is not None:
            self.project_cheap = make_projection_core(kernels, eps, cheap=True)
            self.project_lanes_cheap = make_projection_lanes(kernels, eps, flat=False, cheap=True)
        else:
            self.project_cheap = self.project_full
            self.project_lanes_cheap = self.project_lanes_full
        # smoothings redone at the full budget after a fast projection
        # overflowed (``api/eval_gnn.py::model_smooth`` counts them)
        self.overflow_redos = 0

    # -- the batched sweep's redo (api/batched.py) --------------------------

    @torch.no_grad()
    def smooth_full(self, model_s, scene, path, path_mask, env_nodes, env_valid, n_free: int,
                    base_src, base_dst, base_alive, n_path: int, iters: int = 5, loop: int = 1):
        """Every smoothing iteration of one path at the full edge budget (JAX
        ``fused_smooth(cheap=False)``): the redo of a lane whose cheap
        projection overflowed. Returns (path, count)."""

        count = 0
        for _ in range(iters):
            proposal = smoother_forward(model_s, path, path_mask, env_nodes, env_valid, n_free,
                                        base_src, base_dst, base_alive, loop=loop)
            path, cnt, _ = self.project_full(scene, path, proposal, n_path)
            count += cnt
        return path, count

    # -- serving (api/serve.py) ---------------------------------------------

    @torch.no_grad()
    def serve_round(self, model, scene, draws, init, goal, obstacles, obs_mask,
                    batch: int, k1: int, loop: int):
        """Rejection sampling from ``draws`` (M, d), then the RGG build, the
        explorer forward and the greedy search of one round (JAX
        ``_serve_round``, planner_bundle.py:127-190).

        The sampling mirrors ``sample_n_points(batch, need_negative=True)``
        (reference kuka_env.py:194-222): the consumed prefix ends at the
        ``batch``-th free draw, every consumed draw counts one check, and
        the rejected draws within it (at most ``batch``) are the collided
        set. Returns (result, v (N, d), prefix_len, n_coll, enough), the
        last three as 0-d tensors."""

        M, d = draws.shape
        dev = draws.device
        free_mask, _ = self.state_free(scene, draws)
        cum = torch.cumsum(free_mask.to(torch.int64), 0)
        enough = cum[-1] >= batch
        reached = cum >= batch
        prefix_len = torch.where(enough, torch.argmax(reached.to(torch.int32)) + 1, M)
        idx = torch.arange(M, device=dev)
        free_order = torch.argsort(torch.where(free_mask, idx, M + idx))
        free_rows = draws[free_order[:batch]]
        coll_in_prefix = ~free_mask & (idx < prefix_len)
        n_coll = torch.clamp_max(coll_in_prefix.sum(), batch)
        coll_order = torch.argsort(torch.where(coll_in_prefix, idx, M + idx))
        coll_rows = draws[coll_order[:batch]]

        F = batch + 2
        N = 2 * F
        v = torch.zeros((N, d), dtype=torch.float32, device=dev)
        v[0] = init
        v[1] = goal
        v[2:F] = free_rows
        v[F:F + batch] = coll_rows
        j = torch.arange(N, device=dev)
        collided_mask = (j >= F) & (j < F + n_coll)
        node_valid = (j < F) | collided_mask

        edges = build_rgg_edges(v, node_valid, F, k1)
        policy = explorer_forward(model, v, node_valid, goal, edges.src, edges.dst, edges.alive,
                                  obstacles, obs_mask, loop=loop)
        explored = torch.zeros(N, dtype=torch.bool, device=dev)
        explored[0] = True
        res = self.round_core(
            scene, v, goal, policy, edges, collided_mask, node_valid, explored,
            torch.zeros(N, dtype=torch.int64, device=dev), torch.zeros(N, device=dev),
            torch.zeros((N, N), dtype=torch.bool, device=dev),
        )
        return res, v, prefix_len, n_coll, enough

    @torch.no_grad()
    def backtrack_smooth(self, model_s, scene, v, res, n_coll, F: int, l_pad: int,
                         smooth_iters: int, loop_s: int, cheap: bool = True):
        """The path backtrack through the search tree's parents on the
        device, then every smoothing iteration (JAX ``_backtrack_smooth``,
        planner_bundle.py:192-271): ``backtrack`` -> ``model_smooth`` of the
        host pipeline, with its [:500] truncation of the free list and
        last-waypoint padding. ``fits`` is False when the path does not fit
        ``l_pad`` or the cheap projection overflowed: the caller falls back
        to the host pipeline. Returns (raw_path, path (l_pad, d), n_path,
        fits, count)."""

        dev = v.device
        d = v.shape[1]
        s = torch.clamp_min(torch.as_tensor(res.success_node, device=dev), 0)
        prev = res.prev
        # follow the parents from the goal node: buf holds [s, ..., child of
        # the root], at most l_pad of them
        buf = torch.zeros(l_pad, dtype=torch.int64, device=dev)
        i = s.clone()
        n_rev = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(l_pad):
            go = i != 0
            buf[k] = torch.where(go, i, buf[k])
            n_rev = n_rev + go.to(torch.int64)
            i = torch.where(go, prev[i], i)
        fits = bool(i == 0) and bool(res.success)
        n_path = int(n_rev) + 1
        j = torch.arange(l_pad, device=dev)
        idx_path = torch.where(j == 0, 0, buf[torch.clamp(n_path - 1 - j, 0, l_pad - 1)])
        raw_path = torch.where((j < n_path)[:, None], v[idx_path], v[s][None])
        path_mask = j < n_path

        nf_cap = min(F, 500)
        nc_cap = min(F, 500)
        env_nodes = torch.zeros((1000, d), dtype=torch.float32, device=dev)
        env_nodes[:nf_cap] = v[:nf_cap]
        env_nodes[500:500 + nc_cap] = v[F:F + nc_cap]
        jj = torch.arange(1000, device=dev)
        env_valid = (jj < nf_cap) | ((jj >= 500) & (jj < 500 + torch.clamp_max(n_coll, nc_cap)))
        env_nodes = torch.where(env_valid[:, None], env_nodes, 0.0)

        bs, bd, ba = (torch.as_tensor(a, device=dev) for a in base_chain_edges(l_pad, n_path))
        project = self.project_cheap if cheap else self.project_full
        path, count, overflow = raw_path, 0, False
        for _ in range(smooth_iters):
            proposal = smoother_forward(model_s, path, path_mask, env_nodes, env_valid, nf_cap,
                                        bs, bd, ba, loop=loop_s)
            path, cnt, ovf = project(scene, path, proposal, n_path)
            count += cnt
            overflow |= ovf
        return raw_path, path, n_path, fits and not overflow, count

    @torch.no_grad()
    def serve_full(self, model, model_s, scene, draws, init, goal, obstacles, obs_mask,
                   batch: int, k1: int, loop: int, loop_s: int, l_pad: int, smooth_iters: int):
        """The whole problem: :meth:`serve_round`, then
        :meth:`backtrack_smooth` (JAX ``_serve_full``,
        planner_bundle.py:273-296). Returns (success, n_checks, explored,
        raw_path, path, n_path, fits, prefix_len, n_coll, count, enough)."""

        res, v, prefix_len, n_coll, enough = self.serve_round(
            model, scene, draws, init, goal, obstacles, obs_mask, batch, k1, loop)
        raw_path, path, n_path, fits, count = self.backtrack_smooth(
            model_s, scene, v, res, n_coll, batch + 2, l_pad, smooth_iters, loop_s)
        return (res.success, res.n_checks, res.explored, raw_path, path, n_path, fits,
                prefix_len, n_coll, count, enough)


def get_planner(env) -> Planner:
    """The env's :class:`Planner`, built on first use and cached on it."""

    planner = getattr(env, "_torch_planner", None)
    if planner is None:
        planner = env._torch_planner = Planner(env)
    return planner
