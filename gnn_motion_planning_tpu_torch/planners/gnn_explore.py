"""GNN-guided exploration with lazy collision checking (port of
gnn_motion_planning_tpu/planners/gnn_explore.py).

The JAX package runs the greedy frontier search as one ``lax.while_loop``,
and ``jax.vmap`` of it over a lane group of problems. Here the loop body is
the same branch-free ``where`` form over a leading lane axis, with ``done``
freezing a lane, written with in-place tensor ops that never read a value
back to the host. One pop advances every lane at once: a per-lane argmax
over the (L, N, N) masked frontier, one lane-batched edge check (one kernel
launch for all lanes on the arms), a per-lane goal test and count. The host
runs the loop in chunks of ``sync`` pops and reads ``done`` once per chunk,
so a call costs one sync per chunk, not one per pop. A single problem is
the same code at L = 1 (:func:`make_explore_round_core`).

With ``max_pops`` a call pops at most that many times and pauses: the
returned (explored, prev, costs, edge_dead) resume the search exactly on
the next call (the lane-compaction primitive of ``api/batched.py``). Every
pop that finds an edge kills at least one live edge, so a lane ends within
(its live edges + 1) pops of a call; a lane still running past that cap
raises.

Per pop: the reference's masking order and goal-gated counting
(gnn_explore.py:99-178).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels, one_lane
from gnn_motion_planning_tpu_torch.envs.kinematics import norm_last
from gnn_motion_planning_tpu_torch.graphs.knn import EdgeList

CHUNK = 32


class ExploreResult(NamedTuple):
    """A round's outcome: Python scalars and (N,) tensors for one problem,
    or tensors with a leading lane axis (L,) for a lane group."""

    success: bool
    success_node: int  # goal-reaching node, -1 if none
    explored: torch.Tensor  # (N,) bool
    prev: torch.Tensor  # (N,) long tree parents
    costs: torch.Tensor  # (N,) float32
    n_checks: int  # collision checks consumed on device (this call)
    edge_dead: torch.Tensor  # (N, N) bool — edges popped so far
    n_pops: int  # frontier pops that found an edge (this call)
    done: bool = True  # finished (success or frontier dry); False: paused


def _or_at(flat: torch.Tensor, idx: torch.Tensor, value: torch.Tensor):
    """flat[idx] |= value, in place (idx without repeats)."""

    flat.index_put_((idx,), flat.index_select(0, idx) | value)


def make_explore_round_batch_chunked(kernels: EnvKernels, rrt_eps: float, sync: int = CHUNK):
    """Lane-batched greedy search (JAX ``make_explore_round_batch_chunked``,
    gnn_explore.py:228-246): ``fn(scene, v, goal, scores, edges, collided,
    node_valid, explored, prev, costs, edge_dead, done, chunk=None)`` with a
    stacked scene and every other input of a leading lane axis L; ``done``
    (L,) bool freezes a lane; ``chunk`` bounds the pops of the call (None:
    until every lane is done). Returns an :class:`ExploreResult` of (L, ...)
    tensors, ``n_checks`` and ``n_pops`` for this call."""

    def explore_lanes(
        scene,
        v,  # (L, N, d)
        goal,  # (L, d)
        scores,  # (L, N, N) model output (policy[dst, src] convention)
        edges,  # EdgeList of (L, E) — live graph edges (symmetric set)
        collided_mask,  # (L, N) bool
        node_valid,  # (L, N) bool
        explored_init,  # (L, N) bool
        prev_init,  # (L, N) long
        costs_init,  # (L, N) float32
        edge_dead_init,  # (L, N, N) bool
        done_init,  # (L,) bool
        chunk: Optional[int] = None,
    ) -> ExploreResult:
        L, n = v.shape[0], v.shape[1]
        dev = v.device
        lane = torch.arange(L, device=dev)

        alive = torch.zeros((L, n + 1, n), dtype=torch.bool, device=dev)
        alive[lane[:, None], torch.where(edges.alive, edges.src, n), edges.dst] = True
        alive = alive[:, :n].clone()
        alive &= ~torch.eye(n, dtype=torch.bool, device=dev)
        alive &= ~explored_init[:, None, :]
        alive &= ~collided_mask[:, None, :] & ~collided_mask[:, :, None]
        alive &= node_valid[:, None, :] & node_valid[:, :, None]
        alive &= ~edge_dead_init
        cap = alive.flatten(1).sum(dim=1) + 1  # (L,) pops a lane can take

        explored = explored_init.clone()
        prev = prev_init.clone()
        costs = costs_init.clone()
        edge_dead = edge_dead_init.clone()
        alive_flat = alive.view(-1)
        dead_flat = edge_dead.view(-1)
        explored_flat = explored.view(-1)
        count = torch.zeros(L, dtype=torch.int64, device=dev)
        n_pops = torch.zeros(L, dtype=torch.int64, device=dev)
        success = torch.zeros(L, dtype=torch.bool, device=dev)
        success_node = torch.full((L,), -1, dtype=torch.int64, device=dev)
        done = done_init.clone()
        neg_inf = torch.tensor(float("-inf"), device=dev)
        goal_rows = goal[:, None, :]
        base = lane * (n * n)

        def pop():
            eligible = alive & explored[:, :, None]
            masked = torch.where(eligible, scores, neg_inf).view(L, n * n)
            flat = masked.argmax(dim=1)
            a = flat // n
            b = flat % n
            # no edge left: the frontier is exhausted; a finished lane
            # (done) freezes the same way
            live = (masked.gather(1, flat[:, None])[:, 0] > neg_inf) & ~done
            pair = torch.cat([base + a * n + b, base + b * n + a])
            live2 = live.repeat(2)
            _or_at(dead_flat, pair, live2)

            va, vb = v[lane, a], v[lane, b]  # (L, d)
            free_e, c_edge = kernels.edge_free(scene, va[:, None], vb[:, None])
            free = free_e[:, 0] & live
            near = kernels.distance(vb[:, None], goal_rows)[:, 0] < rrt_eps
            sfree, c_state = kernels.batch_state_free(scene, vb[:, None])
            reached = free & near & sfree[:, 0]
            count.add_(torch.where(
                live, c_edge[:, 0] + torch.where(free & near, c_state[:, 0], 0), 0))

            at_b = lane * n + b
            _or_at(explored_flat, at_b, free)
            step = norm_last((va - vb)[:, None])[:, 0]
            new_cost = costs[lane, a] + step
            costs[lane, b] = torch.where(free, new_cost, costs[lane, b])
            prev[lane, b] = torch.where(free, a, prev[lane, b])
            # a free edge retires every edge into b; a blocked one only itself
            alive[lane, :, b] = alive[lane, :, b] & ~free[:, None]
            kill = (live & ~free).repeat(2)
            alive_flat.index_put_((pair,), alive_flat.index_select(0, pair) & ~kill)

            success.logical_or_(reached)
            success_node.copy_(torch.where(reached, b, success_node))
            done.logical_or_(reached | ~live)
            n_pops.add_(live.to(torch.int64))

        it = 0
        limit = chunk if chunk is not None else None
        while limit is None or it < limit:
            steps = sync if limit is None else min(sync, limit - it)
            for _ in range(steps):
                pop()
            it += steps
            if bool(done.all()):
                break
            over = ~done & (it >= cap)
            if bool(over.any()):
                lane_i = int(over.nonzero()[0, 0])
                frontier = int((alive[lane_i] & explored[lane_i][:, None]).sum())
                raise RuntimeError(
                    f"greedy search did not finish within its cap of {int(cap[lane_i])} pops "
                    f"(lane {lane_i}: {int(n_pops[lane_i])} pops found an edge; frontier "
                    f"holds {frontier} edges)"
                )

        return ExploreResult(
            success=success, success_node=success_node, explored=explored, prev=prev,
            costs=costs, n_checks=count, edge_dead=edge_dead, n_pops=n_pops, done=done,
        )

    return explore_lanes


def make_explore_round_core(kernels: EnvKernels, rrt_eps: float, chunk: int = CHUNK,
                            max_pops: Optional[int] = None):
    """Per-round greedy search for one problem: the lane search at L = 1.
    ``chunk`` pops run between host reads; ``max_pops`` pauses the search
    (``done`` False) as in the JAX core. State tensors may be reused across
    rounds."""

    lanes = make_explore_round_batch_chunked(kernels, rrt_eps, sync=chunk)

    def explore_round(
        scene, v, goal, scores, edges, collided_mask, node_valid, explored_init, prev_init,
        costs_init, edge_dead_init, done_init=None,
    ) -> ExploreResult:
        done = torch.zeros(1, dtype=torch.bool, device=v.device)
        if done_init is not None:
            done |= bool(done_init)
        res = lanes(
            one_lane(scene), v[None], goal.reshape(1, -1), scores[None], EdgeList(*(x[None] for x in edges)),
            collided_mask[None], node_valid[None], explored_init[None], prev_init[None],
            costs_init[None], edge_dead_init[None], done, chunk=max_pops,
        )
        return ExploreResult(
            success=bool(res.success[0]),
            success_node=int(res.success_node[0]),
            explored=res.explored[0],
            prev=res.prev[0],
            costs=res.costs[0],
            n_checks=int(res.n_checks[0]),
            edge_dead=res.edge_dead[0],
            n_pops=int(res.n_pops[0]),
            done=bool(res.done[0]),
        )

    return explore_round


def backtrack(prev, node: int):
    """Host-side path extraction via tree parents (eval_gnn.py:224-229)."""

    path = [int(node)]
    seen = set(path)
    while path[-1] != 0:
        nxt = int(prev[path[-1]])
        if nxt in seen:  # defensive: corrupted tree
            break
        path.append(nxt)
        seen.add(nxt)
    path.reverse()
    return path
