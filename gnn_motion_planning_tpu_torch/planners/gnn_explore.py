"""GNN-guided exploration with lazy collision checking (port of
gnn_motion_planning_tpu/planners/gnn_explore.py).

The JAX package runs the greedy frontier search as one ``lax.while_loop``.
Here the loop body is the same branch-free ``where`` form, with ``done``
freezing the state, written with in-place tensor ops that never read a
value back to the host. The host runs it in chunks of ``chunk`` pops and
reads ``done`` once per chunk, so a round costs one sync per chunk, not one
per pop. Every pop that finds an edge kills at least one live edge, so a
round ends within (live edges + 1) pops; reaching that cap raises.

Per pop: argmax over the masked (N, N) frontier scores, one fixed-step edge
check, the goal test of the newly reached node, and the count, with the
reference's masking order and goal-gated counting (gnn_explore.py:99-178).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels
from gnn_motion_planning_tpu_torch.envs.kinematics import norm_last

CHUNK = 32


class ExploreResult(NamedTuple):
    success: bool
    success_node: int  # goal-reaching node, -1 if none
    explored: torch.Tensor  # (N,) bool
    prev: torch.Tensor  # (N,) long tree parents
    costs: torch.Tensor  # (N,) float32
    n_checks: int  # collision checks consumed on device
    edge_dead: torch.Tensor  # (N, N) bool — edges popped so far
    n_pops: int  # frontier pops that found an edge


def _or_at(flat: torch.Tensor, idx: torch.Tensor, value: torch.Tensor):
    """flat[idx] |= value, in place, for 1-element index tensors."""

    flat.index_put_((idx,), flat.index_select(0, idx) | value)


def make_explore_round_core(kernels: EnvKernels, rrt_eps: float, chunk: int = CHUNK):
    """Per-round greedy search; state tensors may be reused across rounds."""

    def explore_round(
        scene,
        v,  # (N, d)
        goal,  # (d,)
        scores,  # (N, N) model output (policy[dst, src] convention)
        edges,  # EdgeList — live graph edges (symmetric set)
        collided_mask,  # (N,) bool
        node_valid,  # (N,) bool
        explored_init,  # (N,) bool
        prev_init,  # (N,) long
        costs_init,  # (N,) float32
        edge_dead_init,  # (N, N) bool
    ) -> ExploreResult:
        n = v.shape[0]
        dev = v.device

        alive = torch.zeros((n + 1, n), dtype=torch.bool, device=dev)
        alive[torch.where(edges.alive, edges.src, n), edges.dst] = True
        alive = alive[:n].clone()
        alive &= ~torch.eye(n, dtype=torch.bool, device=dev)
        alive &= ~explored_init[None, :]
        alive &= ~collided_mask[None, :] & ~collided_mask[:, None]
        alive &= node_valid[None, :] & node_valid[:, None]
        alive &= ~edge_dead_init
        cap = int(alive.sum()) + 1

        explored = explored_init.clone()
        prev = prev_init.clone()
        costs = costs_init.clone()
        edge_dead = edge_dead_init.clone()
        alive_flat = alive.view(-1)
        dead_flat = edge_dead.view(-1)
        count = torch.zeros(1, dtype=torch.int64, device=dev)
        n_pops = torch.zeros(1, dtype=torch.int64, device=dev)
        success = torch.zeros(1, dtype=torch.bool, device=dev)
        success_node = torch.full((1,), -1, dtype=torch.int64, device=dev)
        done = torch.zeros(1, dtype=torch.bool, device=dev)
        neg_inf = torch.tensor(float("-inf"), device=dev)
        goal_row = goal.reshape(1, -1)

        def pop():
            eligible = alive & explored[:, None]
            masked = torch.where(eligible, scores, neg_inf).view(-1)
            flat = masked.argmax().reshape(1)
            a = flat // n
            b = flat % n
            # no edge left: the frontier is exhausted; a finished search
            # (done) freezes the state the same way
            live = (masked.index_select(0, flat) > neg_inf) & ~done
            pair = torch.cat([a * n + b, b * n + a])
            _or_at(dead_flat, pair, live)

            va, vb = v.index_select(0, a), v.index_select(0, b)
            free_e, c_edge = kernels.edge_free(scene, va, vb)
            free = free_e & live
            near = kernels.distance(vb, goal_row) < rrt_eps
            sfree, c_state = kernels.batch_state_free(scene, vb)
            reached = free & near & sfree
            count.add_(
                torch.where(live, c_edge + torch.where(free & near, c_state, 0), 0)
            )

            _or_at(explored, b, free)
            step = norm_last(va - vb)
            new_cost = costs.index_select(0, a) + step
            costs.index_put_((b,), torch.where(free, new_cost, costs.index_select(0, b)))
            prev.index_put_((b,), torch.where(free, a, prev.index_select(0, b)))
            # a free edge retires every edge into b; a blocked one only itself
            alive.index_copy_(1, b, alive.index_select(1, b) & ~free)
            kill = live & ~free
            alive_flat.index_put_((pair,), alive_flat.index_select(0, pair) & ~kill)

            success.logical_or_(reached)
            success_node.copy_(torch.where(reached, b, success_node))
            done.logical_or_(reached | ~live)
            n_pops.add_(live.to(torch.int64))

        it = 0
        while True:
            for _ in range(chunk):
                pop()
            it += chunk
            if bool(done):
                break
            if it >= cap:
                frontier = int((alive & explored[:, None]).sum())
                raise RuntimeError(
                    f"greedy search did not finish within its cap of {cap} pops "
                    f"({int(n_pops)} pops found an edge; frontier holds {frontier} edges)"
                )

        return ExploreResult(
            success=bool(success),
            success_node=int(success_node),
            explored=explored,
            prev=prev,
            costs=costs,
            n_checks=int(count),
            edge_dead=edge_dead,
            n_pops=int(n_pops),
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
