"""k-NN random-geometric-graph construction with static shapes (port of
gnn_motion_planning_tpu/graphs/knn.py).

Dense pairwise distances (one fp32 matmul, TF32 off), a top-k that breaks
ties lower index first like ``lax.top_k`` (a stable sort, then the first k:
``torch.topk`` on CUDA promises no order for ties), the flip, the union with
the free subgraph and a sort-unique dedup that also gives coalesce's
(src, dst) order. Indices are int64.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gnn_motion_planning_tpu_torch.envs.kinematics import sum_last


class EdgeList(NamedTuple):
    src: torch.Tensor  # (E,) long
    dst: torch.Tensor  # (E,) long
    alive: torch.Tensor  # (E,) bool


def k_scaled(k: int, n_free: int) -> int:
    """k1 = ceil(k * log(n_free) / log(100)) (reference eval_gnn.py:159)."""

    return int(math.ceil(k * math.log(n_free) / math.log(100)))


def pairwise_sq_dists(v: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances, (N, N), via one Gram matmul."""

    sq = sum_last(v * v)
    g = torch.matmul(v, v.T)
    d = sq[:, None] + sq[None, :] - 2.0 * g
    return torch.clamp_min(d, 0.0)


def knn_neighbors(v, valid, k: int, query_valid=None):
    """For each query node, its k nearest valid nodes (self included):
    (idx (N, k), alive (N, k)); neighbours of invalid queries and slots
    beyond the valid candidates are dead."""

    if query_valid is None:
        query_valid = valid
    d = torch.where(valid[None, :], pairwise_sq_dists(v), float("inf"))
    d_sorted, idx = torch.sort(d, dim=1, stable=True)
    alive = torch.isfinite(d_sorted[:, :k]) & query_valid[:, None]
    return idx[:, :k], alive


def dedup_edges(src, dst, alive, n: int) -> EdgeList:
    """Sort-unique on encoded edge ids; dead edges encode to a sentinel that
    sorts last, and dead output slots point at node 0."""

    ids = torch.where(alive, src * n + dst, n * n)
    ids, _ = torch.sort(ids, stable=True)
    first = torch.ones_like(alive)
    first[1:] = ids[1:] != ids[:-1]
    out_alive = first & (ids < n * n)
    out_src = torch.where(out_alive, ids // n, 0)
    out_dst = torch.where(out_alive, ids % n, 0)
    return EdgeList(out_src, out_dst, out_alive)


def build_rgg_edges(v, valid, n_free: int, k1: int) -> EdgeList:
    """Reference create_data edge construction: knn over all nodes + flip,
    union knn over the free prefix + flip, coalesce-dedup."""

    n = v.shape[0]
    dev = v.device
    idx_all, alive_all = knn_neighbors(v, valid, k1)
    centers = torch.arange(n, device=dev)[:, None].expand_as(idx_all)
    idx_f, alive_f = knn_neighbors(v[:n_free], valid[:n_free], min(k1, n_free))
    centers_f = torch.arange(n_free, device=dev)[:, None].expand_as(idx_f)
    src = torch.cat([idx_all.reshape(-1), centers.reshape(-1), idx_f.reshape(-1), centers_f.reshape(-1)])
    dst = torch.cat([centers.reshape(-1), idx_all.reshape(-1), centers_f.reshape(-1), idx_f.reshape(-1)])
    alive = torch.cat([alive_all.reshape(-1), alive_all.reshape(-1), alive_f.reshape(-1), alive_f.reshape(-1)])
    return dedup_edges(src, dst, alive, n)


def build_rgg_edges_lanes(v, valid, n_free: int, k1: int) -> EdgeList:
    """:func:`build_rgg_edges` for a lane group (JAX ``_edges_v``,
    planner_bundle.py:75-76): v (L, N, d), valid (L, N) -> EdgeList of
    (L, E). One lane at a time, so every lane's edges are exactly its scalar
    build's (ties broken lower index first)."""

    lanes = [build_rgg_edges(v[i], valid[i], n_free, k1) for i in range(v.shape[0])]
    return EdgeList(*(torch.stack(parts) for parts in zip(*lanes)))
