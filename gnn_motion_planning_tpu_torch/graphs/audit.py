"""RGG audit helpers: full oracle check + connectivity of a problem graph
(port of gnn_motion_planning_tpu/graphs/audit.py).

They decide whether a failed problem was *sample-coverage-bound* (the exact
protocol RGG contains no feasible init->goal path at all, so no explorer
can solve it at that budget) or *model-bound* (a feasible path exists and
the GNN failed to rank it). Host numpy over the env's batched edge oracle
(``_batch_edge_free``: the device oracle in chunks of 256 edges on the
arms, the host oracle on the mazes).
"""

from __future__ import annotations

import heapq
from collections import deque

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.config import problem_rng
from gnn_motion_planning_tpu_torch.graphs.knn import EdgeList, build_rgg_edges, k_scaled


def checked_free_edges(env, v_np: np.ndarray, n_free: int, edges):
    """Fully oracle-check every free-free RGG edge (one batched call).

    ``edges`` is an EdgeList from graphs/knn.build_rgg_edges, as host
    arrays. Returns (a, b, ok): undirected edge endpoints (a < b) and the
    oracle verdict.
    """

    src = np.asarray(edges.src)
    dst = np.asarray(edges.dst)
    alive = np.asarray(edges.alive)
    keep = alive & (src < n_free) & (dst < n_free) & (src < dst)
    a, b = src[keep], dst[keep]
    if len(a) == 0:
        return a, b, np.zeros(0, bool)
    ok = np.asarray(env._batch_edge_free(v_np[a], v_np[b])[0])
    return a, b, ok


def component_from(n: int, a, b, ok, start: int = 0) -> np.ndarray:
    """BFS reachability over passing edges; returns the (n,) seen mask."""

    adj = [[] for _ in range(n)]
    for s, t in zip(a[ok], b[ok]):
        adj[s].append(t)
        adj[t].append(s)
    seen = np.zeros(n, bool)
    seen[start] = True
    q = deque([start])
    while q:
        u = q.popleft()
        for w in adj[u]:
            if not seen[w]:
                seen[w] = True
                q.append(w)
    return seen


def shortest_feasible_path(v_np, n: int, a, b, ok, src: int = 0, dst: int = 1):
    """Euclidean-shortest path over passing edges, or None."""

    adj = [[] for _ in range(n)]
    for s, t in zip(a[ok], b[ok]):
        w = float(np.linalg.norm(v_np[s].astype(np.float64) - v_np[t]))
        adj[s].append((t, w))
        adj[t].append((s, w))
    dist = np.full(n, np.inf)
    prev = np.full(n, -1, np.int64)
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        for t, w in adj[u]:
            if d + w < dist[t]:
                dist[t] = d + w
                prev[t] = u
                heapq.heappush(pq, (d + w, t))
    if not np.isfinite(dist[dst]):
        return None
    path = [dst]
    while path[-1] != src:
        path.append(int(prev[path[-1]]))
    return path[::-1]


def protocol_rgg_connected(env, seed: int, index: int, batch: int = 500,
                           k: int = 30):
    """Replay the protocol stream for (seed, index), build the exact
    round-1 RGG, fully check it, and report init->goal connectivity.

    Returns a dict with connectivity, endpoint degrees and edge counts.
    """

    env.rng = problem_rng(seed, int(index))
    env.init_new_problem(int(index))
    free, collided = env.sample_n_points(batch, need_negative=True)
    collided = list(collided)[: len(free)]
    F = len(free) + 2
    N = 2 * F
    d = env.config_dim
    v_np = np.zeros((N, d), np.float32)
    v_np[0] = np.asarray(env.init_state, np.float32)
    v_np[1] = np.asarray(env.goal_state, np.float32)
    v_np[2:F] = np.asarray(free, np.float32)
    C = len(collided)
    if C:
        v_np[F : F + C] = np.asarray(collided, np.float32)
    valid = np.arange(N) < F + C
    edges = build_rgg_edges(torch.as_tensor(v_np, device=env.device),
                            torch.as_tensor(valid, device=env.device), F, k_scaled(k, F))
    a, b, ok = checked_free_edges(env, v_np, F, EdgeList(*(x.cpu().numpy() for x in edges)))
    comp = component_from(F, a, b, ok)
    return {
        "connected": bool(comp[1]),
        "init_component_size": int(comp.sum()),
        "init_degree_free": int(ok[(a == 0) | (b == 0)].sum()),
        "goal_degree_free": int(ok[(a == 1) | (b == 1)].sum()),
        "edges_checked": int(len(a)),
        "edges_free": int(ok.sum()),
    }
