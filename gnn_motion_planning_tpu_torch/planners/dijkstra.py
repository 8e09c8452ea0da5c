"""PRM construction + Dijkstra shortest paths.

Port of gnn_motion_planning_tpu/planners/dijkstra.py (host numpy, as there).

Equivalent of reference algorithm/dijkstra.py: the eager-checked kNN PRM
(construct_graph, :15-31), the dict-based Dijkstra used by training oracles
and LazySP (:49-76), plus a vectorised dense variant for the hot training
loop (the reference's O(V^2) Python min-scan is the explorer trainer's
bottleneck, SURVEY.md §3.2).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from gnn_motion_planning_tpu_torch.graphs.knn_host import knn_graph_numpy

INFINITY = float("inf")


def construct_graph(env, points, check_collision: bool = True):
    """kNN(5) PRM with eager edge checks (dijkstra.py:15-31).

    Returns (edge_cost, neighbors, edge_index, edge_free) with the
    reference's dict-of-lists layout keyed by the edge's *target* node.
    """

    points = np.asarray(points)
    edge_index = knn_graph_numpy(points, k=5, loop=True)
    edge_cost = defaultdict(list)
    edge_free = []
    neighbors = defaultdict(list)
    for edge in edge_index:
        a, b = int(edge[0]), int(edge[1])
        if (not check_collision) or env._edge_fp(points[a], points[b]):
            edge_cost[b].append(float(np.linalg.norm(points[b] - points[a])))
            edge_free.append(True)
        else:
            edge_cost[b].append(INFINITY)
            edge_free.append(False)
        neighbors[b].append(a)
    return edge_cost, neighbors, edge_index, edge_free


def dijkstra(nodes, edges, costs, source):
    """Dict-based Dijkstra with the reference's exact API
    (dijkstra.py:49-76). `edges[u]` lists u's in-neighbours and `costs[u]`
    the matching costs (note the reference's reversed adjacency)."""

    dist = {v: INFINITY for v in nodes}
    prev = {v: INFINITY for v in nodes}
    dist[source] = 0
    prev[source] = source
    q = set(nodes)

    while q:
        u = min(q, key=lambda v: dist[v])
        q.remove(u)
        for index, v in enumerate(edges[u]):
            alt = dist[u] + costs[u][index]
            if alt < dist[v]:
                dist[v] = alt
                prev[v] = u
    return dist, prev


def dijkstra_dense(n: int, edge_index: np.ndarray, edge_cost: np.ndarray, source: int):
    """Vectorised Dijkstra over an edge list (training oracle fast path).

    Returns (dist (n,), prev (n,)) arrays. Semantics match `dijkstra` on the
    same graph; ~100x faster for the 100-400 node PRM graphs the explorer
    trainer uses (reference train_explorer.py:130).
    """

    adj = np.full((n, n), np.inf, np.float64)
    adj[edge_index[:, 0], edge_index[:, 1]] = edge_cost
    dist = np.full(n, np.inf)
    prev = np.full(n, -1, np.int64)
    done = np.zeros(n, bool)
    dist[source] = 0.0
    prev[source] = source
    for _ in range(n):
        u = int(np.argmin(np.where(done, np.inf, dist)))
        if not np.isfinite(dist[u]):
            break
        done[u] = True
        alt = dist[u] + adj[u]
        better = alt < dist
        dist = np.where(better, alt, dist)
        prev = np.where(better, u, prev)
    return dist, prev
