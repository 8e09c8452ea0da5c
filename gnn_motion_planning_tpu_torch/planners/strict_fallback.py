"""Strict-hull fallback: recover paths the capsule oracle wrongly blocks
(port of gnn_motion_planning_tpu/planners/strict_fallback.py).

The arm envs' production oracle approximates link meshes with calibrated
capsules, conservative by design, so a narrow corridor can be
capsule-blocked while the reference's mesh oracle (PyBullet hulls) admits
it: the ``oracle_conservatism`` failure class
(assets/benchmarks/failures_kuka14.json).

This stage runs when the GNN planner exhausts the capsule-feasible graph
without success (opt-in: ``explore(..., strict_fallback=True)``). It is a
LazySP loop over the problem's own RGG where capsule-dead edges are
re-admitted if the sound hull-surface verifier (envs/strict.py) certifies
them at RRT_EPS resolution:

  repeat (bounded):
    shortest path init->goal over non-removed free-free RGG edges
    walk its edges in order:
      capsule-checked-alive          -> accept
      capsule-dead or capsule-fails  -> hull-verify every interpolated
                                        state (counted as collision
                                        checks); strict-free -> accept,
                                        strict-hit -> remove edge, repair

Accepted paths are hull-certified end to end. Host numpy and ``heapq``, as
the JAX package's, so heap ties and the removed and verified sets go the
same way; the capsule checks (``env._edge_fp``) and the hull checks run on
the env's device. Every hull-verified interpolated state counts as one
collision check.
"""

from __future__ import annotations

import heapq

import numpy as np


def _dijkstra(n, adj, removed, src=0, dst=1):
    """Shortest path over the adjacency list skipping removed edges.
    Returns node-index path or None."""

    dist = np.full(n, np.inf)
    prev = np.full(n, -1, np.int64)
    dist[src] = 0.0
    pq = [(0.0, src)]
    while pq:
        d, u = heapq.heappop(pq)
        if d > dist[u]:
            continue
        if u == dst:
            break
        for v, w in adj[u]:
            if ((u, v) if u < v else (v, u)) in removed:
                continue
            nd = d + w
            if nd < dist[v]:
                dist[v] = nd
                prev[v] = u
                heapq.heappush(pq, (nd, v))
    if not np.isfinite(dist[dst]):
        return None
    path = [dst]
    while path[-1] != src:
        path.append(int(prev[path[-1]]))
    path.reverse()
    return path


def _hull_verify_edge(env, strict_hit, a, b) -> bool:
    """Hull-verify segment a->b at RRT_EPS resolution; every interpolated
    state counts as one collision check (the accounting unit of
    ``_edge_fp``'s per-state loop)."""

    from gnn_motion_planning_tpu_torch.envs.strict import validate_path_strict

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    d = float(np.linalg.norm(b - a))
    n_states = max(int(d / env.RRT_EPS), 1) + 1
    env.collision_check_count += n_states
    hits = validate_path_strict(env, [a, b], strict_hit)
    return hits == 0


def strict_fallback_path(
    env,
    v_np: np.ndarray,
    n_free: int,
    edges,
    edge_dead: np.ndarray,
    max_repairs: int = 20,
):
    """Hull-certified recovery path over the exhausted RGG, or None.

    ``v_np``: (N, d) node block (free prefix; init=0, goal=1).
    ``edges``: EdgeList from graphs/knn.build_rgg_edges (the problem's own
    protocol graph), as host arrays.
    ``edge_dead``: (N, N) bool — edges the capsule oracle checked and
    blocked during the failed search.
    """

    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    strict_hit = strict_checker(env)
    if strict_hit is None:
        return None  # exact-oracle env: conservatism cannot occur

    src = np.asarray(edges.src)
    dst = np.asarray(edges.dst)
    alive = np.asarray(edges.alive)
    keep = alive & (src < n_free) & (dst < n_free) & (src != dst)
    src, dst = src[keep], dst[keep]
    w = np.linalg.norm(
        v_np[src].astype(np.float64) - v_np[dst].astype(np.float64), axis=1
    )
    adj: list[list] = [[] for _ in range(n_free)]
    for s, t, ww in zip(src, dst, w):
        adj[int(s)].append((int(t), float(ww)))

    dead = np.asarray(edge_dead)
    removed: set = set()
    verified: set = set()
    for _ in range(max_repairs):
        path = _dijkstra(n_free, adj, removed)
        if path is None:
            return None
        ok = True
        for a, b in zip(path[:-1], path[1:]):
            key = (min(a, b), max(a, b))
            if key in verified:
                continue
            if dead[a, b] or dead[b, a]:
                # the capsule oracle already rejected this edge: go
                # straight to the hull verifier
                passed = _hull_verify_edge(env, strict_hit, v_np[a], v_np[b])
            elif env._edge_fp(np.asarray(v_np[a]), np.asarray(v_np[b])):
                passed = True
            else:
                passed = _hull_verify_edge(env, strict_hit, v_np[a], v_np[b])
            if passed:
                verified.add(key)
            else:
                removed.add(key)
                ok = False
                break
        if ok:
            return path
    return None

