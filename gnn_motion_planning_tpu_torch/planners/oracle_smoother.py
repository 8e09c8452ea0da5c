"""Oracle path smoothers (host-side training targets and baselines).

Port of gnn_motion_planning_tpu/planners/oracle_smoother.py (host numpy, as there).

Equivalents of the reference smoothing suite (reference: smoother.py:67-230):
random perturbation smoothing, critical-node pruning via Dijkstra
shortcutting, their joint iteration, and the ratio variant used as the
smoother-GNN training target. These run on the host against the env oracle
(they are data-generation / comparison tools, not the serving path — the
serving path is the compiled model smoother in planners/gnn_smooth.py).
"""

from __future__ import annotations

from copy import deepcopy

import numpy as np


def _rand(env):
    return env.rng if getattr(env, "rng", None) is not None else np.random


def path_cost(path) -> float:
    path = np.asarray(path, np.float64)
    if len(path) < 2:
        return 0.0
    return float(np.sum(np.linalg.norm(path[1:] - path[:-1], axis=-1)))


def random_path_smoother(path, eps, env, iter: int = 100):
    """Random perturbation accept-if-shorter (smoother.py:67-82)."""

    path = deepcopy(path)
    if len(path) > 2:
        rng = _rand(env)
        for _ in range(iter):
            action = rng.uniform(-eps, eps, size=env.config_dim)
            node_idx = rng.randint(1, len(path) - 1)
            prev_node = np.asarray(path[node_idx])
            new_node = path[node_idx] + action
            if (
                env._state_fp(np.asarray(new_node))
                and env._edge_fp(np.asarray(new_node), np.asarray(path[node_idx - 1]))
                and env._edge_fp(np.asarray(new_node), np.asarray(path[node_idx + 1]))
            ):
                if np.linalg.norm(path[node_idx + 1] - new_node) + np.linalg.norm(
                    path[node_idx - 1] - new_node
                ) < np.linalg.norm(path[node_idx + 1] - prev_node) + np.linalg.norm(
                    path[node_idx - 1] - prev_node
                ):
                    path[node_idx] = tuple(new_node)
    return path


def _visibility_window(env, window):
    """Dense visibility adjacency over one path window.

    One oracle call per ordered point pair, in row-major order (the same
    call sequence the reference's nested dict-builder issues, so
    ``collision_check_count`` advances identically); the result is a masked
    cost matrix instead of tuple-keyed neighbor lists.
    """

    k = len(window)
    pts = np.asarray(window, np.float64)
    cost = np.linalg.norm(pts[:, None, :] - pts[None, :, :], axis=-1)
    vis = np.zeros((k, k), bool)
    for i in range(k):
        for j in range(k):
            vis[i, j] = env._edge_fp(pts[i], pts[j])
    return np.where(vis, cost, np.inf)


def _dijkstra_dense(w):
    """Vectorised Dijkstra on a dense masked cost matrix from node 0:
    each settle step relaxes a full adjacency row at once (no per-neighbor
    Python loop, no tuple-dict bookkeeping). Returns the predecessor array
    (-1 = unreached)."""

    k = len(w)
    dist = np.full(k, np.inf)
    prev = np.full(k, -1, np.int64)
    done = np.zeros(k, bool)
    dist[0] = 0.0
    for _ in range(k):
        u = int(np.argmin(np.where(done, np.inf, dist)))
        if not np.isfinite(dist[u]) or done[u]:
            break
        done[u] = True
        relaxed = dist[u] + w[u]
        better = (relaxed < dist) & ~done
        dist[better] = relaxed[better]
        prev[better] = u
    return prev


def prune_path(path, env, iter: int = 100):
    """Critical-node Dijkstra shortcutting (behavior of reference
    smoother.py:97-126, restructured): keep the endpoints plus every
    waypoint whose neighbors cannot see each other, then replace each
    critical segment by the visibility-graph shortest path through the
    window's waypoints. Iterates until a full pass removes nothing.

    Consumes no RNG draws and issues oracle calls in the reference's exact
    order, so training-target streams are unchanged."""

    for _ in range(iter):
        len_path = len(path)
        crit_idx = [0]
        for index in range(1, len(path) - 1):
            if not env._edge_fp(np.asarray(path[index - 1]), np.asarray(path[index + 1])):
                crit_idx.append(index)
        if len(path) > 1:
            crit_idx.append(len(path) - 1)

        new_path = [path[0]]
        ok = True
        for prev_i, nxt_i in zip(crit_idx[:-1], crit_idx[1:]):
            window = path[prev_i : nxt_i + 1]
            w = _visibility_window(env, window)
            pred = _dijkstra_dense(w)
            partial = []
            current = nxt_i - prev_i
            while current != 0:
                partial.append(np.asarray(window[current]))
                current = int(pred[current])
                if current < 0:  # unreachable window end: keep path as-is
                    ok = False
                    break
            if not ok:
                break
            partial.reverse()
            new_path.extend(partial)
        if not ok:
            break
        path = new_path
        if len(path) == len_path:
            return path
    return path


def joint_smoother(path, env, iter, random_iter: int = 100, prune_iter: int = 100):
    """Alternating random smoothing + pruning (smoother.py:129-133)."""

    for _ in range(iter):
        path = random_path_smoother(path, env.RRT_EPS, env, iter=random_iter)
        path = prune_path(path, env, iter=prune_iter)
    return path


def joint_smoother_ratio(
    path, env, iter: int = 5, random_iter: int = 100, prune_iter: int = 100
):
    """Training target: smooth then redistribute dropped waypoints along
    the pruned segments (smoother.py:136-151)."""

    for _ in range(iter):
        path = random_path_smoother(path, env.RRT_EPS, env, iter=random_iter)
        shorten = prune_path(path, env, iter=prune_iter)
        random_idx = prune_idx = 0
        while prune_idx != len(shorten):
            nxt = random_idx
            while not np.array_equal(
                np.asarray(shorten[prune_idx]), np.asarray(path[nxt])
            ):
                nxt += 1
            seg_a = np.asarray(path[random_idx])
            seg_b = np.asarray(path[nxt])
            for inter in range(random_idx + 1, nxt):
                path[inter] = tuple(
                    (seg_b - seg_a) * (inter - random_idx) / (nxt - random_idx)
                    + seg_a
                )
            prune_idx += 1
            random_idx = nxt
    return path


def interpolate_path(env, path, eps=None):
    """Densify a path at eps resolution (smoother.py:219-230)."""

    if eps is None:
        eps = env.RRT_EPS
    path = np.asarray(path)
    out = []
    for n1, n2 in zip(path[:-1], path[1:]):
        dist = np.linalg.norm(n2 - n1)
        K = int(np.ceil(dist / eps))
        for k in range(K):
            out.append(n1 + (n2 - n1) * k / K)
    out.append(path[-1])
    return out
