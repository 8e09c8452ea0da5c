"""Host-side kNN graph construction for baseline planners.

Port of gnn_motion_planning_tpu/graphs/knn_host.py (host numpy, as there).

Numpy equivalent of PyG knn_graph + flip + coalesce as used by the PRM /
LazySP baselines (reference: algorithm/dijkstra.py:15-19,
algorithm/lazy_sp.py:123-129) — baselines keep host control flow, so a
device round trip per graph build is unnecessary.
"""

from __future__ import annotations

import numpy as np


def knn_graph_numpy(points: np.ndarray, k: int, loop: bool = True) -> np.ndarray:
    """Symmetrised, deduplicated kNN edge list, sorted like coalesce.

    Returns edge_index of shape (E, 2) rows (src, dst).
    """

    pts = np.asarray(points, np.float32)
    n = len(pts)
    k = min(k, n)
    d = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    if not loop:
        np.fill_diagonal(d, np.inf)
    nbr = np.argpartition(d, kth=k - 1, axis=1)[:, :k]
    centers = np.repeat(np.arange(n), k)
    neighbors = nbr.reshape(-1)
    src = np.concatenate([neighbors, centers])
    dst = np.concatenate([centers, neighbors])
    ids = np.unique(src.astype(np.int64) * n + dst.astype(np.int64))
    return np.stack([ids // n, ids % n], axis=1).astype(np.int64)
