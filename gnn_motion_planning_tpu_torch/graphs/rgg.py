"""r-disc random geometric graph with edge attributes (port of
gnn_motion_planning_tpu/graphs/rgg.py; reference environment/graph.py:14-198).

Vertices sampled from the env, r-disc edges with Free/Collided/Unknown
attributes checked through the env's host edge oracle, and random problems
from shortest paths, for supervised labels. Host numpy: a data-tooling
surface, the planner's RGG is ``graphs/knn.py``.
"""

from __future__ import annotations

import numpy as np


class EdgeAttribute:
    Collided = 0
    Free = 1
    Unknown = 2


def radius(n_samples: int, dim: int, eta: float = 1.1, volume: float = None):
    """RGG connection radius (graph.py:34-44,186-198)."""

    from scipy import special

    from gnn_motion_planning_tpu_torch.envs.env_config import LIMITS

    n = dim
    unit_ball_volume = np.pi ** (n / 2.0) / special.gamma(n / 2.0 + 1)
    if volume is None:
        volume = np.abs(np.prod(LIMITS[:n])) * (2**n)
    gamma = (1.0 + 1.0 / n) * volume / unit_ball_volume
    radius_constant = 2 * eta * (gamma ** (1.0 / n))
    q = n_samples
    return radius_constant * ((np.log(q) / q) ** (1.0 / dim))


class Graph:
    """r-disc RGG over env samples with lazily-updated edge attributes."""

    def __init__(self, env, k: int = 6):
        self.env = env
        self.dim = env.dim
        self.k = k
        self.V = []
        self.V_attr = []
        self.E = []
        self.E_attr = {}
        self.eta = 1.1

    def initialize(self, n_samples: int, self_loop: bool = True):
        env = self.env
        self.V.extend([tuple(env.init_state), tuple(env.goal_state)])
        self.V_attr.extend([True, True])
        for _ in range(n_samples):
            sample = env.uniform_sample()
            if env._point_in_free_space(sample):
                self.V.append(tuple(sample))
                self.V_attr.append(True)

        pts = np.asarray(self.V)
        r = radius(len(self.V), self.dim)
        d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
        src, dst = np.nonzero(d <= r)
        for a, b in zip(src, dst):
            if a == b and not self_loop:
                continue
            self.E.append((int(a), int(b)))
            self.E_attr[(int(a), int(b))] = EdgeAttribute.Unknown
        return self

    def update(self, edge, no_collision: bool):
        attr = EdgeAttribute.Free if no_collision else EdgeAttribute.Collided
        self.E_attr[edge] = attr
        self.E_attr[(edge[1], edge[0])] = attr

    def evaluate_all_edges(self):
        for a, b in self.E:
            if self.E_attr[(a, b)] == EdgeAttribute.Unknown:
                free = self.env._edge_fp(np.asarray(self.V[a]), np.asarray(self.V[b]))
                self.update((a, b), free)
        return self

    def shortest_path(self, start_idx: int = 0, goal_idx: int = 1):
        """Dijkstra over Free edges; returns vertex-index path ([] if none)."""

        from gnn_motion_planning_tpu_torch.planners.dijkstra import dijkstra_dense

        free_edges = [
            e for e in self.E if self.E_attr[e] == EdgeAttribute.Free
        ]
        if not free_edges:
            return []
        ei = np.asarray(free_edges)
        pts = np.asarray(self.V)
        cost = np.linalg.norm(pts[ei[:, 0]] - pts[ei[:, 1]], axis=-1)
        dist, prev = dijkstra_dense(len(self.V), ei, cost, start_idx)
        if not np.isfinite(dist[goal_idx]):
            return []
        path = [goal_idx]
        while path[-1] != start_idx:
            path.append(int(prev[path[-1]]))
        path.reverse()
        return path

    def random_problem(self, rng=None):
        """Pick a random reachable (start, goal) pair and its shortest path
        (graph.py:130-155 semantics)."""

        rng = rng or np.random
        self.evaluate_all_edges()
        n = len(self.V)
        for _ in range(100):
            a, b = int(rng.randint(0, n)), int(rng.randint(0, n))
            if a == b:
                continue
            path = self.shortest_path(a, b)
            if path:
                return a, b, path
        return None
