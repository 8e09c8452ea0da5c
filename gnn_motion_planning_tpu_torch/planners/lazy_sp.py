"""LazySP — lazy shortest-path planning over an optimistic RGG.

Port of gnn_motion_planning_tpu/planners/lazy_sp.py (host numpy, as there).

Equivalent of reference algorithm/lazy_sp.py:22-196: grow the sample set in
batches, run Dijkstra on the optimistically-free kNN graph, collision-check
only the edges of the candidate shortest path, remove invalid edges, repeat.
Sampling and edge checks go through the env's oracles (native core, device
oracle or host maze oracle, whichever the env has).
"""

from __future__ import annotations

import math
from collections import defaultdict
from time import time

import numpy as np

from gnn_motion_planning_tpu_torch.planners.dijkstra import dijkstra

INF = float("inf")


class LazySP:
    def __init__(self, environment, batch_size: int = 100, T: int = 1000, k: int = 10, timer=None):
        self.env = environment
        self.k0 = k
        self.start = tuple(environment.init_state)
        self.goal = tuple(environment.goal_state)
        self.bounds = np.array(environment.bound).reshape((2, -1)).T
        self.ranges = self.bounds[:, 1] - self.bounds[:, 0]
        self.dimension = environment.config_dim

        self.samples = []
        self.invalid_edges = set()
        self.valid_edges = set()
        self.batch_size = batch_size
        self.T, self.T_max = 0, T
        self.n_collision_points = 0
        self.n_free_points = 2

        from gnn_motion_planning_tpu_torch.utils.timer import Timer

        # reference lazy_sp.py:27-30 timer protocol (NN on graph build,
        # SHORTEST_PATH on the dijkstra repair loop)
        self.timer = timer if timer is not None else Timer()

    def _rand(self):
        return self.env.rng if getattr(self.env, "rng", None) is not None else np.random

    def informed_sample(self, sample_num):
        out = []
        while len(out) < sample_num:
            n = max(sample_num - len(out), 32)
            cand = self.bounds[:, 0] + self._rand().uniform(
                0, 1, (n, self.dimension)
            ) * self.ranges
            if hasattr(self.env, "_batch_free"):
                free = self.env._batch_free(cand)
                self.env.collision_check_count += len(cand)
            else:
                free = np.array([self.env._state_fp(p) for p in cand], bool)
            self.n_free_points += int(free.sum())
            self.n_collision_points += int((~free).sum())
            out.extend(tuple(p) for p in cand[free])
        return out[:sample_num]

    def construct_graph(self, k, points):
        from gnn_motion_planning_tpu_torch.graphs.knn_host import knn_graph_numpy

        points = np.array(points)
        edge_index = knn_graph_numpy(points, k=k, loop=True)
        edge_cost = defaultdict(list)
        neighbors = defaultdict(list)
        for edge in edge_index:
            a, b = int(edge[0]), int(edge[1])
            if (a, b) not in self.invalid_edges:
                edge_cost[b].append(float(np.linalg.norm(points[b] - points[a])))
                neighbors[b].append(a)
        return edge_cost, neighbors, edge_index

    @staticmethod
    def remove_neighbor(edge_cost, neighbors, n1, n2):
        index = neighbors[n1].index(n2)
        edge_cost[n1].pop(index)
        neighbors[n1].pop(index)
        index = neighbors[n2].index(n1)
        edge_cost[n2].pop(index)
        neighbors[n2].pop(index)

    def get_path(self, prev, start, goal):
        path = [start]
        current = start
        while current != goal:
            current = prev[current]
            path.append(current)
        return path

    def plan(self):
        collision_checks = self.env.collision_check_count
        self.samples.extend([self.goal, self.start])
        init_time = time()

        while self.T < self.T_max:
            self.samples.extend(self.informed_sample(self.batch_size))
            self.T += self.batch_size

            q = len(self.samples)
            self.k = int(np.ceil(self.k0 * np.log(q) / np.log(100)))
            self.timer.start()
            edge_cost, neighbors, edge_index = self.construct_graph(self.k, self.samples)
            self.timer.finish(self.timer.NN)

            while True:
                self.timer.start()
                dist, prev = dijkstra(
                    list(range(len(self.samples))), neighbors, edge_cost, 0
                )
                self.timer.finish(self.timer.SHORTEST_PATH)
                if dist[1] != INF:
                    feasible = True
                    path = self.get_path(prev, 1, 0)
                    for n1, n2 in zip(path[:-1], path[1:]):
                        if (n1, n2) in self.valid_edges:
                            continue
                        free = self.env._edge_fp(
                            np.array(self.samples[n1]), np.array(self.samples[n2])
                        )
                        if free:
                            self.valid_edges.add((n1, n2))
                            self.valid_edges.add((n2, n1))
                        else:
                            self.invalid_edges.add((n1, n2))
                            self.invalid_edges.add((n2, n1))
                            self.remove_neighbor(edge_cost, neighbors, n1, n2)
                            feasible = False
                            break
                    if feasible:
                        return (
                            self.samples,
                            self.env.collision_check_count - collision_checks,
                            [self.samples[n] for n in path],
                            self.T,
                            time() - init_time,
                            self.valid_edges,
                            self.invalid_edges,
                        )
                else:
                    break

        return (
            self.samples,
            self.env.collision_check_count - collision_checks,
            [],
            self.T,
            time() - init_time,
            self.valid_edges,
            self.invalid_edges,
        )
