"""BIT* (Batch Informed Trees) — strongest classical baseline.

Port of gnn_motion_planning_tpu/planners/bit_star.py (host numpy, as there).

Algorithmically equivalent to the reference implementation (reference:
algorithm/bit_star.py:18-334): informed ellipsoid batch sampling, lazily
evaluated edge queue ordered by optimistic solution cost, vertex expansion
within a shrinking RGG radius, pruning on solution improvement.

Design differences from the reference (beyond the batched oracle):

* **Multi-root native.** The tree is seeded from ``roots`` (one for the
  standard planner); g/f-scores, heuristics and backtracking take the
  nearest root. The multi-start forest variant
  (:class:`~.bit_star_variants.BITStarTree`, reference
  algorithm/bit_star_tree.py:18-96) is then just a constructor, not a
  re-implementation of the bookkeeping.
* **Lazy ellipsoid frame.** The informed-sampling rotation is computed on
  the first informed draw (it is only defined once a solution cost is
  finite) instead of at setup time.
* **One shrinking-radius helper.** ``_shrinking_radius(q)`` owns the whole
  RGG radius formula (free-volume estimate -> gamma -> ``(log q / q)^1/n``
  shrink); the reference splits it across ``radius_init`` and an inline
  expression in the main loop.
* **Batched candidate evaluation.** Candidate batches are
  collision-checked in one device call (``env._batch_free``) instead of
  one PyBullet call per sample, and neighbour scans are vectorised numpy.
  The search control flow (heaps, parent map) stays on the host — it is
  latency- not compute-bound.
"""

from __future__ import annotations

import heapq
import math
from time import time

import numpy as np

INF = float("inf")


class BITStar:
    """Batch Informed Trees over the env's batched collision oracle.

    Public protocol (matches the reference driver surface,
    eval_bit.py:82-115): construct per problem, ``plan(...)`` returns
    ``(samples, parent_map, n_collision_checks, best_cost, n_samples,
    wall_s)``; ``get_best_path()`` afterwards.
    """

    # RGG stretch factor (reference bit_star.py:51: eta = 1.1)
    ETA = 1.1

    def __init__(
        self,
        environment,
        maxIter: int = 5,
        plot_flag: bool = False,
        batch_size: int = 200,
        T: int = 1000,
        sampling=None,
        timer=None,
        roots=None,
    ):
        from gnn_motion_planning_tpu_torch.utils.timer import Timer

        self.env = environment
        self.timer = timer if timer is not None else Timer()
        self.batch_size = batch_size
        self.T, self.T_max = 0, T
        self.maxIter = maxIter
        self.sampling = sampling if sampling is not None else self.informed_sample

        # configuration-space box: (dim, 2) rows of [lo, hi]
        self.bounds = np.asarray(environment.bound, float).reshape(2, -1).T
        self.ranges = self.bounds[:, 1] - self.bounds[:, 0]
        self.dimension = environment.config_dim

        self.goal = tuple(environment.goal_state)
        self.roots = (
            tuple(tuple(r) for r in roots)
            if roots is not None
            else (tuple(environment.init_state),)
        )
        self._root_set = set(self.roots)
        self.start = self.roots[0]
        # tightest possible solution cost; the informed ellipsoid's focal
        # distance (reference bit_star.py:56)
        self.c_min = min(self.distance(r, self.goal) for r in self.roots)

        # tree state: parent map + cost-to-come, explicit vertex list (its
        # order is the heap tie-breaking order), pool of not-yet-connected
        # samples, and the two lazy BIT* queues
        self.edges: dict = {}
        self.g_scores: dict = {}
        self.vertices: list = []
        self.samples: list = []
        self.vertex_queue: list = []
        self.edge_queue: list = []
        self.old_vertices: set = set()

        # free-volume estimate feeding the RGG radius (the two roots/goal
        # count as free; reference bit_star.py:66-67)
        self.n_free_points = 2
        self.n_collision_points = 0

        self._frame = None  # lazy informed-ellipsoid (center, rotation)
        self.r = INF
        self.deadline = None  # wall-clock bound honoured inside sampling

    # -- seeding / geometry ----------------------------------------------------

    def setup_planning(self) -> float:
        """Seed the tree (all roots at g=0) and the sample pool (goal at
        g=inf); returns the unshrunk RGG radius constant."""

        self.samples.append(self.goal)
        self.g_scores[self.goal] = INF
        for root in self.roots:
            self.vertices.append(root)
            self.g_scores[root] = 0
        return self._shrinking_radius(None)

    def _shrinking_radius(self, q: int | None) -> float:
        """RGG connection radius after q samples (reference splits this
        across radius_init :86-96 and the inline shrink :288).

        ``2 eta ((1 + 1/n) vol_free / zeta_n)^(1/n)`` times
        ``(log q / q)^(1/n)``; ``q=None`` returns the constant alone. The
        free-space volume is estimated from the running accept/reject
        counts of the sampler.
        """

        from scipy import special

        n = self.dimension
        unit_ball_volume = np.pi ** (n / 2.0) / special.gamma(n / 2.0 + 1)
        volume = (
            np.abs(np.prod(self.ranges))
            * self.n_free_points
            / (self.n_collision_points + self.n_free_points)
        )
        gamma = (1.0 + 1.0 / n) * volume / unit_ball_volume
        constant = 2 * self.ETA * (gamma ** (1.0 / n))
        if q is None:
            return constant
        return constant * ((math.log(q) / q) ** (1.0 / n))

    def _ellipsoid(self):
        """Informed-sampling frame: (center, world-from-ellipsoid rotation).
        Built on first use — it only matters once a finite solution cost
        exists (reference computes it eagerly in informed_sample_init
        :99-105)."""

        if self._frame is None:
            start = np.asarray(self.start)
            goal = np.asarray(self.goal)
            a_1 = (goal - start) / self.c_min
            U, _, Vh = np.linalg.svd(np.outer(a_1, np.ones(self.dimension)), 1, 1)
            det_scale = np.linalg.det(U) * np.linalg.det(Vh.T)
            C = U @ np.diag([1.0] * (self.dimension - 1) + [det_scale]) @ Vh
            self._frame = ((start + goal) / 2.0, C)
        return self._frame

    # -- sampling ----------------------------------------------------------------

    def _rand(self):
        rng = getattr(self.env, "rng", None)
        return rng if rng is not None else np.random

    def _draw_candidates(self, c_best, n):
        """n candidate points: uniform over the box until a solution
        exists, then uniform over the informed ellipsoid."""

        rng = self._rand()
        if c_best == INF:
            u = rng.uniform(0, 1, (n, self.dimension))
            return self.bounds[:, 0] + u * self.ranges
        center, C = self._ellipsoid()
        c_b = math.sqrt(max(c_best**2 - self.c_min**2, 0.0)) / 2.0
        L = np.diag([c_best / 2.0] + [c_b] * (self.dimension - 1))
        u = rng.normal(0, 1, (n, self.dimension))
        u /= np.linalg.norm(u, axis=1, keepdims=True) + 1e-12
        radii = rng.uniform(0, 1, n) ** (1.0 / self.dimension)
        return (u * radii[:, None]) @ (C @ L).T + center

    def _batch_point_free(self, pts: np.ndarray) -> np.ndarray:
        """Batched _state_fp with reference counting (one count per check)
        and the free-volume tallies the radius estimate feeds on."""

        env = self.env
        if hasattr(env, "_batch_free"):
            free = env._batch_free(pts)
            env.collision_check_count += len(pts)
        else:
            free = np.array([env._state_fp(p) for p in pts], bool)
        self.n_free_points += int(free.sum())
        self.n_collision_points += int((~free).sum())
        return free

    def informed_sample(self, c_best, sample_num, vertices, max_rounds: int = 500):
        from gnn_motion_planning_tpu_torch.utils.timer import Timer

        self.timer.start()
        out = []
        rounds = 0
        while len(out) < sample_num and rounds < max_rounds:
            rounds += 1
            cand = self._draw_candidates(c_best, max(sample_num - len(out), 32))
            free = self._batch_point_free(cand)
            out.extend(tuple(p) for p in cand[free])
            if self.deadline is not None and time() > self.deadline:
                break
        self.timer.finish(Timer.SAMPLE)
        return out[:sample_num]

    # -- scores --------------------------------------------------------------

    @staticmethod
    def distance(point1, point2):
        return float(np.linalg.norm(np.asarray(point1) - np.asarray(point2)))

    def heuristic_cost(self, point1, point2):
        return self.distance(point1, point2)

    def _h_root(self, point) -> float:
        """Admissible cost-to-come: distance to the nearest root."""

        return min(self.heuristic_cost(r, point) for r in self.roots)

    def get_g_score(self, point):
        if point in self._root_set:
            return 0
        if point not in self.edges:
            return INF
        return self.g_scores.get(point)

    def get_f_score(self, point):
        return self._h_root(point) + self.heuristic_cost(point, self.goal)

    def actual_edge_cost(self, point1, point2):
        if not self.env._edge_fp(np.array(point1), np.array(point2)):
            return INF
        return self.distance(point1, point2)

    def get_edge_value(self, edge):
        return (
            self.get_g_score(edge[0])
            + self.heuristic_cost(edge[0], edge[1])
            + self.heuristic_cost(edge[1], self.goal)
        )

    def get_point_value(self, point):
        return self.get_g_score(point) + self.heuristic_cost(point, self.goal)

    # -- batch boundary ---------------------------------------------------------

    def _start_batch(self):
        """Prune to the current-best ellipse, draw one sample batch, and
        rebuild the vertex queue (reference main-loop head :277-288)."""

        from gnn_motion_planning_tpu_torch.utils.timer import Timer

        c_best = self.g_scores[self.goal]
        self._prune(c_best)
        self.samples.extend(self.sampling(c_best, self.batch_size, self.vertices))
        self.T += self.batch_size
        self.old_vertices = set(self.vertices)

        self.timer.start()
        self.vertex_queue = [(self.get_point_value(p), p) for p in self.vertices]
        heapq.heapify(self.vertex_queue)
        self.timer.finish(Timer.HEAP)

        q = len(self.vertices) + len(self.samples)
        self.r = self._shrinking_radius(q)

    def _prune(self, c_best):
        """Drop samples, tree edges and vertices that cannot participate in
        a solution better than c_best; disconnected survivors return to the
        sample pool (reference prune :194-210)."""

        self.samples = [p for p in self.samples if self.get_f_score(p) < c_best]
        self.edges = {
            point: parent
            for point, parent in self.edges.items()
            if self.get_f_score(point) <= c_best
            and self.get_f_score(parent) <= c_best
        }
        connected, orphaned = [], []
        for point in self.vertices:
            if self.get_f_score(point) <= c_best:
                (orphaned if self.get_g_score(point) == INF else connected).append(
                    point
                )
        self.samples.extend(orphaned)
        self.vertices = connected

    # -- expansion ----------------------------------------------------------------

    def expand_vertex(self, point):
        """Queue every potentially-improving edge out of ``point``
        (vectorised; reference bit_star.py:212-247 loops over every
        sample/vertex in Python)."""

        from gnn_motion_planning_tpu_torch.utils.timer import Timer

        self.timer.start()

        p = np.asarray(point)
        goal = np.asarray(self.goal)
        c_sol = self.g_scores[self.goal]
        g_p = self.get_g_score(point)
        h_start = self._h_root(point)

        if self.samples:
            s_arr = np.asarray(self.samples)
            d = np.linalg.norm(s_arr - p, axis=1)
            near = d <= self.r
            if near.any():
                h_goal = np.linalg.norm(s_arr[near] - goal, axis=1)
                est_f = h_start + d[near] + h_goal
                for ok, sample, dd, hg in zip(
                    est_f < c_sol, np.nonzero(near)[0], d[near], h_goal
                ):
                    if ok:
                        nb = self.samples[sample]
                        heapq.heappush(
                            self.edge_queue, (g_p + dd + hg, (point, nb))
                        )

        if point not in self.old_vertices and self.vertices:
            v_arr = np.asarray(self.vertices)
            d = np.linalg.norm(v_arr - p, axis=1)
            for vi in np.nonzero(d <= self.r)[0]:
                neighbor = self.vertices[vi]
                if neighbor in self.edges and point == self.edges.get(neighbor):
                    continue  # already its parent
                est_f = (
                    h_start + d[vi] + self.heuristic_cost(neighbor, self.goal)
                )
                if est_f < c_sol and g_p + d[vi] < self.get_g_score(neighbor):
                    heapq.heappush(
                        self.edge_queue,
                        (self.get_edge_value((point, neighbor)), (point, neighbor)),
                    )
        self.timer.finish(Timer.EXPAND)

    def _rewire(self, parent, child, g_child):
        """Adopt ``child`` at cost ``g_child``: promote it from the sample
        pool into the tree if new, then drop queued edges into it that can
        no longer improve it: keep (v, x) only while
        g(v) + c_hat(v, x) < g(x).

        The reference's filter (bit_star.py:320-322) self-compares
        g(v) + h < g(v) — always false — silently dropping every queued
        edge into x; this is the intended semantics
        (tests/test_bit_star.py pins it).
        """

        self.g_scores[child] = g_child
        self.edges[child] = parent
        if child not in self.vertices:
            self.samples.remove(child)
            self.vertices.append(child)
            heapq.heappush(
                self.vertex_queue, (self.get_point_value(child), child)
            )
        # the filter runs on EVERY improving rewire (not only promotions):
        # an improved g(child) can retire queued edges into an
        # already-connected child too
        self.edge_queue = [
            item
            for item in self.edge_queue
            if item[1][1] != child
            or self.get_g_score(item[1][0])
            + self.heuristic_cost(item[1][0], item[1][1])
            < self.get_g_score(child)
        ]
        heapq.heapify(self.edge_queue)

    # -- results -------------------------------------------------------------------

    def get_best_path(self):
        path = []
        if self.g_scores[self.goal] != INF:
            path.append(self.goal)
            point = self.goal
            while point not in self._root_set:
                point = self.edges[point]
                path.append(point)
            path.reverse()
        return path

    def path_length_calculate(self, path):
        return sum(self.distance(path[i], path[i + 1]) for i in range(len(path) - 1))

    # -- main loop (reference bit_star.py:266-334) -----------------------------

    def plan(self, pathLengthLimit, refine_time_budget=None, time_budget=None):
        checks_before = self.env.collision_check_count
        if time_budget is None:
            time_budget = INF
        if refine_time_budget is None:
            refine_time_budget = 10

        self.setup_planning()
        init_time = time()
        if time_budget != INF:
            self.deadline = init_time + time_budget

        while self.T < self.T_max and (time() - init_time < time_budget):
            if not self.vertex_queue and not self.edge_queue:
                self._start_batch()

            # expand vertices while the best vertex could still beat the
            # best queued edge (lazy queue interleave, reference :296-303)
            while self.vertex_queue and (
                (self.vertex_queue[0][0] if self.vertex_queue else INF)
                <= (self.edge_queue[0][0] if self.edge_queue else INF)
            ):
                _, point = heapq.heappop(self.vertex_queue)
                self.expand_vertex(point)
            if not self.edge_queue:
                if not self.vertex_queue:
                    continue
                raise RuntimeError("edge queue empty with vertices pending")

            best_edge_value, (u, x) = heapq.heappop(self.edge_queue)

            if best_edge_value < self.g_scores[self.goal]:
                edge_cost = self.actual_edge_cost(u, x)
                true_f = (
                    self.heuristic_cost(self.start, u)
                    + edge_cost
                    + self.heuristic_cost(x, self.goal)
                )
                if true_f < self.g_scores[self.goal]:
                    g_x = self.get_g_score(u) + edge_cost
                    if g_x < self.get_g_score(x):
                        self._rewire(u, x, g_x)
            else:
                # best queued edge can no longer improve the solution:
                # finish this batch
                self.vertex_queue = []
                self.edge_queue = []
            if self.g_scores[self.goal] < pathLengthLimit and (
                time() - init_time > refine_time_budget
            ):
                break
        return (
            self.samples,
            self.edges,
            self.env.collision_check_count - checks_before,
            self.g_scores[self.goal],
            self.T,
            time() - init_time,
        )
