"""BIT* variants: supervision recording and multi-start forest.

Port of gnn_motion_planning_tpu/planners/bit_star_variants.py (host numpy, as there).

* :class:`BITStarTrack` — records every explored node/edge including the
  collision points of failed edge checks; used to generate supervision and
  visualisation data (reference: algorithm/bit_star_track.py, diff at
  :145-157).
* :class:`BITStarTree` — plans from a *set* of start states toward one goal
  (tree/forest variant; reference: algorithm/bit_star_tree.py:18-96).
"""

from __future__ import annotations

import numpy as np

from gnn_motion_planning_tpu_torch.planners.bit_star import INF, BITStar


class BITStarTrack(BITStar):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.explored_nodes = []
        self.explored_edges = []

    def actual_edge_cost(self, point1, point2):
        free = self.env._edge_fp(np.array(point1), np.array(point2))
        if point1 not in self.explored_nodes:
            self.explored_nodes.append(point1)
        id0 = self.explored_nodes.index(point1)
        if free:
            if point2 not in self.explored_nodes:
                self.explored_nodes.append(point2)
            id1 = self.explored_nodes.index(point2)
        else:
            collision_point = (
                tuple(self.env.collision_point)
                if self.env.collision_point is not None
                else point2
            )
            if collision_point not in self.explored_nodes:
                self.explored_nodes.append(collision_point)
            id1 = self.explored_nodes.index(collision_point)
        self.explored_edges.append((id0, id1))
        if not free:
            return INF
        return self.distance(point1, point2)


class BITStarTree(BITStar):
    """Multi-start BIT* (forest): g(start_i) = 0 for every start;
    heuristics and backtracking use the nearest start.

    Since the base planner is multi-root native (``roots=``), this variant
    is just the constructor mapping the reference's ``starts`` argument
    (reference algorithm/bit_star_tree.py:18-96) onto it.
    """

    def __init__(self, environment, starts, **kwargs):
        super().__init__(environment, roots=starts, **kwargs)
        self.starts = list(self.roots)
