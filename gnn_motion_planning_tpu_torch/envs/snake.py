"""5-link snake robot in a 2-D maze: free-base kinematics and
self-collision (port of gnn_motion_planning_tpu/envs/snake.py; reference
environment/snake_env.py).

The snake floats at z = 0.5 in a 15 x 15 maze of 1.4 m boxes. A
configuration maps to the robot as the reference maps it
(snake_env.py:118-135): base position (q0, q1), base yaw q3, revolute
joints [q2, q3, q4, q5]; q6 is unused. The URDF alternates sphere and
capsule links.

A configuration collides when a capsule touches an occupied cell, through
``ops/capsule.py::capsules_hit`` over the problem's occupied cells as
boxes (one launch of its kernel on the card; the JAX package tests a 3 x 3
window of cells around each capsule, which decides the same), or when
capsules of links 4 or more hops apart touch, as batched tensor ops.
Sampling goes through the device oracle.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels
from gnn_motion_planning_tpu_torch.envs.geometry import contact_pairs, pair_contacts
from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world, chain_from_model
from gnn_motion_planning_tpu_torch.envs.kuka import BoxScene, KukaEnv, arm_kernels
from gnn_motion_planning_tpu_torch.envs.ur5 import pair_mask_from_hops
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import capsules_hit
from gnn_motion_planning_tpu_torch.utils.assets import asset_path

HEIGHT = 0.5
GRID_W = 15
# the JAX package's grid scene holds at most this many occupied cells
MAX_CELLS = 160


def make_snake_scene(occ_map: np.ndarray, device) -> BoxScene:
    """The occupied cells as boxes, column by column (JAX
    envs/snake.py:46-58): cell (i, j) has its centre at (1.4 i - 10.5,
    1.4 j - 10.5, 0) and half extents (0.7, 0.7, 1.0)."""

    occ = np.asarray(occ_map)
    cells = [(i, j) for j in range(occ.shape[1]) for i in range(occ.shape[0]) if occ[i, j]]
    if len(cells) > MAX_CELLS:
        raise ValueError(f"{len(cells)} occupied cells exceed the cap of {MAX_CELLS}")
    centers = np.array([(1.4 * i - 10.5, 1.4 * j - 10.5, 0.0) for i, j in cells],
                       np.float32).reshape(-1, 3)
    halfs = np.tile(np.array([0.7, 0.7, 1.0], np.float32), (len(cells), 1))
    mask = np.ones(len(cells), bool)
    return BoxScene(*(torch.as_tensor(a, device=device) for a in (centers, halfs, mask)))


def snake_capsules(chain, qs: torch.Tensor):
    """Capsule endpoints and radii of configurations qs (B, 7) under the
    reference's mapping: base (q0, q1, HEIGHT), yaw q3, joints q2..q5."""

    c, s = torch.cos(qs[:, 3]), torch.sin(qs[:, 3])
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    base_rot = torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    base_trans = torch.stack([qs[:, 0], qs[:, 1], torch.full_like(c, HEIGHT)], dim=-1)
    return capsules_world(chain, qs[:, 2:6], base_rot=base_rot, base_trans=base_trans)


def make_snake_kernels(chain, pair_mask: np.ndarray, lower, upper, rrt_eps: float,
                       k_max: int) -> EnvKernels:
    """JAX envs/snake.py:187-217, batched: limits, cells and self pairs."""

    pair_i, pair_j, pair_r2 = contact_pairs(pair_mask, chain.cap_r.cpu().numpy(),
                                            chain.cap_r.device)

    def batch_state_free(scene, qs):
        valid = ((qs >= lower) & (qs <= upper)).all(dim=1)
        p0, p1, r = snake_capsules(chain, qs)
        p0, p1 = p0.contiguous(), p1.contiguous()
        box = capsules_hit(p0, p1, r, scene.centers, scene.halfs, scene.mask)
        self_hit = pair_contacts(p0, p1, pair_i, pair_j, pair_r2)
        return valid & ~box & ~self_hit, valid.to(torch.int32)

    return arm_kernels(batch_state_free, lower, upper, rrt_eps, k_max)


class SnakeEnv(KukaEnv):
    """Host wrapper with the reference SnakeEnv protocol: KukaEnv's metric,
    step budget and sampling through the device oracle, on maze problems."""

    RRT_EPS = 0.1

    def __init__(self, map_file: str = "maze_files/snakes_15_2_3000.npz", device=None):
        self._start(device)
        with np.load(asset_path(map_file)) as f:
            self.maps = f["maps"]
            self.init_states = f["init_states"]
            self.goal_states = f["goal_states"]
        self.width = self.maps.shape[1]
        self._set_pose_range([(-9.0, 9.0), (-9.0, 9.0)] + [(-np.pi, np.pi)] * 5)

        model = parse_urdf(asset_path("snake.urdf"))
        self.chain = chain_from_model(model, self.device)
        # links 4 or more hops apart: the capsule fits of neighbouring
        # capsule and ball links overlap by construction
        self.pair_mask = pair_mask_from_hops(model, self.chain.cap_link.cpu().numpy(), 4)
        pr = np.array(self.pose_range, np.float32)
        self.lower = torch.as_tensor(pr[:, 0], device=self.device)
        self.upper = torch.as_tensor(pr[:, 1], device=self.device)

    def __str__(self):
        return "snake" + str(self.config_dim)

    def init_new_problem(self, index: Optional[int] = None):
        if index is None:
            index = self.episode_i
        self.index = index
        self.episode_i = (self.episode_i + 1) % len(self.maps)
        self.collision_check_count = 0
        self.map = self.maps[index]
        self.init_state = self.init_states[index]
        self.goal_state = self.goal_states[index]
        self.obstacles = np.argwhere(self.map == 1) / self.map.shape[0] - 0.5
        self._scene = make_snake_scene(self.map, self.device)

    def kernels(self) -> EnvKernels:
        if self._kernels is None:
            self._kernels = make_snake_kernels(
                self.chain, self.pair_mask, self.lower, self.upper, self.RRT_EPS, self._k_max())
        return self._kernels

    def obs_tokens(self):
        """The occupied cells' grid coordinates, scaled to [-0.5, 0.5), in
        225 token slots."""

        cap = self.width * self.width
        toks = np.zeros((cap, 2), np.float32)
        mask = np.zeros(cap, bool)
        n = len(self.obstacles)
        toks[:n] = self.obstacles
        mask[:n] = True
        return toks, mask
