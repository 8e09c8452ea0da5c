"""UR5 6-DoF tabletop environment: boxes, self-collision and the ground
plane (port of gnn_motion_planning_tpu/envs/ur5.py; reference
environment/ur5_env.py).

The device oracle has three families of checks, each with its own
calibrated capsule radii (assets/calibration/ur5.json):

* boxes: every capsule against the problem's AABBs, through
  ``ops/capsule.py::capsules_hit`` (one launch of its kernel on the card);
* self-collision: capsule pairs of links at least 3 hops apart in the
  kinematic tree (PyBullet excludes adjacent links);
* the ground plane z = 0, for capsules of links that can reach it.

Forward kinematics and the last two families are batched tensor ops on the
capsule endpoints; nothing is read back to the host inside a call. UR5 has
no native core: sampling goes through the device oracle.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels, lane_oracle
from gnn_motion_planning_tpu_torch.envs.geometry import contact_pairs, pair_contacts
from gnn_motion_planning_tpu_torch.envs.kinematics import (
    chain_from_model,
    lane_capsules,
    link_translations,
)
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv, arm_kernels
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import capsules_hit
from gnn_motion_planning_tpu_torch.utils.assets import asset_path

# links that rest on or below the table: never tested against the plane
_GROUNDED = {"world", "rotated_base_link", "base_link", "base", "shoulder_link"}


class UR5Geom(NamedTuple):
    """Static UR5 collision metadata beyond the kinematic chain."""

    pair_mask: torch.Tensor  # (C, C) bool: self-collision pairs to test
    pairs: tuple  # geometry.contact_pairs of pair_mask with r_self
    plane_mask: torch.Tensor  # (C,) bool: capsules tested against z = 0
    r_box: torch.Tensor  # (C,) radii of each family
    r_self: torch.Tensor
    r_plane: torch.Tensor

    @property
    def pair_i(self) -> torch.Tensor:
        """(P,) long: the first capsule of each self pair, row-major."""

        return self.pairs[0]


def link_graph_distance(model) -> np.ndarray:
    """Hop counts between the links of the kinematic tree."""

    idx = {n: i for i, n in enumerate(model.link_order)}
    n = len(idx)
    dist = np.full((n, n), 99, int)
    np.fill_diagonal(dist, 0)
    for j in model.joints:
        a, b = idx[j.parent], idx[j.child]
        dist[a, b] = dist[b, a] = 1
    for _ in range(n):
        for k in range(n):
            dist = np.minimum(dist, dist[:, k : k + 1] + dist[k : k + 1, :])
    return dist


def pair_mask_from_hops(model, cap_link: np.ndarray, min_hops: int) -> np.ndarray:
    """(C, C) bool: capsule pairs whose links are ``min_hops`` or more apart."""

    hops = link_graph_distance(model)
    return hops[cap_link[:, None], cap_link[None, :]] >= min_hops


def build_ur5_geom(model, chain, calibration=None) -> UR5Geom:
    """Pairs >= 3 hops apart (conservative fits of neighbours overlap),
    the plane mask and the calibrated radii of each family (JAX
    envs/ur5.py:64-121)."""

    dev = chain.cap_r.device
    cap_link = chain.cap_link.cpu().numpy()
    n_caps = cap_link.shape[0]
    pair_mask = pair_mask_from_hops(model, cap_link, 3)
    plane_mask = np.array([model.link_order[c] not in _GROUNDED for c in cap_link], bool)

    r = chain.cap_r.cpu().numpy()
    r_box, r_self, r_plane = r.copy(), r.copy(), r.copy()
    if calibration:
        for key, arr in (("box_offsets", r_box), ("self_offsets", r_self),
                         ("plane_offsets", r_plane)):
            off = np.asarray(calibration.get(key, np.zeros(n_caps)), np.float32)
            if off.shape[0] == n_caps:
                arr -= off
        r_box, r_self, r_plane = (np.maximum(a, 1e-3) for a in (r_box, r_self, r_plane))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return UR5Geom(
        pair_mask=t(pair_mask), pairs=contact_pairs(pair_mask, r_self, dev),
        plane_mask=t(plane_mask), r_box=t(np.asarray(r_box, np.float32)),
        r_self=t(np.asarray(r_self, np.float32)), r_plane=t(np.asarray(r_plane, np.float32)),
    )


def ur5_states_free(chain, geom: UR5Geom, scene, qs: torch.Tensor):
    """(free, n_checks) of configurations qs (L, B, 6) in the lanes of a
    stacked scene: within the limits, and no box, self
    or plane contact (JAX envs/ur5.py:124-143)."""

    valid = ((qs >= chain.lower) & (qs <= chain.upper)).all(dim=-1)
    p0, p1 = lane_capsules(chain, qs)
    box = capsules_hit(p0, p1, geom.r_box, scene.centers, scene.halfs, scene.mask)
    self_hit = pair_contacts(p0, p1, geom.pairs)
    zmin = torch.minimum(p0[..., 2], p1[..., 2])
    plane = ((zmin < geom.r_plane) & geom.plane_mask).any(dim=-1)
    return valid & ~box & ~self_hit & ~plane, valid.to(torch.int32)


def make_ur5_kernels(chain, geom: UR5Geom, rrt_eps: float, k_max: int) -> EnvKernels:
    @lane_oracle
    def batch_state_free(scene, qs):
        return ur5_states_free(chain, geom, scene, qs)

    return arm_kernels(batch_state_free, chain.lower, chain.upper, rrt_eps, k_max)


class UR5Env(KukaEnv):
    """Host wrapper with the reference UR5Env protocol: KukaEnv's problems,
    obstacle tokens and sampling, through the device oracle."""

    RRT_EPS = 0.1

    def __init__(self, map_file: str = "maze_files/ur5s_6_3000.pkl", device=None):
        self._start(device)
        self._load_problems(map_file)
        # 6 capsules a link: a 3-capsule fit of the chunky UR5 meshes
        # overshoots by up to 5.4 cm (JAX envs/ur5.py:199-205)
        self.model = model = parse_urdf(asset_path("ur5/ur5.urdf"), n_caps=6)
        self.chain = chain_from_model(model, self.device)
        self._set_pose_range(model.pose_range())
        calibration = json.loads(Path(asset_path("calibration/ur5.json")).read_text())
        self.geom = build_ur5_geom(model, self.chain, calibration)
        self.tip_index = model.link_order.index("ee_link")

    def __str__(self):
        return "ur5"

    def init_new_problem_with_config(self, start, goal, obstacles):
        """A problem given by its endpoints and boxes (reference
        ur5_env.py:84-102, JAX envs/ur5.py:229-233)."""

        self.set_problem_data(obstacles, start, goal)
        return self.get_problem()

    def kernels(self) -> EnvKernels:
        if self._kernels is None:
            self._kernels = make_ur5_kernels(self.chain, self.geom, self.RRT_EPS, self._k_max())
        return self._kernels

    def robot_points(self, configs) -> np.ndarray:
        ts = link_translations(self.host_chain, np.asarray(configs).reshape(-1, self.config_dim))
        return ts[:, self.tip_index] - np.array([0.0, 0.0, 0.4])

    def get_robot_points(self, config, end_point: bool = True):
        """FK workspace points of the tool link, z - 0.4 (JAX
        envs/ur5.py:244-249)."""

        if end_point:
            return tuple(self.robot_points(config)[0])
        pts = link_translations(self.host_chain, config) - np.array([0.0, 0.0, 0.4])
        return [tuple(p) for p in pts[1 : self.tip_index + 1]]
