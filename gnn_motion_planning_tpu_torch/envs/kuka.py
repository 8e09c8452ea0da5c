"""KUKA iiwa environments (kuka7, kuka13): batched FK plus the capsule
kernel.

Port of gnn_motion_planning_tpu/envs/kuka.py. Problems are the
pickled (obstacles(halfExtents, basePosition), start, goal, demo_path)
lists; the robot is a capsule decomposition of the URDF meshes with the
calibrated radii. The device oracle is ``ops/capsule.py::chain_states_free``
(limits, FK and the narrow phase): one launch of its fused kernel on the
card, its plain PyTorch version on the CPU. Host sampling goes through the
port's own build of the float64 native core (utils/geomcore.py), as the JAX
package's does, so the accepted-sample stream is the same. A missing native
core is an error, never a silent switch to another oracle. ``KukaEnv`` is
also the host wrapper of the other fixed-step envs (envs/ur5.py,
envs/kuka2.py, envs/snake.py), which bring their own robot, problems,
kernels and sampling oracle.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.envs.base import (
    EnvKernels,
    K_CHEAP,
    make_fixed_step_edge_free,
    rejection_sample,
)
from gnn_motion_planning_tpu_torch.envs.kinematics import ChainParams, chain_from_model, norm_last
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import chain_states_free, pack_chain
from gnn_motion_planning_tpu_torch.utils.assets import asset_path
from gnn_motion_planning_tpu_torch.utils.geomcore import GeomChain

MAX_OBSTACLES = 16


def _apply_calibration(chain: ChainParams, urdf_relpath: str) -> ChainParams:
    """Shrink capsule radii by the offsets calibrated against the shipped
    known-free configurations (assets/calibration/<urdf stem>.json)."""

    try:
        cal_path = asset_path(f"calibration/{Path(urdf_relpath).stem}.json")
    except FileNotFoundError:
        return chain
    offsets = np.asarray(json.loads(Path(cal_path).read_text())["radius_offsets"], np.float32)
    if offsets.shape[0] != chain.cap_r.shape[0]:
        return chain  # stale calibration for a different decomposition
    off = torch.as_tensor(offsets, device=chain.cap_r.device)
    return chain._replace(cap_r=torch.clamp_min(chain.cap_r - off, 1e-3))


class BoxScene(NamedTuple):
    """Padded axis-aligned obstacle set for one problem."""

    centers: torch.Tensor  # (MAX_OBSTACLES, 3)
    halfs: torch.Tensor  # (MAX_OBSTACLES, 3)
    mask: torch.Tensor  # (MAX_OBSTACLES,) bool


def _coerce_vec3(x) -> np.ndarray:
    return np.array([float(np.asarray(v).reshape(-1)[0]) for v in x], np.float32)


def make_box_scene(obstacles, device) -> BoxScene:
    centers = np.zeros((MAX_OBSTACLES, 3), np.float32)
    halfs = np.zeros((MAX_OBSTACLES, 3), np.float32)
    mask = np.zeros(MAX_OBSTACLES, bool)
    for i, (half, base) in enumerate(obstacles):
        halfs[i] = _coerce_vec3(half)
        centers[i] = _coerce_vec3(base)
        mask[i] = True
    return BoxScene(*(torch.as_tensor(a, device=device) for a in (centers, halfs, mask)))


def _clamp(x, lower, upper):
    return torch.minimum(torch.maximum(x, lower), upper)


def arm_kernels(batch_state_free, lower, upper, rrt_eps: float, k_max: int) -> EnvKernels:
    """EnvKernels of a fixed-step arm env from its batched state oracle:
    the clamped Euclidean metric and steering rule, the edge check at the
    space diagonal's budget and, where that is large, at K_CHEAP."""

    def distance(a, b):
        return norm_last(_clamp(b, lower, upper) - a)

    def interpolate(a, b, ratio):
        return _clamp(a + (b - a) * ratio[..., None], lower, upper)

    edge_free = make_fixed_step_edge_free(
        batch_state_free, distance, lower, upper, rrt_eps, k_max
    )
    edge_free_cheap = None
    if k_max > K_CHEAP + 16:
        edge_free_cheap = make_fixed_step_edge_free(
            batch_state_free, distance, lower, upper, rrt_eps, K_CHEAP,
            with_overflow=True,
        )
    return EnvKernels(
        batch_state_free=batch_state_free,
        edge_free=edge_free,
        distance=distance,
        interpolate=interpolate,
        edge_free_cheap=edge_free_cheap,
        bounds=(lower, upper),
    )


def make_chain_kernels(chain: ChainParams, rrt_eps: float, k_max: int) -> EnvKernels:
    """EnvKernels for a serial-chain robot among AABB obstacles."""

    packed = pack_chain(chain)

    def batch_state_free(scene: BoxScene, qs: torch.Tensor):
        return chain_states_free(qs.contiguous(), packed, scene)

    return arm_kernels(batch_state_free, chain.lower, chain.upper, rrt_eps, k_max)


class KukaEnv:
    """Host wrapper with the reference env protocol (kuka_env.py:10-411)."""

    RRT_EPS = 0.5

    def __init__(
        self,
        kuka_file: str = "kuka_iiwa/model_0.urdf",
        map_file: str = "maze_files/kukas_7_3000.pkl",
        device=None,
    ):
        self._start(device)
        self._load_problems(map_file)
        model = parse_urdf(asset_path(kuka_file))
        self.chain = _apply_calibration(chain_from_model(model, self.device), kuka_file)
        self._set_pose_range(model.pose_range())
        self._native = GeomChain(self.chain.numpy_arrays(), self.RRT_EPS)

    def _start(self, device):
        """The host state every env of this family starts with."""

        self.device = resolve_device(device)
        self.collision_check_count = 0
        self.rng = None
        self.episode_i = 0
        self._native = None  # host sampling oracle; None: the device oracle
        self._kernels = None

    def _load_problems(self, map_file: str):
        with open(asset_path(map_file), "rb") as f:
            self.problems = pickle.load(f)

    def _set_pose_range(self, pose_range):
        self.pose_range = [(float(lo), float(hi)) for lo, hi in pose_range]
        self.config_dim = len(self.pose_range)
        self.bound = np.array(self.pose_range).T.reshape(-1)

    def __str__(self):
        return "kuka" + str(self.config_dim)

    def init_new_problem(self, index: Optional[int] = None):
        if index is None:
            index = self.episode_i
        self.index = index
        obstacles, start, goal, path = self.problems[index]
        self.episode_i = (self.episode_i + 1) % len(self.problems)
        self.collision_check_count = 0
        self.obstacles = obstacles
        self.init_state = np.asarray(start)
        self.goal_state = np.asarray(goal)
        self.path = path
        self._scene = make_box_scene(obstacles, self.device)
        if self._native is not None:
            if obstacles:
                centers = np.stack([_coerce_vec3(b) for _, b in obstacles])
                halfs = np.stack([_coerce_vec3(h) for h, _ in obstacles])
            else:
                centers = halfs = np.zeros((0, 3))
            self._native.set_scene(centers, halfs)

    def device_scene(self) -> BoxScene:
        return self._scene

    def kernels(self) -> EnvKernels:
        if self._kernels is None:
            self._kernels = make_chain_kernels(self.chain, self.RRT_EPS, self._k_max())
        return self._kernels

    def _k_max(self) -> int:
        pr = np.array(self.pose_range)
        d_max = float(np.linalg.norm(pr[:, 1] - pr[:, 0]))
        return int(d_max / self.RRT_EPS) + 2

    def obs_tokens(self):
        toks = np.zeros((MAX_OBSTACLES, 6), np.float32)
        mask = np.zeros(MAX_OBSTACLES, bool)
        for i, (half, base) in enumerate(self.obstacles):
            toks[i, :3] = _coerce_vec3(half)
            toks[i, 3:] = _coerce_vec3(base)
            mask[i] = True
        return toks, mask

    # -- sampling ------------------------------------------------------------

    def sample_n_points(self, n: int, need_negative: bool = False):
        """Chunked rejection sampling (kuka.py:388-451): through the native
        core where the env has one, else through the device oracle with
        chunks sized by the accept rate."""

        return rejection_sample(self, n, need_negative, self._batch_free,
                                adaptive=self._native is None)

    def _batch_free(self, draws: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.states_free(draws)[0]
        qs = torch.as_tensor(np.asarray(draws, np.float32), device=self.device)
        free, _ = self.kernels().batch_state_free(self._scene, qs)
        return free.cpu().numpy()

    # -- metric (host) -------------------------------------------------------

    def distance(self, from_state, to_state):
        pr = np.array(self.pose_range)
        to_state = np.clip(to_state, pr[:, 0], pr[:, 1])
        return np.sqrt(np.sum((to_state - from_state) ** 2, axis=-1))
