"""Dual-KUKA 14-DoF environment: two arms and their cross-arm contacts
(port of gnn_motion_planning_tpu/envs/kuka2.py; reference
environment/kuka_2arm_env.py).

Two calibrated iiwa arms (``kuka_iiwa/model_0.urdf``) stand at x = -0.5
and x = +0.5; a configuration is the first arm's 7 angles, then the
second's. A configuration collides when a capsule of either arm touches an
obstacle box, through ``ops/capsule.py::capsules_hit`` over both arms' 48
capsules (one launch of its kernel on the card), or when a capsule of one
arm touches one of the other's, as batched tensor ops on the endpoints.
Host sampling goes through the port's build of the float64 native core
(``utils/geomcore.py::GeomDual``), as the JAX package's does.
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels, lane_oracle
from gnn_motion_planning_tpu_torch.envs.geometry import contact_pairs, pair_contacts, vector_tail
from gnn_motion_planning_tpu_torch.envs.kinematics import (
    capsules_world,
    chain_from_model,
    lane_capsules,
    link_translations,
)
from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv, _apply_calibration, arm_kernels
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import capsules_hit
from gnn_motion_planning_tpu_torch.utils.assets import asset_path
from gnn_motion_planning_tpu_torch.utils.geomcore import GeomDual

BASES = ((-0.5, 0.0, 0.0), (0.5, 0.0, 0.0))


def make_dual_kernels(chain, base1, base2, rrt_eps: float, k_max: int) -> EnvKernels:
    """The kernels of two copies of ``chain`` rooted at ``base1`` and
    ``base2`` (3,) (JAX envs/kuka2.py:42-101)."""

    dof = chain.lower.shape[0]
    C = chain.cap_r.shape[0]
    lower = torch.cat([chain.lower, chain.lower])
    upper = torch.cat([chain.upper, chain.upper])
    r = torch.cat([chain.cap_r, chain.cap_r])
    # every capsule of the first arm against every capsule of the second;
    # XLA takes each arm's squared lengths in its own loop of C capsules
    cross = np.zeros((2 * C, 2 * C), bool)
    cross[:C, C:] = True
    pairs = contact_pairs(cross, r.cpu().numpy(), r.device,
                          fused_len=np.tile(vector_tail(C), 2))

    @lane_oracle
    def batch_state_free(scene, qs):
        valid = ((qs >= lower) & (qs <= upper)).all(dim=-1)
        p0a, p1a = lane_capsules(chain, qs[..., :dof].contiguous(), base_trans=base1)
        p0b, p1b = lane_capsules(chain, qs[..., dof:].contiguous(), base_trans=base2)
        p0 = torch.cat([p0a, p0b], dim=2)
        p1 = torch.cat([p1a, p1b], dim=2)
        box = capsules_hit(p0, p1, r, scene.centers, scene.halfs, scene.mask)
        arms = pair_contacts(p0, p1, pairs)
        return valid & ~box & ~arms, valid.to(torch.int32)

    return arm_kernels(batch_state_free, lower, upper, rrt_eps, k_max)


class Kuka2Env(KukaEnv):
    """Host wrapper with the reference Kuka2Env protocol: KukaEnv's problems,
    obstacle tokens and native-core sampling, for two arms."""

    RRT_EPS = 0.5
    kukaEndEffectorIndex = 6

    def __init__(self, kuka_file: str = "kuka_iiwa/model_0.urdf",
                 map_file: str = "maze_files/kukas_14_3000.pkl", device=None):
        self._start(device)
        self._load_problems(map_file)
        self.kuka_file = kuka_file
        self.model = model = parse_urdf(asset_path(kuka_file))
        self.chain = _apply_calibration(chain_from_model(model, self.device), kuka_file)
        self._set_pose_range(list(model.pose_range()) * 2)
        self.base1, self.base2 = (
            torch.tensor(b, dtype=torch.float32, device=self.device) for b in BASES)
        self._native = GeomDual(self.chain.numpy_arrays(), *BASES, self.RRT_EPS)

    def kernels(self) -> EnvKernels:
        if self._kernels is None:
            self._kernels = make_dual_kernels(
                self.chain, self.base1, self.base2, self.RRT_EPS, self._k_max())
        return self._kernels

    def _arm_translations(self, configs):
        """Link translations of both arms, (n, 8, 3) each, for (n, 14)."""

        q = np.asarray(configs).reshape(-1, self.config_dim)
        dof = self.config_dim // 2
        return (link_translations(self.host_chain, q[:, :dof], base_trans=self.base1),
                link_translations(self.host_chain, q[:, dof:], base_trans=self.base2))

    def _render_segments(self, config):
        """Both arms' capsule axis segments, arm one's first (JAX
        envs/kuka2.py:168-176)."""

        q = torch.as_tensor(np.asarray(config, np.float32)).reshape(1, -1)
        dof = self.config_dim // 2
        arms = [capsules_world(self.host_chain, q[:, :dof], base_trans=self.base1.cpu()),
                capsules_world(self.host_chain, q[:, dof:], base_trans=self.base2.cpu())]
        return tuple(np.concatenate([a[i][0].numpy() for a in arms]) for i in (0, 1))

    def robot_points(self, configs) -> np.ndarray:
        a, b = self._arm_translations(configs)
        k = 1 + self.kukaEndEffectorIndex
        return np.concatenate([a[:, k], b[:, k]], axis=-1)

    def get_robot_points(self, config, end_point: bool = True):
        """Both arms' end effectors, no z shift (kuka_2arm_env.py:348-353);
        else every link point of both arms at z - 0.4 (JAX
        envs/kuka2.py:178-191)."""

        if end_point:
            return list(self.robot_points(config)[0])
        a, b = (t[0, 1:] for t in self._arm_translations(config))
        shift = np.array([0.0, 0.0, 0.4])
        return [tuple(p - shift) for p in a[:7]] + [tuple(p - shift) for p in b[:7]]
