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

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels
from gnn_motion_planning_tpu_torch.envs.geometry import contact_pairs, pair_contacts
from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world, chain_from_model
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
    # every capsule of the first arm against every capsule of the second
    cross = np.zeros((2 * C, 2 * C), bool)
    cross[:C, C:] = True
    pair_i, pair_j, pair_r2 = contact_pairs(cross, r.cpu().numpy(), r.device)

    def batch_state_free(scene, qs):
        valid = ((qs >= lower) & (qs <= upper)).all(dim=1)
        p0a, p1a, _ = capsules_world(chain, qs[:, :dof], base_trans=base1)
        p0b, p1b, _ = capsules_world(chain, qs[:, dof:], base_trans=base2)
        p0 = torch.cat([p0a, p0b], dim=1)
        p1 = torch.cat([p1a, p1b], dim=1)
        box = capsules_hit(p0, p1, r, scene.centers, scene.halfs, scene.mask)
        arms = pair_contacts(p0, p1, pair_i, pair_j, pair_r2)
        return valid & ~box & ~arms, valid.to(torch.int32)

    return arm_kernels(batch_state_free, lower, upper, rrt_eps, k_max)


class Kuka2Env(KukaEnv):
    """Host wrapper with the reference Kuka2Env protocol: KukaEnv's problems,
    obstacle tokens and native-core sampling, for two arms."""

    RRT_EPS = 0.5

    def __init__(self, kuka_file: str = "kuka_iiwa/model_0.urdf",
                 map_file: str = "maze_files/kukas_14_3000.pkl", device=None):
        self._start(device)
        self._load_problems(map_file)
        model = parse_urdf(asset_path(kuka_file))
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
