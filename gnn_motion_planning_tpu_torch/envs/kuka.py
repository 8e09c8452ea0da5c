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
    lane_oracle,
    make_fixed_step_edge_free,
    rejection_sample,
)
from gnn_motion_planning_tpu_torch.envs.kinematics import (
    ChainParams,
    capsules_world,
    chain_from_model,
    link_translations,
    norm_last,
    on_cpu,
)
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import chain_states_free, pack_chain
from gnn_motion_planning_tpu_torch.utils.assets import asset_path
from gnn_motion_planning_tpu_torch.utils.geomcore import GeomChain
from gnn_motion_planning_tpu_torch.utils.timer import Timer, timed

MAX_OBSTACLES = 16
# edges a call of the batched edge oracle (``_batch_edge_free``): each
# takes 2 + k_max states, 74,496 a call on ur5 (JAX envs/kuka.py:543-568)
EDGE_CHUNK = 256


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
    """Padded axis-aligned obstacle set for one problem, or for L problems
    with a leading lane axis (``envs/base.py::stack_scenes``)."""

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

    @lane_oracle
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
        self.kuka_file = kuka_file
        # the parsed URDF: its link order names the frames of fk_link_frames
        # (the strict verifier reads it, envs/strict.py)
        self.model = model = parse_urdf(asset_path(kuka_file))
        self.chain = _apply_calibration(chain_from_model(model, self.device), kuka_file)
        self._set_pose_range(model.pose_range())
        self.kukaEndEffectorIndex = self.config_dim - 1
        self._native = GeomChain(self.chain.numpy_arrays(), self.RRT_EPS)

    def _start(self, device):
        """The host state every env of this family starts with."""

        self.device = resolve_device(device)
        self.dim = 3  # the workspace's
        self.collision_check_count = 0
        self.collision_point = None
        self.maps = {}
        self.rng = None
        self.episode_i = 0
        self._native = None  # host sampling oracle; None: the device oracle
        self._kernels = None
        # opt-in narrow-pocket draws (``_bias_draws``); the protocol never sets it
        self.sampler_bias = None
        self._draw_pos = 0  # the problem's draws so far, anchoring ``_bias_draws``

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
        obstacles, start, goal, path = self.problems[index]
        self.episode_i = (self.episode_i + 1) % len(self.problems)
        self.set_problem_data(obstacles, start, goal, path)
        self.index = index
        return self.get_problem()

    def set_problem_data(self, obstacles, start, goal, path=None):
        """A problem given by its boxes and endpoints (JAX envs/kuka.py:
        209-222; ``init_new_problem`` loads a stored one through it)."""

        self.index = -1
        self.collision_check_count = 0
        self.collision_point = None
        self.obstacles = obstacles
        self.init_state = np.asarray(start)
        self.goal_state = np.asarray(goal)
        self.path = path
        self._scene = make_box_scene(obstacles, self.device)
        self._draw_pos = 0
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

    # every this-many-th draw is remapped when sampler_bias = "endpoint"
    _ENDPOINT_EVERY = 4

    def _bias_draws(self, draws: np.ndarray, offset: int = 0) -> np.ndarray:
        """The opt-in "endpoint" sampler bias (JAX envs/kuka.py:343-379;
        the identity while ``sampler_bias`` is None). Every
        ``_ENDPOINT_EVERY``-th draw by its position in the problem's stream
        (``offset`` is the position of the first row) is moved near init or
        goal, alternately: per joint ``anchor + (2u - 1)^3 * 0.25 * span``
        for the draw's own uniform u, clipped to the limits. A function of
        each row and its position, so chunking does not change it."""

        if self.sampler_bias is None:
            return draws
        if self.sampler_bias != "endpoint":
            raise ValueError(f"unknown sampler_bias {self.sampler_bias!r}")
        draws = draws.copy()
        pos = offset + np.arange(len(draws))
        idx = np.nonzero(pos % self._ENDPOINT_EVERY == 0)[0]
        if not len(idx):
            return draws
        pr = np.array(self.pose_range)
        span = pr[:, 1] - pr[:, 0]
        u = (draws[idx] - pr[:, 0]) / span
        off = (2.0 * u - 1.0) ** 3 * (0.25 * span)
        toward_goal = ((pos[idx] // self._ENDPOINT_EVERY) % 2 == 1)[:, None]
        anchor = np.where(toward_goal, np.asarray(self.goal_state, np.float64),
                          np.asarray(self.init_state, np.float64))
        draws[idx] = np.clip(anchor + off, pr[:, 0], pr[:, 1])
        return draws

    def sample_empty_points(self):
        """One free configuration from the global-or-owned stream, a check
        a draw (JAX envs/kuka.py:453-457)."""

        while True:
            s = self.uniform_sample()
            if self._state_fp(s):
                return s

    def aug_path(self):
        """The stored demo path densified to RRT_EPS steps (reference
        kuka_env.py:118-131, JAX envs/kuka.py:467-485)."""

        result = [self.init_state]
        path = np.array(self.path)
        agent = np.array(path[0])
        next_index = 1
        while next_index < len(path):
            if np.linalg.norm(path[next_index] - agent) <= self.RRT_EPS:
                agent = path[next_index]
                next_index += 1
            else:
                agent = agent + self.RRT_EPS * (path[next_index] - agent) / np.linalg.norm(
                    path[next_index] - agent)
            result.append(np.array(agent))
        return result

    def _batch_free(self, draws: np.ndarray) -> np.ndarray:
        if self._native is not None:
            return self._native.states_free(draws)[0]
        qs = torch.as_tensor(np.asarray(draws, np.float32), device=self.device)
        free, _ = self.kernels().batch_state_free(self._scene, qs)
        return free.cpu().numpy()

    def set_random_init_goal(self):
        """A fresh start and goal, two distinct free samples (JAX
        envs/kuka.py:459; ur5 and kuka14 inherit it). The smoother trainer
        draws them from its second data pass on."""

        while True:
            points = self.sample_n_points(n=2)
            init, goal = points[0], points[1]
            if np.sum(np.abs(init - goal)) != 0:
                break
        self.init_state, self.goal_state = init, goal

    # -- metric (host) -------------------------------------------------------

    def distance(self, from_state, to_state):
        pr = np.array(self.pose_range)
        to_state = np.clip(to_state, pr[:, 0], pr[:, 1])
        return np.sqrt(np.sum((to_state - from_state) ** 2, axis=-1))

    def interpolate(self, from_state, to_state, ratio):
        pr = np.array(self.pose_range)
        new_state = from_state + (to_state - from_state) * ratio
        return np.clip(new_state, pr[:, 0], pr[:, 1])

    def uniform_sample(self, n: int = 1):
        pr = np.array(self.pose_range)
        rng = self.rng if self.rng is not None else np.random
        sample = rng.uniform(pr[:, 0], pr[:, 1], (n, self.config_dim))
        return sample.reshape(-1) if n == 1 else sample

    # -- the reference env protocol of the baselines (JAX envs/kuka.py:
    # 282-342, 488-638): host numbers in and out, one oracle call each ------

    def get_problem(self, width: int = 15, index: Optional[int] = None):
        if index is not None:
            return self.maps[index]
        problem = {
            "map": np.asarray(self.obs_map(width)[1]).astype(float),
            "init_state": self.init_state,
            "goal_state": self.goal_state,
        }
        self.maps[self.index] = problem
        return problem

    def obs_map(self, num: int):
        """num^3 voxel map of the obstacles with the reference's z - 0.4
        shift (kuka_env.py:145-166): (grid points (num, num, num, 3),
        occupancy (num, num, num))."""

        resolution = 2.0 / (num - 1)
        grid = [np.linspace(-1.0, 1.0, num=num) for _ in range(3)]
        points_pos = np.concatenate([m.reshape(-1, 1) for m in np.meshgrid(*grid)], axis=-1)
        points_obs = np.zeros(points_pos.shape[0], bool)
        for obstacle_size, obstacle_base in self.obstacles:
            lo = (_coerce_vec3(obstacle_base) - _coerce_vec3(obstacle_size)).astype(float)
            hi = (_coerce_vec3(obstacle_base) + _coerce_vec3(obstacle_size)).astype(float)
            lo[2] -= 0.4
            hi[2] -= 0.4
            bools = []
            for i in range(3):
                m = np.zeros(num, bool)
                m[max(int((lo[i] + 1) / resolution), 0):
                  min(1 + int((hi[i] + 1) / resolution), 1 + int(2.0 / resolution))] = True
                bools.append(m)
            cur = np.concatenate([c.reshape(-1, 1) for c in np.meshgrid(*bools)], axis=-1)
            points_obs |= np.all(cur, axis=-1)
        return points_pos.reshape((num, num, num, -1)), points_obs.reshape((num, num, num))

    @property
    def host_chain(self) -> ChainParams:
        """The chain on the CPU, for host FK (``get_robot_points``)."""

        if getattr(self, "_host_chain", None) is None:
            self._host_chain = on_cpu(self.chain)
        return self._host_chain

    def robot_points(self, configs) -> np.ndarray:
        """``get_robot_points`` (end point) of many configurations (n, dof):
        (n, 3 or 6), one FK pass; row i equals ``get_robot_points(configs[i])``."""

        ts = link_translations(self.host_chain, np.asarray(configs).reshape(-1, self.config_dim))
        return ts[:, 1 + self.kukaEndEffectorIndex] - np.array([0.0, 0.0, 0.4])

    def get_robot_points(self, config, end_point: bool = True):
        """FK workspace points with the z - 0.4 shift (kuka_env.py:168-180)."""

        if end_point:
            return tuple(self.robot_points(config)[0])
        pts = link_translations(self.host_chain, config)[1:] - np.array([0.0, 0.0, 0.4])
        return [tuple(p) for p in pts[: self.kukaEndEffectorIndex + 1]]

    def in_goal_region(self, state):
        return bool(self.distance(state, self.goal_state) < self.RRT_EPS
                    and self._state_fp(state))

    def step(self, state, action=None, new_state=None, check_collision=True):
        if action is not None:
            new_state = state + action
        pr = np.array(self.pose_range)
        new_state = np.clip(new_state, pr[:, 0], pr[:, 1])
        action = new_state - state
        if not check_collision:
            return new_state, action
        no_collision = self._edge_fp(state, new_state)
        done = no_collision and self.in_goal_region(new_state)
        return new_state, action, no_collision, done

    def _render_segments(self, config):
        """World-frame capsule axis segments of one configuration, (C, 3)
        twice, for the plots (host FK on the CPU chain)."""

        p0, p1, _ = capsules_world(self.host_chain, torch.as_tensor(
            np.asarray(config, np.float32)).reshape(1, -1))
        return p0[0].numpy(), p1[0].numpy()

    def plot(self, path, make_gif: bool = False, save_path=None):
        """Headless render of the path sweep (reference kuka_env.py:281-346;
        ``utils/plot.py::plot_arm_path``): the RGBA frames with
        ``make_gif``, else one figure (to ``save_path``) and []."""

        from gnn_motion_planning_tpu_torch.utils.plot import plot_arm_path

        return plot_arm_path(self, path, make_gif=make_gif, save_path=save_path)

    def _batch_edge_free(self, a: np.ndarray, b: np.ndarray):
        """(free (n,), counts (n,)) of the edges a[i] -> b[i] under the
        fixed-step rule, through the device edge oracle in chunks of
        ``EDGE_CHUNK`` edges, each chunk one oracle call (entry B on kuka7 and
        kuka13, entry A on ur5, kuka14 and snake7); the last chunk is padded
        with copies of its first edge to the full width, as the JAX package
        pads it, so every call has one shape. Decisions are per edge.
        ``collision_check_count`` is left as it was (the audit's call)."""

        a = np.asarray(a, np.float32)
        b = np.asarray(b, np.float32)
        n = len(a)
        free = np.zeros(n, bool)
        cnt = np.zeros(n, np.int32)
        edge_free = self.kernels().edge_free
        for s0 in range(0, n, EDGE_CHUNK):
            aa, bb = a[s0 : s0 + EDGE_CHUNK], b[s0 : s0 + EDGE_CHUNK]
            m = len(aa)
            if m < EDGE_CHUNK:
                pad = (EDGE_CHUNK - m,) + aa.shape[1:]
                aa = np.concatenate([aa, np.broadcast_to(aa[:1], pad)])
                bb = np.concatenate([bb, np.broadcast_to(bb[:1], pad)])
            fr, ct = edge_free(self._scene, *(torch.as_tensor(x, device=self.device)
                                              for x in (aa, bb)))
            free[s0 : s0 + m] = fr.cpu().numpy()[:m]
            cnt[s0 : s0 + m] = ct.cpu().numpy()[:m]
        return free, cnt

    def _valid_state(self, state):
        pr = np.array(self.pose_range)
        return bool((state >= pr[:, 0]).all() and (state <= pr[:, 1]).all())

    def _point_in_free_space(self, state) -> bool:
        """One configuration, one check: through the native core where the
        env has one, else the device oracle (float32), as JAX's."""

        if not self._valid_state(state):
            return False
        self.collision_check_count += 1
        free = bool(self._batch_free(np.asarray(state)[None])[0])
        if not free:
            self.collision_point = state
        return free

    @timed(Timer.VERTEX_CHECK)
    def _state_fp(self, state) -> bool:
        return self._point_in_free_space(state)

    @timed(Timer.EDGE_CHECK)
    def _edge_fp(self, state, new_state) -> bool:
        """One edge under the fixed-step rule, with the reference count:
        the native core where the env has one (kuka7, kuka13, kuka14), else
        one call of the device edge oracle (ur5: entry A), read back at
        once."""

        state = np.asarray(state)
        new_state = np.asarray(new_state)
        if not self._valid_state(state) or not self._valid_state(new_state):
            return False
        if self._native is not None:
            free, count = self._native.edge_free(state, new_state)
        else:
            qa, qb = (torch.as_tensor(np.asarray(x, np.float32)[None], device=self.device)
                      for x in (state, new_state))
            free_t, count_t = self.kernels().edge_free(self._scene, qa, qb)
            free, count = bool(free_t[0]), int(count_t[0])
        self.collision_check_count += count
        if not free:
            self.collision_point = new_state
        return free
