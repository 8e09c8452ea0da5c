"""2-D point and 3-D stick maze environments (port of
gnn_motion_planning_tpu/envs/maze.py; reference environment/maze_env.py).

The collision oracle exists twice, with the same decisions and the same
collision-check counter (the paper's headline metric; counts go up where
reference maze_env.py:276 counts):

* :class:`MazeEnv`'s numpy host oracle, which sampling counts with;
* batched device functions over the (W, W) occupancy grid
  (:func:`point_free_2d`, :func:`edge_free_2d`, :func:`stick_free_3d`,
  :func:`edge_free_3d`). Each takes a batch along its first axis and
  returns ``(free, n_checks)``.

The reference bisects a segment recursively and stops at the first
colliding midpoint. On the device the recursion is unrolled over the static
complete bisection tree in DFS preorder: which nodes would be visited is
purely geometric (grid-coordinate spread > 1 and L1 length > RRT_EPS), and
the stop is the first preorder index among visited colliding nodes. That
gives both the decision and the exact count with static shapes and no host
read.

Float32 positions are rounded as the JAX package's compiled functions
round them: XLA contracts ``c + a * b`` into one fused multiply-add, so
``kinematics.fma32`` forms it with one rounding, exactly. Without it a
midpoint that falls on a cell boundary lands in the other cell now and
then (cell-centre edges, tests). The stick's cos and sin are glibc's
``cosf`` and ``sinf``, which XLA's CPU code calls
(``kinematics.sincosf32``), and sqrt goes through float64: torch's float32
versions on the CPU are not correctly rounded, the card's are, and both
must give the same cells.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.envs.base import BIG, EnvKernels
from gnn_motion_planning_tpu_torch.envs.env_config import LIMITS, RRT_EPS, STICK_LENGTH
from gnn_motion_planning_tpu_torch.envs.kinematics import fma32, sincosf32, sum_last
from gnn_motion_planning_tpu_torch.utils.assets import asset_path
from gnn_motion_planning_tpu_torch.utils.timer import Timer, timed

# ---------------------------------------------------------------------------
# Static bisection-tree tables
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _preorder_tree(depth: int):
    """Complete bisection tree in DFS preorder (maze.py:46-74).

    Returns (t0, t1, parent) arrays of length 2**depth - 1: node i covers
    the segment fraction [t0[i], t1[i]] and parent[i] is the preorder index
    of its parent (-1 for the root). Left children come first, so preorder
    rank is the reference's recursive visit order (maze_env.py:312).
    """

    t0s, t1s, parents = [], [], []

    def rec(t0, t1, level, parent):
        if level >= depth:
            return
        idx = len(t0s)
        t0s.append(t0)
        t1s.append(t1)
        parents.append(parent)
        tm = 0.5 * (t0 + t1)
        rec(t0, tm, level + 1, idx)
        rec(tm, t1, level + 1, idx)

    rec(0.0, 1.0, 0, -1)
    return (
        np.asarray(t0s, np.float64),
        np.asarray(t1s, np.float64),
        np.asarray(parents, np.int32),
    )


def bisection_depth(max_l1: float, eps: float = RRT_EPS) -> int:
    """Levels at which `L1 segment length > eps` can still hold."""

    depth = 0
    length = float(max_l1)
    while length > eps:
        depth += 1
        length *= 0.5
    return max(depth, 1)


# Max L1 length of a segment between valid 2D points is 4 ((-1,-1)->(1,1)).
_DEPTH_2D = bisection_depth(4.0)
# A stick is STICK_LENGTH long; its endpoint segment L1 <= sqrt(2)*len.
_DEPTH_STICK = bisection_depth(float(np.sqrt(2.0) * STICK_LENGTH))
# Interior stick interpolation: K = int(d / 0.015), d <= sqrt(8 + 0.4^2).
_K_MAX_3D = int(np.sqrt(8.0 + LIMITS[2] ** 2) / 0.015) + 2


@functools.lru_cache(maxsize=None)
def _tree_tables(depth: int, dtype: torch.dtype, device: torch.device):
    """The tree as tensors on ``device`` (made once: a host-to-device copy
    inside a search pop would be a sync): t0, t1, midpoint fraction, parent
    (root -> 0), is_root, preorder index."""

    t0, t1, parent = _preorder_tree(depth)
    as_t = functools.partial(torch.as_tensor, device=device)
    return (
        as_t(t0, dtype=dtype),
        as_t(t1, dtype=dtype),
        as_t(0.5 * (t0 + t1), dtype=dtype),
        as_t(np.maximum(parent, 0), dtype=torch.int64),
        as_t(parent < 0),
        torch.arange(len(t0), dtype=torch.int32, device=device),
    )


@functools.lru_cache(maxsize=None)
def _limits(dim: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(LIMITS[:dim], dtype=dtype, device=device)


@functools.lru_cache(maxsize=None)
def _interior_steps(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.arange(1, _K_MAX_3D, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Device oracle (batched along the first axis)
# ---------------------------------------------------------------------------


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt on every device."""

    return torch.sqrt(x.double()).to(x.dtype)


def grid_coord(xy: torch.Tensor, width: int) -> torch.Tensor:
    """State -> grid coordinate (maze.py:101-109): truncation toward zero,
    then the upper clamp (the lower side is left to the callers)."""

    coord = ((xy + 1.0) * width / 2.0).to(torch.int32)
    return torch.clamp_max(coord, width - 1)


def occ_at(occ: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Occupancy of the cell holding each point: a gather on the (W, W)
    grid, or, for a stacked (L, W, W) scene of L problems, on the grid of
    the point's lane, the leading axis of ``xy`` (L, ..., 2). A negative
    coordinate reads as free, as the JAX package's bitmap lookup does
    (``_occ_at_flat``, maze.py:205); callers reject invalid states
    separately."""

    width = occ.shape[-1]
    c = grid_coord(xy, width)
    c0, c1 = c[..., 0], c[..., 1]
    in_range = (c0 >= 0) & (c1 >= 0)
    flat = (torch.clamp_min(c0, 0) * width + torch.clamp_min(c1, 0)).long()
    if occ.dim() == 3:
        lane = torch.arange(occ.shape[0], device=xy.device)
        flat = flat + (lane * (width * width)).reshape((-1,) + (1,) * (flat.dim() - 1))
    return in_range & occ.reshape(-1)[flat]


def valid_state(q: torch.Tensor) -> torch.Tensor:
    """Box bounds, and the theta bound for dim 3 (maze_env.py:266-268)."""

    lim = _limits(q.shape[-1], q.dtype, q.device)
    return ((q >= -lim) & (q <= lim)).all(dim=-1)


def point_free_2d(occ: torch.Tensor, xy: torch.Tensor):
    """(free, n_checks) of (B, 2) points (maze_env.py:270-277). An invalid
    state is rejected without counting."""

    valid = valid_state(xy)
    free = valid & ~occ_at(occ, xy)
    return free, valid.to(torch.int32)


def _segment_checks(occ: torch.Tensor, a: torch.Tensor, b: torch.Tensor, depth: int):
    """Bisection of the (..., 2) segments [a, b] with the reference's
    preorder stop (maze_env.py:301-314), both endpoints known free:
    (no_collision (...), midpoint checks (...))."""

    t0, t1, tm, parent, is_root, order = _tree_tables(depth, a.dtype, a.device)
    a3 = a[..., None, :]
    d3 = (b - a)[..., None, :]
    lefts = fma32(t0[:, None], d3, a3)  # (B, n, 2)
    rights = fma32(t1[:, None], d3, a3)
    mids = fma32(tm[:, None], d3, a3)

    width = occ.shape[-1]
    coord_spread = sum_last((grid_coord(lefts, width) - grid_coord(rights, width)).abs()) > 1
    seg_len = sum_last((lefts - rights).abs()) > RRT_EPS
    split = coord_spread & seg_len

    # visited[i] = split[i] and visited[parent[i]]; parents precede their
    # children in preorder, so depth - 1 passes reach the fixed point
    visited = split
    for _ in range(depth - 1):
        visited = split & (is_root | visited[..., parent])

    colliding = visited & occ_at(occ, mids)  # mids lie between valid endpoints
    first_fail = torch.where(colliding, order, BIG).amin(dim=-1)
    counted = visited & (order <= first_fail[..., None])
    return first_fail == BIG, counted.sum(dim=-1, dtype=torch.int32)


def _staged_count(valid, a_free, a_cnt, b_free, b_cnt, rest_cnt):
    """valid ? a_cnt + (a_free ? b_cnt + (b_free ? rest_cnt : 0) : 0) : 0."""

    zero = torch.zeros_like(rest_cnt)
    inner = b_cnt + torch.where(b_free, rest_cnt, zero)
    return torch.where(valid, a_cnt + torch.where(a_free, inner, zero), zero).to(torch.int32)


def edge_free_2d(occ: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(free, n_checks) of (E, 2) segments (maze_env.py:316-326): validity
    (uncounted), endpoint a, endpoint b, then the bisection midpoints, each
    stage stopping at the first failure."""

    valid = valid_state(a) & valid_state(b)
    a_free = ~occ_at(occ, a)
    b_free = ~occ_at(occ, b)
    seg_free, seg_cnt = _segment_checks(occ, a, b, _DEPTH_2D)
    free = valid & a_free & b_free & seg_free
    one = torch.ones_like(seg_cnt)
    return free, _staged_count(valid, a_free, one, b_free, one, seg_cnt)


def stick_endpoints(q: torch.Tensor):
    """Stick endpoints from (..., 3) configurations (x, y, theta)
    (maze_env.py:245-264)."""

    # q / 0.4 * pi as XLA folds it: one multiply by the float32 pi / 0.4
    theta = q[..., 2] * (np.float32(np.pi) / np.float32(LIMITS[2]))
    orient = torch.stack(sincosf32(theta), dim=-1)
    center = q[..., :2]
    half = np.float32(0.5 * STICK_LENGTH)
    return fma32(-half, orient, center), fma32(half, orient, center)


def stick_free_3d(occ: torch.Tensor, q: torch.Tensor):
    """(free, n_checks) of (B, 3) stick configurations (maze_env.py:279-291)."""

    valid = valid_state(q)
    a, b = stick_endpoints(q)
    a_free, a_cnt = point_free_2d(occ, a)
    b_free, b_cnt = point_free_2d(occ, b)
    seg_free, seg_cnt = _segment_checks(occ, a, b, _DEPTH_STICK)
    free = valid & a_free & b_free & seg_free
    return free, _staged_count(valid, a_free, a_cnt, b_free, b_cnt, seg_cnt)


def wrap_theta_disp(disp: torch.Tensor) -> torch.Tensor:
    """Wrap the angular component of (..., 3) displacements (maze_env.py:329-335)."""

    t = disp[..., 2]
    lim = LIMITS[2]
    t = torch.where(t.abs() > lim, t - torch.sign(t) * 2 * lim, t)
    return torch.cat([disp[..., :2], t[..., None]], dim=-1)


def maze_distance(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """Euclidean, with angular wraparound for dim >= 3 (maze_env.py:137-149)."""

    diff = (b - a).abs()
    sq = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    if dim >= 3:
        # XLA fuses the third square into the sum
        t = torch.minimum(diff[..., 2], (diff[..., 2] - 2 * LIMITS[2]).abs())
        sq = fma32(t, t, sq)
    return _sqrt(sq)


def edge_free_3d(occ: torch.Tensor, q0: torch.Tensor, q1: torch.Tensor):
    """(free, n_checks) of (..., E, 3) stick-maze edges (maze_env.py:316-347).

    Endpoint stick checks, then K = int(d / 0.015) interior sticks, each of
    which runs a full 2-D edge check between its endpoints (the two
    endpoint point checks included), stopping at the first collision: one
    batched (..., E, 191, 127) pass.
    """

    valid = valid_state(q0) & valid_state(q1)
    s0_free, s0_cnt = stick_free_3d(occ, q0)
    s1_free, s1_cnt = stick_free_3d(occ, q1)

    disp = wrap_theta_disp(q1 - q0)
    K = (maze_distance(q0, q1, 3) / 0.015).to(torch.int32)
    ks = _interior_steps(q0.dtype, q0.device)  # 1 .. _K_MAX_3D - 1
    active = ks < K.to(q0.dtype)[..., None]
    frac = ks / torch.clamp_min(K, 1).to(q0.dtype)[..., None]
    cs = fma32(frac[..., :, None], disp[..., None, :], q0[..., None, :])  # (..., E, k, 3)
    ca, cb = stick_endpoints(cs)
    in_free, in_cnt = edge_free_2d(occ, ca, cb)  # (..., E, k)

    order = torch.arange(ks.shape[0], dtype=torch.int32, device=q0.device)
    first_fail = torch.where(active & ~in_free, order, BIG).amin(dim=-1)
    counted = active & (order <= first_fail[..., None])
    interior_cnt = torch.where(counted, in_cnt, 0).sum(dim=-1)
    free = valid & s0_free & s1_free & (first_fail == BIG)
    return free, _staged_count(valid, s0_free, s0_cnt, s1_free, s1_cnt, interior_cnt)


def maze_interpolate(a: torch.Tensor, b: torch.Tensor, ratio: torch.Tensor, dim: int):
    """Steering with angular wrap for dim >= 3 (maze_env.py:151-172);
    ``ratio`` has the batch shape of ``a``."""

    diff = b - a
    if dim >= 3:
        diff = wrap_theta_disp(diff)
    new = fma32(diff, ratio[..., None], a)
    if dim >= 3:
        new = wrap_theta_disp(new)
    return new


def maze_kernels(dim: int) -> EnvKernels:
    """EnvKernels for a maze dimension; the scene is the (W, W) bool grid
    on the device, or the (L, W, W) grids of L problems with inputs of a
    leading lane axis. No bounds: the projection takes the full sweep."""

    if dim == 2:
        state_free, edge_free = point_free_2d, edge_free_2d
    elif dim == 3:
        state_free, edge_free = stick_free_3d, edge_free_3d
    else:
        raise ValueError(f"maze dim must be 2 or 3, got {dim}")
    return EnvKernels(
        batch_state_free=state_free,
        edge_free=edge_free,
        distance=functools.partial(maze_distance, dim=dim),
        interpolate=functools.partial(maze_interpolate, dim=dim),
    )


# ---------------------------------------------------------------------------
# Host wrapper (reference env protocol)
# ---------------------------------------------------------------------------


class MazeEnv:
    """Host-side maze env with the reference protocol (maze_env.py:5-347):
    problems, sampling and the numpy host oracle; the planner's checks run
    through :func:`maze_kernels` on ``device``."""

    RRT_EPS = RRT_EPS

    def __init__(self, dim: int, map_file: Optional[str] = None, device=None):
        self.device = resolve_device(device)
        self.dim = dim
        self.config_dim = dim
        self.collision_check_count = 0
        if map_file is None:
            map_file = f"maze_files/mazes_15_{dim}_3000.npz"
        with np.load(asset_path(map_file)) as f:
            self.maps = f["maps"]
            self.init_states = f["init_states"]
            self.goal_states = f["goal_states"]
        self.size = self.maps.shape[0]
        self.width = self.maps.shape[1]
        self.bound = (-1, -1, 1, 1) if dim == 2 else (-1, -1, -0.4, 1, 1, 0.4)
        self.order = list(range(self.size))
        self.episode_i = 0
        self.collision_point = None
        self.rng = None  # owned stream (config.problem_rng); None = np.random
        self._kernels = None

    def __str__(self):
        return "maze" + str(self.config_dim)

    # -- problem management -------------------------------------------------

    def init_new_problem(self, index: Optional[int] = None):
        if index is None:
            index = self.episode_i
        self.index = index
        self.map = self.maps[self.order[index]]
        self.width = self.map.shape[0]
        self.init_state = self.init_states[self.order[index]]
        self.goal_state = self.goal_states[self.order[index]]
        self.episode_i = (self.episode_i + 1) % len(self.order)
        self.collision_point = None
        self.obstacles = np.argwhere(self.map == 1) / self.map.shape[0] - 0.5
        self.collision_check_count = 0
        self._scene = None  # rebuilt lazily for the new map
        return self.get_problem()

    def get_problem(self):
        return {"map": self.map, "init_state": self.init_state, "goal_state": self.goal_state}

    def kernels(self) -> EnvKernels:
        if self._kernels is None:
            self._kernels = maze_kernels(self.dim)
        return self._kernels

    def obs_tokens(self):
        """Obstacle tokens for the explorer's cross-attention, padded to
        every grid cell (W * W tokens of size 2), with their mask."""

        cap = self.width * self.width
        toks = np.zeros((cap, 2), np.float32)
        mask = np.zeros(cap, bool)
        n = len(self.obstacles)
        toks[:n] = self.obstacles
        mask[:n] = True
        return toks, mask

    def device_scene(self) -> torch.Tensor:
        """The occupancy grid on the device, (W, W) bool (cached per problem)."""

        if self._scene is None:
            self._scene = torch.as_tensor(np.asarray(self.map) != 0, device=self.device)
        return self._scene

    # -- sampling ------------------------------------------------------------

    def _rand(self):
        return self.rng if self.rng is not None else np.random

    def uniform_sample(self, n: int = 1):
        sample = self._rand().uniform(-LIMITS[: self.dim], LIMITS[: self.dim], (n, self.dim))
        return sample.reshape(-1) if n == 1 else sample

    def sample_n_points(self, n: int, need_negative: bool = False):
        """Rejection sampling with the stream of maze_env.py:85-100.

        With an owned stream, chunks are drawn and the state restored to
        un-draw the overshoot past the n-th acceptance, so the consumed
        prefix equals the reference's one-at-a-time loop. With
        ``rng = None`` it draws one sample at a time from ``np.random``
        (the reference's global stream)."""

        rng = self.rng
        samples: list = []
        negative: list = []
        if rng is None:
            while len(samples) < n:
                s = self.uniform_sample()
                if self._accept(s):
                    samples.append(s)
                elif need_negative:
                    negative.append(s)
            return (samples, negative) if need_negative else samples

        lim = LIMITS[: self.dim]
        need = n
        while need > 0:
            chunk = max(2 * need, 64)
            state = rng.get_state()
            draws = rng.uniform(-lim, lim, (chunk, self.dim))
            ok = self._accept_batch(draws, count=False)
            n_acc = int(np.cumsum(ok)[-1]) if len(ok) else 0
            if n_acc >= need:
                # position of the need-th acceptance; un-draw the rest
                stop = int(np.nonzero(np.cumsum(ok) == need)[0][0]) + 1
                rng.set_state(state)
                rng.uniform(-lim, lim, (stop, self.dim))
                draws, ok = draws[:stop], ok[:stop]
                need = 0
            else:
                need -= n_acc
            # count the draws actually consumed (the pass above is count-free)
            self._accept_batch(draws, count=True)
            samples.extend(draws[ok])
            negative.extend(draws[~ok])
        return (samples, negative) if need_negative else samples

    def _accept(self, s: np.ndarray) -> bool:
        if self.dim == 2:
            return self._point_in_free_space(s)
        return self._stick_in_free_space(s)

    def _accept_batch(self, draws: np.ndarray, count: bool = True) -> np.ndarray:
        saved = self.collision_check_count
        out = np.array([self._accept(d) for d in draws], dtype=bool)
        if not count:
            self.collision_check_count = saved
        return out

    def sample_empty_points(self):
        while True:
            point = self.uniform_sample()
            if self._accept(point):
                return point

    def set_random_init_goal(self):
        """A fresh start and goal, two distinct free samples (JAX
        envs/maze.py:594)."""

        while True:
            init, goal = self.sample_empty_points(), self.sample_empty_points()
            if np.sum(np.abs(init - goal)) != 0:
                break
        self.init_state, self.goal_state = init, goal

    # -- metric geometry -----------------------------------------------------

    def distance(self, from_state, to_state):
        diff = np.abs(np.asarray(to_state) - np.asarray(from_state))
        if diff.ndim == 1:
            diff = diff.reshape(1, -1)
        if self.dim >= 3:
            diff[:, 2] = np.minimum(diff[:, 2], np.abs(diff[:, 2] - 2 * LIMITS[2]))
        return np.sqrt(np.sum(diff**2, axis=-1))

    def interpolate(self, from_state, to_state, ratio):
        diff = to_state - from_state
        if self.dim >= 3:
            if np.abs(diff[2]) > LIMITS[2]:
                diff[2] -= np.sign(diff[2]) * 2 * LIMITS[2]
        new_state = from_state + diff * ratio
        if self.dim >= 3:
            if np.abs(new_state[2]) > LIMITS[2]:
                new_state[2] -= np.sign(new_state[2]) * 2 * LIMITS[2]
        return new_state

    def in_goal_region(self, state):
        return bool(
            np.asarray(self.distance(state, self.goal_state)).reshape(-1)[0] < RRT_EPS
        ) and self._state_fp(state)

    def step(self, state, action=None, new_state=None, check_collision=True):
        if action is not None:
            new_state = state + action
        new_state[:2] = new_state[:2].clip(-LIMITS[:2], LIMITS[:2])
        if self.dim >= 3:
            if np.abs(new_state[2]) > LIMITS[2]:
                new_state[2] -= np.sign(new_state[2]) * 2 * LIMITS[2]
        action = new_state - state
        if not check_collision:
            return new_state, action
        no_collision = self._edge_fp(state, new_state)
        done = no_collision and self.in_goal_region(new_state)
        return new_state, action, no_collision, done

    def get_robot_points(self, config):
        return [config]

    def plot(self, path, make_gif: bool = False, save_path=None):
        """Headless render of the path sweep over the occupancy map
        (``utils/plot.py::plot_maze_path``; the reference MazeEnv has none,
        this gives it the other envs' protocol)."""

        from gnn_motion_planning_tpu_torch.utils.plot import plot_maze_path

        return plot_maze_path(self, path, make_gif=make_gif, save_path=save_path)

    # -- map rasters (model inputs; JAX envs/maze.py:644-658) ----------------

    voxel_r = 1.0 / 15

    def obs_map(self, resolution=voxel_r):
        """(points (n, 2) on a ``resolution`` lattice of [-1, 1)^2, whether
        each lies in an occupied cell)."""

        xs = np.arange(-1, 1, resolution)
        xs, ys = np.meshgrid(xs, xs)
        points = np.stack([xs.reshape(-1), ys.reshape(-1)], axis=-1)
        coords = np.minimum(((points + 1.0) * self.width / 2.0).astype(int), self.width - 1)
        return points, self.map[coords[:, 0], coords[:, 1]] == 1

    def free_map(self, w: int = 15):
        """The centres of the free cells of a ``w`` x ``w`` map."""

        fx, fy = np.nonzero(self.map == 0)
        pts = np.stack([fx, fy], axis=-1) * 2.0 / w + (1.0 / w - 1.0)
        return [p for p in pts]

    # -- collision oracle (numpy host mirror of the device functions) --------

    def _transform(self, state):
        w = self.width
        coord = ((np.asarray(state)[:2].flatten() + 1.0) * w / 2.0).astype(int)
        coord[coord > w - 1] = w - 1
        return coord

    def _valid_state(self, state):
        state = np.asarray(state)
        lim = LIMITS[: state.size]
        return bool((state >= -lim).all() and (state <= lim).all())

    def _point_in_free_space(self, state):
        state = np.asarray(state)
        if not self._valid_state(state):
            self.collision_point = state
            return False
        self.collision_check_count += 1
        c = self._transform(state)
        return self.map[c[0], c[1]] == 0

    def _stick_in_free_space(self, state):
        state = np.asarray(state)
        if not self._valid_state(state):
            return False
        a, b = self._stick_ends(state)
        if not self._point_in_free_space(a) or not self._point_in_free_space(b):
            self.collision_point = state
            return False
        return self._iterative_check_segment(a, b)

    @staticmethod
    def _stick_ends(state):
        theta = state[2] / LIMITS[2] * np.pi
        orient = np.array([np.cos(theta), np.sin(theta)])
        half = STICK_LENGTH / 2.0
        center = np.asarray(state[:2])
        return center - half * orient, center + half * orient

    @timed(Timer.VERTEX_CHECK)
    def _state_fp(self, state):
        state = np.asarray(state)
        if state.size == 2:
            return self._point_in_free_space(state)
        return self._stick_in_free_space(state)

    def _iterative_check_segment(self, left, right):
        lc = self._transform(left)
        rc = self._transform(right)
        if np.sum(np.abs(lc - rc)) > 1 and np.sum(np.abs(left - right)) > RRT_EPS:
            mid = (left + right) / 2.0
            if not self._point_in_free_space(mid):
                self.collision_point = mid
                return False
            return self._iterative_check_segment(left, mid) and self._iterative_check_segment(
                mid, right
            )
        return True

    def _batch_edge_free(self, a, b):
        """(free (n,), counts (n,)) of the edges a[i] -> b[i], one host
        ``_edge_fp`` each; ``collision_check_count`` is left as it was
        (JAX envs/maze.py:736-746)."""

        free = np.zeros(len(a), bool)
        counts = np.zeros(len(a), np.int32)
        for i in range(len(a)):
            c0 = self.collision_check_count
            free[i] = self._edge_fp(np.asarray(a[i]), np.asarray(b[i]))
            counts[i] = self.collision_check_count - c0
        self.collision_check_count -= int(counts.sum())
        return free, counts

    @timed(Timer.EDGE_CHECK)
    def _edge_fp(self, state, new_state):
        """The host oracle of one edge (JAX envs/maze.py:741-766): both ends,
        then the 2-D bisection, or for sticks the bisection of every
        interior stick at the 0.015 step."""

        state, new_state = np.asarray(state), np.asarray(new_state)
        if not self._valid_state(state) or not self._valid_state(new_state):
            return False
        if not self._state_fp(state) or not self._state_fp(new_state):
            return False
        if state.size == 2:
            return self._iterative_check_segment(state, new_state)
        disp = new_state - state
        if np.abs(disp[2]) > LIMITS[2]:
            disp[2] -= np.sign(disp[2]) * 2 * LIMITS[2]
        d = self.distance(state, new_state)
        K = int(np.asarray(d).reshape(-1)[0] / 0.015)
        for k in range(1, K):
            ca, cb = self._stick_ends(state + k * 1.0 / K * disp)
            if not self._edge_fp(ca, cb):
                return False
        return True
