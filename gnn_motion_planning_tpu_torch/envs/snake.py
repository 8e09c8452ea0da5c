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
boxes (one launch of its kernel on the card), or when capsules of links 4
or more hops apart touch, as batched tensor ops. The JAX package's scene is
the 3 x 3 window of cells around each capsule (:class:`SnakeGridScene`,
:func:`snake_state_free_grid`), which decides the same; the oracle takes it
when it is passed. Sampling goes through the device oracle, optionally
biased toward straight snakes or the corridor joining init and goal
(``sampler_bias``).
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.base import EnvKernels, lane_oracle
from gnn_motion_planning_tpu_torch.envs.geometry import (
    contact_pairs,
    pair_contacts,
    seg_box_sq_dist,
)
from gnn_motion_planning_tpu_torch.envs.kinematics import (
    chain_from_model,
    joint_angles,
    lane_capsules,
    sincosf32,
)
from gnn_motion_planning_tpu_torch.envs.kuka import BoxScene, KukaEnv, arm_kernels
from gnn_motion_planning_tpu_torch.envs.ur5 import pair_mask_from_hops
from gnn_motion_planning_tpu_torch.envs.urdf import parse_urdf
from gnn_motion_planning_tpu_torch.ops.capsule import capsules_hit
from gnn_motion_planning_tpu_torch.utils.assets import asset_path

HEIGHT = 0.5
GRID_W = 15
CELL = 1.4
CELL_ORIGIN = -10.5  # the centre of cell index 0 along each axis
# the JAX package's grid scene holds at most this many occupied cells
MAX_CELLS = 160
# the 3 x 3 window of cell offsets around a capsule's cell
_WIN = np.stack(np.meshgrid(np.arange(-1, 2), np.arange(-1, 2), indexing="ij"), -1).reshape(9, 2)
# a cell centre a grid index, computed in float64 then cast: bit for bit the
# centres make_snake_scene stores
_COORDS = np.float32(CELL * np.arange(GRID_W) + CELL_ORIGIN)
_HALF = (0.7, 0.7, 1.0)


class SnakeGridScene(NamedTuple):
    """The occupied cells as a grid (JAX envs/snake.py:61-80): ``cells``,
    the flat ids of the occupied cells padded with -1, and ``row_masks``,
    bit j of entry i set when cell (i, j) is occupied. The snake is planar
    and every capsule has half length plus radius at most 0.27, so a capsule
    can touch only the cells within one index of its midpoint's nearest
    cell: a 3 x 3 window decides as the whole scan. With lanes both have a
    leading lane axis (``envs/base.py::stack_scenes``)."""

    cells: torch.Tensor  # (MAX_CELLS,) int32
    row_masks: torch.Tensor  # (GRID_W,) int32


def make_snake_grid_scene(occ_map: np.ndarray, device=None, cap: int = MAX_CELLS) -> SnakeGridScene:
    """The grid scene of an occupancy map (JAX envs/snake.py:92-100)."""

    occ = np.asarray(occ_map)
    flat = np.flatnonzero(occ.reshape(-1) != 0).astype(np.int32)
    if len(flat) > cap:
        raise ValueError(f"{len(flat)} occupied cells exceed cap {cap}")
    cells = np.full(cap, -1, np.int32)
    cells[: len(flat)] = flat
    masks = (np.asarray(occ != 0, np.int64) << np.arange(occ.shape[-1])).sum(1)
    return SnakeGridScene(torch.as_tensor(cells, device=device),
                          torch.as_tensor(masks.astype(np.int32), device=device))


def grid_contacts(p0, p1, r, scene: SnakeGridScene):
    """(L, B) bool: any capsule of (L, B, C, 3) endpoints within its radius
    of an occupied cell of its 3 x 3 window (JAX envs/snake.py:148-178),
    as tensor ops. The window's centres come from the float64-derived table
    and the nearest cell rounds half to even, as ``jnp.round``."""

    dev = p0.device
    mid = 0.5 * (p0[..., :2] + p1[..., :2])  # (L, B, C, 2)
    ci = torch.clamp(torch.round((mid - CELL_ORIGIN) / CELL).to(torch.int64), 0, GRID_W - 1)
    cand = ci[..., None, :] + torch.as_tensor(_WIN, device=dev)  # (L, B, C, 9, 2)
    in_grid = ((cand >= 0) & (cand < GRID_W)).all(-1)
    ix = cand.clamp(0, GRID_W - 1)
    L = p0.shape[0]
    rows = scene.row_masks.to(torch.int64).reshape(L, 1, 1, GRID_W)
    word = torch.gather(rows.expand(ix.shape[:3] + (GRID_W,)), 3, ix[..., 0])
    occupied = (((word >> ix[..., 1]) & 1) != 0) & in_grid
    coords = torch.as_tensor(_COORDS, device=dev)
    centers = torch.cat([coords[ix], torch.zeros_like(coords[ix][..., :1])], -1)
    halfs = torch.tensor(_HALF, dtype=torch.float32, device=dev).expand_as(centers)
    d2 = seg_box_sq_dist(p0[..., None, :], p1[..., None, :], centers, halfs)  # (L, B, C, 9)
    return (occupied & (d2 < (r ** 2)[:, None])).any(-1).any(-1)


def snake_state_free_grid(chain, pairs, scene: SnakeGridScene, qs, lower, upper):
    """(free, n_checks) of configurations (L, B, 7) through the 3 x 3 grid
    window (JAX envs/snake.py:134-184) and the self pairs
    (``geometry.contact_pairs``)."""

    valid = ((qs >= lower) & (qs <= upper)).all(dim=-1)
    p0, p1, r = snake_capsules(chain, qs)
    box = grid_contacts(p0, p1, r, scene)
    return valid & ~box & ~pair_contacts(p0, p1, pairs), valid.to(torch.int32)


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
    """Capsule endpoints of configurations qs (..., B, 7) under the
    reference's mapping: base (q0, q1, HEIGHT), yaw q3, joints q2..q5:
    (L, B, C, 3) twice for lanes (L, B, 7), (B, C, 3) for (B, 7), and the
    radii (C,)."""

    lanes = qs.dim() == 3
    q = qs if lanes else qs[None]
    joints = q[..., 2:6].contiguous()
    L, B = q.shape[:2]
    # the yaw and every joint angle in one sincosf32 pass
    angles = torch.cat([q[..., 3:4], joint_angles(chain, joints.reshape(L * B, 4))
                        .reshape(L, B, -1)], -1)
    cos, sin = sincosf32(angles)
    c, s = cos[..., 0], sin[..., 0]
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    base_rot = torch.stack([
        torch.stack([c, -s, zero], dim=-1),
        torch.stack([s, c, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    base_trans = torch.stack([q[..., 0], q[..., 1], torch.full_like(c, HEIGHT)], dim=-1)
    p0, p1 = lane_capsules(chain, joints, base_rot=base_rot, base_trans=base_trans,
                           trig=(cos[..., 1:], sin[..., 1:]))
    return (p0, p1, chain.cap_r) if lanes else (p0[0], p1[0], chain.cap_r)


def make_snake_kernels(chain, pair_mask: np.ndarray, lower, upper, rrt_eps: float,
                       k_max: int) -> EnvKernels:
    """JAX envs/snake.py:187-217, batched: limits, cells and self pairs. A
    :class:`SnakeGridScene` takes the 3 x 3 window (as JAX's
    ``state_free`` does, :187-191); the box scene goes through entry A."""

    r = chain.cap_r
    pairs = contact_pairs(pair_mask, r.cpu().numpy(), r.device)

    @lane_oracle
    def batch_state_free(scene, qs):
        if isinstance(scene, SnakeGridScene):
            return snake_state_free_grid(chain, pairs, scene, qs, lower, upper)
        valid = ((qs >= lower) & (qs <= upper)).all(dim=-1)
        p0, p1, _ = snake_capsules(chain, qs)
        box = capsules_hit(p0, p1, r, scene.centers, scene.halfs, scene.mask)
        self_hit = pair_contacts(p0, p1, pairs)
        return valid & ~box & ~self_hit, valid.to(torch.int32)

    return arm_kernels(batch_state_free, lower, upper, rrt_eps, k_max)


class SnakeEnv(KukaEnv):
    """Host wrapper with the reference SnakeEnv protocol on maze problems:
    its own problem dict and robot points; KukaEnv's metric, ``step``,
    ``set_random_init_goal``, edge and state checks and sampling, through
    the device oracle (JAX envs/snake.py's are the same arithmetic)."""

    RRT_EPS = 0.1

    def __init__(self, map_file: str = "maze_files/snakes_15_2_3000.npz", device=None):
        self._start(device)
        self.dim = 2
        with np.load(asset_path(map_file)) as f:
            self.maps = f["maps"]
            self.init_states = f["init_states"]
            self.goal_states = f["goal_states"]
        self.width = self.maps.shape[1]
        self._set_pose_range([(-9.0, 9.0), (-9.0, 9.0)] + [(-np.pi, np.pi)] * 5)

        self.model = model = parse_urdf(asset_path("snake.urdf"))
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
        """Problem ``index``'s map, start and goal (JAX envs/snake.py:
        282-296): the reference protocol's dict (``get_problem``)."""

        if index is None:
            index = self.episode_i
        self.index = index
        self.episode_i = (self.episode_i + 1) % len(self.maps)
        self.set_problem_data(self.maps[index], self.init_states[index],
                              self.goal_states[index])
        return self.get_problem()

    def set_problem_data(self, occ_map, start, goal):
        """A problem given by its occupancy map and its endpoints (JAX
        envs/snake.py:298-308)."""

        self.collision_check_count = 0
        self.collision_point = None
        self.map = occ_map
        self.init_state = np.asarray(start)
        self.goal_state = np.asarray(goal)
        self.obstacles = np.argwhere(occ_map == 1) / occ_map.shape[0] - 0.5
        self._scene = make_snake_scene(occ_map, self.device)
        self._corr_cells = None
        self._draw_pos = 0

    def get_problem(self):
        """The map and the endpoints (JAX envs/snake.py:310-315)."""

        return {"map": self.map, "init_state": self.init_state, "goal_state": self.goal_state}

    def get_robot_points(self, config):
        """The base position (q0, q1), a copy (JAX envs/snake.py:341-344)."""

        return copy.deepcopy(config[:2])

    def _render_segments(self, config):
        """World-frame capsule segments of one configuration under the
        reference's mapping (JAX envs/snake.py:719-731)."""

        q = torch.as_tensor(np.asarray(config, np.float32)).reshape(1, -1)
        p0, p1, _ = snake_capsules(self.host_chain, q)
        return p0[0].numpy(), p1[0].numpy()

    def plot(self, map=None, path=None, make_gif: bool = False, save_path=None):
        """Headless top-down render (reference snake_env.py:287-330
        signature, ``utils/plot.py::plot_snake_path``)."""

        from gnn_motion_planning_tpu_torch.utils.plot import plot_snake_path

        occ = self.map if map is None else map
        return plot_snake_path(self, occ, path, make_gif=make_gif, save_path=save_path)

    def robot_points(self, configs) -> np.ndarray:
        """``get_robot_points`` of many configurations (n, 7): (n, 2)."""

        return np.asarray(configs).reshape(-1, self.config_dim)[:, :2].copy()

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

    # -- the opt-in sampler biases (JAX envs/snake.py:356-537) -------------

    # every this-many-th draw is transformed: "straight" (every 3rd),
    # "corridor" (every 2nd)
    _BIAS_EVERY = 3
    _CORRIDOR_EVERY = 2

    def _corridor_cells(self) -> tuple:
        """The problem's corridor: the free cells on near-shortest
        4-connected grid paths (slack 2) between the init and goal base
        cells, as ((n, 2) cell centres, (n, 2) unit goal-ward directions,
        zero where the BFS descent is undefined). Cached; the key holds the
        map itself and copies of init and goal, so a new problem or
        ``set_random_init_goal`` is never served a stale corridor."""

        key = getattr(self, "_corr_key", None)
        if (self._corr_cells is not None and key is not None and key[0] is self.map
                and np.array_equal(key[1], self.init_state)
                and np.array_equal(key[2], self.goal_state)):
            return self._corr_cells
        occ = np.asarray(self.map) != 0
        w = occ.shape[0]
        centers = 1.4 * np.arange(w) - 10.5
        unreached = np.iinfo(np.int32).max

        def cell_of(xy):
            return tuple(int(np.clip(np.round((c + 10.5) / 1.4), 0, w - 1)) for c in xy)

        def bfs(start):
            d = np.full((w, w), unreached, np.int64)
            if occ[start]:
                return d
            d[start] = 0
            q = [start]
            while q:
                nq = []
                for i, j in q:
                    for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
                        ni, nj = i + di, j + dj
                        if 0 <= ni < w and 0 <= nj < w and not occ[ni, nj]:
                            if d[ni, nj] > d[i, j] + 1:
                                d[ni, nj] = d[i, j] + 1
                                nq.append((ni, nj))
                q = nq
            return d

        ci, cg = cell_of(self.init_state[:2]), cell_of(self.goal_state[:2])
        d_i, d_g = bfs(ci), bfs(cg)
        best = d_i[cg]
        sel = ~occ if best >= unreached else (d_i + d_g) <= best + 2
        ij = np.argwhere(sel)
        cells = np.stack([centers[ij[:, 0]], centers[ij[:, 1]]], axis=1)
        dirs = np.zeros_like(cells)
        for r, (i, j) in enumerate(ij):
            if d_g[i, j] >= unreached or d_g[i, j] == 0:
                continue
            steps = [(di, dj) for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1))
                     if 0 <= i + di < w and 0 <= j + dj < w
                     and d_g[i + di, j + dj] == d_g[i, j] - 1]
            if steps:
                v = np.mean(np.asarray(steps, np.float64), axis=0)
                nrm = np.hypot(*v)
                if nrm > 0:
                    dirs[r] = v / nrm
        self._corr_key = (self.map, np.array(self.init_state, copy=True),
                          np.array(self.goal_state, copy=True))
        self._corr_cells = (cells.astype(np.float64), dirs)
        return self._corr_cells

    def _bias_draws(self, draws: np.ndarray, offset: int = 0) -> np.ndarray:
        """The opt-in narrow-passage biases (JAX envs/snake.py:449-537), each
        a function of a draw and its position in the problem's stream
        (``offset`` is the first row's), so chunking does not change them.

        "straight": the five angles of every ``_BIAS_EVERY``-th draw go to
        t^3 / pi^2. "corridor": the base of every ``_CORRIDOR_EVERY``-th draw
        goes into a corridor cell (``_corridor_cells``; the x draw picks the
        cell, the fractional parts the offset, along the cell's tangent and a
        quarter cell across it), its angles to a pose aligned with the
        tangent plus a small squashed noise, or the straight squash where
        the cell has no tangent."""

        bias = self.sampler_bias
        if bias is None:
            return draws
        draws = draws.copy()
        pos = offset + np.arange(len(draws))
        if bias == "straight":
            idx = np.nonzero(pos % self._BIAS_EVERY == 0)[0]
            draws[idx, 2:] = draws[idx, 2:] ** 3 / (np.pi**2)
            return draws
        if bias != "corridor":
            raise ValueError(f"unknown sampler_bias {bias!r}")
        cells, dirs = self._corridor_cells()
        idx = np.nonzero(pos % self._CORRIDOR_EVERY == 0)[0]
        u = (draws[idx, :2] + 9.0) / 18.0
        t = u[:, 0] * len(cells)
        c = np.minimum(t.astype(np.int64), len(cells) - 1)
        fx, fy = t - c, u[:, 1]
        ang = draws[idx, 2:]
        d = dirs[c]
        aimed = (d[:, 0] != 0.0) | (d[:, 1] != 0.0)
        phi = np.arctan2(d[:, 1], d[:, 0])
        delta = np.mod(np.pi / 2 - phi + np.pi / 2, np.pi) - np.pi / 2
        tang = np.where(aimed[:, None], d, np.asarray([[0.0, 1.0]]))
        perp = np.stack([-tang[:, 1], tang[:, 0]], 1)
        off = 1.4 * (fx - 0.5)[:, None] * tang + 0.35 * (fy - 0.5)[:, None] * perp
        off_uni = 1.4 * (np.stack([fx, fy], 1) - 0.5)
        xy = cells[c] + np.where(aimed[:, None], off, off_uni)
        draws[idx, :2] = np.clip(xy, -9.0, 9.0)
        noise = 0.4 * ang**3 / (np.pi**2)
        zero = np.zeros_like(delta)
        slab = np.stack([-delta / 2, -delta / 2, 0.75 * delta, zero, zero], 1)
        draws[idx, 2:] = np.where(aimed[:, None], slab + noise, ang**3 / (np.pi**2))
        return draws
