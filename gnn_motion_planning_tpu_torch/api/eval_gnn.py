"""GNN planner protocol drivers: explore + smooth + benchmark metrics
(port of gnn_motion_planning_tpu/api/eval_gnn.py).

The unfused order of the JAX package's scalar protocol: per round, RGG
build -> explorer forward -> greedy search; then backtrack and five
smoothing iterations. The JAX package states that its fused round-1
program is bit-identical to this order (eval_gnn.py:161-162).
"""

from __future__ import annotations

from time import time

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.config import problem_rng, set_random_seed
from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges, k_scaled
from gnn_motion_planning_tpu_torch.models.explorer import explorer_forward
from gnn_motion_planning_tpu_torch.models.smoother import smoother_forward
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack, make_explore_round_core
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import (
    base_chain_edges,
    make_projection_core,
    make_projection_core_flat,
    pad_to_bucket,
)


def path_cost(path) -> float:
    """Euclidean path length (reference eval_gnn.py:53-58)."""

    if len(path) < 2:
        return 0.0
    path = np.asarray(path, np.float64)
    return float(np.sum(np.linalg.norm(path[1:] - path[:-1], axis=-1)))


class _Planner:
    """The env's round core and projection cores, built once per env."""

    def __init__(self, env):
        kernels = env.kernels()
        eps = float(env.RRT_EPS)
        self.round_core = make_explore_round_core(kernels, eps)
        # flat projection first where the kernels have bounds (the arms); on
        # overflow the full one redoes the work. Envs without bounds (the
        # mazes) have no cheap edge check, so both are the full sweep (JAX
        # api/planner_bundle.py:94-108 with no edge_free_cheap).
        self.project_full = make_projection_core(kernels, eps)
        if kernels.bounds is not None:
            self.project_cheap = make_projection_core_flat(kernels, eps)
        else:
            self.project_cheap = self.project_full


def get_planner(env) -> _Planner:
    planner = getattr(env, "_torch_planner", None)
    if planner is None:
        planner = env._torch_planner = _Planner(env)
    return planner


def _smooth_iterations(model_s, project, scene, path, args, n_path, iters):
    count, overflow = 0, False
    for _ in range(iters):
        proposal = smoother_forward(model_s, path, *args, loop=1)
        path, cnt, ovf = project(scene, path, proposal, n_path)
        count += cnt
        overflow |= ovf
    return path, count, overflow


def model_smooth(model_s, free, collided, old_path, env, iter: int = 5):
    """GNN smoothing driver (reference smoother.py:233-246); ``free`` and
    ``collided`` are truncated to 500 samples each like the reference."""

    planner = get_planner(env)
    dev = env.device
    d = env.config_dim
    free_used = np.asarray(free, np.float32)[:500]
    coll_used = np.asarray(collided, np.float32)[:500] if len(collided) else np.zeros((0, d), np.float32)
    env_nodes = np.zeros((1000, d), np.float32)
    env_valid = np.zeros(1000, bool)
    env_nodes[: len(free_used)] = free_used
    env_valid[: len(free_used)] = True
    env_nodes[500 : 500 + len(coll_used)] = coll_used
    env_valid[500 : 500 + len(coll_used)] = True

    L = len(old_path)
    l_pad = pad_to_bucket(L, step=64)
    base = base_chain_edges(l_pad, L)
    path_arr = np.zeros((l_pad, d), np.float32)
    path_arr[:L] = np.asarray(old_path, np.float32)
    path_arr[L:] = path_arr[L - 1]
    path_mask = np.zeros(l_pad, bool)
    path_mask[:L] = True

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    args = (t(path_mask), t(env_nodes), t(env_valid), len(free_used), *(t(a) for a in base))
    scene = env.device_scene()
    path, count, overflow = _smooth_iterations(
        model_s, planner.project_cheap, scene, t(path_arr), args, L, iter
    )
    if overflow:
        # a step needed more than the cheap budget: redo at the full budget,
        # whose counts are the protocol result
        path, count, _ = _smooth_iterations(
            model_s, planner.project_full, scene, t(path_arr), args, L, iter
        )
    env.collision_check_count += count
    out = path.cpu().numpy()[:L]
    return [out[i] for i in range(L)]


def explore(env, model, model_s, smooth: bool = True, batch: int = 500,
            t_max: int = 1000, k: int = 30, loop: int = 5):
    """GNN-guided planning for the env's current problem (reference
    eval_gnn.py:168-276; the same return payload)."""

    planner = get_planner(env)
    scene = env.device_scene()
    dev = env.device
    d = env.config_dim
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    c0 = env.collision_check_count
    t0 = time()
    forward = 0.0
    success = False
    path, smooth_path = [], []
    free, collided = env.sample_n_points(batch, need_negative=True)
    collided = list(collided)[: len(free)]
    free = [np.asarray(env.init_state, np.float64), np.asarray(env.goal_state, np.float64)] + [
        np.asarray(f) for f in free
    ]
    obstacles, obs_mask = env.obs_tokens()
    goal = t(np.asarray(env.goal_state, np.float32))
    obstacles, obs_mask = t(obstacles), t(obs_mask)

    state = None  # (explored, prev, costs, edge_dead) carried across rounds
    v_np = None
    while not success and (len(free) - 2) <= t_max:
        F, C = len(free), len(collided)
        N = 2 * F
        v_np = np.zeros((N, d), np.float32)
        v_np[:F] = np.asarray(free, np.float32)
        if C:
            v_np[F : F + C] = np.asarray(collided, np.float32)
        node_valid = np.zeros(N, bool)
        node_valid[: F + C] = True
        collided_mask = np.zeros(N, bool)
        collided_mask[F : F + C] = True
        v, node_valid, collided_mask = t(v_np), t(node_valid), t(collided_mask)

        if state is None:
            explored = torch.zeros(N, dtype=torch.bool, device=dev)
            explored[0] = True
            prev = torch.zeros(N, dtype=torch.int64, device=dev)
            costs = torch.zeros(N, dtype=torch.float32, device=dev)
            edge_dead = torch.zeros((N, N), dtype=torch.bool, device=dev)
        else:
            explored, prev, costs, edge_dead = state
            pad = N - explored.shape[0]
            if pad:
                explored = torch.nn.functional.pad(explored, (0, pad))
                prev = torch.nn.functional.pad(prev, (0, pad))
                costs = torch.nn.functional.pad(costs, (0, pad))
                edge_dead = torch.nn.functional.pad(edge_dead, (0, pad, 0, pad))

        t1 = time()
        edges = build_rgg_edges(v, node_valid, F, k_scaled(k, F))
        policy = explorer_forward(
            model, v, node_valid, goal, edges.src, edges.dst, edges.alive,
            obstacles, obs_mask, loop=loop,
        )
        res = planner.round_core(
            scene, v, goal, policy, edges, collided_mask, node_valid,
            explored, prev, costs, edge_dead,
        )
        forward += time() - t1
        success = res.success
        env.collision_check_count += res.n_checks
        state = (res.explored, res.prev, res.costs, res.edge_dead)
        if success:
            idx_path = backtrack(res.prev.cpu().numpy(), res.success_node)
            path = [v_np[i] for i in idx_path]
        else:
            if not smooth:
                return []
            if (batch + len(free) - 2) > t_max:
                break
            new_free, new_collided = env.sample_n_points(batch, need_negative=True)
            free = free + [np.asarray(f) for f in new_free]
            collided = (collided + list(new_collided))[: len(free)]

    c_explore = env.collision_check_count - c0
    c1 = env.collision_check_count
    t1 = time()
    if success and smooth:
        smooth_path = model_smooth(model_s, free, collided, path, env)
    c_smooth = env.collision_check_count - c1

    if not smooth:
        return path, free, collided
    explored_idx = (
        list(np.nonzero(state[0].cpu().numpy())[0]) if state is not None else [0]
    )
    total_time = time()
    return {
        "c_explore": int(c_explore),
        "c_smooth": int(c_smooth),
        "explored": explored_idx,
        "forward": forward,
        "total": total_time - t0,
        "total_explore": t1 - t0,
        "success": success,
        "t0": t0,
        "path": path,
        "smooth_path": smooth_path,
        "v": v_np,
    }


def eval_gnn(str_, seed, env, indexes, model=None, model_s=None, smooth: bool = True,
             batch: int = 500, t_max: int = 500, k: int = 30, rows=None):
    """Benchmark sweep with the reference's metric block
    (reference eval_gnn.py:96-145). ``rows``, if given, receives one dict
    per problem: index, success, c_explore, c_smooth, cost, and wall seconds
    in all, in exploration (sampling included) and in the planning rounds."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2models

    set_random_seed(seed)
    if model is None or model_s is None:
        m, m_s = str2models(str_, env.device, smoother_scale(str_, env))
        model = m if model is None else model
        model_s = m_s if model_s is None else model_s

    solutions = []
    paths, smooth_paths = [], []
    for index in indexes:
        # independent per-problem stream, as in the JAX package
        env.rng = problem_rng(seed, int(index))
        env.init_new_problem(int(index))
        result = explore(env, model, model_s, smooth, batch=batch, t_max=t_max, k=k)
        paths.append(result["path"])
        smooth_paths.append(result["smooth_path"])
        solutions.append((
            result["success"],
            path_cost(result["path"]),
            path_cost(result["smooth_path"]),
            result["c_explore"],
            result["c_smooth"],
            result["total"],
            result["total_explore"],
        ))
        if rows is not None:
            rows.append(dict(
                index=int(index), success=bool(result["success"]),
                c_explore=int(result["c_explore"]), c_smooth=int(result["c_smooth"]),
                cost=path_cost(result["smooth_path"]), seconds=result["total"],
                explore_seconds=result["total_explore"], round_seconds=result["forward"],
            ))

    n_success = sum(s[0] for s in solutions)
    collision_explore = float(np.mean([s[3] for s in solutions]))
    collision = float(np.mean([s[3] + s[4] for s in solutions]))
    running_time = (
        float(sum(s[5] for s in solutions if s[0])) / n_success if n_success else float("nan")
    )
    solution_cost = (
        float(sum(s[2] for s in solutions if s[0])) / n_success if n_success else float("nan")
    )
    total_time = float(sum(s[5] for s in solutions))
    total_time_explore = float(sum(s[6] for s in solutions))

    print("success rate:", n_success)
    print("collision check: %.2f" % collision)
    print("collision check explore: %.2f" % collision_explore)
    print("running time: %.2f" % running_time)
    print("path cost: %.2f" % solution_cost)
    print("total time: %.2f" % total_time)
    print("total time explore: %.2f" % total_time_explore)
    print("")

    return (
        n_success, collision, running_time, solution_cost, total_time,
        paths, smooth_paths, collision_explore, total_time_explore,
    )
