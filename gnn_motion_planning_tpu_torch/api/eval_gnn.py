"""GNN planner protocol drivers: explore + smooth + benchmark metrics
(port of gnn_motion_planning_tpu/api/eval_gnn.py).

The unfused order of the JAX package's scalar protocol: per round, RGG
build -> explorer forward -> greedy search; then backtrack and five
smoothing iterations. The JAX package states that its fused round-1
program is bit-identical to this order (eval_gnn.py:161-162). The batched
sweep and the serving paths live in ``api/batched.py`` and
``api/serve.py`` and are re-exported here, as in the JAX package.
"""

from __future__ import annotations

import copy
from time import time

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.api.planner_bundle import get_planner
from gnn_motion_planning_tpu_torch.config import problem_rng, set_random_seed
from gnn_motion_planning_tpu_torch.graphs.knn import EdgeList, build_rgg_edges, k_scaled
from gnn_motion_planning_tpu_torch.models.explorer import explorer_forward
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, smoother_forward
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges, pad_to_bucket
from gnn_motion_planning_tpu_torch.planners.oracle_smoother import joint_smoother


def progress(indexes, use_tqdm: bool):
    """``indexes``, under a tqdm bar where asked and tqdm is installed (the
    card's machine may lack it: then the plain sequence)."""

    if use_tqdm:
        try:
            from tqdm import tqdm
        except ImportError:
            return indexes
        return tqdm(indexes)
    return indexes


def path_cost(path) -> float:
    """Euclidean path length (reference eval_gnn.py:53-58)."""

    if len(path) < 2:
        return 0.0
    path = np.asarray(path, np.float64)
    return float(np.sum(np.linalg.norm(path[1:] - path[:-1], axis=-1)))


def _smooth_iterations(model_s, project, scene, path, args, n_path, iters):
    count, overflow = 0, False
    for _ in range(iters):
        proposal = smoother_forward(model_s, path, *args, loop=1)
        path, cnt, ovf = project(scene, path, proposal, n_path)
        count += cnt
        overflow |= ovf
    return path, count, overflow


@torch.no_grad()
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
        planner.overflow_redos += 1
        path, count, _ = _smooth_iterations(
            model_s, planner.project_full, scene, t(path_arr), args, L, iter
        )
    env.collision_check_count += count
    out = path.cpu().numpy()[:L]
    return [out[i] for i in range(L)]


@torch.no_grad()
def explore(env, model, model_s, smooth: bool = True, batch: int = 500,
            t_max: int = 1000, k: int = 30, smoother: str = "model", loop: int = 5,
            strict_fallback: bool = False):
    """GNN-guided planning for the env's current problem (reference
    eval_gnn.py:168-276; the same return payload). ``smoother``: "model"
    (the smoother GNN ``model_s``), "oracle" (``planners/oracle_smoother.py::
    joint_smoother``, five rounds, through the env's host oracles) or
    anything else (the path as found), as JAX api/eval_gnn.py:322-338.

    ``strict_fallback`` (opt-in, off under the reference protocol): when
    the capsule-feasible graph exhausts without success on an arm env,
    re-admit capsule-blocked RGG edges that the sound hull-surface verifier
    certifies free (``planners/strict_fallback.py``), as JAX
    api/eval_gnn.py:295-316. Every extra check is counted; a path found so
    has ``strict_certified`` true in the result."""

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
    if smooth and smoother == "model" and not isinstance(model_s, Smoother):
        smoother = "oracle"  # no model smoother for this env: JAX's fallback
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

    strict_certified = False
    if not success and strict_fallback and v_np is not None:
        from gnn_motion_planning_tpu_torch.planners.strict_fallback import strict_fallback_path

        # the last round's RGG, built on this v_np and its F (JAX rebuilds
        # it because its fused round does not return the edges)
        edges = EdgeList(*(x.cpu().numpy() for x in edges))
        idx_path = strict_fallback_path(env, v_np, F, edges, state[3].cpu().numpy())
        if idx_path is not None:
            success = True
            strict_certified = True
            path = [v_np[i] for i in idx_path]

    c_explore = env.collision_check_count - c0
    c1 = env.collision_check_count
    t1 = time()
    if success and smooth:
        if smoother == "model":
            smooth_path = model_smooth(model_s, free, collided, path, env)
        elif smoother == "oracle":
            smooth_path = joint_smoother(path, env, iter=5)
        else:
            smooth_path = path
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
        "strict_certified": strict_certified,
        "t0": t0,
        "path": path,
        "smooth_path": smooth_path,
        "v": v_np,
    }


def eval_gnn(str_, seed, env, indexes, model=None, model_s=None, use_tqdm: bool = False,
             smooth: bool = True, batch: int = 500, t_max: int = 500, k: int = 30, rows=None,
             **kwargs):
    """Benchmark sweep with the reference's metric block
    (reference eval_gnn.py:96-145). ``rows``, if given, receives one dict
    per problem: index, success, c_explore, c_smooth, cost, and wall seconds
    in all, in exploration (sampling included) and in the planning rounds.
    Other keywords (``smoother``, ``loop``) go to :func:`explore`."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2models

    set_random_seed(seed)
    if model is None or model_s is None:
        m, m_s = str2models(str_, env.device, smoother_scale(str_, env))
        model = m if model is None else model
        model_s = m_s if model_s is None else model_s

    solutions = []
    paths, smooth_paths = [], []
    for index in progress(indexes, use_tqdm):
        # independent per-problem stream, as in the JAX package
        env.rng = problem_rng(seed, int(index))
        env.init_new_problem(int(index))
        result = explore(env, model, model_s, smooth, batch=batch, t_max=t_max, k=k, **kwargs)
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


def eval_gnn_pure(str_, seed, env, indexes, model=None, model_s=None, **kwargs):
    """Obstacle-encoding-free variant (reference eval_gnn.py:80-93; JAX
    api/eval_gnn.py:475-487): the explorer of ``str2name(use_obstacle=
    False)``, the ``_pure.pt`` checkpoint, or ``model``, run without its
    obstacle encoder; the protocol's smoother."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2models

    if model is None:
        model, _ = str2models(str_, env.device, smoother_scale(str_, env), use_obstacle=False)
    # the caller's module keeps its config: a shallow copy shares the weights
    model = copy.copy(model)
    model.cfg = model.cfg._replace(use_obstacles=False)
    if model_s is None:
        _, model_s = str2models(str_, env.device, smoother_scale(str_, env))
    return eval_gnn(str_, seed, env, indexes, model, model_s, **kwargs)


# the batched sweep and the serving paths, re-exported as the JAX package
# does (eval_gnn.py:494-499)
from gnn_motion_planning_tpu_torch.api.batched import eval_gnn_batched, explore_batch  # noqa: E402
from gnn_motion_planning_tpu_torch.api.serve import eval_gnn_serve, explore_serve  # noqa: E402
