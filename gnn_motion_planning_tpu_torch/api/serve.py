"""Serving-mode planning: the minimum-latency path (port of
gnn_motion_planning_tpu/api/serve.py).

:func:`explore_serve` runs a whole problem from draws made on the device:
rejection sampling, RGG build, explorer forward, greedy search, backtrack and
smoothing (``Planner.serve_full``), without the host sampling loop of the
protocol path. :func:`eval_gnn_serve` is its latency benchmark driver.

The draws come from a ``torch.Generator`` on the env's device, seeded from
``(seed, index)`` by :func:`serve_generator`, where the JAX package folds the
index into ``PRNGKey(seed)``. So, as there, serve metrics are statistically,
not bit-, equal to the protocol path's; use :func:`eval_gnn` for reference
comparisons.
"""

from __future__ import annotations

import importlib
from time import time

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.api.planner_bundle import get_planner
from gnn_motion_planning_tpu_torch.config import problem_rng, set_random_seed
from gnn_motion_planning_tpu_torch.envs.env_config import LIMITS
from gnn_motion_planning_tpu_torch.graphs.knn import k_scaled
from gnn_motion_planning_tpu_torch.models.smoother import Smoother
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack
from gnn_motion_planning_tpu_torch.planners.oracle_smoother import joint_smoother

# the smoothed path's buffer; a longer path falls back to the host pipeline
L_PAD = 64
OVERSAMPLE = 4


def _protocol():
    """The scalar protocol drivers, imported at call time (api.eval_gnn
    re-exports this module's entry points)."""

    return importlib.import_module("gnn_motion_planning_tpu_torch.api.eval_gnn")


def serve_generator(seed: int, index: int, device) -> torch.Generator:
    """The draw stream of problem ``index``: a generator on ``device``
    seeded with the first word of numpy's ``SeedSequence([seed, index, 1])``
    (the protocol stream, ``config.problem_rng``, takes ``[seed, index]``,
    so the two never share a seed). The same (seed, index) on the same
    device gives the same draws."""

    word = np.random.SeedSequence([int(seed), int(index), 1]).generate_state(1)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(word))
    return gen


def sample_range(env) -> np.ndarray:
    """(d, 2) float32 bounds the env samples in: its pose range, or the maze
    limits (reference maze_env.py:127-135)."""

    if hasattr(env, "pose_range"):
        return np.array(env.pose_range, np.float32)
    lim = np.asarray(LIMITS[: env.config_dim], np.float32)
    return np.stack([-lim, lim], axis=1)


def draw(env, gen: torch.Generator, n: int) -> torch.Tensor:
    """(n, d) float32 draws uniform in the env's sampling range."""

    pr = torch.as_tensor(sample_range(env), device=env.device)
    u = torch.rand((n, env.config_dim), generator=gen, device=env.device)
    return pr[:, 0] + u * (pr[:, 1] - pr[:, 0])


@torch.no_grad()
def explore_serve(env, model, model_s, gen: torch.Generator, smooth: bool = True,
                  batch: int = 500, k: int = 30, loop: int = 5, oversample: int = OVERSAMPLE,
                  draws: torch.Tensor | None = None):
    """Serving-mode planning for the env's current problem (JAX
    ``explore_serve``): the whole problem through ``Planner.serve_full``
    where the env has a model smoother, else ``serve_round`` and the host
    smoothing pipeline. ``draws`` (oversample x batch, d), if given,
    replace the generator's. Falls back to :func:`explore` when the draws
    hold fewer than ``batch`` free samples, the round fails, or the path
    does not fit the smoothing buffer; the checks the serve call consumed
    are counted first (JAX serve.py:99-108, :146-150)."""

    planner = get_planner(env)
    scene = env.device_scene()
    dev = env.device
    c0 = env.collision_check_count
    t0 = time()
    if draws is None:
        draws = draw(env, gen, oversample * batch)
    obstacles, obs_mask = (torch.as_tensor(a, device=dev) for a in env.obs_tokens())
    init = torch.as_tensor(np.asarray(env.init_state, np.float32), device=dev)
    goal = torch.as_tensor(np.asarray(env.goal_state, np.float32), device=dev)
    k1 = k_scaled(k, batch + 2)
    explore = _protocol().explore

    if smooth and isinstance(model_s, Smoother):
        (success, n_checks, explored, raw_path, sm_path, n_path, fits, prefix_len, n_coll,
         sm_count, enough) = planner.serve_full(
            model, model_s, scene, draws, init, goal, obstacles, obs_mask, batch, k1, loop,
            loop_s=1, l_pad=L_PAD, smooth_iters=5)
        if not (success and bool(enough) and fits):
            # the sampling and search checks were spent; the smoothing ran
            # on no path and is not protocol work
            env.collision_check_count += int(prefix_len) + n_checks
            return explore(env, model, model_s, smooth=smooth, batch=batch, k=k, loop=loop)
        c_explore = int(prefix_len) + n_checks
        env.collision_check_count += c_explore + sm_count
        t1 = time()
        raw = raw_path[:n_path].cpu().numpy()
        smp = sm_path[:n_path].cpu().numpy()
        return {
            "c_explore": c_explore,
            "c_smooth": int(sm_count),
            "explored": list(np.nonzero(explored.cpu().numpy())[0]),
            "forward": t1 - t0,
            "total": time() - t0,
            "total_explore": t1 - t0,
            "success": True,
            "path": [raw[i] for i in range(n_path)],
            "smooth_path": [smp[i] for i in range(n_path)],
            "v": None,
        }

    res, v, prefix_len, n_coll, enough = planner.serve_round(
        model, scene, draws, init, goal, obstacles, obs_mask, batch, k1, loop)
    env.collision_check_count += int(prefix_len) + res.n_checks
    if not bool(enough) or not res.success:
        return explore(env, model, model_s, smooth=smooth, batch=batch, k=k, loop=loop)
    v_np = v.cpu().numpy()
    path = [v_np[i] for i in backtrack(res.prev.cpu().numpy(), res.success_node)]
    c_explore = env.collision_check_count - c0
    t1 = time()
    smooth_path = path
    if smooth:
        if isinstance(model_s, Smoother):
            F = batch + 2
            free = [v_np[i] for i in range(F)]
            collided = [v_np[F + i] for i in range(int(n_coll))]
            smooth_path = _protocol().model_smooth(model_s, free, collided, path, env)
        else:
            # no model smoother: the oracle smoother (JAX api/serve.py:166)
            smooth_path = joint_smoother(path, env, iter=5)
    return {
        "c_explore": int(c_explore),
        "c_smooth": int(env.collision_check_count - c0 - c_explore),
        "explored": list(np.nonzero(res.explored.cpu().numpy())[0]),
        "forward": t1 - t0,
        "total": time() - t0,
        "total_explore": t1 - t0,
        "success": True,
        "path": path,
        "smooth_path": smooth_path,
        "v": v_np,
    }


def eval_gnn_serve(str_, seed, env, indexes, model=None, model_s=None, smooth: bool = True,
                   batch: int = 500, k: int = 30, loop: int = 5, rows: list | None = None):
    """Serving-latency benchmark (JAX ``eval_gnn_serve``): the per-problem
    wall time of :func:`explore_serve`, with the reference metric block and
    the p50/p95 latency over successes. ``rows``, if given, receives one
    dict per problem (index, success, c_explore, c_smooth, cost,
    seconds)."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2models

    set_random_seed(seed)
    if model is None or model_s is None:
        m, m_s = str2models(str_, env.device, smoother_scale(str_, env))
        model = m if model is None else model
        model_s = m_s if model_s is None else model_s

    path_cost = _protocol().path_cost
    solutions, times = [], []
    for index in indexes:
        # the fallback path consumes the protocol stream of this problem
        env.rng = problem_rng(seed, int(index))
        env.init_new_problem(int(index))
        r = explore_serve(env, model, model_s, serve_generator(seed, index, env.device),
                          smooth=smooth, batch=batch, k=k, loop=loop)
        s = (r["success"], path_cost(r["path"]), path_cost(r["smooth_path"]),
             r["c_explore"], r["c_smooth"], r["total"], r["total_explore"])
        solutions.append(s)
        if r["success"]:
            times.append(r["total"])
        if rows is not None:
            rows.append(dict(index=int(index), success=bool(s[0]), c_explore=int(s[3]),
                             c_smooth=int(s[4]), cost=s[2], seconds=s[5]))

    n_success = sum(s[0] for s in solutions)
    collision = float(np.mean([s[3] + s[4] for s in solutions]))
    collision_explore = float(np.mean([s[3] for s in solutions]))
    running_time = float(np.mean(times)) if times else float("nan")
    solution_cost = (
        float(sum(s[2] for s in solutions if s[0])) / n_success if n_success else float("nan")
    )
    p50 = float(np.percentile(times, 50)) if times else float("nan")
    p95 = float(np.percentile(times, 95)) if times else float("nan")

    print("success rate:", n_success)
    print("collision check: %.2f" % collision)
    print("collision check explore: %.2f" % collision_explore)
    print("running time: %.2f" % running_time)
    print("path cost: %.2f" % solution_cost)
    print("p50 latency: %.3f  p95: %.3f" % (p50, p95))
    print("")
    return (n_success, collision, running_time, solution_cost, float(np.sum(times)), p50, p95)
