"""Baseline evaluation drivers: BIT*, LazySP, RRT*, NEXT.

Port of gnn_motion_planning_tpu/api/eval_baselines.py: drop-in equivalents
of the reference drivers (reference: eval_bit.py:82-151, eval_rrt.py:21-57,
eval_next.py:21-88) with the same metric blocks and return tuples. The
planners are host code over numpy and draw from ``env.rng``; their
collision checks go through the env's oracles (``_edge_fp``, ``_state_fp``,
``_batch_free``): the native core, the maze host oracle, or the device
oracle on ``env.device`` (ur5: one launch of ``capsules_hit`` a call). The
NEXT model runs on the env's device.
"""

from __future__ import annotations

from time import time

import numpy as np

from gnn_motion_planning_tpu_torch.api.eval_gnn import path_cost, progress
from gnn_motion_planning_tpu_torch.config import set_random_seed

INFINITY = float("inf")


def _seed_env(seed, env):
    rng = set_random_seed(seed)
    env.rng = rng
    return rng


def eval_bit(str, seed, env, indexes, use_tqdm=False, batch=50, t_max=1000, **kwargs):
    """reference eval_bit.py:82-115."""

    from gnn_motion_planning_tpu_torch.planners.bit_star import BITStar

    _seed_env(seed, env)
    solutions = []
    paths = []

    for problem_index in progress(indexes, use_tqdm):
        env.init_new_problem(int(problem_index))
        bit = BITStar(env, batch_size=batch, T=t_max, sampling=None)
        solution = bit.plan(INFINITY, time_budget=300, refine_time_budget=0)
        solutions.append(solution)
        paths.append(bit.get_best_path())

    n_success = sum(s[-3] != INFINITY for s in solutions)
    collision = float(np.mean([s[2] for s in solutions]))
    running_time = float(np.mean([s[-1] for s in solutions if s[-3] != INFINITY]))
    solution_cost = (
        float(sum(s[-3] for s in solutions if s[-3] != INFINITY)) / n_success
        if n_success
        else float("nan")
    )
    total_time = float(sum(s[-1] for s in solutions))

    print("success rate: %d" % n_success)
    print("collision check: %.2f" % collision)
    print("running time: %.2f" % running_time)
    print("path cost: %.2f" % solution_cost)
    print("total time: %.2f" % total_time)
    print("")
    return n_success, collision, running_time, solution_cost, total_time, paths


def eval_lazysp(str, seed, env, indexes, use_tqdm=False, batch=50, t_max=1000, **kwargs):
    """reference eval_bit.py:118-151."""

    from gnn_motion_planning_tpu_torch.planners.lazy_sp import LazySP

    _seed_env(seed, env)
    solutions = []
    paths = []
    for problem_index in progress(indexes, use_tqdm):
        env.init_new_problem(int(problem_index))
        lazy_sp = LazySP(env, batch_size=batch, T=t_max)
        solution = lazy_sp.plan()
        solutions.append(solution)
        paths.append(solution[2])

    n_success = sum(len(p) != 0 for p in paths)
    collision = float(np.mean([s[1] for s in solutions]))
    running_time = float(np.mean([s[4] for s in solutions if len(s[2]) != 0]))
    solution_cost = (
        float(sum(path_cost(p) for p in paths if len(p) != 0)) / n_success
        if n_success
        else float("nan")
    )
    total_time = float(sum(s[4] for s in solutions))

    print("success rate: %d" % n_success)
    print("collision check: %.2f" % collision)
    print("running time: %.2f" % running_time)
    print("path cost: %.2f" % solution_cost)
    print("total time: %.2f" % total_time)
    print("")
    return n_success, collision, running_time, solution_cost, total_time, paths


def _eval_tree_planner(env, indexes, use_tqdm, t_max, model, g_explore_eps):
    from gnn_motion_planning_tpu_torch.planners.tsa import NEXT_plan

    solutions = []
    times = []
    for i in progress(indexes, use_tqdm):
        pb = env.init_new_problem(int(i))
        if model is not None:
            model.set_problem(pb)
        t0 = time()
        solutions.append(
            NEXT_plan(
                env=env,
                model=model,
                T=t_max,
                g_explore_eps=g_explore_eps,
                stop_when_success=True,
                UCB_type="kde",
            )
        )
        times.append(time() - t0)

    n_success = int(np.sum([bool(s[1]) for s in solutions]))
    collision = float(
        np.mean(
            [
                s[0].cumulated_collision_checks[-1] - s[0].cumulated_collision_checks[1]
                for s in solutions
            ]
        )
    )
    running_time = float(
        np.mean([t for t, s in zip(times, solutions) if s[1]])
    ) if n_success else float("nan")
    solution_cost = (
        float(np.mean([s[0].path_lengths[-1] for s in solutions if s[1]]))
        if n_success
        else float("nan")
    )
    total_time = float(sum(times))

    print("success rate:", n_success)
    print("collision check: %.2f" % collision)
    print("running time: %.2f" % running_time)
    print("path cost: %.2f" % solution_cost)
    print("total time: %.2f" % total_time)
    print("")
    return (
        n_success,
        collision,
        running_time,
        solution_cost,
        total_time,
        [s[0].path()[0] for s in solutions],
    )


def eval_rrt(str, seed, env, indexes, use_tqdm=False, t_max=1000, **kwargs):
    """reference eval_rrt.py:21-57 (RRT* = NEXT with eps=1, no model)."""

    _seed_env(seed, env)
    return _eval_tree_planner(env, indexes, use_tqdm, t_max, None, 1.0)


def str2next(str, env):
    """(model, ckpt_path) per env (reference eval_next.py:21-44); the model
    on the env's device."""

    from gnn_motion_planning_tpu_torch.models.next_model import Model2D, Model3D, load_next

    table = {
        "maze2": ("data/weights/next_2.pt", Model2D, {}),
        "maze3": ("data/weights/next_3.pt", Model2D, {}),
        "snake7": ("data/weights/next_snake.pt", Model2D, {}),
        "ur5": ("data/weights/next_ur5.pt", Model3D, {"point_dim": 3}),
        "kuka7": ("data/weights/next_7.pt", Model3D, {"point_dim": 3}),
        "kuka13": ("data/weights/next_13.pt", Model3D, {"point_dim": 3}),
        "kuka14": ("data/weights/next_14.pt", Model3D, {"point_dim": 6}),
    }
    key = "maze2" if "maze2" in str else str
    ckpt, cls, kw = table[key]
    model = load_next(cls, env, ckpt, env.config_dim, **kw)
    return model, ckpt


def eval_next(str, seed, env, indexes, use_tqdm=False, t_max=1000, **kwargs):
    """reference eval_next.py:47-88."""

    _seed_env(seed, env)
    model, _ = str2next(str, env)
    return _eval_tree_planner(env, indexes, use_tqdm, t_max, model, 0.1)
