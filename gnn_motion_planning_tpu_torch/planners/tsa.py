"""NEXT / RRT* tree-search planners (reference algorithm/tsa.py:8-281).

Port of gnn_motion_planning_tpu/planners/tsa.py (host numpy, as there).

UCB-guided selection and model-guided expansion over the SoA search tree,
with RRT-style global exploration and RRT* rewiring. `RRTS_plan` is the
model-free special case (g_explore_eps = 1). Vectorised where the reference
loops in Python (selection scores, neighbour scans); collision stepping
uses the env's edge oracle.
"""

from __future__ import annotations

import numpy as np

from gnn_motion_planning_tpu_torch.planners.search_tree import (
    SearchTree,
    compute_w,
    insert_new_state,
    rewire_to,
    set_cost,
    update_collision_checks,
)


def _rand(env):
    return env.rng if getattr(env, "rng", None) is not None else np.random


def RRTS_plan(env, T: int = 100, stop_when_success: bool = False, timer=None):
    return NEXT_plan(
        env=env, T=T, g_explore_eps=1.0, stop_when_success=stop_when_success, timer=timer
    )


def NEXT_plan(
    env,
    model=None,
    T: int = 100,
    g_explore_eps: float = 1.0,
    stop_when_success: bool = False,
    model_eps: float = 0.05,
    UCB_type: str = "kde",
    c: float = 1.0,
    timer=None,
):
    """(search_tree, success, n_samples) — reference tsa.py:12-81."""

    search_tree = SearchTree(env=env, root=env.init_state, model=model, dim=env.dim)
    rng = _rand(env)

    success = False
    i = 0
    for i in range(T):
        if rng.uniform(0, 1) < model_eps:
            leaf_state, parent_idx, _, no_collision, done = global_explore(
                search_tree, env, sample_state=env.goal_state
            )
            success = success or done
            expanded_by_rrt = True
        elif rng.uniform(0, 1) < g_explore_eps:
            leaf_state, parent_idx, _, no_collision, done = global_explore(
                search_tree, env
            )
            success = success or done
            expanded_by_rrt = True
        else:
            idx = select(search_tree, env, c=c, timer=timer)
            parent_idx = idx
            leaf_state, _, no_collision, done = expand(
                search_tree, parent_idx, model, env, c=c
            )
            success = success or done
            expanded_by_rrt = False

        insert_new_state(
            env,
            search_tree,
            leaf_state,
            model,
            parent_idx,
            no_collision,
            done,
            expanded_by_rrt=expanded_by_rrt,
        )
        RRTS_rewire_last(env, search_tree)

        if success and stop_when_success:
            break

    return search_tree, success, i


def RRT_steer(env, sample_state, nearest, dist):
    if dist < env.RRT_EPS:
        return sample_state
    return env.interpolate(nearest, sample_state, env.RRT_EPS / dist)


def global_explore(search_tree, env, sample_state=None):
    """One RRT expansion step (tsa.py:103-139)."""

    non_terminal_states = search_tree.non_terminal_states
    if sample_state is None:
        sample_state = env.uniform_sample()

    dists = env.distance(non_terminal_states, sample_state)
    nearest_idx, min_dist = int(np.argmin(dists)), float(np.min(dists))
    new_state = RRT_steer(env, sample_state, non_terminal_states[nearest_idx], min_dist)
    new_state, action, no_collision, done = env.step(
        state=non_terminal_states[nearest_idx], new_state=new_state
    )
    return (
        new_state,
        search_tree.non_terminal_idxes[nearest_idx],
        action,
        no_collision,
        done,
    )


def select(search_tree, env, c: float = 1.0, timer=None):
    """UCB argmax over non-terminal tree nodes, vectorised
    (reference tsa.py:141-165 loops per node; HEAP timer tag there)."""

    if timer is not None:
        timer.start()
    idxes = np.asarray(search_tree.non_terminal_idxes)
    Q = np.asarray(search_tree.state_values, dtype=float)[idxes]
    w = np.asarray(search_tree.w, dtype=float)[idxes]
    U = np.sqrt(np.log(search_tree.w_sum) / w)
    out = int(idxes[np.argmax(Q + c * U)])
    if timer is not None:
        timer.finish(timer.HEAP)
    return out


def expand(search_tree, idx, model, env, k: int = 10, c: float = 1.0):
    """Model-guided expansion: k candidate actions scored by value + UCB
    (reference tsa.py:168-220)."""

    state = np.array(search_tree.states[idx])
    candidate_actions = model.policy(state=state, k=k)[0]
    candidates = []
    for i in range(k):
        new_state, _ = env.step(
            state=state, action=np.asarray(candidate_actions[i]), check_collision=False
        )
        candidates.append(new_state)

    if k > 1:
        Qs = np.asarray(model.pred_value(np.array(candidates))).reshape(-1)
        ws = np.array(
            [compute_w(env, search_tree, state=cand) for cand in candidates]
        )
        scores = Qs + c * np.sqrt(np.log(search_tree.w_sum) / ws)
        new_state = candidates[int(np.argmax(scores))]
    else:
        new_state = candidates[0]

    new_state, action, no_collision, done = env.step(state=state, new_state=new_state)
    return new_state, action, no_collision, done


def RRTS_rewire_last(env, search_tree, neighbor_r=None, obs_cost: float = 2.0):
    """RRT* rewiring of the latest node (reference tsa.py:222-281)."""

    if neighbor_r is None:
        neighbor_r = env.RRT_EPS * 3
    cur_tree = search_tree.states[:-1]
    new_state = search_tree.states[-1]
    nearest = search_tree.parents[-1]
    freesp = search_tree.freesp

    if not search_tree.freesp[-1]:
        set_cost(search_tree, -1, obs_cost)
        update_collision_checks(search_tree, env.collision_check_count)
        return

    dists = env.distance(cur_tree, new_state)
    near = np.where(dists < neighbor_r)[0]

    min_cost = dists[nearest] + search_tree.costs[nearest]
    min_j = nearest
    for j in near:
        if not freesp[j]:
            continue
        cost_new = dists[j] + search_tree.costs[j]
        if cost_new < min_cost:
            _, _, no_collision, _ = env.step(state=cur_tree[j], new_state=new_state)
            if no_collision:
                min_cost, min_j = cost_new, j

    rewire_to(search_tree, -1, min_j)
    set_cost(search_tree, -1, min_cost)

    for j in near:
        cost_new = min_cost + dists[j]
        if cost_new < search_tree.costs[j]:
            _, _, no_collision, _ = env.step(state=cur_tree[j], new_state=new_state)
            if no_collision:
                set_cost(search_tree, j, cost_new)
                rewire_to(search_tree, j, len(search_tree.states) - 1)

    update_collision_checks(search_tree, env.collision_check_count)
