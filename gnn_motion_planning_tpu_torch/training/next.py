"""NEXT training: iterative imitation with epsilon-decayed exploration (port
of gnn_motion_planning_tpu/training/next.py; reference train_next.py:42-120).

Each problem is planned with the current model (``g_explore_eps`` decaying
0.7x every ``train_every`` problems); a successful path, or else BIT*'s
solution, enters the replay; every ``train_every`` problems the net
regresses per-waypoint clipped actions and costs-to-go over the replay
(MSE, one Adam step a path). The planner reads the module's live weights,
so each problem is planned with the weights trained so far.
"""

from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.next_model import (
    NextNet, init_next_from_scratch, pb_forward, state_forward)
from gnn_motion_planning_tpu_torch.training.optim import adam, apply_step, trainable_leaves

L_PAD = 64  # a path of more waypoints is skipped


def get_label(path, env):
    """(actions, costs-to-go) along a demo path (train_next.py:25-39)."""

    path = np.array(path)
    path_cost = [0.0]
    action = []
    for prev, nxt in zip(path[:-1], path[1:]):
        edge_cost = np.linalg.norm(nxt - prev)
        path_cost.append(path_cost[-1] + edge_cost)
        if edge_cost > env.RRT_EPS:
            action.append(env.interpolate(prev, nxt, env.RRT_EPS / edge_cost) - prev)
        else:
            action.append(nxt - prev)
    action.append(path[-1] * 0.0)
    total = path_cost[-1]
    path_cost = [c - total for c in path_cost]
    return np.asarray(action, np.float32), np.asarray(path_cost, np.float32)


def make_next_loss():
    """The loss of one padded path (JAX training/next.py:43-58): the masked
    MSE of the action head plus that of the value head."""

    def loss_fn(net: NextNet, states, maze_map, goal_state, actions, values, mask):
        pb = pb_forward(net, goal_state, maze_map)
        y = state_forward(net, states, pb)
        pred_a = y[:, :-1]
        pred_v = y[:, -1]
        m = mask.to(torch.float32)
        action_loss = (m[:, None] * (pred_a[:, : actions.shape[1]] - actions) ** 2).sum() / (
            torch.clamp_min(m.sum() * actions.shape[1], 1.0))
        value_loss = (m * (pred_v - values) ** 2).sum() / torch.clamp_min(m.sum(), 1.0)
        return action_loss + value_loss

    return loss_fn


def train_step(loss_fn, net: NextNet, optimizer, leaves, batch) -> float:
    """One optimiser step on one padded path -> its loss."""

    loss = loss_fn(net, *batch)
    loss.backward()
    apply_step(optimizer, leaves)
    return float(loss.detach())


def label_batch(model, env, pb, path, dev):
    """The padded (states, map, goal, actions, values, mask) of a demo path,
    or None for a path longer than ``L_PAD`` (JAX training/next.py:152-183)."""

    cfg = model.cfg
    maze_map = np.asarray(pb["map"], np.float32).reshape((1,) + (cfg.env_width,) * cfg.nd)
    goal = model._normalize(model._augment(np.asarray(pb["goal_state"], np.float32).reshape(1, -1)))
    actions, values = get_label(path, env)
    states = model._normalize(model._augment(np.asarray(path, np.float32)))
    n = len(path)
    if n > L_PAD:
        return None
    s_pad = np.zeros((L_PAD, states.shape[1]), np.float32)
    s_pad[:n] = states
    a_pad = np.zeros((L_PAD, actions.shape[1]), np.float32)
    a_pad[:n] = actions
    v_pad = np.zeros(L_PAD, np.float32)
    v_pad[:n] = values
    mask = np.zeros(L_PAD, bool)
    mask[:n] = True
    return tuple(torch.as_tensor(np.asarray(a, dtype), device=dev) for a, dtype in (
        (s_pad, np.float32), (maze_map, np.float32), (goal, np.float32), (a_pad, np.float32),
        (v_pad, np.float32), (mask, bool)))


def train_next(str_name, T: int = 1000, n_problems: int = 2000, seed: int = 1234,
               model_path=None, train_every: int = 200, log_dir=None,
               from_scratch: bool = False, device=None, stats: dict | None = None):
    """Full NEXT training loop (reference train_next.py:71-120) on
    ``device`` (None: CUDA, which must exist). ``from_scratch``
    re-initialises the net (He normal weights, zero biases) instead of
    fine-tuning the shipped checkpoint. ``stats``, if given, receives the
    replay size and the number of BIT* fallbacks. Returns (model, losses)."""

    from gnn_motion_planning_tpu_torch.api.eval_baselines import str2next
    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.config import set_random_seed
    from gnn_motion_planning_tpu_torch.models.convert import save_npz
    from gnn_motion_planning_tpu_torch.planners.bit_star import BITStar
    from gnn_motion_planning_tpu_torch.planners.tsa import NEXT_plan
    from gnn_motion_planning_tpu_torch.utils.metrics import ScalarLogger

    dev = resolve_device(device)
    rng = set_random_seed(seed)
    env, _ = str2env(str_name, dev)
    env.rng = rng
    model, _ = str2next(str_name, env)
    if model_path is None:
        model_path = str(Path(tempfile.gettempdir()) / f"next_{str_name}.npz")
    net = model.net
    if from_scratch:
        init_next_from_scratch(net, seed)
    leaves = trainable_leaves(net)
    optimizer = adam(leaves, 1e-3)
    loss_fn = make_next_loss()
    logger = ScalarLogger(log_dir) if log_dir else None

    replay = []
    n_fallback = 0
    explore_eps = 1.0
    losses = []

    for i in range(n_problems):
        pb = env.init_new_problem(i)
        model.set_problem(pb)

        tree, success, _ = NEXT_plan(
            env=env, model=model, T=T, g_explore_eps=explore_eps,
            stop_when_success=True, UCB_type="kde",
        )
        if success:
            replay.append((i, tree.path()[0]))
        else:
            bit = BITStar(env, T=float("inf"), batch_size=50)
            g_score = bit.plan(float("inf"), time_budget=60, refine_time_budget=0)[-3]
            if g_score != float("inf"):
                replay.append((i, bit.get_best_path()))
                n_fallback += 1

        if i % train_every == train_every - 1 and replay:
            explore_eps *= 0.7
            indexes = rng.choice(len(replay), size=len(replay), replace=False)
            for idx in indexes:
                pi, path = replay[idx]
                pb = env.init_new_problem(int(pi))
                batch = label_batch(model, env, pb, path, dev)
                if batch is None:
                    continue
                losses.append(train_step(loss_fn, net, optimizer, leaves, batch))
                if logger is not None:
                    logger.add_scalar("train/loss", losses[-1], len(losses))
            save_npz(net, model_path)

    save_npz(net, model_path)
    if stats is not None:
        stats.update(replay=len(replay), fallback=n_fallback)
    return model, losses
