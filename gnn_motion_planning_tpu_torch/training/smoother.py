"""Smoother training: DAgger-style oracle-smoothed replay, MSE on interior
waypoints (port of gnn_motion_planning_tpu/training/smoother.py; reference
train_smoother.py:33-133).

Data collection runs the explorer (``explore(smooth=False)``, on an arm
env through its collision kernel), oracle-smooths the raw path with
``joint_smoother_ratio`` and fills a replay buffer; training batches replay
samples, runs the smoother with a random loop count and regresses the
interior waypoints to the oracle-smoothed ones with SGD, momentum and
decayed weights, and a reduce-on-plateau schedule.

As in the JAX package, BatchNorm uses its running statistics (eval mode)
and they are trained leaves: they take gradients, momentum and weight decay
like every other leaf (``training/optim.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.smoother import (  # noqa: F401 (JAX's surface)
    Smoother,
    init_smoother_params,
    smoother_forward,
)
from gnn_motion_planning_tpu_torch.training.optim import (
    apply_step, set_lr, sgd_decayed, trainable_leaves)


def smoother_mse(model: Smoother, batch, loop: int):
    """Mean over the batch of each sample's MSE over its interior waypoints
    (JAX training/smoother.py:54-71). ``batch``: path, path_mask,
    env_nodes, env_valid, n_free, base_src, base_dst, base_alive, target,
    each with a leading batch axis."""

    losses = []
    for path, path_mask, env_nodes, env_valid, n_free, bs, bd, ba, target in zip(*batch):
        pred = smoother_forward(model, path, path_mask, env_nodes, env_valid, int(n_free),
                                bs, bd, ba, loop=loop)
        n_path = path_mask.sum()
        idx = torch.arange(path.shape[0], device=path.device)
        interior = path_mask & (idx >= 1) & (idx <= n_path - 2)
        se = ((pred - target) ** 2).sum(dim=-1)
        losses.append(torch.where(interior, se, 0.0).sum()
                      / (torch.clamp_min(interior.sum(), 1) * path.shape[1]))
    return torch.stack(losses).mean()


def train_step(model: Smoother, optimizer, leaves, batch, loop: int) -> float:
    """One optimiser step on a batch -> its loss."""

    loss = smoother_mse(model, batch, loop)
    loss.backward()
    apply_step(optimizer, leaves)
    return float(loss.detach())


def build_sample(item, l_pad: int, d: int):
    """One replay item as padded arrays (JAX training/smoother.py:133-154):
    free samples truncated to 500, collided ones at offset 500."""

    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges

    _, path, path_smooth, free, collided = item
    L = len(path)
    path_arr = np.zeros((l_pad, d), np.float32)
    path_arr[:L] = np.asarray(path, np.float32)
    path_arr[L:] = path_arr[L - 1]
    target = np.array(path_arr)
    target[:L] = np.asarray(path_smooth, np.float32)
    mask = np.zeros(l_pad, bool)
    mask[:L] = True
    env_nodes = np.zeros((1000, d), np.float32)
    env_valid = np.zeros(1000, bool)
    fr = np.asarray(free, np.float32)[:500]
    co = np.asarray(collided, np.float32)[:500] if len(collided) else np.zeros((0, d), np.float32)
    env_nodes[: len(fr)] = fr
    env_valid[: len(fr)] = True
    env_nodes[500 : 500 + len(co)] = co
    env_valid[500 : 500 + len(co)] = True
    bs, bd, ba = base_chain_edges(l_pad, L)
    return path_arr, mask, env_nodes, env_valid, np.int64(len(fr)), bs, bd, ba, target


def collect_replay(epoch, model_explore, env, rng, data_iter: int) -> list:
    """The data passes (JAX training/smoother.py:102-123): each problem
    explored without smoothing, a path of more than two waypoints
    oracle-smoothed; from the second pass on, at a random start and goal."""

    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore
    from gnn_motion_planning_tpu_torch.planners.oracle_smoother import joint_smoother_ratio

    replay = []
    for iter_i in range(data_iter):
        indexes = rng.choice(np.arange(epoch), size=epoch, replace=False)
        for index in indexes:
            env.init_new_problem(int(index))
            if iter_i != 0:
                env.set_random_init_goal()
            try:
                result = explore(env, model_explore, None, smooth=False)
                if result == []:
                    continue
                path, free, collided = result
                if len(path) > 2:
                    path_smooth = joint_smoother_ratio([tuple(node) for node in path], env, iter=5)
                    replay.append((int(index), path, path_smooth, free, collided))
            except Exception:  # the JAX package's: a problem that fails is skipped
                continue
    return replay


def train_smoother(
    epoch,
    model_explore,
    model: Smoother,
    model_path,
    env,
    data_iter: int = 3,
    train_iter: int = 20,
    seed: int = 1234,
    batch_size: int = 8,
    log_dir: str | None = None,
    device=None,
    stats: dict | None = None,
):
    """Full smoother training loop (reference train_smoother.py:67-133).
    ``model`` is trained in place on ``device`` (None: CUDA, which must
    exist); the explorer runs on the env's device, from the trainer's own
    stream (``env.rng``). ``stats``, if given, receives the replay size.
    Returns (model, per-epoch mean losses)."""

    from gnn_motion_planning_tpu_torch.config import set_random_seed
    from gnn_motion_planning_tpu_torch.models.convert import save_npz
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import pad_to_bucket
    from gnn_motion_planning_tpu_torch.utils.metrics import ScalarLogger

    dev = resolve_device(device)
    rng = set_random_seed(seed)
    env.rng = rng
    model_explore.to(env.device)
    model.to(dev)
    leaves = trainable_leaves(model)

    replay = collect_replay(epoch, model_explore, env, rng, data_iter)
    if stats is not None:
        stats["replay"] = len(replay)
    if len(replay) <= batch_size:
        return model, []

    lr = 1e-3
    losses_out = []
    d = model.cfg.config_size
    optimizer = sgd_decayed(leaves, lr, momentum=0.9, weight_decay=1e-4)
    logger = ScalarLogger(log_dir) if log_dir else None

    prev_loss = np.inf
    for iter_i in range(train_iter):
        indexes = rng.choice(len(replay), size=len(replay), replace=False)
        losses = []
        for bstart in range(0, len(indexes) - batch_size + 1, batch_size):
            items = [replay[i] for i in indexes[bstart : bstart + batch_size]]
            l_pad = pad_to_bucket(max(len(it[1]) for it in items))
            batch = tuple(
                torch.as_tensor(np.stack(cols), device=dev)
                for cols in zip(*[build_sample(it, l_pad, d) for it in items])
            )
            loop = int(rng.randint(1, 10))
            losses.append(train_step(model, optimizer, leaves, batch, loop))
        mean_loss = float(np.mean(losses)) if losses else np.inf
        losses_out.append(mean_loss)
        if logger is not None:
            logger.add_scalar("train/loss", mean_loss, iter_i)
            logger.add_scalar("train/lr", lr, iter_i)
        # ReduceLROnPlateau(patience=0), written out as the JAX package does
        if mean_loss >= prev_loss:
            lr *= 0.1
            set_lr(optimizer, lr)
        prev_loss = min(prev_loss, mean_loss)
        save_npz(model, model_path)

    save_npz(model, model_path)
    return model, losses_out
