"""Explorer training: oracle next-edge cross-entropy (port of
gnn_motion_planning_tpu/training/explorer.py).

The trainer rolls the current policy over a PRM graph to a random frontier
and supervises the next-edge choice with cross-entropy over the frontier
edges against a Dijkstra oracle (reference train_explorer.py:96-211, loss
at :172-177). A batch of such samples takes one Adam step; the loss is the
mean over the batch of each sample's loss (the JAX package's ``vmap``, one
sample at a time here). Gradients are autograd's over the forward's plain
tensor ops, as the JAX package's are ``jax.grad``'s over XLA's. The step
shards the batch over a ``dp`` mesh (``parallel/mesh.py``), averaging the
gradients, as the JAX package's one pjit program does.
"""

from __future__ import annotations

import functools
import pickle
from typing import NamedTuple

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig, explorer_forward
from gnn_motion_planning_tpu_torch.parallel.mesh import (
    Mesh,
    all_reduce_sum,
    data_sharding,
    make_mesh,
    replicated,
)
from gnn_motion_planning_tpu_torch.training.optim import adam, apply_step, trainable_leaves

_NEG = -1e9


class ExplorerBatch(NamedTuple):
    """One training example per leading-axis row (padded, static shapes)."""

    v: torch.Tensor  # (B, N, d)
    node_valid: torch.Tensor  # (B, N)
    goal: torch.Tensor  # (B, d)
    src: torch.Tensor  # (B, E) long
    dst: torch.Tensor  # (B, E)
    e_alive: torch.Tensor  # (B, E)
    obstacles: torch.Tensor  # (B, M, obs)
    obs_mask: torch.Tensor  # (B, M)
    frontier: torch.Tensor  # (B, N, N) bool: eligible frontier entries
    target: torch.Tensor  # (B,) long: flat index of the oracle edge
    loop: torch.Tensor  # (B,) the sample's loop count (unused by the loss)


def frontier_cross_entropy(model: Explorer, ex: ExplorerBatch, max_loop: int = 10):
    """-log softmax over the frontier entries at the oracle edge, the mean
    over the batch (JAX training/explorer.py:44-62)."""

    losses = []
    for i in range(ex.v.shape[0]):
        policy = explorer_forward(
            model, ex.v[i], ex.node_valid[i], ex.goal[i], ex.src[i], ex.dst[i], ex.e_alive[i],
            ex.obstacles[i], ex.obs_mask[i], loop=max_loop,
        )
        logits = torch.where(ex.frontier[i], policy, _NEG).reshape(-1)
        losses.append(-(logits[ex.target[i]] - torch.logsumexp(logits, dim=0)))
    return torch.stack(losses).mean()


def train_step(model: Explorer, optimizer, leaves, ex: ExplorerBatch, loop: int,
               mesh: Mesh | None = None) -> float:
    """One optimiser step on a batch -> its loss. Across ``mesh`` (JAX
    ``make_train_step``'s ``dp`` axis) each shard takes its rows on its own
    device, through a replica of the model there, and the gradients are
    summed over the shards and the processes and averaged (the all-reduce):
    with equal shards the loss and the update are the whole batch's.
    Without a mesh the batch is one shard on the model's device."""

    dev = leaves[0].device
    shards = [(dev, ex)] if mesh is None else data_sharding(mesh)(ex)
    replicas = [model] if mesh is None else replicated(mesh)(model)
    n_shards = 1 if mesh is None else mesh.size
    grads = [torch.zeros_like(t) for t in leaves]
    total = torch.zeros((), dtype=torch.float32, device=dev)
    for (_, part), replica in zip(shards, replicas):
        own = leaves if replica is model else trainable_leaves(replica)
        loss = frontier_cross_entropy(replica, part, loop)
        for acc, g in zip(grads, torch.autograd.grad(loss, own, allow_unused=True)):
            if g is not None:
                acc += g.to(dev)
        total += loss.detach().to(dev)
    if mesh is not None:
        all_reduce_sum(grads + [total], mesh)
    for t, g in zip(leaves, grads):
        t.grad = g / n_shards
    apply_step(optimizer, leaves)
    return float(total / n_shards)


def make_train_step(cfg: ExplorerConfig, optimizer=None, mesh: Mesh | None = None,
                    loop: int = 10):
    """The data-parallel train step (JAX training/explorer.py:65-98) ->
    ``(step, optimizer, mesh)``: ``step(model, opt_state, ex) -> loss``
    takes one :func:`train_step` over ``mesh`` (default: every card of this
    process, :func:`~gnn_motion_planning_tpu_torch.parallel.mesh.make_mesh`)
    at ``loop`` passes; ``model`` has config ``cfg`` and is updated in place,
    ``opt_state`` is ``optimizer(trainable_leaves(model))``, the torch
    optimiser over its leaves (``optimizer`` defaults to optax's
    ``adam(1e-3, eps=1e-8)``, ``training/optim.py::adam``)."""

    if optimizer is None:
        optimizer = functools.partial(adam, lr=1e-3, eps=1e-8)
    if mesh is None:
        mesh = make_mesh()

    def step(model: Explorer, opt_state, ex: ExplorerBatch) -> float:
        if model.cfg != cfg:
            raise ValueError(f"the step was made for {cfg}, the model has {model.cfg}")
        leaves = [t for group in opt_state.param_groups for t in group["params"]]
        return train_step(model, opt_state, leaves, ex, loop, mesh)

    return step, optimizer, mesh


# ---------------------------------------------------------------------------
# Full trainer (reference train_explorer.py:96-211)
# ---------------------------------------------------------------------------


def _pad_bucket(n, step=64):
    return max(step, ((n + step - 1) // step) * step)


def host_rollout(edge_cost_arr, policy, start, end, step):
    """Roll the current policy over the PRM cost matrix to a frontier
    (reference train_explorer.py:42-63). Mutates a copy of `policy`."""

    policy = np.array(policy)
    np.fill_diagonal(policy, 0.0)
    policy[end, end] = 1.0
    explored = [start]
    step_i = 0
    for step_i in range(step):
        rows = policy[explored, :]
        nz = np.nonzero(rows)
        if len(nz[0]) == 0:
            break
        k = np.argmax(rows[nz])
        end_a, end_b = explored[nz[0][k]], int(nz[1][k])
        if edge_cost_arr[end_a, end_b] != np.inf:
            explored.append(end_b)
            policy[:, end_b] = 0.0
            if end_b == end:
                return step_i, explored, policy
        else:
            policy[end_a, end_b] = 0.0
            policy[end_b, end_a] = 0.0
    return step_i, explored, policy


def host_policy_data(edge_cost_arr, dist, prev, policy, start, end, step):
    """Oracle next-edge target at a rollout frontier
    (reference train_explorer.py:66-93)."""

    _, explored, policy = host_rollout(edge_cost_arr, policy, start, end, step)
    next_node = explored[int(np.argmin([dist[e] for e in explored]))]
    policy[end, end] = 1.0
    rows = policy[explored, :]
    nz = np.nonzero(rows)
    frontier_rows = np.array(explored)[nz[0]]
    frontier_cols = nz[1]
    next_edge = (next_node, int(prev[next_node]))
    d = np.linalg.norm(
        np.stack([frontier_rows, frontier_cols]).astype(float)
        - np.array(next_edge, float)[:, None],
        axis=0,
    )
    next_edge_idx = int(np.argmin(d))
    return next_edge, next_edge_idx, (frontier_rows, frontier_cols)


def load_graphs(data_path):
    """The PRM graphs of a config (an asset path, or an absolute path)."""

    from gnn_motion_planning_tpu_torch.utils.assets import asset_path

    path = data_path if str(data_path).startswith("/") else asset_path(data_path)
    with open(path, "rb") as f:
        return pickle.load(f)


def _stack(samples, dev) -> ExplorerBatch:
    t = lambda a, dtype=None: torch.as_tensor(np.stack(a), dtype=dtype, device=dev)  # noqa: E731
    col = lambda k: [s[k] for s in samples]  # noqa: E731
    return ExplorerBatch(
        v=t(col("v")), node_valid=t(col("node_valid")), goal=t(col("goal")),
        src=t(col("src"), torch.int64), dst=t(col("dst"), torch.int64),
        e_alive=t(col("e_alive")), obstacles=t(col("obstacles")), obs_mask=t(col("obs_mask")),
        frontier=t(col("frontier")), target=t(col("target"), torch.int64),
        loop=t(col("loop"), torch.int64),
    )


def train_explorer(
    epoch,
    data_path,
    model: Explorer,
    model_path,
    env,
    use_obstacle: bool = True,
    iter: int = 20,
    loop: int = 10,
    batch_size: int = 8,
    seed: int = 1234,
    log_every: int = 10,
    log_dir: str | None = None,
    device=None,
):
    """DAgger-style explorer training (reference train_explorer.py:96-211),
    the JAX package's loop: one global pad over ``graphs[:epoch]``, the
    rollout forward at an even ``cur_loop``, a step at the rounded mean loop
    of each ``batch_size`` samples. ``model`` is trained in place on
    ``device`` (None: CUDA, which must exist); ``str2name(load=False)``
    gives a freshly initialised one. Returns (model, losses)."""

    from gnn_motion_planning_tpu_torch.config import set_random_seed
    from gnn_motion_planning_tpu_torch.models.convert import save_npz
    from gnn_motion_planning_tpu_torch.planners.dijkstra import dijkstra_dense
    from gnn_motion_planning_tpu_torch.utils.metrics import ScalarLogger

    dev = resolve_device(device)
    rng = set_random_seed(seed)
    env.rng = rng
    model.cfg = model.cfg._replace(use_obstacles=use_obstacle)
    model.to(dev)
    leaves = trainable_leaves(model)
    optimizer = adam(leaves, 1e-3, eps=1e-8)

    # the mesh size must divide the batch: the largest power-of-two divisor
    # of batch_size that this process's cards can provide (JAX :209-222)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh_n = 1
    while mesh_n * 2 <= min(n_dev, batch_size) and batch_size % (mesh_n * 2) == 0:
        mesh_n *= 2
    mesh = make_mesh(mesh_n, device=dev if dev.type == "cpu" else None)
    steps = {}

    def get_step(cur_loop):
        if cur_loop not in steps:
            steps[cur_loop] = make_train_step(model.cfg, mesh=mesh, loop=cur_loop)[0]
        return steps[cur_loop]

    graphs = load_graphs(data_path)
    epoch = min(epoch, len(graphs))

    # one global padded shape (the JAX package compiles a program a shape)
    global_n_pad = _pad_bucket(max(len(g[0]) for g in graphs[:epoch]))
    global_e_pad = _pad_bucket(max(len(g[3]) for g in graphs[:epoch]), 512)

    logger = ScalarLogger(log_dir) if log_dir else None
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    batch_buf = []
    losses = []
    T = 0

    for _ in range(iter):
        indexes = rng.choice(np.arange(epoch), size=epoch, replace=False)
        for index in indexes:
            env.init_new_problem(int(index))
            obstacles, obs_mask = env.obs_tokens()
            points, neighbors, edge_cost, edge_index, edge_free = graphs[index]
            points = np.asarray(points, np.float32)
            n = len(points)
            goal_index = int(rng.choice(n))

            costs_flat = []
            for d_node in range(n):
                costs_flat.extend(
                    (s, d_node, c)
                    for s, c in zip(neighbors[d_node], edge_cost[d_node])
                )
            ei = np.array([(s, d) for s, d, _ in costs_flat], np.int64)
            ec = np.array([c for _, _, c in costs_flat])
            # the reference's edges_dict[u] lists u's in-neighbours, so the
            # traversal follows the reversed adjacency
            dist, prev = dijkstra_dense(n, ei[:, [1, 0]], ec, goal_index)
            valid_node = np.isfinite(dist)
            if valid_node.sum() <= 1:
                continue

            n_pad = global_n_pad
            e_pad = global_e_pad
            v = np.zeros((n_pad, points.shape[1]), np.float32)
            v[:n] = points
            node_valid = np.zeros(n_pad, bool)
            node_valid[:n] = True
            src = np.zeros(e_pad, np.int64)
            dst = np.zeros(e_pad, np.int64)
            e_alive = np.zeros(e_pad, bool)
            src[: len(ei)] = edge_index[:, 0]
            dst[: len(ei)] = edge_index[:, 1]
            e_alive[: len(ei)] = True

            cur_loop = int(rng.randint(1, loop))
            cur_loop = max(1, 2 * (cur_loop // 2))  # even, as the JAX package's
            with torch.no_grad():
                policy = explorer_forward(
                    model, t(v), t(node_valid), t(points[goal_index]), t(src), t(dst),
                    t(e_alive), t(obstacles), t(obs_mask), loop=cur_loop,
                ).cpu().numpy()[:n, :n]

            cost_arr = np.full((n, n), np.inf)
            for x in neighbors:
                for y, c in zip(neighbors[x], edge_cost[x]):
                    cost_arr[x, y] = c

            start_index = int(rng.choice(np.arange(n)[valid_node]))
            try:
                step_n, _, _ = host_rollout(cost_arr, policy, start_index, goal_index, 1000)
                next_edge, next_edge_idx, frontier = host_policy_data(
                    cost_arr, dist, prev, policy, start_index, goal_index,
                    int(rng.randint(0, step_n + 1)),
                )
            except Exception:  # the JAX package's: a sample the oracle cannot label
                continue

            frontier_mask = np.zeros((n_pad, n_pad), bool)
            frontier_mask[frontier[0], frontier[1]] = True
            target_flat = int(frontier[0][next_edge_idx]) * n_pad + int(
                frontier[1][next_edge_idx]
            )

            batch_buf.append(dict(
                v=v, node_valid=node_valid, goal=points[goal_index], src=src, dst=dst,
                e_alive=e_alive, obstacles=obstacles, obs_mask=obs_mask,
                frontier=frontier_mask, target=target_flat, loop=cur_loop,
                shape=(n_pad, e_pad),
            ))

            # flush a batch of same-shaped samples
            shapes = [s["shape"] for s in batch_buf]
            same = [s for s in batch_buf if s["shape"] == shapes[-1]]
            if len(same) >= batch_size:
                batch_buf = [s for s in batch_buf if s["shape"] != shapes[-1]]
                cur = int(np.round(np.mean([s["loop"] for s in same])))
                losses.append(get_step(max(cur, 1))(model, optimizer, _stack(same, dev)))
                T += 1
                if logger is not None:
                    # reference tag: train_explorer.py:191 add_scalar('train/loss')
                    logger.add_scalar("train/loss", losses[-1], T)
                if T % log_every == 0:
                    print(f"step {T}: policy loss {np.mean(losses[-log_every:]):.3f}", flush=True)
                    save_npz(model, model_path)

    save_npz(model, model_path)
    return model, losses
