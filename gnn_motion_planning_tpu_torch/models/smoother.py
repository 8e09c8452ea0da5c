"""Smoother GNN: iterative path refinement over a re-wired graph (port of
gnn_motion_planning_tpu/models/smoother.py).

Per loop iteration it links each path waypoint to its 10 nearest
environment samples (stable argsort, as ``jnp.argsort``), runs one
add-aggregation residual MPNN pass over [path | free | collided] nodes with
a 3-bit type one-hot, and rewrites the interior waypoints.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gnn_motion_planning_tpu_torch.graphs.knn import dedup_edges
from gnn_motion_planning_tpu_torch.models.mlp import batch_norm_eval, linear, mlp2, seq2
from gnn_motion_planning_tpu_torch.ops.segment import masked_segment_sum


class SmootherConfig(NamedTuple):
    workspace_size: int
    config_size: int
    obs_size: int
    embed_size: int
    scale: float = 1.0


class _Process(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.lin_0 = seq2(e * 3, e, e)
        self.lin_1 = seq2(e, e, e)


class Smoother(nn.Module):
    """Parameters of the smoother, named as in the shipped state dicts."""

    def __init__(self, cfg: SmootherConfig):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.embed_size, cfg.config_size
        self.node_code = nn.Sequential(
            nn.Linear(d + 3, e), nn.BatchNorm1d(e), nn.ReLU(), nn.Linear(e, e)
        )
        self.process = _Process(e)
        self.smooth_node = nn.Linear(e, d)


def _node_code(m: nn.Sequential, x):
    """Seq(Lin, BatchNorm1d(eval), ReLU, Lin)."""

    h = batch_norm_eval(m[1], linear(m[0], x))
    return linear(m[3], torch.relu(h))


def _mpnn_add(p: _Process, x, src, dst, e_alive):
    """Residual add-aggregation MPNN."""

    x_j = x[src]
    x_i = x[dst]
    msg = mlp2(p.lin_0, torch.cat([x_j - x_i, x_j, x_i], dim=-1))
    agg = masked_segment_sum(msg, dst, e_alive, x.shape[0])
    return x + mlp2(p.lin_1, agg)


@torch.no_grad()
def smoother_forward(
    model: Smoother,
    path: torch.Tensor,  # (L, d) padded waypoints
    path_mask: torch.Tensor,  # (L,) bool, prefix-true
    env_nodes: torch.Tensor,  # (S, d) padded [free | collided] samples
    env_valid: torch.Tensor,  # (S,) bool
    n_free: int,  # live free count within the env_nodes prefix
    base_src: torch.Tensor,  # (Eb,) chain + self-loop edges over path indices
    base_dst: torch.Tensor,
    base_alive: torch.Tensor,
    loop: int,
    knn_k: int = 10,
) -> torch.Tensor:
    """New path of the same shape (interior waypoints rewritten)."""

    cfg = model.cfg
    L = path.shape[0]
    S = env_nodes.shape[0]
    dev = path.device
    path = path / cfg.scale
    env = env_nodes / cfg.scale

    n_path = path_mask.sum()
    idx = torch.arange(L, device=dev)
    interior = path_mask & (idx >= 1) & (idx <= n_path - 2)

    env_idx = torch.arange(S, device=dev)
    is_free = env_valid & (env_idx < n_free)
    is_coll = env_valid & ~(env_idx < n_free)
    info_env = torch.stack(
        [torch.zeros(S, device=dev), is_free.to(path.dtype), is_coll.to(path.dtype)], dim=-1
    )
    info_path = torch.cat(
        [torch.ones((L, 1), dtype=path.dtype, device=dev), torch.zeros((L, 2), dtype=path.dtype, device=dev)],
        dim=-1,
    )
    info = torch.cat([info_path, info_env], dim=0)
    knn_dst = torch.arange(L, device=dev)[:, None].expand(L, knn_k).reshape(-1)

    for _ in range(loop):
        # each path waypoint -> its k nearest env samples, edges env -> path
        d = ((path[:, None, :] - env[None, :, :]) ** 2).sum(dim=-1)
        d = torch.where(env_valid[None, :], d, float("inf"))
        nn_d, nn_idx = torch.sort(d, dim=-1, stable=True)
        nn_idx, nn_d = nn_idx[:, :knn_k], nn_d[:, :knn_k]
        nn_alive = torch.isfinite(nn_d) & path_mask[:, None]

        src = torch.cat([base_src, (nn_idx + L).reshape(-1)])
        dst = torch.cat([base_dst, knn_dst])
        alive = torch.cat([base_alive, nn_alive.reshape(-1)])
        edges = dedup_edges(src, dst, alive, L + S)

        nodes = torch.cat([path, env], dim=0)
        x = _node_code(model.node_code, torch.cat([nodes, info], dim=-1))
        h = _mpnn_add(model.process, x, edges.src, edges.dst, edges.alive)

        proposal = linear(model.smooth_node, h[:L])
        path = torch.where(interior[:, None], proposal, path)

    return path * cfg.scale
