"""Explorer GNN: encoder-process-decoder over the RGG (port of
gnn_motion_planning_tpu/models/explorer.py).

Obstacle cross-attention on node/edge free-codes, a goal-seeded latent,
``loop`` weight-tied max-aggregation MPNN passes, and a per-directed-edge
policy score scattered into a dense (N, N) matrix at ``[dst, src]`` (the
reference's orientation quirk), dead edges dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from gnn_motion_planning_tpu_torch.models.mlp import layer_norm, linear, mlp2, mlp3, seq2
from gnn_motion_planning_tpu_torch.ops.segment import masked_segment_max

_NEG = -1e9


class ExplorerConfig(NamedTuple):
    workspace_size: int
    config_size: int
    embed_size: int
    obs_size: int
    use_obstacles: bool = True


class _Attention(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.key = nn.Linear(e, e, bias=False)
        self.query = nn.Linear(e, e, bias=False)
        self.value = nn.Linear(e, e, bias=False)
        self.layer_norm = nn.LayerNorm(e)


class _FeedForward(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.w_1 = nn.Linear(e, e)
        self.w_2 = nn.Linear(e, e)
        self.layer_norm = nn.LayerNorm(e)


class _Block(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.attention = _Attention(e)
        self.map_feed = _FeedForward(e)
        self.obs_feed = _FeedForward(e)


class _Process(nn.Module):
    def __init__(self, e):
        super().__init__()
        self.lin_0 = seq2(e * 5, e, e)
        self.lin_1 = nn.Linear(e * 2, e)


class Explorer(nn.Module):
    """Parameters of the explorer, named as in the shipped state dicts."""

    def __init__(self, cfg: ExplorerConfig):
        super().__init__()
        self.cfg = cfg
        e, d = cfg.embed_size, cfg.config_size
        self.node_code = seq2(d * 4, e, e)
        self.edge_code = seq2(d * 2, e, e)
        self.obs_node_code = seq2(cfg.obs_size, e, e)
        self.obs_edge_code = seq2(cfg.obs_size, e, e)
        self.node_free_code = seq2(d, e, e)
        self.edge_free_code = seq2(d * 2, e, e)
        self.goal_encoder = nn.Parameter(torch.zeros(e))
        self.node_attentions = nn.ModuleList([_Block(e) for _ in range(3)])
        self.edge_attentions = nn.ModuleList([_Block(e) for _ in range(3)])
        self.encoder = nn.Linear(e * 4, e)
        self.decoder = nn.Linear(e * 2, e)
        self.process = _Process(e)
        self.policy = nn.Sequential(
            nn.Linear(e * 3, e), nn.ReLU(), nn.Linear(e, e), nn.ReLU(),
            nn.Linear(e, 1, bias=False),
        )


def _attention(p: _Attention, map_code, obs_code, obs_mask, temperature):
    """Cross-attention of map tokens over obstacle tokens + a self token,
    padding masked out of the softmax."""

    map_value = linear(p.value, map_code)
    obs_value = linear(p.value, obs_code)
    map_query = linear(p.query, map_code)
    map_key = linear(p.key, map_code)
    obs_key = linear(p.key, obs_code)

    obs_att = torch.matmul(map_query, obs_key.T)  # (N, M)
    self_att = (map_query * map_key).sum(dim=-1)  # (N,)
    logits = torch.cat([self_att[:, None], obs_att], dim=-1) / temperature
    mask = torch.cat(
        [
            torch.ones((map_code.shape[0], 1), dtype=torch.bool, device=map_code.device),
            obs_mask[None, :].expand_as(obs_att),
        ],
        dim=-1,
    )
    logits = torch.where(mask, logits, _NEG)
    attn = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    attn = attn * mask
    attn = attn / attn.sum(dim=-1, keepdim=True)
    new = attn[:, :1] * map_value + torch.matmul(attn[:, 1:], obs_value)
    return layer_norm(p.layer_norm, new + map_code, eps=1e-6)


def _feed_forward(p: _FeedForward, x):
    h = torch.relu(linear(p.w_1, x))
    return layer_norm(p.layer_norm, linear(p.w_2, h) + x, eps=1e-6)


def _block(p: _Block, map_code, obs_code, obs_mask, embed_size):
    map_code = _attention(p.attention, map_code, obs_code, obs_mask, embed_size**0.5)
    map_code = _feed_forward(p.map_feed, map_code)
    obs_code = _feed_forward(p.obs_feed, obs_code)
    return map_code, obs_code


def _mpnn_max(p: _Process, x, src, dst, e_alive, edge_attr):
    """Max-aggregation MPNN: messages flow src -> dst;
    out = lin_1([x, max-aggr(msg)])."""

    x_j = x[src]
    x_i = x[dst]
    msg = mlp2(p.lin_0, torch.cat([x_j - x_i, x_j, x_i, edge_attr], dim=-1))
    agg = masked_segment_max(msg, dst, e_alive, x.shape[0])
    return linear(p.lin_1, torch.cat([x, agg], dim=-1))


@torch.no_grad()
def explorer_forward(
    model: Explorer,
    v: torch.Tensor,  # (N, d) padded node configs
    node_valid: torch.Tensor,  # (N,) bool
    goal: torch.Tensor,  # (d,)
    src: torch.Tensor,  # (E,) long
    dst: torch.Tensor,  # (E,)
    e_alive: torch.Tensor,  # (E,) bool
    obstacles: torch.Tensor,  # (M, obs_size) padded
    obs_mask: torch.Tensor,  # (M,) bool
    loop: int,
) -> torch.Tensor:
    """Dense (N, N) directed edge-score matrix."""

    cfg = model.cfg
    goal = goal.reshape(-1)
    gdiff = v - goal[None, :]
    node_code = mlp2(
        model.node_code,
        torch.cat([v, goal[None, :].expand_as(v), gdiff**2, gdiff], dim=-1),
    )
    ecat = torch.cat([v[src], v[dst]], dim=-1)
    edge_code = mlp2(model.edge_code, ecat)
    node_free_code = mlp2(model.node_free_code, v)
    edge_free_code = mlp2(model.edge_free_code, ecat)

    if cfg.use_obstacles:
        obs = obstacles.reshape(-1, cfg.obs_size)
        obs_node_code = mlp2(model.obs_node_code, obs)
        obs_edge_code = mlp2(model.obs_edge_code, obs)
        for i in range(3):
            node_free_code, obs_node_code = _block(
                model.node_attentions[i], node_free_code, obs_node_code, obs_mask,
                cfg.embed_size,
            )
            edge_free_code, obs_edge_code = _block(
                model.edge_attentions[i], edge_free_code, obs_edge_code, obs_mask,
                cfg.embed_size,
            )

    # goal node = nearest valid node to the goal config (node 1 of the
    # free block, at distance 0)
    gd = ((v - goal[None, :]) ** 2).sum(dim=-1)
    goal_index = torch.where(node_valid, gd, float("inf")).argmin().reshape(1)
    h_0 = torch.zeros((v.shape[0], cfg.embed_size), dtype=v.dtype, device=v.device)
    h_0 = h_0.index_add(0, goal_index, model.goal_encoder[None, :])
    h_i = h_0

    edge_attr = torch.cat([edge_free_code, edge_code], dim=-1)
    decode = torch.zeros_like(h_0)
    for _ in range(loop):
        encode = linear(
            model.encoder, torch.cat([node_code, node_free_code, h_0, h_i], dim=-1)
        )
        h_i = _mpnn_max(model.process, encode, src, dst, e_alive, edge_attr)
        decode = linear(model.decoder, torch.cat([node_code, h_i], dim=-1))

    score = mlp3(
        model.policy,
        torch.cat([decode[src], decode[src] - decode[dst], edge_free_code], dim=-1),
    ).squeeze(-1)

    n = v.shape[0]
    policy = torch.zeros((n + 1, n), dtype=v.dtype, device=v.device)
    row = torch.where(e_alive, dst, n)  # dead edges land in the dropped row
    policy.index_put_((row, src), score)
    return policy[:n]
