"""Functional NN primitives written out as the JAX package writes them
(port of gnn_motion_planning_tpu/models/mlp.py).

Modules hold the parameters (``nn.Linear``, ``nn.LayerNorm``,
``nn.BatchNorm1d``, so checkpoints load by their state-dict names); these
functions apply them with the JAX package's arithmetic: matmul then bias,
and layer/batch norm from their definitions with the same epsilons.
"""

from __future__ import annotations

import torch
from torch import nn


def linear(m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """torch nn.Linear: weight (out, in), optional bias."""

    y = torch.matmul(x, m.weight.T)
    if m.bias is not None:
        y = y + m.bias
    return y


def mlp2(m: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Seq(Lin, ReLU, Lin) with keys '0', '2'."""

    return linear(m[2], torch.relu(linear(m[0], x)))


def mlp3(m: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """Seq(Lin, ReLU, Lin, ReLU, Lin) with keys '0', '2', '4'."""

    h = torch.relu(linear(m[0], x))
    h = torch.relu(linear(m[2], h))
    return linear(m[4], h)


def layer_norm(m: nn.LayerNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis (biased variance)."""

    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * m.weight + m.bias


def batch_norm_eval(m: nn.BatchNorm1d, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm1d in eval mode (running statistics)."""

    return (x - m.running_mean) / torch.sqrt(m.running_var + eps) * m.weight + m.bias


def seq2(n_in: int, n_hidden: int, n_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(n_in, n_hidden), nn.ReLU(), nn.Linear(n_hidden, n_out))
