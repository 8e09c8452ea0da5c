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


@torch.no_grad()
def init_default_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """torch's default initialisation of every layer of ``module``, drawn
    from ``gen``: ``nn.Linear`` weight and bias U(+-1/sqrt(fan_in)),
    LayerNorm and BatchNorm at identity (BatchNorm's running statistics at
    mean 0, variance 1). The JAX package's ``_init_linear`` draws the same
    distribution (JAX models/explorer.py:29-44), not the same numbers."""

    for m in module.modules():
        if isinstance(m, nn.Linear):
            bound = 1.0 / m.in_features**0.5
            m.weight.uniform_(-bound, bound, generator=gen)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=gen)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            if isinstance(m, nn.BatchNorm1d):
                m.running_mean.fill_(0.0)
                m.running_var.fill_(1.0)
    return module


def seq2(n_in: int, n_hidden: int, n_out: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(n_in, n_hidden), nn.ReLU(), nn.Linear(n_hidden, n_out))
