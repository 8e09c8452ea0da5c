"""The trainers' parameter leaves and optimiser steps, as optax's.

The JAX package trains a parameter tree with ``jax.value_and_grad`` and
optax. Two differences of torch's optimisers matter here:

- BatchNorm's running statistics are leaves of the JAX tree
  (``node_code.1.running_mean``, ``running_var``), so JAX trains and decays
  them; in torch they are buffers. :func:`trainable_leaves` hands them to
  the optimiser as leaves that autograd writes a gradient to.
- torch skips a leaf whose ``.grad`` is None, while optax updates every
  leaf (a zero gradient still decays the weight and advances Adam's
  moments). :func:`apply_step` gives such a leaf a zero gradient first.
"""

from __future__ import annotations

import torch
from torch import nn


def trainable_leaves(module: nn.Module) -> list:
    """Every float the JAX package's parameter tree holds, in state-dict
    order: the parameters and the floating buffers (BatchNorm's running
    statistics), each set to require a gradient. Call it after the module
    reached its device (``.to`` replaces buffers)."""

    leaves = []
    for t in module.state_dict(keep_vars=True).values():
        if t.is_floating_point():
            leaves.append(t.requires_grad_(True))
    return leaves


def adam(leaves, lr: float = 1e-3, eps: float = 1e-8) -> torch.optim.Optimizer:
    """``optax.adam(lr, eps=eps)``: b1 0.9, b2 0.999, the same update."""

    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=eps)


def sgd_decayed(leaves, lr: float = 1e-3, momentum: float = 0.9,
                weight_decay: float = 1e-4) -> torch.optim.Optimizer:
    """``optax.chain(add_decayed_weights(wd), sgd(lr, momentum))``: the
    decayed gradient g + wd * p into a momentum trace, p -= lr * trace."""

    return torch.optim.SGD(leaves, lr=lr, momentum=momentum, weight_decay=weight_decay)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """``opt_state.hyperparams["learning_rate"] = lr``."""

    for group in optimizer.param_groups:
        group["lr"] = lr


def apply_step(optimizer: torch.optim.Optimizer, leaves) -> None:
    """One update of every leaf from the gradients ``backward`` left, then
    the gradients cleared to zero."""

    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    optimizer.step()
    optimizer.zero_grad(set_to_none=False)
