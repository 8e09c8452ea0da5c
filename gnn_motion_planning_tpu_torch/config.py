"""Typed configuration, seeding and the host RNG stream (port of
gnn_motion_planning_tpu/config.py).

Host sampling stays on numpy's legacy MT19937 ``RandomState`` and consumes
it in the same call order as the JAX package, so for a given seed the
rejection-sampled node set is the same stream on both sides.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom

import numpy as np


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference config.py:19-27)."""

    batch_size: int = 8
    gamma: float = 2.0
    alpha: float = 1.0
    n: int = 1
    lr: float = 1e-3
    adam_eps: float = 1e-8
    anchor_num: int = 64


@dataclasses.dataclass(frozen=True)
class NNConfig:
    """Model width defaults (reference config.py:39-45)."""

    layer_num: int = 1
    embed_dim: int = 32
    feature_dim: int = 32
    hidden_dim: int = 32
    output_dim: int = 32


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """GNN planner defaults (reference eval_gnn.py:96-97,169)."""

    batch: int = 500
    t_max: int = 500
    k: int = 30
    loop: int = 5
    smoother: str = "model"


train_config = TrainConfig()
nn_config = NNConfig()
planner_config = PlannerConfig()


class HostRNG:
    """Owned MT19937 stream with save/restore (config.py:65-95)."""

    def __init__(self, seed: int):
        self._rs = np.random.RandomState(seed)

    def uniform(self, low, high, size=None) -> np.ndarray:
        return self._rs.uniform(low, high, size)

    def randint(self, low, high=None, size=None):
        return self._rs.randint(low, high, size)

    def choice(self, a, size=None, replace=True):
        return self._rs.choice(a, size=size, replace=replace)

    def normal(self, loc=0.0, scale=1.0, size=None):
        return self._rs.normal(loc, scale, size)

    def get_state(self):
        return self._rs.get_state()

    def set_state(self, state) -> None:
        self._rs.set_state(state)


def problem_rng(seed: int, index: int) -> HostRNG:
    """Independent per-problem MT19937 stream derived from ``(seed, index)``
    (config.py:98-113)."""

    root = np.random.SeedSequence([int(seed), int(index)]).generate_state(1)[0]
    return HostRNG(int(root))


def set_random_seed(seed: int) -> HostRNG:
    """Seed numpy's and Python's global RNGs and return an owned stream."""

    np.random.seed(seed)
    _pyrandom.seed(seed)
    return HostRNG(seed)
