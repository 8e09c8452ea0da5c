"""Seeding and the host RNG stream (port of gnn_motion_planning_tpu/config.py).

Host sampling stays on numpy's legacy MT19937 ``RandomState`` and consumes
it in the same call order as the JAX package, so for a given seed the
rejection-sampled node set is the same stream on both sides.
"""

from __future__ import annotations

import random as _pyrandom

import numpy as np


class HostRNG:
    """Owned MT19937 stream with save/restore (config.py:65-95)."""

    def __init__(self, seed: int):
        self._rs = np.random.RandomState(seed)

    def uniform(self, low, high, size=None) -> np.ndarray:
        return self._rs.uniform(low, high, size)

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
