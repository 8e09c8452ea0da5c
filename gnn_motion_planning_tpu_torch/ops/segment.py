"""Segment aggregation over padded edge lists (port of ops/segment.py).

XLA ops in the JAX package, plain PyTorch here: dead edges are routed to an
extra trash segment that is dropped.
"""

from __future__ import annotations

import torch


def masked_segment_max(data, segment_ids, alive, num_segments: int):
    """Max-aggregate rows of ``data``; empty segments give 0."""

    ids = torch.where(alive, segment_ids, num_segments)
    out = torch.full(
        (num_segments + 1, data.shape[1]), float("-inf"), dtype=data.dtype, device=data.device
    )
    out = out.scatter_reduce(0, ids[:, None].expand_as(data), data, "amax", include_self=True)
    out = torch.where(torch.isneginf(out), 0.0, out)
    return out[:num_segments]


def masked_segment_sum(data, segment_ids, alive, num_segments: int):
    """Sum-aggregate rows of ``data``; dead edges contribute nothing."""

    ids = torch.where(alive, segment_ids, num_segments)
    out = torch.zeros((num_segments + 1, data.shape[1]), dtype=data.dtype, device=data.device)
    out = out.scatter_reduce(0, ids[:, None].expand_as(data), data, "sum", include_self=True)
    return out[:num_segments]
