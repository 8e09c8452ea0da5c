"""gnn_motion_planning_tpu_torch — the planner in PyTorch for an NVIDIA H100.

A port of ``gnn_motion_planning_tpu`` (the JAX package, which stays the
reference) one slice at a time. Modules keep their JAX counterparts' names
and paths. The package imports torch, numpy and the standard library only:
never JAX and nothing of the JAX package.

Entry points take ``device=None``, which means CUDA; with no CUDA device they
raise instead of falling back to the CPU. Tests pass ``device="cpu"``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# The JAX package pins Precision.HIGHEST for the kNN Gram (graphs/knn.py),
# FK (envs/kinematics.py) and the model linears (models/mlp.py); TF32 would
# keep ~3 decimal digits and flip near-tie argmaxes.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA, which must exist; anything else is taken as is."""

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
