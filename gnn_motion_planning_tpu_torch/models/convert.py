"""Checkpoint loading into the port's modules (port of models/convert.py).

The shipped checkpoints are torch state dicts (``assets/data/weights/*.pt``)
whose dotted names are the modules' own, so loading is a lookup: every
parameter and buffer a module has is taken from the file by name (keys the
module does not use are ignored, a key it needs and the file lacks raises).
``params_from_numpy`` takes the JAX package's nested numpy parameters, as
its ``load_params`` returns them, into the same modules.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gnn_motion_planning_tpu_torch.utils.assets import asset_path


def flatten(tree: dict, prefix: str = "") -> dict:
    """Nested dict -> {dotted name: leaf}."""

    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten(v, name))
        else:
            out[name] = v
    return out


def load_flat(module: nn.Module, flat: dict) -> nn.Module:
    """Copy every floating parameter/buffer of ``module`` from ``flat``."""

    own = module.state_dict()
    missing = [k for k, v in own.items() if v.is_floating_point() and k not in flat]
    if missing:
        raise KeyError(f"checkpoint lacks {missing[:5]} (+{max(len(missing) - 5, 0)})")
    with torch.no_grad():
        for k, v in own.items():
            if v.is_floating_point():
                src = torch.as_tensor(np.asarray(flat[k], np.float32))
                if tuple(src.shape) != tuple(v.shape):
                    raise ValueError(f"{k}: checkpoint {tuple(src.shape)} vs module {tuple(v.shape)}")
                v.copy_(src)
    return module


def load_checkpoint(module: nn.Module, relpath: str) -> nn.Module:
    """Load a reference-style checkpoint (e.g. data/weights/weights_kuka.pt)."""

    sd = torch.load(asset_path(relpath), map_location="cpu", weights_only=True)
    return load_flat(module, {k: v.detach().float() for k, v in sd.items()})


def params_from_numpy(module: nn.Module, tree: dict) -> nn.Module:
    """Load the JAX package's nested numpy parameter tree into ``module``."""

    return load_flat(module, flatten(tree))
