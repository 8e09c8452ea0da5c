"""Checkpoint loading into the port's modules (port of models/convert.py).

The shipped checkpoints are torch state dicts (``assets/data/weights/*.pt``)
whose dotted names are the modules' own, so loading is a lookup: every
parameter and buffer a module has is taken from the file by name (keys the
module does not use are ignored, a key it needs and the file lacks raises).
``params_from_numpy`` takes the JAX package's nested numpy parameters, as
its ``load_params`` returns them, into the same modules; ``load_npz`` reads
the flat ``.npz`` files of ``assets/weights_jax/`` (scratch-trained and
fine-tuned weights) into them. ``to_flat`` and ``save_npz`` go the other
way: a module's floats under the same names, which is the JAX package's
flat npz format (its ``_flatten``), so weights the port trains load there.
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


def nest(flat: dict) -> dict:
    """{dotted name: leaf} -> nested dict (the JAX package's ``_nest``)."""

    tree: dict = {}
    for key, value in flat.items():
        parts = key.split(".")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def to_flat(module: nn.Module) -> dict:
    """{dotted name: float32 numpy array} of every floating parameter and
    buffer of ``module`` (BatchNorm's running statistics included, as the
    JAX package keeps them in its parameter tree)."""

    return {k: v.detach().cpu().numpy().astype(np.float32)
            for k, v in module.state_dict().items() if v.is_floating_point()}


def save_npz(module: nn.Module, path) -> None:
    """Write ``module``'s floats as a flat ``.npz`` of dotted names."""

    np.savez(path, **to_flat(module))


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


def read_checkpoint(relpath: str) -> dict:
    """{dotted name: float tensor} of a reference-style checkpoint (e.g.
    data/weights/weights_kuka.pt). The reference names the maze3 smoother
    ``smooth_3d_attv3.pt`` but ships only ``smooth_3d_att.pt``
    (str2name.py:25 vs data/weights/), so a missing ``_attv3.pt`` falls back
    to the ``_att.pt`` beside it (JAX models/convert.py:76-81)."""

    sd = torch.load(_checkpoint_path(relpath), map_location="cpu", weights_only=True)
    return {k: v.detach().float() for k, v in sd.items()}


def _checkpoint_path(relpath: str):
    try:
        return asset_path(relpath)
    except FileNotFoundError:
        if not relpath.endswith("_attv3.pt"):
            raise
        return asset_path(relpath.replace("_attv3.pt", "_att.pt"))


def load_torch_checkpoint(pt_path) -> dict:
    """A torch ``.pt`` state dict as a nested tree of float32 numpy arrays
    (JAX models/convert.py:45-56)."""

    sd = torch.load(pt_path, map_location="cpu", weights_only=True)
    return nest({k: v.detach().numpy().astype(np.float32) for k, v in sd.items()
                 if hasattr(v, "detach") and v.dtype.is_floating_point})


def load_params(relpath: str) -> dict:
    """The nested numpy parameters of a reference-style checkpoint path
    (JAX models/convert.py:59-85, without its npz cache: the file is read
    each call), with ``read_checkpoint``'s maze3 fallback."""

    return load_torch_checkpoint(_checkpoint_path(relpath))


def load_checkpoint(module: nn.Module, relpath: str) -> nn.Module:
    """Load a reference-style checkpoint into ``module``."""

    return load_flat(module, read_checkpoint(relpath))


def load_npz(module: nn.Module, path) -> nn.Module:
    """Load a flat ``.npz`` of dotted names (the JAX package's weight
    files, JAX api/registry.py:181-187) into ``module``."""

    with np.load(path) as f:
        return load_flat(module, {k: f[k] for k in f.files})


def params_from_numpy(module: nn.Module, tree: dict) -> nn.Module:
    """Load the JAX package's nested numpy parameter tree into ``module``."""

    return load_flat(module, flatten(tree))
