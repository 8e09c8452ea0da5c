"""Checkpointing: the whole train state through ``torch.save``, and weight
export in the JAX package's flat npz format (port of
gnn_motion_planning_tpu/parallel/checkpoint.py, which goes through orbax).

A train state holds the module's floats (parameters and buffers), the
optimizer's state, the step and the host RNG's MT19937 state, so a resumed
run draws the same stream. The npz export is the JAX package's
``export_params_npz`` format, dotted names, so a checkpoint the port trains
loads there (``load_params_npz``), and the JAX package's load here
(``models/convert.py::load_npz``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from gnn_motion_planning_tpu_torch.models.convert import nest, save_npz


def save_train_state(ckpt_dir, step: int, model: nn.Module, optimizer,
                     host_rng_state=None) -> None:
    """Write ``step_<step>.pt`` and point ``LATEST`` at it."""

    path = Path(ckpt_dir).resolve()
    path.mkdir(parents=True, exist_ok=True)
    payload = {"params": model.state_dict(), "opt_state": optimizer.state_dict(),
               "step": int(step)}
    if host_rng_state is not None:
        # numpy get_state(): (bit-generator name, keys, pos, has_gauss,
        # cached_gaussian); config.HostRNG is always MT19937
        name, keys, pos, has_gauss, cached = host_rng_state
        assert name == "MT19937", f"unexpected bit generator {name!r}"
        payload["rng"] = {"keys": torch.as_tensor(np.asarray(keys, np.int64)), "pos": int(pos),
                          "has_gauss": int(has_gauss), "cached": float(cached)}
    torch.save(payload, path / f"step_{step}.pt")
    (path / "LATEST").write_text(str(step))


def restore_train_state(ckpt_dir, model: nn.Module, optimizer, step=None):
    """Load a train state into ``model`` and ``optimizer`` (in place) ->
    (model, optimizer, step, host_rng_state or None)."""

    path = Path(ckpt_dir).resolve()
    if step is None:
        step = int((path / "LATEST").read_text())
    payload = torch.load(path / f"step_{step}.pt", map_location="cpu", weights_only=True)
    model.load_state_dict(payload["params"])
    optimizer.load_state_dict(payload["opt_state"])
    rng = payload.get("rng")
    rng_state = None
    if rng is not None:
        rng_state = ("MT19937", rng["keys"].numpy().astype(np.uint32), rng["pos"],
                     rng["has_gauss"], rng["cached"])
    return model, optimizer, payload["step"], rng_state


def export_params_npz(path, model: nn.Module):
    save_npz(model, path)
    return path


def load_params_npz(path) -> dict:
    """The nested numpy tree of a flat npz (JAX ``load_params_npz``)."""

    with np.load(path) as f:
        return nest({k: f[k] for k in f.files})
