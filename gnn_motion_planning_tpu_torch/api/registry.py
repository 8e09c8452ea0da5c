"""Name registries (port of gnn_motion_planning_tpu/api/registry.py):
the same names, test index ranges, model widths and checkpoint paths.
This slice carries kuka7; other names raise ``KeyError``."""

from __future__ import annotations

import numpy as np

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.convert import load_checkpoint
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig

_SPECS = {
    "kuka7": dict(
        explorer=dict(workspace_size=3, config_size=7, embed_size=64, obs_size=6),
        explorer_ckpt="data/weights/weights_kuka.pt",
        smoother=dict(workspace_size=3, config_size=7, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_7d_attv3.pt",
    ),
}


def _spec(name: str) -> dict:
    if name not in _SPECS:
        raise KeyError(f"{name!r} is not ported yet (ported: {sorted(_SPECS)})")
    return _SPECS[name]


def str2env(name: str, device=None):
    """(env, test_indexes) for a benchmark config (str2env.py:11-40)."""

    _spec(name)
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv

    return KukaEnv(device=device), np.arange(2000, 3000)


def str2models(name: str, device=None):
    """(explorer, smoother) modules on ``device``, with the shipped weights."""

    spec = _spec(name)
    device = resolve_device(device)
    explorer = load_checkpoint(Explorer(ExplorerConfig(**spec["explorer"])), spec["explorer_ckpt"])
    smoother = load_checkpoint(Smoother(SmootherConfig(**spec["smoother"])), spec["smoother_ckpt"])
    return explorer.to(device).eval(), smoother.to(device).eval()


def str2name(name: str, device=None):
    """(env, explorer, explorer_ckpt, smoother, smoother_ckpt) —
    reference str2name.py:11-81."""

    spec = _spec(name)
    env, _ = str2env(name, device)
    explorer, smoother = str2models(name, env.device)
    return env, explorer, spec["explorer_ckpt"], smoother, spec["smoother_ckpt"]
