"""Name registries (port of gnn_motion_planning_tpu/api/registry.py):
the same names, test index ranges, model widths and checkpoint paths.
This port carries maze2easy, maze2hard, maze3, kuka7 and kuka13; other
names raise ``KeyError``."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.convert import load_checkpoint, load_flat, load_npz, read_checkpoint
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig
from gnn_motion_planning_tpu_torch.utils.assets import asset_path

_SPECS = {
    "maze2": dict(
        explorer=dict(workspace_size=2, config_size=2, embed_size=32, obs_size=2),
        explorer_ckpt="data/weights/weights_maze.pt",
        smoother=dict(workspace_size=2, config_size=2, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_2d_attv3.pt",
    ),
    "maze3": dict(
        explorer=dict(workspace_size=2, config_size=3, embed_size=32, obs_size=2),
        explorer_ckpt="data/weights/weights_maze_3.pt",
        smoother=dict(workspace_size=3, config_size=3, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_3d_attv3.pt",
    ),
    "kuka7": dict(
        explorer=dict(workspace_size=3, config_size=7, embed_size=64, obs_size=6),
        explorer_ckpt="data/weights/weights_kuka.pt",
        smoother=dict(workspace_size=3, config_size=7, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_7d_attv3.pt",
    ),
    "kuka13": dict(
        explorer=dict(workspace_size=3, config_size=13, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/weights_kuka_13.pt",
        smoother=dict(workspace_size=3, config_size=13, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_13d_attv3.pt",
    ),
}


# name -> (env family, env keyword arguments, test index range, spec key):
# the one table of ported names (JAX api/registry.py:35-56, :162-165)
_CONFIGS = {
    "maze2easy": ("maze", dict(dim=2), (2000, 3000), "maze2"),
    "maze2hard": ("maze", dict(dim=2, map_file="maze_files/mazes_hard.npz"), (0, 1000), "maze2"),
    "maze3": ("maze", dict(dim=3), (2000, 3000), "maze3"),
    "kuka7": ("kuka", dict(), (2000, 3000), "kuka7"),
    "kuka13": ("kuka", dict(kuka_file="kuka_iiwa/model_3.urdf",
                            map_file="maze_files/kukas_13_3000.pkl"), (2000, 3000), "kuka13"),
}


def _config(name: str) -> tuple:
    if name not in _CONFIGS:
        raise KeyError(f"{name!r} is not ported yet (ported: {sorted(_CONFIGS)})")
    return _CONFIGS[name]


def _spec(name: str) -> dict:
    return _SPECS[_config(name)[3]]


def str2env(name: str, device=None):
    """(env, test_indexes) for a benchmark config (str2env.py:11-40)."""

    family, kwargs, (lo, hi), _ = _config(name)
    if family == "maze":
        from gnn_motion_planning_tpu_torch.envs.maze import MazeEnv as env_cls
    else:
        from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv as env_cls
    return env_cls(device=device, **kwargs), np.arange(lo, hi)


def _scratch_npz(ckpt: str) -> str:
    """Asset path of the from-scratch-trained twin of a checkpoint
    (tools/train_scratch.py naming: <stem without _attv3>_scratch.npz)."""

    return f"weights_jax/{Path(ckpt).stem.replace('_attv3', '')}_scratch.npz"


def _load_smoother(spec: dict) -> Smoother:
    """The smoother of a spec. Where the shipped checkpoint is the legacy
    architecture (no ``node_code.0.*``: maze3's ``smooth_3d_att.pt``), the
    scratch-trained twin in ``assets/weights_jax/`` is loaded instead, as
    the JAX package does (api/registry.py:230-253). A missing twin raises:
    the JAX package would then smooth with the oracle smoother, which is
    not ported."""

    smoother = Smoother(SmootherConfig(**spec["smoother"]))
    flat = read_checkpoint(spec["smoother_ckpt"])
    if any(k.startswith("node_code.0.") for k in flat):
        return load_flat(smoother, flat)
    return load_npz(smoother, asset_path(_scratch_npz(spec["smoother_ckpt"])))


def str2models(name: str, device=None):
    """(explorer, smoother) modules on ``device``, with the shipped weights."""

    spec = _spec(name)
    device = resolve_device(device)
    explorer = load_checkpoint(Explorer(ExplorerConfig(**spec["explorer"])), spec["explorer_ckpt"])
    smoother = _load_smoother(spec)
    return explorer.to(device).eval(), smoother.to(device).eval()


def str2name(name: str, device=None):
    """(env, explorer, explorer_ckpt, smoother, smoother_ckpt) —
    reference str2name.py:11-81. The env is ``str2env``'s (maze2hard gets
    the hard maps; the JAX package's ``str2name`` builds the default maze2
    maps for any maze2 name)."""

    spec = _spec(name)
    env, _ = str2env(name, device)
    explorer, smoother = str2models(name, env.device)
    return env, explorer, spec["explorer_ckpt"], smoother, spec["smoother_ckpt"]
