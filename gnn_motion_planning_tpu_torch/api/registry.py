"""Name registries (port of gnn_motion_planning_tpu/api/registry.py):
the same names, test index ranges, model widths, checkpoint paths and
per-config protocol overrides, for all eight configurations."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.convert import load_checkpoint, load_flat, load_npz, read_checkpoint
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig
from gnn_motion_planning_tpu_torch.utils.assets import REPO, asset_path

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
    "ur5": dict(
        explorer=dict(workspace_size=3, config_size=6, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/weights_ur5.pt",
        smoother=dict(workspace_size=3, config_size=6, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_ur5_attv3.pt",
    ),
    "snake7": dict(
        explorer=dict(workspace_size=3, config_size=7, embed_size=32, obs_size=2),
        explorer_ckpt="data/weights/weights_snake.pt",
        # snake7's problems are regenerated (upstream ships none); its
        # explorer is the checkpoint fine-tuned on them (JAX
        # api/registry.py:92-100)
        explorer_ft="weights_snake_ft.npz",
        smoother=dict(workspace_size=3, config_size=7, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_snake_attv3.pt",
    ),
    "kuka14": dict(
        explorer=dict(workspace_size=3, config_size=14, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/kuka_14.pt",
        smoother=dict(workspace_size=3, config_size=14, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_14d_attv3.pt",
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
    "ur5": ("ur5", dict(), (2000, 3000), "ur5"),
    "snake7": ("snake", dict(), (2000, 3000), "snake7"),
    "kuka14": ("kuka2", dict(), (2000, 3000), "kuka14"),
}

# Per-config protocol overrides (JAX api/registry.py:130-159): snake7's
# regenerated problems need resample rounds, so its t_max is 2000. The maze
# ``chunk`` entries tune the batched path, which is not ported yet.
EVAL_OVERRIDES = {
    "snake7": {"t_max": 2000},
    "maze2easy": {"chunk": 4096},
    "maze2hard": {"chunk": 4096},
    "maze3": {"chunk": 4096},
}
_BATCHED_ONLY = ("chunk", "lanes")


def scalar_overrides(name: str) -> dict:
    """The overrides that ``explore`` takes (batched-only knobs dropped)."""

    return {k: v for k, v in EVAL_OVERRIDES.get(name, {}).items() if k not in _BATCHED_ONLY}


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
    elif family == "kuka":
        from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv as env_cls
    elif family == "ur5":
        from gnn_motion_planning_tpu_torch.envs.ur5 import UR5Env as env_cls
    elif family == "snake":
        from gnn_motion_planning_tpu_torch.envs.snake import SnakeEnv as env_cls
    else:
        from gnn_motion_planning_tpu_torch.envs.kuka2 import Kuka2Env as env_cls
    return env_cls(device=device, **kwargs), np.arange(lo, hi)


def smoother_scale(name: str, env) -> float:
    """ur5's smoother works in units of its widest joint bound, 2 pi (JAX
    api/registry.py:306); every other config's in the env's own."""

    return float(np.max(env.bound)) if _config(name)[3] == "ur5" else 1.0


def _scratch_npz(ckpt: str) -> str:
    """Asset path of the from-scratch-trained twin of a checkpoint
    (tools/train_scratch.py naming: <stem without _attv3>_scratch.npz)."""

    return f"weights_jax/{Path(ckpt).stem.replace('_attv3', '')}_scratch.npz"


def _load_smoother(spec: dict, scale: float) -> Smoother:
    """The smoother of a spec. Where the shipped checkpoint is the legacy
    architecture (no ``node_code.0.*``: maze3's ``smooth_3d_att.pt``), the
    scratch-trained twin in ``assets/weights_jax/`` is loaded instead, as
    the JAX package does (api/registry.py:230-253). A missing twin raises:
    the JAX package would then smooth with the oracle smoother, which is
    not ported."""

    smoother = Smoother(SmootherConfig(scale=scale, **spec["smoother"]))
    flat = read_checkpoint(spec["smoother_ckpt"])
    if any(k.startswith("node_code.0.") for k in flat):
        return load_flat(smoother, flat)
    return load_npz(smoother, asset_path(_scratch_npz(spec["smoother_ckpt"])))


def _load_explorer(spec: dict) -> Explorer:
    """The explorer of a spec: the shipped checkpoint, or the fine-tuned
    ``explorer_ft`` in ``assets/weights_jax/`` where the spec names one. A
    missing fine-tuned file raises: the JAX package would quietly take the
    shipped checkpoint, another planner."""

    explorer = Explorer(ExplorerConfig(**spec["explorer"]))
    if "explorer_ft" not in spec:
        return load_checkpoint(explorer, spec["explorer_ckpt"])
    path = REPO / "assets" / "weights_jax" / spec["explorer_ft"]
    if not path.exists():
        raise FileNotFoundError(f"fine-tuned explorer weights {path} are missing")
    return load_npz(explorer, path)


def str2models(name: str, device=None, scale: float = 1.0):
    """(explorer, smoother) modules on ``device``, with the shipped weights;
    the smoother works in units of ``scale`` (``smoother_scale``)."""

    spec = _spec(name)
    device = resolve_device(device)
    explorer = _load_explorer(spec)
    smoother = _load_smoother(spec, scale)
    return explorer.to(device).eval(), smoother.to(device).eval()


def str2name(name: str, device=None):
    """(env, explorer, explorer_ckpt, smoother, smoother_ckpt) —
    reference str2name.py:11-81. The env is ``str2env``'s (maze2hard gets
    the hard maps; the JAX package's ``str2name`` builds the default maze2
    maps for any maze2 name)."""

    spec = _spec(name)
    env, _ = str2env(name, device)
    explorer, smoother = str2models(name, env.device, smoother_scale(name, env))
    return env, explorer, spec["explorer_ckpt"], smoother, spec["smoother_ckpt"]
