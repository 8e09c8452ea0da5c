"""Name registries (port of gnn_motion_planning_tpu/api/registry.py):
the same names, test index ranges, model widths, checkpoint paths, training
data and per-config protocol overrides, for all eight configurations.

``GMP_WEIGHTS=scratch`` in the environment loads every config's
from-scratch-trained weights (``assets/weights_jax/*_scratch.npz``) where
they exist, as the JAX package does (api/registry.py:190-197).
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.models.convert import load_checkpoint, load_flat, load_npz, read_checkpoint
from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig, init_explorer_params
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, SmootherConfig, init_smoother_params
from gnn_motion_planning_tpu_torch.utils.assets import REPO

_SPECS = {
    "maze2": dict(
        explorer=dict(workspace_size=2, config_size=2, embed_size=32, obs_size=2),
        explorer_ckpt="data/weights/weights_maze.pt",
        smoother=dict(workspace_size=2, config_size=2, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_2d_attv3.pt",
        data="data/pkl/maze_prm_4000.pkl",
    ),
    "maze3": dict(
        explorer=dict(workspace_size=2, config_size=3, embed_size=32, obs_size=2),
        explorer_ckpt="data/weights/weights_maze_3.pt",
        smoother=dict(workspace_size=3, config_size=3, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_3d_attv3.pt",
        data="data/pkl/maze_prm_3.pkl",
    ),
    "kuka7": dict(
        explorer=dict(workspace_size=3, config_size=7, embed_size=64, obs_size=6),
        explorer_ckpt="data/weights/weights_kuka.pt",
        smoother=dict(workspace_size=3, config_size=7, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_7d_attv3.pt",
        data="data/pkl/kuka_prm_4000.pkl",
    ),
    "kuka13": dict(
        explorer=dict(workspace_size=3, config_size=13, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/weights_kuka_13.pt",
        smoother=dict(workspace_size=3, config_size=13, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_13d_attv3.pt",
        data="data/pkl/kuka_prm_13.pkl",
    ),
    "ur5": dict(
        explorer=dict(workspace_size=3, config_size=6, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/weights_ur5.pt",
        smoother=dict(workspace_size=3, config_size=6, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_ur5_attv3.pt",
        data="data/pkl/ur5_prm_3000.pkl",
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
        data="data/pkl/snake_prm_3000.pkl",
    ),
    "kuka14": dict(
        explorer=dict(workspace_size=3, config_size=14, embed_size=32, obs_size=6),
        explorer_ckpt="data/weights/kuka_14.pt",
        smoother=dict(workspace_size=3, config_size=14, embed_size=128, obs_size=6),
        smoother_ckpt="data/weights/smooth_14d_attv3.pt",
        data="data/pkl/kuka_prm_14.pkl",
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
# ``chunk`` entries tune the batched path (``api/batched.py``): a large
# chunk makes a round one search call, since the maze oracle is cheap.
EVAL_OVERRIDES = {
    "snake7": {"t_max": 2000},
    "maze2easy": {"chunk": 4096},
    "maze2hard": {"chunk": 4096},
    "maze3": {"chunk": 4096},
}
# knobs that tune only the batched path; the scalar explore() takes none
_BATCHED_ONLY = ("chunk", "lanes")


def eval_overrides(name: str) -> dict:
    """Harness keywords overriding the reference defaults for one config."""

    return dict(EVAL_OVERRIDES.get(name, {}))


def scalar_overrides(name: str) -> dict:
    """The overrides that ``explore`` takes (batched-only knobs dropped)."""

    return {k: v for k, v in EVAL_OVERRIDES.get(name, {}).items() if k not in _BATCHED_ONLY}


def _config(name: str) -> tuple:
    if name not in _CONFIGS:
        raise KeyError(f"{name!r} is not ported yet (ported: {sorted(_CONFIGS)})")
    return _CONFIGS[name]


def _spec_key(name: str) -> str:
    """The model spec of a name: every maze2 name (also the env's own
    ``str``, "maze2", which ``eval_all`` passes) takes maze2's (JAX
    api/registry.py:162-165)."""

    return "maze2" if "maze2" in name else _config(name)[3]


def _spec(name: str) -> dict:
    return _SPECS[_spec_key(name)]


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

    return float(np.max(env.bound)) if _spec_key(name) == "ur5" else 1.0


def _scratch_npz(ckpt: str) -> str:
    """Asset path of the from-scratch-trained twin of a checkpoint
    (tools/train_scratch.py naming: <stem without _attv3>_scratch.npz)."""

    return f"weights_jax/{Path(ckpt).stem.replace('_attv3', '')}_scratch.npz"


_INIT_SEED = 1234  # the trainers' default seed (JAX training/*.py)


def _prefer_scratch() -> bool:
    return os.environ.get("GMP_WEIGHTS", "").lower() == "scratch"


def _scratch(ckpt: str):
    """The from-scratch twin's path under ``GMP_WEIGHTS=scratch`` where it
    exists, else None."""

    path = REPO / "assets" / _scratch_npz(ckpt)
    return path if _prefer_scratch() and path.exists() else None


def _load_smoother(spec: dict, scale: float):
    """The smoother of a spec, or None. Where the shipped checkpoint is the
    legacy architecture (no ``node_code.0.*``: maze3's ``smooth_3d_att.pt``),
    the scratch-trained twin in ``assets/weights_jax/`` is loaded instead,
    and where that twin is missing there is no smoother: ``explore`` then
    smooths with the oracle smoother, as the JAX package does
    (api/registry.py:230-253)."""

    smoother = Smoother(SmootherConfig(scale=scale, **spec["smoother"]))
    scratch = _scratch(spec["smoother_ckpt"])
    if scratch is not None:
        return load_npz(smoother, scratch)
    flat = read_checkpoint(spec["smoother_ckpt"])
    if any(k.startswith("node_code.0.") for k in flat):
        return load_flat(smoother, flat)
    twin = REPO / "assets" / _scratch_npz(spec["smoother_ckpt"])
    return load_npz(smoother, twin) if twin.exists() else None


def _explorer_ckpt(spec: dict, use_obstacle: bool) -> str:
    """The explorer checkpoint; the obstacle-free ablation's is the
    ``_pure.pt`` beside it (JAX api/registry.py:302-304)."""

    ckpt = spec["explorer_ckpt"]
    return ckpt if use_obstacle else ckpt.replace(".pt", "_pure.pt")


def _load_explorer(spec: dict, use_obstacle: bool = True) -> Explorer:
    """The explorer of a spec: the shipped checkpoint, or the fine-tuned
    ``explorer_ft`` in ``assets/weights_jax/`` where the spec names one. A
    missing fine-tuned file raises: the JAX package would quietly take the
    shipped checkpoint, another planner. A missing ``_pure.pt`` raises, as
    in the JAX package."""

    explorer = Explorer(ExplorerConfig(use_obstacles=use_obstacle, **spec["explorer"]))
    ckpt = _explorer_ckpt(spec, use_obstacle)
    scratch = _scratch(ckpt)
    if scratch is not None:
        return load_npz(explorer, scratch)
    if "explorer_ft" not in spec or not use_obstacle:
        return load_checkpoint(explorer, ckpt)
    path = REPO / "assets" / "weights_jax" / spec["explorer_ft"]
    if not path.exists():
        raise FileNotFoundError(f"fine-tuned explorer weights {path} are missing")
    return load_npz(explorer, path)


def str2models(name: str, device=None, scale: float = 1.0, use_obstacle: bool = True,
               load: bool = True):
    """(explorer, smoother) modules on ``device``, with the shipped weights;
    the smoother works in units of ``scale`` (``smoother_scale``) and is None
    where the config has no loadable one (``_load_smoother``). With
    ``load=False`` both are freshly initialised (``init_explorer_params``,
    ``init_smoother_params``, seeded by the trainers' default seed), for
    training from scratch."""

    spec = _spec(name)
    device = resolve_device(device)
    if load:
        explorer = _load_explorer(spec, use_obstacle)
        smoother = _load_smoother(spec, scale)
    else:
        explorer = init_explorer_params(
            Explorer(ExplorerConfig(use_obstacles=use_obstacle, **spec["explorer"])), _INIT_SEED)
        smoother = init_smoother_params(
            Smoother(SmootherConfig(scale=scale, **spec["smoother"])), _INIT_SEED)
    if smoother is not None:
        smoother = smoother.to(device).eval()
    return explorer.to(device).eval(), smoother


def str2name(name: str, device=None, get_data: bool = False, use_obstacle: bool = True,
             load: bool = True):
    """(env, explorer, explorer_ckpt, smoother, smoother_ckpt[, data]) —
    reference str2name.py:11-81. The env is ``str2env``'s (maze2hard gets
    the hard maps; the JAX package's ``str2name`` builds the default maze2
    maps for any maze2 name). ``get_data`` appends the config's PRM
    training data (an asset path); ``load=False`` gives freshly
    initialised models."""

    spec = _spec(name)
    env, _ = str2env(name, device)
    explorer, smoother = str2models(name, env.device, smoother_scale(name, env),
                                    use_obstacle=use_obstacle, load=load)
    out = (env, explorer, _explorer_ckpt(spec, use_obstacle), smoother, spec["smoother_ckpt"])
    return out + (spec["data"],) if get_data else out
