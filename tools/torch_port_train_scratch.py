"""From-scratch (or fine-tuning) training of a registry config through the
port: the counterpart of tools/train_scratch.py for
``gnn_motion_planning_tpu_torch``.

Trains the explorer, the smoother or NEXT from freshly initialised weights
(the explorer also from the shipped ones with ``--finetune``) with the
reference protocol's loops (``training/{explorer,smoother,next}.py``), and
writes the flat ``.npz`` checkpoint (``SCRATCH_NAMES``, the JAX package's
file names) and a loss curve and ``summary.json`` under ``train_logs/`` of
the output directory. The default directory is ``build/torch_port/weights``
of the checkout; an existing checkpoint there is resumed. The port's
``models/convert.py::load_npz`` reads the result (and so does the JAX
package: the format is its own). The explorer trains on the config's PRM
pickle, or on ``--data=PATH`` (the committed slices
``tests/data/torch_port_prm_{kuka7_8,maze2_6}.pkl`` are what reaches a card).

Usage:
  python tools/torch_port_train_scratch.py explorer <config> [epoch] [iter] [--finetune]
      [--data=PATH] [--out=DIR] [--device=cpu]
  python tools/torch_port_train_scratch.py smoother <config> [epoch] [data_iter] [train_iter]
      [--out=DIR] [--device=cpu]
  python tools/torch_port_train_scratch.py next <config> [n_problems] [T] [train_every]
      [--out=DIR] [--device=cpu]
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from time import time

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OUT_DIR = REPO / "build" / "torch_port" / "weights"

SCRATCH_NAMES = {
    ("explorer", "maze2"): "weights_maze_scratch.npz",
    ("explorer", "maze2easy"): "weights_maze_scratch.npz",
    ("explorer", "maze3"): "weights_maze_3_scratch.npz",
    ("explorer", "kuka7"): "weights_kuka_scratch.npz",
    ("explorer", "snake7"): "weights_snake_scratch.npz",
    ("explorer", "ur5"): "weights_ur5_scratch.npz",
    ("explorer", "kuka13"): "weights_kuka_13_scratch.npz",
    ("explorer", "kuka14"): "kuka_14_scratch.npz",  # the registry checkpoint's stem
    ("smoother", "maze2"): "smooth_2d_scratch.npz",
    ("smoother", "maze2easy"): "smooth_2d_scratch.npz",
    ("smoother", "maze3"): "smooth_3d_scratch.npz",
    ("smoother", "kuka7"): "smooth_7d_scratch.npz",
    ("smoother", "ur5"): "smooth_ur5_scratch.npz",
    ("smoother", "snake7"): "smooth_snake_scratch.npz",
    ("smoother", "kuka13"): "smooth_13d_scratch.npz",
    ("smoother", "kuka14"): "smooth_14d_scratch.npz",
}


def _summary(log: Path, **fields) -> None:
    log.mkdir(parents=True, exist_ok=True)
    (log / "summary.json").write_text(json.dumps(fields, indent=1) + "\n")


def train_explorer_scratch(config: str, epoch: int = 2000, iters: int = 20,
                           finetune: bool = False, data_path=None, out_dir=None, device=None):
    """The explorer from a fresh init (or, ``finetune``, from the shipped
    weights, written as ``*_ft.npz``) -> (checkpoint path, model, losses)."""

    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.models.convert import load_npz
    from gnn_motion_planning_tpu_torch.training.explorer import train_explorer

    out_dir = Path(out_dir or OUT_DIR)
    env, model, _, _, _, data = str2name(config, device=device, get_data=True, load=finetune)
    data = str(Path(data_path).resolve()) if data_path else data  # an asset path otherwise
    name = SCRATCH_NAMES[("explorer", config)]
    out = out_dir / (name.replace("_scratch", "_ft") if finetune else name)
    if out.exists():
        load_npz(model, out)  # resume
        print(f"resuming from {out}", flush=True)
    log = out_dir / "train_logs" / f"{config}_explorer_{'ft' if finetune else 'scratch'}"
    log.mkdir(parents=True, exist_ok=True)
    t0 = time()
    model, losses = train_explorer(epoch=epoch, data_path=data, model=model,
                                   model_path=str(out), env=env, iter=iters, log_dir=str(log),
                                   device=env.device)
    _summary(log, config=config, epoch=epoch, iters=iters, steps=len(losses),
             loss_first10=float(np.mean(losses[:10])) if losses else None,
             loss_last10=float(np.mean(losses[-10:])) if losses else None,
             wall_s=round(time() - t0, 1), data_path=data, ckpt=str(out))
    print(f"explorer scratch {config}: {len(losses)} steps -> {out}", flush=True)
    return out, model, losses


def train_smoother_scratch(config: str, epoch: int = 300, data_iter: int = 3,
                           train_iter: int = 20, out_dir=None, device=None):
    """The smoother from a fresh init, on paths the shipped explorer finds
    -> (checkpoint path, model, per-epoch losses)."""

    from gnn_motion_planning_tpu_torch.api.registry import str2models, str2name
    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale
    from gnn_motion_planning_tpu_torch.training.smoother import train_smoother

    out_dir = Path(out_dir or OUT_DIR)
    env, explorer, _, _, _ = str2name(config, device=device)
    smoother = str2models(config, env.device, smoother_scale(config, env), load=False)[1]
    out = out_dir / SCRATCH_NAMES[("smoother", config)]
    log = out_dir / "train_logs" / f"{config}_smoother_scratch"
    log.mkdir(parents=True, exist_ok=True)
    t0 = time()
    smoother, losses = train_smoother(epoch=epoch, model_explore=explorer, model=smoother,
                                      model_path=str(out), env=env, data_iter=data_iter,
                                      train_iter=train_iter, log_dir=str(log), device=env.device)
    _summary(log, config=config, epoch=epoch, data_iter=data_iter, train_iter=train_iter,
             losses=[round(float(x), 5) for x in losses], wall_s=round(time() - t0, 1),
             ckpt=str(out))
    print(f"smoother scratch {config}: losses {losses[:3]}...{losses[-3:]} -> {out}", flush=True)
    return out, smoother, losses


def train_next_scratch(config: str, n_problems: int = 400, T: int = 1000,
                       train_every: int = 100, out_dir=None, device=None):
    """NEXT from He-normal weights (reference train_next.py:42-120, on a
    cut problem budget recorded in the summary) -> (checkpoint, model, losses)."""

    from gnn_motion_planning_tpu_torch.training.next import train_next

    out_dir = Path(out_dir or OUT_DIR)
    out = out_dir / f"next_{config}_scratch.npz"
    log = out_dir / "train_logs" / f"{config}_next_scratch"
    log.mkdir(parents=True, exist_ok=True)
    t0 = time()
    model, losses = train_next(config, T=T, n_problems=n_problems, model_path=str(out),
                               train_every=train_every, log_dir=str(log), from_scratch=True,
                               device=device)
    _summary(log, config=config, n_problems=n_problems, T=T, train_every=train_every,
             reference_budget_note="reference train_next.py uses 2000 problems",
             losses=[round(float(x), 5) for x in losses], wall_s=round(time() - t0, 1),
             ckpt=str(out))
    print(f"next scratch {config}: {len(losses)} updates -> {out}", flush=True)
    return out, model, losses


def main(argv) -> None:
    kind, config = argv[0], argv[1]
    opts = dict(a[2:].split("=", 1) for a in argv[2:] if a.startswith("--") and "=" in a)
    args = [int(a) for a in argv[2:] if not a.startswith("--")]
    common = dict(out_dir=opts.get("out"), device=opts.get("device"))
    if kind == "explorer":
        train_explorer_scratch(config, *args, finetune="--finetune" in argv,
                               data_path=opts.get("data"), **common)
    elif kind == "smoother":
        train_smoother_scratch(config, *args, **common)
    elif kind == "next":
        train_next_scratch(config, *args, **common)
    else:
        raise SystemExit(f"unknown kind {kind}")


if __name__ == "__main__":
    main(sys.argv[1:])
