"""Training-metrics logging: JSONL scalars and, where available, TensorBoard
(port of gnn_motion_planning_tpu/utils/metrics.py).

The same append-only ``scalars.jsonl`` as the JAX package, one
``{"step": .., "tag": .., "value": .., "wall_s": ..}`` object per line, so
the two packages' training logs read alike; when torch's SummaryWriter is
importable the scalars are mirrored there too.
"""

from __future__ import annotations

import json
import time
from pathlib import Path


class ScalarLogger:
    """Append-only scalar logger with the add_scalar API.

    >>> log = ScalarLogger("assets/train_logs/explorer_maze2")
    >>> log.add_scalar("train/loss", 0.5, step=10)
    """

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.path = self.dir / "scalars.jsonl"
        self._f = open(self.path, "a")
        self._t0 = time.time()
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value, step: int):
        self._f.write(
            json.dumps(
                {
                    "step": int(step),
                    "tag": tag,
                    "value": float(value),
                    "wall_s": round(time.time() - self._t0, 2),
                }
            )
            + "\n"
        )
        self._f.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_scalars(log_dir: str):
    """Parse a scalars.jsonl back into {tag: [(step, value), ...]}."""

    out: dict = {}
    path = Path(log_dir) / "scalars.jsonl"
    if not path.exists():
        return out
    for line in path.read_text().splitlines():
        if not line.strip():
            continue
        row = json.loads(line)
        out.setdefault(row["tag"], []).append((row["step"], row["value"]))
    return out
