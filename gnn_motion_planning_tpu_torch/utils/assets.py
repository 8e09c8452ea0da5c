"""Asset paths: ``$GMP_ASSETS`` first, then the repository's ``assets/``
(port of gnn_motion_planning_tpu/utils/assets.py)."""

from __future__ import annotations

import os
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BUILD_DIR = REPO / "build" / "torch_port"  # native libraries built at first use


def asset_path(relpath: str) -> str:
    """Resolve a reference-style relative asset path to an absolute path."""

    candidates = []
    env_root = os.environ.get("GMP_ASSETS")
    if env_root:
        candidates.append(Path(env_root) / relpath)
    candidates.append(REPO / "assets" / relpath)
    for cand in candidates:
        if cand.exists():
            return str(cand)
    raise FileNotFoundError(
        f"asset {relpath!r} not found (searched {[str(c) for c in candidates]})"
    )
