"""Build a native source into ``build/torch_port/`` at first use.

The library's name carries a hash of the source and the command, so a stale
build is never loaded, and the compiler writes to a private temporary name
that is renamed into place, so concurrent processes cannot load a half
written file. A failed build raises with the compiler's output; a build
that succeeds keeps it beside the library, in ``<library>.log``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import time
from pathlib import Path

from gnn_motion_planning_tpu_torch.utils.assets import BUILD_DIR

# seconds each library took to build in this process (0.0: already built)
BUILD_SECONDS: dict = {}
# the compiler's output for each library built or loaded in this process
BUILD_LOGS: dict = {}


def build_shared_library(src: Path, name: str, compiler: list, flags: list) -> Path:
    """``compiler + flags + [src, -o, lib]``; returns the library's path."""

    key = hashlib.sha256(src.read_bytes() + " ".join(compiler + flags).encode())
    lib = BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"
    log = lib.with_name(lib.name + ".log")
    if lib.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        BUILD_LOGS[name] = log.read_text() if log.exists() else ""
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        compiler + flags + [str(src), "-o", str(tmp)],
        capture_output=True,
        text=True,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({' '.join(compiler + flags)}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    BUILD_SECONDS[name] = time.perf_counter() - t0
    BUILD_LOGS[name] = proc.stdout + proc.stderr
    return lib
