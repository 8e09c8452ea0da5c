#!/usr/bin/env python3
"""Trace a host-only baseline row call by call, to find where a host leaves
the JAX package's row.

    python3 tools/torch_port_host_rows.py [OUT_DIR]
    python3 tools/torch_port_host_rows.py --compare TRACE_A TRACE_B

``eval_rrt`` on kuka7 problem 2000 at the drivers' defaults (T 1000, seed
1234; ``eval_all``'s Kuka_7D RRT* row). Every check of this row goes through
the native float64 core (``runtime/geomcore.cpp``) and the planner's host
numpy, so no kernel runs. Each env call the planner makes is recorded: the
sample drawn, or the inputs of ``_edge_fp``/``_state_fp`` as float64 hex,
the decision and the count after it.

The first form prints the host (CPU model and flags, glibc, numpy and its
AVX-512 dispatch, g++), then runs the row in variants, each in a process of
its own: the env on the card (as ``chip_smoke.py`` phase 8 runs it, where a
card is present) and on the CPU, with the native core built with the port's
flags (``utils/geomcore.py::FLAGS``), with ``-march=native``, without
``-march`` (with and without ``-ffp-contract=off``), and for the fixed
targets ``x86-64-v3`` and ``x86-64-v4``. It prints each variant's row and the first call
at which its trace leaves the first variant's, and writes the traces to
``OUT_DIR`` (default ``build/host_rows``). The second form prints the
first call at which two traces (say one made on this host and one on
another) differ, and what differs there.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import platform
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CONFIG, INDEX, SEED = "kuka7", 2000, 1234
VARIANTS = {
    "port": None,  # the port's own flags (utils/geomcore.py::FLAGS)
    "native": ["-O3", "-march=native", "-shared", "-fPIC"],
    "no-march": ["-O3", "-shared", "-fPIC"],
    "no-march-no-contract": ["-O3", "-ffp-contract=off", "-shared", "-fPIC"],
    "x86-64-v3": ["-O3", "-march=x86-64-v3", "-shared", "-fPIC"],
    "x86-64-v4": ["-O3", "-march=x86-64-v4", "-shared", "-fPIC"],
}


def _hex(x) -> list:
    import numpy as np

    return [float(v).hex() for v in np.asarray(x, np.float64).reshape(-1)]


def run_one(device: str, flags: list, out: Path) -> None:
    """The row on ``device`` with the native core built with ``flags``; the
    trace to ``out``."""

    sys.path.insert(0, str(REPO))
    from gnn_motion_planning_tpu_torch.api import eval_baselines
    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.utils import geomcore

    if flags is not None:
        geomcore.FLAGS = list(flags)  # before the first build in this process
    env = str2env(CONFIG, device=device)[0]
    trace = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            result = fn(*args, **kwargs)
            if name == "uniform_sample":
                trace.append([name, _hex(result)])
            else:
                trace.append([name, [_hex(a) for a in args], bool(result),
                              int(env.collision_check_count)])
            return result
        return call

    for name in ("uniform_sample", "_edge_fp", "_state_fp"):
        setattr(env, name, recorded(name, getattr(env, name)))
    with contextlib.redirect_stdout(io.StringIO()):
        r = eval_baselines.eval_rrt(CONFIG, SEED, env, [INDEX])
    row = [int(r[0]), float(r[1]), float(r[3])]
    out.write_text(json.dumps({"device": device, "flags": geomcore.FLAGS, "row": row,
                               "trace": trace}) + "\n")


def first_difference(a: list, b: list):
    """(call number, entry of a, entry of b) of the first differing call, or
    None."""

    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i, x, y
    if len(a) != len(b):
        i = min(len(a), len(b))
        return i, a[i] if i < len(a) else None, b[i] if i < len(b) else None
    return None


def describe(diff) -> str:
    if diff is None:
        return "the same trace"
    i, x, y = diff
    return f"first differing call {i}: {json.dumps(x)} against {json.dumps(y)}"


def host_lines() -> list:
    import numpy as np

    try:
        from numpy._core._multiarray_umath import __cpu_features__ as feats
    except ImportError:  # numpy 1.x
        from numpy.core._multiarray_umath import __cpu_features__ as feats
    cpu = Path("/proc/cpuinfo")
    info = cpu.read_text() if cpu.exists() else ""
    field = lambda key: next((line.split(":", 1)[1].strip() for line in info.splitlines()  # noqa: E731
                              if line.split(":", 1)[0].strip() == key), "not in /proc/cpuinfo")
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True).stdout
    return [
        f"host: {platform.machine()} {field('model name')}",
        f"cpu flags (fma, avx2, avx512*): " + " ".join(
            f for f in field("flags").split() if f in ("fma", "avx2") or f.startswith("avx512")),
        f"glibc {os.confstr('CS_GNU_LIBC_VERSION')}; python {platform.python_version()}; "
        f"numpy {np.__version__} (AVX-512 dispatch: "
        f"{' '.join(sorted(k for k, v in feats.items() if v and 'AVX512' in k)) or 'none'})",
        f"g++: {gxx.splitlines()[0] if gxx else 'not found'}",
    ]


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        run_one(argv[1], json.loads(argv[2]), Path(argv[3]))
        return 0
    if argv[:1] == ["--compare"]:
        a, b = (json.loads(Path(p).read_text()) for p in argv[1:3])
        print(f"{argv[1]}: row {a['row']}; {argv[2]}: row {b['row']}")
        print(describe(first_difference(a["trace"], b["trace"])))
        return 0
    import torch

    out_dir = Path(argv[0]) if argv else REPO / "build" / "host_rows"
    out_dir.mkdir(parents=True, exist_ok=True)
    for line in host_lines():
        print(line, flush=True)
    devices = ["cuda", "cpu"] if torch.cuda.is_available() else ["cpu"]
    first = None
    for device in devices:
        for name, flags in VARIANTS.items():
            out = out_dir / f"{CONFIG}_{INDEX}_rrt_{device}_{name}.json"
            ran = subprocess.run([sys.executable, __file__, "--one", device, json.dumps(flags),
                                  str(out)])
            if ran.returncode:  # x86-64-v4 on a host without AVX-512
                print(f"{device} {name} ({' '.join(flags or ['port'])}): exit {ran.returncode}",
                      flush=True)
                continue
            got = json.loads(out.read_text())
            first = first or (out.name, got["trace"])
            print(f"{device} {name} ({' '.join(got['flags'])}): row {got['row']}, "
                  f"{len(got['trace'])} calls; against {first[0]}: "
                  f"{describe(first_difference(first[1], got['trace']))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
