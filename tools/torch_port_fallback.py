#!/usr/bin/env python3
"""Run and time the batched path's scalar fallback on one NVIDIA H100.

    python3 tools/torch_port_fallback.py

``eval_gnn_batched`` on kuka14 problems 2000-2007 at the reference protocol
(batch 500, t_max 500, k 30, chunk 64) in one group of 8 lanes. The first
round of problem 2006 fails only when its frontier runs dry, so the lane
search runs it to the end and the scalar fallback (``api/batched.py``) runs
it again. Then the port's scalar ``eval_gnn`` of 2006 alone, for its time
and its row. Prints the card, the launch counts of the batched sweep, the
group's stats and the fallback's, the rows, and the seconds of each run.
Fails if no fallback ran, if the sweep never launched ``capsules_hit``, or
if the fallback's row differs from the scalar row.

``chip_smoke.py`` phase 6 leaves 2006 out of its kuka14 cell: the two
exhaustive searches this script times would not fit the smoke's watchdog.
Without a CUDA device the script exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 1234
CONFIG = "kuka14"
INDEXES = list(range(2000, 2008))
FAILING = 2006
PROTOCOL = dict(batch=500, t_max=500, k=30)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_port_fallback: no CUDA device; this script needs one H100", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from chip_smoke import card_line, print_group_stats

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn, eval_gnn_batched
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.ops import capsule

    card = card_line()
    print(f"card: {card}", flush=True)
    env, model, _, model_s, _ = str2name(CONFIG, device="cuda")
    capsule.load_library()

    for name in capsule.LAUNCHES:
        capsule.LAUNCHES[name] = 0
    stats, rows_b = [], []
    t0 = time.perf_counter()
    eval_gnn_batched(CONFIG, SEED, env, INDEXES, model, model_s, lanes=len(INDEXES),
                     stats=stats, rows=rows_b, **PROTOCOL)
    torch.cuda.synchronize()
    t_batched = time.perf_counter() - t0
    counts = dict(capsule.LAUNCHES)
    for name, n in counts.items():
        print(f"{name} launches on the {CONFIG} batched path: {n}", flush=True)
    print_group_stats(CONFIG, stats)
    for row in rows_b:
        print(f"batched {json.dumps(row)}", flush=True)
    fallbacks = sum(s.get("scalar_fallbacks", 0) for s in stats)
    print(f"{CONFIG} batched {len(INDEXES)} problems, {fallbacks} through the scalar "
          f"fallback: {t_batched:.2f} s ({card})", flush=True)

    rows_s = []
    t0 = time.perf_counter()
    eval_gnn(CONFIG, SEED, env, [FAILING], model=model, model_s=model_s, rows=rows_s,
             **PROTOCOL)
    torch.cuda.synchronize()
    t_scalar = time.perf_counter() - t0
    print(f"scalar {json.dumps(rows_s[0])}", flush=True)
    print(f"{CONFIG} scalar eval_gnn of problem {FAILING} alone: {t_scalar:.2f} s ({card})",
          flush=True)

    fb = next(r for r in rows_b if r["index"] == FAILING)
    same = all(fb[k] == rows_s[0][k] for k in ("success", "c_explore", "c_smooth"))
    print(f"fallback row of {FAILING} equals the scalar row: {same}", flush=True)
    if fallbacks < 1:
        raise AssertionError("no lane went through the scalar fallback")
    if counts["capsules_hit"] <= 0:
        raise AssertionError("the batched kuka14 path never launched capsules_hit")
    if not same:
        raise AssertionError(f"the fallback row of {FAILING} differs from the scalar row")
    return 0


if __name__ == "__main__":
    sys.exit(main())
