"""Sharded evaluation sweeps: problems partitioned across processes, with
resumable partial results (port of
gnn_motion_planning_tpu/parallel/sharded_eval.py).

Evaluation is embarrassingly parallel over problem indexes, so a sweep (a)
shards the index range across processes (each worker owns a disjoint
range) and (b) checkpoints partial results so an interrupted sweep resumes
mid-range. Host numpy and pickle; the eval method runs on its env's device.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path

import numpy as np


def shard_indexes(indexes, n_shards: int, shard_id: int):
    """Deterministic contiguous partition of a problem index range."""

    indexes = np.asarray(indexes)
    chunks = np.array_split(indexes, n_shards)
    return chunks[shard_id]


def resumable_eval(
    method,
    str_name: str,
    seed: int,
    env,
    indexes,
    out_path: str,
    chunk: int = 50,
    **kwargs,
):
    """Run an eval method over `indexes` in chunks, checkpointing per-chunk
    partial metrics to `out_path` (resume skips finished chunks).

    The method is any reference-style driver (eval_gnn/eval_bit/...) whose
    leading return values are (n_success, collision, running_time,
    solution_cost, total_time, ...).
    """

    out = Path(out_path)
    state = {"done": [], "results": []}
    if out.exists():
        state = pickle.loads(out.read_bytes())

    indexes = np.asarray(indexes)
    for start in range(0, len(indexes), chunk):
        key = (int(indexes[start]), int(indexes[min(start + chunk, len(indexes)) - 1]))
        if key in state["done"]:
            continue
        part = indexes[start : start + chunk]
        result = method(str_name, seed, env, part, **kwargs)
        state["done"].append(key)
        state["results"].append((key, result[:5], len(part)))
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_bytes(pickle.dumps(state))

    # aggregate: success is a count, others are per-problem means weighted by
    # chunk sizes; total_time sums
    n_total = sum(n for _, _, n in state["results"])
    n_success = sum(r[0] for _, r, _ in state["results"])
    collision = sum(r[1] * n for _, r, n in state["results"]) / n_total
    total_time = sum(r[4] for _, r, _ in state["results"])
    running_time = (
        sum(r[2] * r[0] for _, r, _ in state["results"]) / n_success
        if n_success
        else float("nan")
    )
    solution_cost = (
        sum(r[3] * r[0] for _, r, _ in state["results"]) / n_success
        if n_success
        else float("nan")
    )
    summary = {
        "n_problems": int(n_total),
        "success": int(n_success),
        "collision": float(collision),
        "running_time": float(running_time),
        "path_cost": float(solution_cost),
        "total_time": float(total_time),
    }
    out.with_suffix(".json").write_text(json.dumps(summary, indent=1))
    return summary
