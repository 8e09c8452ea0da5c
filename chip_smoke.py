#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each bracketed by a progress line with the elapsed seconds:

0. card and build: the card's name and power limit, the torch and CUDA
   versions; the capsule kernel (plain ``nvcc``) and the native float64
   core (``g++``) are built in parallel into ``build/torch_port/``.
1. the kernel against its plain PyTorch version on the card: two random
   scenes and real kuka7 capsules at the main path's batch (B = 4096,
   C = 24, O = 16). The decisions must be bit-equal.
2. end to end: ``eval_gnn("kuka7")`` at full width (batch 500, k 30,
   t_max 500, seed 1234) on test problems 2000-2004. The kernel's launch
   counter, set to 0 just before, must be above 0 after. The rows are
   printed beside those the JAX package recorded on the CPU
   (tests/data/torch_port_kuka7_jax_rows.json); a difference there is
   reported, not fatal (an order-of-summation difference can flip a
   near-tie argmax), but every path must be finite and join start to goal.
3. timing at B = 4096, C = 24, O = 16: the wrapper and the plain version,
   CUDA events around 10 calls, median of 21 after warm-up, in turns; and
   the bare kernel, 200 launches through its C entry point. Then seconds
   per stage of eval_gnn (a second pass over the same problems).

A watchdog ends a stalled run with every thread's stack and a non-zero
exit. Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result. Its last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

WATCHDOG_SECONDS = 480
REPO = Path(__file__).resolve().parent
JAX_ROWS = REPO / "tests" / "data" / "torch_port_kuka7_jax_rows.json"
INDEXES = [2000, 2001, 2002, 2003, 2004]
SEED = 1234
# H100 SXM peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

_T0 = time.perf_counter()


def _elapsed() -> float:
    return time.perf_counter() - _T0


@contextlib.contextmanager
def phase(name: str):
    print(f"[phase] {name} start t={_elapsed():.1f}s", flush=True)
    yield
    import torch

    torch.cuda.synchronize()
    print(f"[phase] {name} done t={_elapsed():.1f}s", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def random_scene(seed: int, device):
    """The scenes of tests/test_pallas_capsule.py::test_random_scenes_match_xla."""

    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    B, C, O = 200, 5, 7
    p0 = rng.uniform(-1, 1, (B, C, 3)).astype(np.float32)
    p1 = p0 + rng.uniform(-0.5, 0.5, (B, C, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.15, C).astype(np.float32)
    centers = rng.uniform(-0.8, 0.8, (O, 3)).astype(np.float32)
    halfs = rng.uniform(0.05, 0.4, (O, 3)).astype(np.float32)
    mask = rng.rand(O) > 0.3
    return tuple(torch.as_tensor(a, device=device) for a in (p0, p1, r, centers, halfs, mask))


def kuka7_scene(env, batch: int, seed: int = 0):
    """Capsules of ``batch`` uniform kuka7 configurations, with the scene of
    the env's current problem: (p0, p1, r, centers, halfs, mask)."""

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world

    pr = np.array(env.pose_range)
    qs = np.random.RandomState(seed).uniform(pr[:, 0], pr[:, 1], (batch, env.config_dim))
    q = torch.as_tensor(qs.astype(np.float32), device=env.device)
    p0, p1, r = capsules_world(env.chain, q)
    sc = env.device_scene()
    return p0.contiguous(), p1.contiguous(), r, sc.centers, sc.halfs, sc.mask


def check_kernel(name: str, args) -> int:
    """Kernel against the plain version on the same inputs; returns the
    number of differing decisions (must be 0)."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    got = capsule.capsules_hit(*args)
    want = capsule.capsules_hit_reference(*args)
    n_diff = int((got != want).sum())
    B, C = args[0].shape[:2]
    print(
        f"  {name}: B={B} C={C} O={args[3].shape[0]} hits={int(want.sum())} "
        f"differing={n_diff}",
        flush=True,
    )
    return n_diff


def time_pair(fn_a, fn_b, reps: int = 21, calls: int = 10, warmup: int = 3):
    """Median ms per call of fn_a and fn_b: CUDA events around ``calls``
    back-to-back calls, ``reps`` times each, in turns a b b a."""

    import torch

    def once(fn):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for _ in range(warmup):
        fn_a(), fn_b()
    ta, tb = [], []
    for i in range(reps):
        order = (fn_a, fn_b, fn_b, fn_a) if i % 2 == 0 else (fn_b, fn_a, fn_a, fn_b)
        for fn in order:
            (ta if fn is fn_a else tb).append(once(fn))
    return sorted(ta)[len(ta) // 2], sorted(tb)[len(tb) // 2]


def kernel_only_ms(args, calls: int = 200) -> float:
    """ms per launch of the bare kernel: CUDA events around ``calls``
    back-to-back launches through the C entry point, without the wrapper's
    checks and allocation, so the card and not the host sets the pace."""

    import torch

    from gnn_motion_planning_tpu_torch.ops import capsule

    p0, p1, r, centers, halfs, mask = args
    out = torch.zeros(p0.shape[0], dtype=torch.int32, device=p0.device)
    lib = capsule.load_library()
    ptrs = [t.data_ptr() for t in (p0, p1, r, centers, halfs, mask)]
    dims = (p0.shape[0], p0.shape[1], centers.shape[0])
    stream = torch.cuda.current_stream().cuda_stream
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        err = lib.capsules_hit_launch(*ptrs, *dims, out.data_ptr(), stream)
        if err:
            raise RuntimeError(f"capsules_hit launch failed: cudaError {err}")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def stage_breakdown(env, model, model_s) -> dict:
    """Seconds per stage of eval_gnn over INDEXES, from host clocks around
    each stage with a device synchronise on both sides (a second pass over
    the same problems, after the main path's own run)."""

    import torch

    from gnn_motion_planning_tpu_torch.api import eval_gnn as driver

    totals: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    planner = driver.get_planner(env)
    saved = (driver.build_rgg_edges, driver.explorer_forward, driver.smoother_forward,
             planner.round_core, planner.project_cheap, env.sample_n_points)
    driver.build_rgg_edges = timed("rgg build", driver.build_rgg_edges)
    driver.explorer_forward = timed("explorer forward", driver.explorer_forward)
    driver.smoother_forward = timed("smoother forward", driver.smoother_forward)
    planner.round_core = timed("greedy search", planner.round_core)
    planner.project_cheap = timed("projection", planner.project_cheap)
    env.sample_n_points = timed("host sampling", env.sample_n_points)
    t0 = time.perf_counter()
    try:
        driver.eval_gnn("kuka7", SEED, env, INDEXES, model=model, model_s=model_s,
                        batch=500, t_max=500, k=30)
    finally:
        (driver.build_rgg_edges, driver.explorer_forward, driver.smoother_forward,
         planner.round_core, planner.project_cheap) = saved[:5]
        del env.sample_n_points
    totals["all"] = time.perf_counter() - t0
    return totals


def main() -> int:
    faulthandler.dump_traceback_later(WATCHDOG_SECONDS, exit=True)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one H100", file=sys.stderr)
        return 2
    if not (REPO / "gnn_motion_planning_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    import numpy as np

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.ops import capsule
    from gnn_motion_planning_tpu_torch.utils import geomcore
    from gnn_motion_planning_tpu_torch.utils.build import BUILD_SECONDS

    dev = torch.device("cuda")
    card = card_line()

    with phase("0 card and build"):
        print(f"  card: {card}", flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}",
              flush=True)
        with ThreadPoolExecutor(max_workers=2) as pool:
            builds = [pool.submit(capsule.load_library), pool.submit(geomcore.get_lib)]
            for b in builds:
                b.result()
        for name, secs in sorted(BUILD_SECONDS.items()):
            print(f"  built {name} in {secs:.2f}s", flush=True)

    with phase("1 kernel against plain version"):
        env, model, _, model_s, _ = str2name("kuka7", device=dev)
        env.init_new_problem(INDEXES[0])
        main_args = kuka7_scene(env, 4096)
        diffs = [check_kernel(f"random scene seed {seed}", random_scene(seed, dev)) for seed in (0, 1)]
        diffs.append(check_kernel("kuka7 problem 2000", main_args))
        # decisions are 0/1, so the largest absolute error is 1 if any differ
        max_abs_err = int(max(diffs) > 0)
        if max_abs_err:
            raise AssertionError(f"kernel and plain version differ on {diffs} decisions")

    with phase("2 eval_gnn kuka7 end to end"):
        capsule.LAUNCHES["capsules_hit"] = 0
        rows: list = []
        out = eval_gnn("kuka7", SEED, env, INDEXES, model=model, model_s=model_s,
                       batch=500, t_max=500, k=30, rows=rows)
        launches = capsule.LAUNCHES["capsules_hit"]
        print(f"  capsules_hit launches on the main path: {launches}", flush=True)
        if launches <= 0:
            raise AssertionError("the main path never launched capsules_hit")
        jax_rows = {r["index"]: r for r in json.loads(JAX_ROWS.read_text())["rows"]}
        agree = 0
        for row, smooth_path in zip(rows, out[6]):
            ref = jax_rows.get(row["index"])
            same = ref is not None and all(
                row[k] == ref[k] for k in ("success", "c_explore", "c_smooth")
            ) and abs(row["cost"] - ref["cost"]) < 1e-3
            agree += same
            print(f"  port {json.dumps(row)}", flush=True)
            print(f"  jax  {json.dumps(ref)} {'agree' if same else 'DIFFER'}", flush=True)
            if not math.isfinite(row["cost"]):
                raise AssertionError(f"problem {row['index']}: cost is not finite")
            if row["success"]:
                p = np.asarray(smooth_path)
                env.init_new_problem(row["index"])
                if p.ndim != 2 or p.shape[1] != env.config_dim or not np.isfinite(p).all():
                    raise AssertionError(f"problem {row['index']}: bad path {p.shape}")
                if not np.allclose(p[0], env.init_state, atol=1e-5):
                    raise AssertionError(f"problem {row['index']}: path does not start at init")
                if env.distance(p[-1], env.goal_state) >= env.RRT_EPS:
                    raise AssertionError(f"problem {row['index']}: path does not reach the goal")
        print(f"  rows agreeing with the JAX package: {agree} of {len(rows)}", flush=True)
        if out[0] == 0:
            raise AssertionError("no problem solved")

    with phase("3 timing"):
        p0, p1, r, centers, halfs, mask = main_args
        kernel_ms, plain_ms = time_pair(
            lambda: capsule.capsules_hit(*main_args),
            lambda: capsule.capsules_hit_reference(*main_args),
        )
        B, C = p0.shape[:2]
        n_active = int(mask.sum())
        flops = B * C * n_active * capsule.OPS_PER_PAIR
        O = centers.shape[0]
        # each input read once (p0, p1, r, centers, halfs, mask), the output written once
        nbytes = 4 * (2 * B * C * 3 + C + 2 * O * 3) + O + 4 * B
        ops_ms = flops / PEAK_FP32_FLOPS * 1e3
        bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        bare_ms = kernel_only_ms(main_args)
        for stage, secs in stage_breakdown(env, model, model_s).items():
            print(f"  stage {stage}: {secs / len(INDEXES):.4f} s per problem", flush=True)
        print(f"  capsules_hit B={B} C={C} O={O} active={n_active}: "
              f"wrapper {kernel_ms:.4f} ms per call, plain {plain_ms:.4f} ms per call, "
              f"bare kernel {bare_ms:.4f} ms per launch, bound {max(ops_ms, bytes_ms):.4f} ms "
              f"({card})", flush=True)

    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": [{
        "name": "capsules_hit",
        "route": "cuda",
        "source": "gnn_motion_planning_tpu_torch/csrc/capsules_hit.cu",
        "replaces": "gnn_motion_planning_tpu/ops/pallas_capsule.py:120",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
