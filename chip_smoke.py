#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each bracketed by a progress line with the elapsed seconds:

0. card and build: the card's name and power limit, the torch and CUDA
   versions; the capsule kernels' source (plain ``nvcc``, both entry
   points) and the native float64 core (``g++``) are built in parallel into
   ``build/torch_port/``; the ``-Xptxas -v`` lines (registers, spills) of
   both entry points, at each width of lane group, are printed.
1. each entry point against its plain PyTorch version on the card (B =
   4096 runs groups of 16 lanes a configuration, smaller batches whole
   warps, ``ops/capsule.py::lanes_for``). ``capsules_hit`` (entry A): two random scenes and real kuka7 capsules at
   B = 4096, C = 24, O = 16. ``chain_states_free`` (entry B): kuka7 problem
   2000 and the kuka13 chain (J = 13, C = 42) in kuka13 problem 2000's
   scene, each at every batch its main path gives the kernel (B = 4096,
   2 + k_max = 31 or 41, and 1), configurations uniform in the
   joint limits with every 20th outside them (and a NaN row), with and
   without the endpoint output. Decisions and check counts must be equal;
   the largest difference of the kernel's capsule endpoints from
   ``capsules_world`` is printed.
2. end to end: ``eval_gnn("kuka7")`` at full width (batch 500, k 30,
   t_max 500, seed 1234) on test problems 2000-2004. The launch counters,
   set to 0 just before, must show ``chain_states_free`` launched and
   ``capsules_hit`` not (the main path runs FK inside the fused kernel).
   The rows are printed beside those the JAX package recorded on the CPU
   (tests/data/torch_port_kuka7_jax_rows.json); a difference there is
   reported, not fatal (an order-of-summation difference can flip a
   near-tie argmax), but every path must be finite and join start to goal.
   Phase 1 also holds the maze oracle on the card against the same
   functions on the CPU: 4096 points and 4096 edges in 2-D (maze2easy
   problem 2000), 4096 sticks and 256 edges in 3-D (maze3 problem 2000);
   decisions and counts must be equal. And it holds the oracles of ur5,
   kuka14 and snake7 (problem 2000) at every batch their main paths give
   them (B = 4096, 2 + k_max and 1): each whole oracle with the kernel
   against the same oracle with the plain version of ``capsules_hit``, and
   entry A against its plain version on the very inputs the oracle gave it
   (ur5 C = 43, O = 16; kuka14 C = 48, O = 16; snake7 C = 10, O = the
   problem's occupied cells). Decisions and counts must be equal.
3. timing at the main path's batches, B = 4096 (flat projection), 31 (edge
   check) and 1 (goal state), kuka7 problem 2000: each entry point's
   wrapper against its plain version, and entry B against the composition
   it replaced (torch FK + entry A), CUDA events around 10 calls, median of
   21 after warm-up, in turns; the bare kernel of each entry, 200 launches
   through its C entry point; the bounds from this run's data. The bare
   kernels at each width of lane group: kuka7 problem 2000 at B = 1 to
   4096, and at B = 4096 kuka7 problem 2004 (6 active boxes) and kuka13
   problem 2000 (C = 42, 8 active boxes). Then seconds
   per stage of eval_gnn (a second pass over the same problems) and the
   device busy share of problem 2000 under torch.profiler.
4. end to end: ``eval_gnn`` on maze2easy, maze2hard, maze3 and kuka13 at
   full width, the first problems of each config's JAX rows fixture
   (tests/data/torch_port_<config>_jax_rows.json), printed beside them with
   the count that agrees (reported, as in phase 2); every path checked as
   in phase 2; kuka13 must launch ``chain_states_free`` and not
   ``capsules_hit``. Then, for maze2easy and maze3, seconds per stage (a
   second pass), the oracle's own seconds in a third pass that
   synchronises around every oracle call, and the oracle's time and aten
   ops per call at the main path's batches; for every config but
   maze2hard, the device busy share of its first problem under
   torch.profiler.
5. end to end: ``eval_gnn`` on ur5, kuka14 and snake7 at full width and at
   each config's protocol (snake7: t_max 2000, so problem 2004 runs more
   than one round), three problems each beside the JAX fixture rows, paths
   checked as in phase 2; each must launch ``capsules_hit`` (entry A, the
   box family) and not ``chain_states_free``. Then entry A's timing at B =
   4096 on each config's shapes, and for ur5 and snake7 the stage table,
   the synchronised-oracle pass and the oracle's ms and aten ops per call;
   the device busy share of each config's first problem.

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
INDEXES = [2000, 2001, 2002, 2003, 2004]
PHASE4_CONFIGS = ("maze2easy", "maze2hard", "maze3", "kuka13")
PHASE4_PROBLEMS = 3
# the configs whose box family goes through entry A, and their problems
PHASE5_PROBLEMS = {"ur5": [2000, 2001, 2002], "kuka14": [2000, 2001, 2002],
                   "snake7": [2000, 2001, 2004]}
# the configs whose oracle is the fused kernel (entry B)
FUSED_CONFIGS = ("kuka7", "kuka13")
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


def protocol(config: str) -> dict:
    """The reference protocol with the config's own overrides (snake7:
    t_max 2000)."""

    from gnn_motion_planning_tpu_torch.api.registry import scalar_overrides

    return {**dict(batch=500, t_max=500, k=30), **scalar_overrides(config)}


def chain_configs(env, batch: int, seed: int):
    """(batch, d) float32 configurations uniform in the env's limits, every
    20th row from row 10 on pushed outside them (one check, never free)."""

    import numpy as np
    import torch

    lo, hi = np.array(env.pose_range, np.float32).T
    qs = np.random.RandomState(seed).uniform(lo, hi, (batch, lo.shape[0])).astype(np.float32)
    qs[10::20] += hi - lo
    return torch.as_tensor(qs, device=env.device)


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
    """Entry A against the plain version on the same inputs; returns the
    number of differing decisions (must be 0)."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    got = capsule.capsules_hit(*args)
    want = capsule.capsules_hit_reference(*args)
    n_diff = int((got != want).sum())
    B, C = args[0].shape[:2]
    print(
        f"  capsules_hit {name}: B={B} C={C} O={args[3].shape[0]} "
        f"lanes={capsule.lanes_for(B)} hits={int(want.sum())} differing={n_diff}",
        flush=True,
    )
    return n_diff


def check_chain(name: str, env, qs):
    """Entry B against its plain version on the same inputs, with and
    without the endpoint output; returns (differing decisions and counts,
    largest endpoint difference from capsules_world over finite rows)."""

    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
    from gnn_motion_planning_tpu_torch.ops import capsule

    packed, scene = capsule.pack_chain(env.chain), env.device_scene()
    B, C = qs.shape[0], env.chain.cap_r.shape[0]
    want_free, want_cnt = capsule.chain_states_free_reference(qs, packed, scene)
    ends = (torch.empty(B, C, 3, device=qs.device), torch.empty(B, C, 3, device=qs.device))
    n_diff = 0
    for endpoints in (None, ends):
        free, cnt = capsule.chain_states_free(qs, packed, scene, endpoints=endpoints)
        n_diff += int((free != want_free).sum()) + int((cnt != want_cnt).sum())
    p0, p1, _ = capsules_world(env.chain, qs)
    rows = torch.isfinite(qs).all(dim=1)
    err = max(float((ends[0] - p0)[rows].abs().max()), float((ends[1] - p1)[rows].abs().max()))
    print(
        f"  chain_states_free {name}: B={B} J={packed.sizes[0]} C={C} "
        f"lanes={capsule.lanes_for(B)} "
        f"active={int(scene.mask.sum())} valid={int(want_cnt.sum())} "
        f"free={int(want_free.sum())} differing={n_diff} endpoint max diff={err:.3g}",
        flush=True,
    )
    return n_diff, err


@contextlib.contextmanager
def plain_box_family(env, record: list):
    """Run the env's oracle with the plain version of ``capsules_hit`` in
    place of the kernel; ``record`` receives the arguments of every call."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    module = sys.modules[type(env).__module__]

    def plain(*args):
        record.append(args)
        return capsule.capsules_hit_reference(*args)

    module.capsules_hit = plain
    try:
        yield
    finally:
        module.capsules_hit = capsule.capsules_hit


def check_env_oracle(config: str, env, qs):
    """An entry-A env's oracle with the kernel against the same oracle with
    the plain version, and entry A against its plain version on the inputs
    the oracle gave it. Returns (differing oracle decisions and counts,
    differing kernel decisions, entry A's inputs)."""

    kern, scene = env.kernels(), env.device_scene()
    calls: list = []
    with plain_box_family(env, calls):
        want_free, want_cnt = kern.batch_state_free(scene, qs)
    free, cnt = kern.batch_state_free(scene, qs)
    n_oracle = int((free != want_free).sum()) + int((cnt != want_cnt).sum())
    print(f"  {config} oracle problem {env.index}: B={len(qs)} valid={int(want_cnt.sum())} "
          f"free={int(want_free.sum())} differing={n_oracle}", flush=True)
    n_kernel = sum(check_kernel(f"{config} problem {env.index}", args) for args in calls)
    return n_oracle, n_kernel, calls[0]


def time_turns(fns: dict, reps: int = 21, calls: int = 10, warmup: int = 3) -> dict:
    """Median ms per call of each function: CUDA events around ``calls``
    back-to-back calls, ``reps`` times each, in turns (a b c, c b a, ...)."""

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

    names = list(fns)
    for _ in range(warmup):
        for name in names:
            fns[name]()
    times: dict = {name: [] for name in names}
    for i in range(reps):
        for name in names if i % 2 == 0 else names[::-1]:
            times[name].append(once(fns[name]))
    return {name: sorted(t)[len(t) // 2] for name, t in times.items()}


def bare_ms(launch, calls: int = 200) -> float:
    """ms per launch of a bare kernel: CUDA events around ``calls``
    back-to-back launches through its C entry point, without the wrapper's
    checks and allocation, so the card and not the host sets the pace."""

    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        err = launch()
        if err:
            raise RuntimeError(f"kernel launch failed: cudaError {err}")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def count_ops(fn) -> int:
    """Top-level aten ops one call of fn queues (torch.profiler, host side)."""

    import torch

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None)


def pairs_needed(contacts):
    """(B,) pairs a configuration needs in the kernels' order: up to its
    first contact, capsule-major, or all C x A when there is none."""

    import torch

    flat = contacts.flatten(1)
    n = flat.shape[1]
    first = torch.where(flat.any(dim=1), flat.int().argmax(dim=1) + 1, n)
    return first.to(torch.int64)


def bound_ms(flops: float, nbytes: float):
    """(bound ms, "operations" or "bytes") at the H100's fp32 and HBM peaks."""

    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def bare_launchers(env, batch: int, seed: int):
    """Bare launches of both entry points at ``batch`` configurations uniform
    in the limits, in the env's current scene: (entry A's launch, entry B's
    launch), each taking the lane-group width, and the inputs (qs, entry A's
    arguments, the packed chain)."""

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
    from gnn_motion_planning_tpu_torch.ops import capsule

    chain, scene = env.chain, env.device_scene()
    packed = capsule.pack_chain(chain)
    J, C, dof = packed.sizes
    O = scene.centers.shape[0]
    lo, hi = chain.lower.cpu().numpy(), chain.upper.cpu().numpy()
    qs = np.random.RandomState(seed).uniform(lo, hi, (batch, dof))
    qs = torch.as_tensor(qs.astype(np.float32), device=env.device)
    p0, p1, r = capsules_world(chain, qs)
    args_a = (p0.contiguous(), p1.contiguous(), r, scene.centers, scene.halfs, scene.mask)
    lib = capsule.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(batch, dtype=torch.bool, device=env.device)
    cnt = torch.empty(batch, dtype=torch.int32, device=env.device)
    ptr = [x.data_ptr() for x in args_a]

    def launch_a(lanes):
        return lib.capsules_hit_launch(*ptr, batch, C, O, out.data_ptr(), lanes, stream)

    def launch_b(lanes):
        return lib.chain_states_free_launch(
            qs.data_ptr(), batch, dof, packed.floats.data_ptr(), packed.ints.data_ptr(), J, C,
            scene.centers.data_ptr(), scene.halfs.data_ptr(), scene.mask.data_ptr(), O,
            out.data_ptr(), cnt.data_ptr(), None, None, lanes, stream)

    return launch_a, launch_b, (qs, args_a, packed)


def lane_sweep(name: str, env, batch: int = 4096) -> dict:
    """Bare ms of both entry points at each width of lane group, in turns."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    launch_a, launch_b, _ = bare_launchers(env, batch, seed=batch)
    choices = capsule.LANE_CHOICES
    times: dict = {}
    for i in range(5):
        for lanes in choices if i % 2 == 0 else choices[::-1]:
            for entry, launch in (("A", launch_a), ("B", launch_b)):
                times.setdefault((entry, lanes), []).append(
                    bare_ms(lambda: launch(lanes)))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    print(f"  lanes sweep {name} B={batch} active={int(env.device_scene().mask.sum())}: " +
          "; ".join(f"{entry} at {lanes} lanes {med[(entry, lanes)]:.4f} ms"
                    for entry in "AB" for lanes in choices), flush=True)
    return med


def time_batch(env, batch: int, card: str) -> dict:
    """Both entry points at one batch of configurations uniform in the limits,
    in the env's current scene: wrapper, plain version, bare kernel, bounds
    from this data."""

    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
    from gnn_motion_planning_tpu_torch.ops import capsule

    chain, scene = env.chain, env.device_scene()
    launch_a, launch_b, (qs, args_a, packed) = bare_launchers(env, batch, seed=batch)
    J, C, dof = packed.sizes
    O = scene.centers.shape[0]
    lo, hi = chain.lower, chain.upper

    def torch_fk_and_entry_a():
        # the oracle before the fused kernel: limits, torch FK, entry A
        valid = ((qs >= lo) & (qs <= hi)).all(dim=1)
        e0, e1, er = capsules_world(chain, qs)
        hit = capsule.capsules_hit(e0.contiguous(), e1.contiguous(), er, scene.centers,
                                   scene.halfs, scene.mask)
        return valid & ~hit, valid.to(torch.int32)

    t = time_turns({
        "B": lambda: capsule.chain_states_free(qs, packed, scene),
        "B plain": lambda: capsule.chain_states_free_reference(qs, packed, scene),
        "torch FK + A": torch_fk_and_entry_a,
    })
    t.update(time_turns({
        "A": lambda: capsule.capsules_hit(*args_a),
        "A plain": lambda: capsule.capsules_hit_reference(*args_a),
    }))

    t["B ops"] = count_ops(lambda: capsule.chain_states_free(qs, packed, scene))
    t["torch FK + A ops"] = count_ops(torch_fk_and_entry_a)

    t["A bare"] = bare_ms(lambda: launch_a(capsule.lanes_for(batch)))
    t["B bare"] = bare_ms(lambda: launch_b(capsule.lanes_for(batch)))

    # work this run's data needs, in the kernels' order: pairs up to the
    # first contact; entry B skips FK and pairs of out-of-limit states
    n_active = int(scene.mask.sum())
    pairs = pairs_needed(capsule.capsule_contacts(*args_a))
    valid = ((qs >= lo) & (qs <= hi)).all(dim=1)
    ops_a = int(pairs.sum()) * capsule.OPS_PER_PAIR
    ops_b = (batch * dof * capsule.OPS_PER_DOF + int(valid.sum()) * (
        J * capsule.OPS_PER_JOINT + C * capsule.OPS_PER_CAPSULE)
        + int(pairs[valid].sum()) * capsule.OPS_PER_PAIR)
    scene_bytes = 4 * 6 * O + O
    bytes_a = 4 * (2 * batch * C * 3 + C) + scene_bytes + batch
    bytes_b = 4 * batch * dof + 4 * sum(capsule.packed_lengths(J, C, dof)) + \
        scene_bytes + batch * 5
    t["A bound"], t["A bound_by"] = bound_ms(ops_a, bytes_a)
    t["B bound"], t["B bound_by"] = bound_ms(ops_b, bytes_b)
    all_pair_ops = batch * C * n_active * capsule.OPS_PER_PAIR
    t["A bound all pairs"], _ = bound_ms(all_pair_ops, bytes_a)
    t["B bound all pairs"], _ = bound_ms(
        all_pair_ops + batch * (J * capsule.OPS_PER_JOINT + C * capsule.OPS_PER_CAPSULE
                              + dof * capsule.OPS_PER_DOF), bytes_b)
    print(
        f"  B={batch} (kuka7 problem {env.index}, C={C} active={n_active}, "
        f"pairs needed {int(pairs.sum())} of {batch * C * n_active}; {card})\n"
        f"    capsules_hit: wrapper {t['A']:.4f} ms, bare {t['A bare']:.4f} ms, "
        f"plain {t['A plain']:.4f} ms, bound {t['A bound']:.3g} ms ({t['A bound_by']}; "
        f"all pairs {t['A bound all pairs']:.3g} ms)\n"
        f"    chain_states_free: wrapper {t['B']:.4f} ms, bare {t['B bare']:.4f} ms, "
        f"plain {t['B plain']:.4f} ms, torch FK + capsules_hit {t['torch FK + A']:.4f} ms, "
        f"bound {t['B bound']:.3g} ms ({t['B bound_by']}; all pairs "
        f"{t['B bound all pairs']:.3g} ms)\n"
        f"    aten ops queued per call: chain_states_free {t['B ops']}, "
        f"torch FK + capsules_hit {t['torch FK + A ops']}",
        flush=True,
    )
    return t


def time_entry_a(config: str, args, card: str) -> dict:
    """Entry A on one oracle call's inputs: wrapper and plain version (CUDA
    events around 10 calls, median of 21, in turns), the bare kernel (200
    launches through its C entry point) and the bound from this data."""

    import torch

    from gnn_motion_planning_tpu_torch.ops import capsule

    B, C = args[0].shape[:2]
    O = args[3].shape[0]
    t = time_turns({"A": lambda: capsule.capsules_hit(*args),
                    "A plain": lambda: capsule.capsules_hit_reference(*args)})
    lib = capsule.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty(B, dtype=torch.bool, device=args[0].device)
    ptr = [x.data_ptr() for x in args]
    t["A bare"] = bare_ms(lambda: lib.capsules_hit_launch(
        *ptr, B, C, O, out.data_ptr(), capsule.lanes_for(B), stream))
    n_active = int(args[5].sum())
    pairs = int(pairs_needed(capsule.capsule_contacts(*args)).sum())
    nbytes = 4 * (2 * B * C * 3 + C) + 4 * 6 * O + O + B
    t["A bound"], t["A bound_by"] = bound_ms(pairs * capsule.OPS_PER_PAIR, nbytes)
    print(f"  capsules_hit {config}: B={B} C={C} O={O} active={n_active} pairs needed {pairs} "
          f"of {B * C * n_active}: wrapper {t['A']:.4f} ms, bare {t['A bare']:.4f} ms, "
          f"plain {t['A plain']:.4f} ms, bound {t['A bound']:.3g} ms ({t['A bound_by']}; "
          f"{card})", flush=True)
    return t


def stage_breakdown(config: str, env, model, model_s, indexes, oracle: bool = False) -> dict:
    """Seconds per stage of eval_gnn over ``indexes``, from host clocks
    around each stage with a device synchronise on both sides (a second
    pass over the same problems, after the main path's own run). With
    ``oracle``, the env's oracle calls are timed the same way too, which
    adds a synchronise to every search pop: their sum bounds the oracle's
    share from above."""

    import torch

    from gnn_motion_planning_tpu_torch.api import eval_gnn as evaluation

    totals: dict = {}

    def timed(name, fn):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            totals[name] = totals.get(name, 0.0) + time.perf_counter() - t0
            totals[name + " calls"] = totals.get(name + " calls", 0) + 1
            return out
        return wrapper

    saved_kernels, saved_planner = env._kernels, getattr(env, "_torch_planner", None)
    if oracle:
        kern = env.kernels()
        env._kernels = kern._replace(
            edge_free=timed("oracle edge_free", kern.edge_free),
            batch_state_free=timed("oracle state_free", kern.batch_state_free))
        env._torch_planner = None
    planner = evaluation.get_planner(env)
    saved = (evaluation.build_rgg_edges, evaluation.explorer_forward, evaluation.smoother_forward,
             planner.round_core, planner.project_cheap)
    evaluation.build_rgg_edges = timed("rgg build", evaluation.build_rgg_edges)
    evaluation.explorer_forward = timed("explorer forward", evaluation.explorer_forward)
    evaluation.smoother_forward = timed("smoother forward", evaluation.smoother_forward)
    planner.round_core = timed("greedy search", planner.round_core)
    planner.project_cheap = timed("projection", planner.project_cheap)
    env.sample_n_points = timed("host sampling", env.sample_n_points)
    t0 = time.perf_counter()
    try:
        evaluation.eval_gnn(config, SEED, env, indexes, model=model, model_s=model_s,
                            **protocol(config))
    finally:
        (evaluation.build_rgg_edges, evaluation.explorer_forward, evaluation.smoother_forward,
         planner.round_core, planner.project_cheap) = saved
        del env.sample_n_points
        env._kernels, env._torch_planner = saved_kernels, saved_planner
    totals["all"] = time.perf_counter() - t0
    return totals


def print_stages(config: str, totals: dict, n: int, card: str) -> None:
    """Per-problem seconds (and calls) of each stage of ``n`` problems."""

    for stage, secs in totals.items():
        if not stage.endswith(" calls"):
            calls = totals.get(stage + " calls")
            extra = f" ({calls / n:.1f} calls)" if calls else ""
            print(f"  stage {config} {stage}: {secs / n:.4f} s per problem{extra}", flush=True)
    print(f"  ({config}: {n} problems, {card})", flush=True)


def fixture_rows(config: str) -> list:
    path = REPO / "tests" / "data" / f"torch_port_{config}_jax_rows.json"
    return json.loads(path.read_text())["rows"]


def report_rows(config: str, env, rows, smooth_paths) -> int:
    """Print each port row beside the JAX row of the same problem; check
    every path (finite, from the start, into the goal region). Returns the
    number of rows that agree with the JAX package."""

    import numpy as np

    jax_rows = {r["index"]: r for r in fixture_rows(config)}
    agree = 0
    for row, smooth_path in zip(rows, smooth_paths):
        ref = jax_rows.get(row["index"])
        same = ref is not None and all(
            row[k] == ref[k] for k in ("success", "c_explore", "c_smooth")
        ) and abs(row["cost"] - ref["cost"]) < 1e-3
        agree += same
        print(f"  port {json.dumps(row)}", flush=True)
        print(f"  jax  {json.dumps(ref)} {'agree' if same else 'DIFFER'}", flush=True)
        if not math.isfinite(row["cost"]):
            raise AssertionError(f"{config} problem {row['index']}: cost is not finite")
        if row["success"]:
            p = np.asarray(smooth_path)
            env.init_new_problem(row["index"])
            if p.ndim != 2 or p.shape[1] != env.config_dim or not np.isfinite(p).all():
                raise AssertionError(f"{config} problem {row['index']}: bad path {p.shape}")
            if not np.allclose(p[0], env.init_state, atol=1e-5):
                raise AssertionError(f"{config} problem {row['index']}: path does not start at init")
            if np.asarray(env.distance(p[-1], env.goal_state)).max() >= env.RRT_EPS:
                raise AssertionError(f"{config} problem {row['index']}: path does not reach the goal")
    print(f"  {config}: rows agreeing with the JAX package: {agree} of {len(rows)}", flush=True)
    return agree


def maze_inputs(dim: int, seed: int, n_states: int, n_edges: int):
    """Float32 states and edge endpoints for the maze oracle: uniform in
    slightly more than the limits (some invalid); in 2-D a quarter of the
    points on a cell boundary or one float32 step beside it, in 3-D half
    the edges short hops."""

    import numpy as np

    rng = np.random.RandomState(seed)
    lim = np.array([1.05, 1.05, 0.42])[:dim]
    states = rng.uniform(-lim, lim, (n_states, dim)).astype(np.float32)
    qa = rng.uniform(-lim, lim, (n_edges, dim)).astype(np.float32)
    qb = rng.uniform(-lim, lim, (n_edges, dim)).astype(np.float32)
    if dim == 2:
        m = n_edges // 4
        edge = (-1 + 2 * rng.randint(0, 16, (m, 2)) / 15).astype(np.float32)
        qa[:m] = np.nextafter(edge, edge + rng.choice(np.array([-1, 0, 1], np.float32), (m, 2)))
    else:
        h = n_edges // 2
        qb[:h] = qa[:h] + rng.uniform(-0.12, 0.12, (h, 3)).astype(np.float32)
    return states, qa, qb


def check_maze_oracle(dev) -> int:
    """The maze oracle on the card against the same functions on the CPU;
    returns the number of differing decisions and counts (must be 0)."""

    import torch

    from gnn_motion_planning_tpu_torch.envs import maze

    n_diff = 0
    for dim, n_edges, fns in ((2, 4096, (maze.point_free_2d, maze.edge_free_2d)),
                              (3, 256, (maze.stick_free_3d, maze.edge_free_3d))):
        env = maze.MazeEnv(dim=dim, device="cpu")
        env.init_new_problem(2000)
        occ = env.device_scene()
        states, qa, qb = maze_inputs(dim, 6 + dim, 4096, n_edges)
        for fn, args in ((fns[0], (states,)), (fns[1], (qa, qb))):
            want = fn(occ, *(torch.as_tensor(x) for x in args))
            got = [x.cpu() for x in fn(occ.to(dev), *(torch.as_tensor(x, device=dev) for x in args))]
            diff = int((got[0] != want[0]).sum()) + int((got[1] != want[1]).sum())
            n_diff += diff
            print(f"  {fn.__name__} maze{dim} problem 2000: B={len(args[0])} "
                  f"free={int(want[0].sum())} checks={int(want[1].sum())} "
                  f"max checks={int(want[1].max())} differing={diff}", flush=True)
    return n_diff


def device_busy_share(config: str, env, model, model_s, index: int, card: str) -> None:
    """Device busy share of one problem: the summed time of the device
    events in a torch.profiler trace of eval_gnn (device activity only,
    which keeps the trace small) over the problem's wall time (host clock,
    synchronised). The profiler slows the host, so the share reads low
    rather than high."""

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eval_gnn(config, SEED, env, [index], model=model, model_s=model_s, **protocol(config))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not device:
        print(f"  device busy share {config} problem {index}: not measured "
              f"(no device events in the trace)", flush=True)
        return
    busy = sum(e.time_range.elapsed_us() for e in device) / 1e6
    print(f"  device busy share {config} problem {index}: {busy:.4f} s of device events "
          f"({len(device)} events) in {wall:.4f} s, {100 * busy / wall:.1f} % "
          f"(profiled; {card})", flush=True)


def time_oracle(env, card: str) -> None:
    """ms per call of the env's oracle at the main path's batches, CUDA
    events around 10 calls, median of 21, and aten ops queued per call.
    Mazes: the edge check at E = 1 (a search pop) and 192 (a projection step
    of a 64-slot path). Arms: the edge check at E = 1 (2 + k_max states) and
    the state oracle at B = 4096 (the flat projection)."""

    import torch

    kern = env.kernels()
    scene = env.device_scene()
    if kern.bounds is None:
        _, qa, qb = maze_inputs(env.config_dim, 11, 1, 192)
        qa, qb = torch.as_tensor(qa, device=env.device), torch.as_tensor(qb, device=env.device)
        fns = {f"edge_free E={E}": (lambda E=E: kern.edge_free(scene, qa[:E], qb[:E]))
               for E in (1, 192)}
    else:
        qs = chain_configs(env, 4096, seed=11)
        fns = {"edge_free E=1": lambda: kern.edge_free(scene, qs[:1], qs[1:2]),
               "state_free B=4096": lambda: kern.batch_state_free(scene, qs)}
    t = time_turns(fns)
    ops = {name: count_ops(fn) for name, fn in fns.items()}
    print(f"  oracle {env}: " + "; ".join(
        f"{name} {t[name]:.4f} ms, {ops[name]} aten ops" for name in fns) + f" ({card})", flush=True)


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

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2name
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
    from gnn_motion_planning_tpu_torch.ops import capsule
    from gnn_motion_planning_tpu_torch.utils import geomcore
    from gnn_motion_planning_tpu_torch.utils.build import BUILD_LOGS, BUILD_SECONDS

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
        for line in BUILD_LOGS["capsules_hit"].splitlines():  # nvcc -Xptxas -v
            if line.strip():
                print(f"  {line.strip()}", flush=True)

    with phase("1 kernels against plain versions"):
        env, model, _, model_s, _ = str2name("kuka7", device=dev)
        env.init_new_problem(INDEXES[0])
        main_args = kuka7_scene(env, 4096)
        diffs = [check_kernel(f"random scene seed {seed}", random_scene(seed, dev)) for seed in (0, 1)]
        diffs.append(check_kernel("kuka7 problem 2000", main_args))
        # decisions are 0/1, so the largest absolute error is 1 if any differ
        max_abs_err = {"capsules_hit": int(max(diffs) > 0)}
        if max_abs_err["capsules_hit"]:
            raise AssertionError(f"capsules_hit and its plain version differ on {diffs} decisions")

        env13 = KukaEnv(kuka_file="kuka_iiwa/model_3.urdf",
                        map_file="maze_files/kukas_13_3000.pkl", device=dev)
        env13.init_new_problem(INDEXES[0])
        checks = []
        # every batch the main paths give the kernel: the flat projection,
        # one search pop's edge (2 + k_max states) and the goal test
        for arm, arm_env, seed in (("kuka7", env, 0), ("kuka13", env13, 13)):
            for batch in (4096, 2 + arm_env._k_max(), 1):
                qs = chain_configs(arm_env, batch, seed=seed + batch)
                if batch == 4096:
                    qs[7, 3] = float("nan")  # NaN is out of limits
                checks.append(check_chain(f"{arm} problem 2000 B={batch}", arm_env, qs))
        n_chain_diff = sum(n for n, _ in checks)
        max_abs_err["chain_states_free"] = int(n_chain_diff > 0)
        print(f"  chain_states_free endpoint max diff from capsules_world: "
              f"{max(e for _, e in checks):.3g}", flush=True)
        if n_chain_diff:
            raise AssertionError(
                f"chain_states_free and its plain version differ: {[n for n, _ in checks]}")
        n_maze_diff = check_maze_oracle(dev)
        if n_maze_diff:
            raise AssertionError(f"the maze oracle differs between the card and the CPU: {n_maze_diff}")

        # the entry-A envs at every batch their main paths give the oracle:
        # the flat projection, one search pop's edge and the goal test
        arm_envs, entry_a_inputs, n_env_diff, n_a_diff = {}, {}, [], []
        for config in PHASE5_PROBLEMS:
            arm_env, arm_model, _, arm_model_s, _ = str2name(config, device=dev)
            arm_env.init_new_problem(2000)
            arm_envs[config] = (arm_env, arm_model, arm_model_s)
            for batch in (4096, 2 + arm_env._k_max(), 1):
                qs = chain_configs(arm_env, batch, seed=len(config) + batch)
                n_oracle, n_kernel, args = check_env_oracle(config, arm_env, qs)
                n_env_diff.append(n_oracle)
                n_a_diff.append(n_kernel)
                entry_a_inputs.setdefault(config, args)
        max_abs_err["capsules_hit"] = int(max(diffs + n_a_diff) > 0)
        if sum(n_env_diff) or sum(n_a_diff):
            raise AssertionError(
                f"ur5, kuka14, snake7 with the kernel and the plain version differ: oracle "
                f"{n_env_diff}, capsules_hit {n_a_diff}")

    def main_path(config, env, model, model_s, indexes):
        """eval_gnn on one config with the launch counts set to 0 just
        before and read just after; the rows are reported."""

        for name in capsule.LAUNCHES:
            capsule.LAUNCHES[name] = 0
        rows: list = []
        out = eval_gnn(config, SEED, env, indexes, model=model, model_s=model_s, rows=rows,
                       **protocol(config))
        counts = dict(capsule.LAUNCHES)
        for name, n in counts.items():
            print(f"  {name} launches on the {config} main path: {n}", flush=True)
        if config in FUSED_CONFIGS:
            if counts["chain_states_free"] <= 0:
                raise AssertionError(f"the {config} main path never launched chain_states_free")
            if counts["capsules_hit"] != 0:
                raise AssertionError(
                    f"the {config} main path ran torch FK and capsules_hit, not the fused kernel")
        if config in PHASE5_PROBLEMS:
            if counts["capsules_hit"] <= 0:
                raise AssertionError(f"the {config} main path never launched capsules_hit")
            if counts["chain_states_free"] != 0:
                raise AssertionError(f"the {config} main path launched chain_states_free")
        report_rows(config, env, rows, out[6])
        if out[0] == 0:
            raise AssertionError(f"{config}: no problem solved")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n

    launches: dict = {}  # summed over the main paths of phases 2 and 4
    with phase("2 eval_gnn kuka7 end to end"):
        main_path("kuka7", env, model, model_s, INDEXES)

    with phase("3 timing"):
        env.init_new_problem(INDEXES[0])  # phase 2 left the env on another problem
        timings = {batch: time_batch(env, batch, card) for batch in (4096, 31, 1)}
        for batch in (1, 31, 256, 1024, 2048, 4096):
            lane_sweep("kuka7 problem 2000", env, batch)
        env.init_new_problem(INDEXES[-1])
        lane_sweep(f"kuka7 problem {INDEXES[-1]}", env)
        env.init_new_problem(INDEXES[0])
        lane_sweep("kuka13 problem 2000", env13)
        del env13
        print_stages("kuka7", stage_breakdown("kuka7", env, model, model_s, INDEXES),
                     len(INDEXES), card)
        device_busy_share("kuka7", env, model, model_s, INDEXES[0], card)

    with phase("4 eval_gnn maze2easy, maze2hard, maze3, kuka13 end to end"):
        for config in PHASE4_CONFIGS:
            env, model, _, model_s, _ = str2name(config, device=dev)
            indexes = [r["index"] for r in fixture_rows(config)][:PHASE4_PROBLEMS]
            main_path(config, env, model, model_s, indexes)
            if config in ("maze2easy", "maze3"):
                print_stages(config, stage_breakdown(config, env, model, model_s, indexes),
                             len(indexes), card)
                print_stages(f"{config} synchronised oracle",
                             stage_breakdown(config, env, model, model_s, indexes, oracle=True),
                             len(indexes), card)
                time_oracle(env, card)
            if config != "maze2hard":  # its problem 0 alone is a 6 s trace
                device_busy_share(config, env, model, model_s, indexes[0], card)

    with phase("5 eval_gnn ur5, kuka14, snake7 end to end"):
        for config, indexes in PHASE5_PROBLEMS.items():
            env, model, model_s = arm_envs[config]
            main_path(config, env, model, model_s, indexes)
            time_entry_a(config, entry_a_inputs[config], card)
            if config in ("ur5", "snake7"):
                print_stages(config, stage_breakdown(config, env, model, model_s, indexes),
                             len(indexes), card)
                print_stages(f"{config} synchronised oracle",
                             stage_breakdown(config, env, model, model_s, indexes, oracle=True),
                             len(indexes), card)
                time_oracle(env, card)
            device_busy_share(config, env, model, model_s, indexes[0], card)

    faulthandler.cancel_dump_traceback_later()
    at_4096 = timings[4096]
    source = "gnn_motion_planning_tpu_torch/csrc/capsules_hit.cu"
    replaces = "gnn_motion_planning_tpu/ops/pallas_capsule.py:120"
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": max_abs_err[name],
        "ms": at_4096[key],
        "plain_ms": at_4096[f"{key} plain"],
        "bound_ms": at_4096[f"{key} bound"],
        "bound_by": at_4096[f"{key} bound_by"],
        "library_ms": None,
    } for name, key in (("capsules_hit", "A"), ("chain_states_free", "B"))]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
