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
   problem's occupied cells). Decisions and counts must be equal. Then the
   lane axis (a launch takes L problems, each lane with its own scene) at
   the shapes the batched and serve paths give it: entry B on kuka7 and
   kuka14's oracle with entry A, at L = 25 and 8 lanes of one search pop's
   2 + k_max states and of 4,096 (the batched flat projection, which
   checks the successful lanes of a group at once), every lane its own
   problem (2000 on, whose active boxes differ), and L = 1 of 4,096 (the
   scalar flat projection) and of 2,000 (serve sampling), each against its
   plain version. And states 2**-17 to 2**-20 of a segment from
   a contact boundary (problems 2000 and 2001 of kuka7, ur5, kuka14 and
   snake7, bisected on the CPU): the kernel against its plain version; on
   the CPU's own capsule endpoints, the narrow phase on the card (entry
   A, its plain version, the pair families) against the CPU; and the whole
   oracle on the card, its own FK included, against the CPU (FK takes
   glibc's cos and sin and XLA's fused multiply-adds on every device:
   ``envs/kinematics.py``). All enforced.
3. timing at the main path's batches, B = 4096 (flat projection), 31 (edge
   check) and 1 (goal state), kuka7 problem 2000: each entry point's
   wrapper against its plain version, and entry B against the composition
   it replaced (torch FK + entry A), CUDA events around 10 calls, median of
   21 after warm-up (B = 31 and 1: 3 calls, median of 5), in turns; the bare kernel of each entry, 200 launches
   through its C entry point; the bounds from this run's data. The bare
   kernels at each width of lane group: kuka7 problem 2000 at B = 31 and
   4096, and at B = 4096 kuka7 problem 2004 (6 active boxes) and kuka13
   problem 2000 (C = 42, 8 active boxes). Then seconds
   per stage of eval_gnn (a second pass over the same problems) and the
   device busy share of problem 2000 under torch.profiler.
4. end to end: ``eval_gnn`` on maze2easy, maze2hard, maze3 and kuka13 at
   full width, the first three problems of each config's JAX rows fixture
   (tests/data/torch_port_<config>_jax_rows.json), printed beside them with
   the count that agrees (reported, as in phase 2); every path checked as
   in phase 2; kuka13 must launch ``chain_states_free`` and not
   ``capsules_hit``. Then, for maze2easy and maze3, seconds per stage (a
   second pass; maze3: its first problem) and the oracle's time and aten
   ops per call at the main path's batches; maze2easy's device busy share
   of its first problem under torch.profiler.
5. end to end: ``eval_gnn`` on ur5, kuka14 and snake7 at full width and at
   each config's protocol (snake7: t_max 2000), problems 2000-2001 and
   snake7's 2004 too (its search takes two rounds, the state carried from
   round to round, on an oracle through entry A) beside the JAX fixture
   rows, paths checked as in phase 2; each must launch ``capsules_hit`` (entry A, the
   box family) and not ``chain_states_free``. Then entry A's timing at B =
   4096 on each config's shapes, and for ur5 and snake7 the stage table
   (problem 2000) and the oracle's ms and aten ops per call; ur5's device
   busy share of problem 2000.

6. the batched sweep: ``eval_gnn_batched`` at each config's protocol on
   kuka7 (25 lanes, problems 2000-2024), kuka14 (7 lanes, 2000-2007 but
   2006, whose failing first round is an exhaustive search too long for
   the watchdog twice over: ``tools/torch_port_fallback.py`` runs that
   cell) and maze2easy (10 lanes, 2000-2009). The launch counts, set to 0 just before
   and read just after, must show ``chain_states_free`` on kuka7 and
   ``capsules_hit`` on kuka14. Rows 2000-2004 beside the JAX fixture rows
   (reported); every path checked; the stats of the first lane group;
   every batched row against the port's scalar ``eval_gnn`` row of the
   same problem in the same call (reported) and problems a second of both.
   Then the lane shapes' timing: both entries at kuka7's 25 x 31, 8 x 31,
   25 x 4,096, 8 x 4,096, 1 x 4,096 and 1 x 2,000, and entry A on kuka14's
   lane oracle inputs at the same shapes.
7. the serve path: ``eval_gnn_serve`` on kuka7 and maze2easy, problems
   2000-2009, with p50 and p95; kuka7's must launch
   ``chain_states_free``. On problem 2000 of each, ``serve_full`` against
   the composition it fuses (serve_round, host backtrack, model_smooth):
   checks equal, the path within 1e-6 and the smoothed path within 1e-5
   (enforced).
8. the baselines: ``eval_all`` on Maze_2D_Easy and Kuka_7D, one problem,
   all five methods (GNN, NEXT, BIT*, RRT*, LazySP) at the drivers'
   defaults; Kuka_7D's launches must include ``chain_states_free`` (only
   its GNN method reaches the kernel: its baselines check through the
   native core and NEXT's FK runs on the host). Then ``eval_bit``,
   ``eval_lazysp``, ``eval_rrt`` and ``eval_next`` (at T = UR5_NEXT_T) on
   ur5 problem 2000, and
   ``explore_batch`` without a model smoother (the oracle smoother) on ur5
   2000-2001: each must launch ``capsules_hit`` and not
   ``chain_states_free``, and each smoothed lane must have spent checks
   (on ur5 they can only go through the device oracle). Every returned
   path is finite and joins the start to the goal (a tree planner's ends in
   the goal region), and ur5's paths are collision-free under the oracle
   on the CPU. Rows beside the JAX fixture rows
   (tests/data/torch_port_{eval_all,baselines_ur5,oracle_smoother_ur5}_jax_
   rows.json), reported with the count that agrees; seconds per method and
   problem. Then the four baselines on snake7 problem 2000, through its own
   host protocol (NEXT at T = SNAKE7_NEXT_T: a minute or more at T =
   1000), each launching ``capsules_hit`` and not ``chain_states_free``,
   beside tests/data/torch_port_baselines_snake7_jax_rows.json (reported).

9. training, at the full width of the shipped models, from the committed
   data (tests/data/torch_port_prm_kuka7_8.pkl, the first 8 kuka7 PRM
   graphs; the full pickles do not reach the card): ``train_explorer`` on
   kuka7 (epoch 8, iter 2, batch 8), ``train_smoother`` on kuka7 (epoch 4,
   data_iter 1, train_iter 2, batch 2; its data pass must launch
   ``chain_states_free``) and ``train_next("maze2easy", T=40,
   n_problems=3, train_every=2)``: each loss sequence beside the JAX
   package's (tests/data/torch_port_training_jax.json; reported), the
   steps and replay sizes equal to the fixture's (enforced), ms a step in
   the loop and at steady state (CUDA events). Then the loss and every
   gradient leaf on the card against the CPU through the same port code,
   TF32 off (enforced: ``GRAD_RTOL``, ``GRAD_ATOL``): the explorer on the
   loop's 8 samples at loop 8, the smoother on 8 samples of the replay's
   paths at loop 4, NEXT's ``Model2D`` on one padded path. Last, each
   trained module through an npz and back: the forwards bit for bit
   (deterministic kernels).

10. strict and audit (``envs/strict.py``, ``graphs/audit.py``,
   ``planners/strict_fallback.py``): (a) the hull surface points of
   ``model_0``, ``model_3`` and ur5, built on the host (scipy's qhull): P
   and the SHA-256 of the points beside the JAX package's
   (tests/data/torch_port_strict_jax.json; reported) and the build's
   seconds. (b) ``strict_hit`` on the card against the same port code on
   the CPU, problem 2000 of kuka7, kuka13, ur5 and kuka14: 4,096 uniform
   states and up to 64 lines from a free to a blocked one bisected to
   2**-17..2**-20 (enforced: 0 differing); the largest difference of the
   world points, and ms and aten ops per 256 states. (c) ``_batch_edge_free``
   on 300 edges (chunks of 256) of kuka7 (entry B) and ur5 (entry A), each
   launching its entry: the oracle with the kernel against the oracle with
   its plain version, and the entry against its plain version on the
   chunk's inputs (enforced), ur5's peak memory; both entries timed at
   kuka7's chunk shape and entry A at ur5's. (d) the audit of
   ``tools/strict_verifier.py`` (seed 0, chunks of 256 from problem 2000
   on, 100,096 configurations) with the port's oracle and ``strict_hit``
   (``envs/strict.py::audit_counts``): the four counts beside
   ``assets/calibration/strict_<env>.json`` and the JAX package's counts on
   the CPU (tests/data/torch_port_strict_jax.json), reported,
   configurations a second, and the seconds of the ``strict_hit`` calls
   inside the audit (each between two synchronisations) and their share.
   (e) ``protocol_rgg_connected`` on kuka7 2000 and maze2easy 2000 beside
   the JAX dicts (reported). (f)
   kuka14 problem 2170 through ``explore(strict_fallback=True)`` at the
   reference protocol: success and ``strict_certified``, a finite path from
   the start to the goal, 0 strict hits along it on the card and on the
   CPU, ``capsules_hit`` launched and ``chain_states_free`` not
   (enforced); checks and cost beside the JAX row (reported); seconds of
   the search, the fallback and the smoothing.

11. the rest (the last slice): (a) the explorer's policy scatter on 2,048
   random edges of 64 nodes with repeated live (dst, src) pairs, card
   against CPU: the forward and the gradient equal, the last live duplicate
   written, the others' gradient 0 (enforced). (b) ``eval_gnn`` on kuka7
   and ur5 2000-2001 with ``GMP_FLAT_PROJ=0`` (ur5: the dense sweep at the
   K_CHEAP budget through entry A; kuka7: the full sweep through entry B)
   and with the default flat sweep, in this run: rows equal (enforced),
   beside tests/data/torch_port_cheap_jax.json (reported), the smoothing's
   seconds and overflow redos of both. (c) 2,000 samples of kuka13
   "endpoint" (the native core) and snake7 "straight" and "corridor"
   (entry A) on problem 2000, card against CPU (enforced: equal streams),
   then one ``eval_gnn`` row each beside
   tests/data/torch_port_bias_jax_rows.json (reported). (d) snake7's 3 x 3
   grid window against the full scan through entry A, problem 2000, 4,096
   uniform states and phase 1's near-contact states (enforced: equal), ms
   per call of both at B = 4,096. (e) ``make_mesh(1)`` and a refused
   ``make_mesh(count + 1)``; ``explore_batch`` on kuka7 2000-2003 on the
   one-card mesh against the unsharded rows (enforced); one
   ``make_train_step`` step's loss within 1e-5 of
   ``frontier_cross_entropy`` (enforced). Nothing runs on more than one
   card. (f) ``tools/torch_port_train_scratch.py``: the explorer (kuka7's
   committed slice, 4 iterations of 8 graphs) and the smoother (the paths
   of 12 problems, 3 epochs) from fresh inits into
   ``build/torch_port/smoke_weights``: losses finite,
   the npz read back, the forwards bit for bit (enforced). (g)
   ``rgg.Graph`` on kuka7 and maze2easy 2000 with 200 samples, card env
   against CPU env (enforced). (h) ``jit_eager_consistent`` on the 2-D maze edge oracle
   (eager against a CUDA graph) and a ``profile_trace`` file (enforced).

A watchdog ends a stalled run with every thread's stack and a non-zero
exit. Without a CUDA device, or outside a checkout of the repository, the
script exits non-zero and prints no result. Its last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib
import io
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

# the card's host sets the pace: the paths are host-bound, and on one H100
# machine phases 0-7 took 1.8x as long as on another, ur5's oracle 27 ms a
# call against 10. Phase 8's two T = 1000 runs on ur5 (RRT*, NEXT) took
# 115-127 s together on the faster hosts; on the slower one the whole script
# would need some 900 s, inside a 1200 s limit
WATCHDOG_SECONDS = 900
REPO = Path(__file__).resolve().parent
INDEXES = [2000, 2001, 2002, 2003, 2004]
PHASE4_CONFIGS = ("maze2easy", "maze2hard", "maze3", "kuka13")
PHASE4_PROBLEMS = 3
# the configs whose box family goes through entry A, and their problems
PHASE5_PROBLEMS = {"ur5": [2000, 2001], "kuka14": [2000, 2001],
                   "snake7": [2000, 2001, 2004]}
# the configs whose oracle is the fused kernel (entry B)
FUSED_CONFIGS = ("kuka7", "kuka13")
# the lane shapes of the batched and serve paths: (lanes, configurations a
# lane), None for one search pop's 2 + k_max states; L x 4096 is the
# batched flat projection of L successful lanes, 1 x 2000 serve sampling
LANE_SHAPES = ((25, None), (8, None), (25, 4096), (8, 4096), (1, 4096), (1, 2000))
NEAR_CONFIGS = ("kuka7", "ur5", "kuka14", "snake7")
# phase 6: (config, lanes, problems); phase 7: problems a config. kuka14
# leaves out 2006: its first round fails only when its frontier runs dry, a
# search the batched path runs twice (lane search, then the scalar
# fallback), too long for the watchdog; tools/torch_port_fallback.py runs
# and times that cell on the card, and the CPU tests hold it
BATCHED_CELLS = (("kuka7", 25, list(range(2000, 2025))),
                 ("kuka14", 7, [2000, 2001, 2002, 2003, 2004, 2005, 2007]),
                 ("maze2easy", 10, list(range(2000, 2010))))
SERVE_CELLS = {"kuka7": list(range(2000, 2010)), "maze2easy": list(range(2000, 2010))}
SEED = 1234
# phase 8: the eval_all envs (one problem each), ur5's baseline problem and
# the oracle smoother's problems
BASELINE_ENVS = ("Maze_2D_Easy", "Kuka_7D")
UR5_BASELINE = 2000
# ur5's NEXT at a cut T, to make room for phase 10 (at T = 1000: 71-80 s
# on the card; the CPU tests hold the whole row)
UR5_NEXT_T = 200
# snake7's baseline problem; its NEXT at a cut T (at T = 1000 a minute or
# more; the CPU tests hold the whole row)
SNAKE7_BASELINE = 2000
SNAKE7_NEXT_T = 200
ORACLE_SMOOTHER_PROBLEMS = [2000, 2001]
# phase 10: the URDFs whose hull surfaces are sampled, the envs of the
# strict check and of the audit, uniform states a config, the audit's
# configurations and chunk (tools/strict_verifier.py::audit: seed 0,
# problems 2000 on), the batched edge oracle's configs, and the
# oracle_conservatism witness (assets/benchmarks/strict_fallback_kuka14.json)
STRICT_URDFS = {"kuka7": "kuka_iiwa/model_0.urdf", "kuka13": "kuka_iiwa/model_3.urdf",
                "ur5": "ur5/ur5.urdf"}
STRICT_CONFIGS = ("kuka7", "kuka13", "ur5", "kuka14")
STRICT_STATES = 4096
AUDIT_CONFIGS = 100_000
EDGE_CONFIGS = ("kuka7", "ur5")
RGG_CASES = (("kuka7", 2000), ("maze2easy", 2000))
WITNESS = 2170
# phase 11: the GMP_FLAT_PROJ=0 problems (kuka7 and ur5), the biased
# samplers (config, bias) with their samples and problem, the sharded
# explore_batch's problems, the scratch trainer's steps, rgg.Graph's samples
PHASE11_PROJ_PROBLEMS = [2000, 2001]
PHASE11_BIASES = (("kuka13", "endpoint"), ("snake7", "straight"), ("snake7", "corridor"))
PHASE11_BIAS_SAMPLES = 2000
PHASE11_BIAS_PROBLEM = 2000
PHASE11_MESH_PROBLEMS = [2000, 2001, 2002, 2003]
PHASE11_SCRATCH_STEPS = 3
# the explorer's iterations over the 8 graphs: 3 steps of 8 samples (a
# graph without a label is skipped)
PHASE11_SCRATCH_ITERS = 4
# the smoother's data pass: 12 problems give a replay over one batch of 8
PHASE11_SMOOTHER_PROBLEMS = 12
PHASE11_RGG_SAMPLES = 200
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
    return lane_args(tuple(torch.as_tensor(a, device=device)
                          for a in (p0, p1, r, centers, halfs, mask)))


def lane_args(args):
    """Entry A's arguments for one problem: a lane axis of 1 on the
    endpoints and the scene (the radii are shared)."""

    p0, p1, r, centers, halfs, mask = args
    return p0[None], p1[None], r, centers[None], halfs[None], mask[None]


def lane_scene(scene):
    """One problem's scene as a stacked scene of one lane."""

    from gnn_motion_planning_tpu_torch.envs.base import one_lane

    return one_lane(scene)


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
    return lane_args((p0.contiguous(), p1.contiguous(), r, sc.centers, sc.halfs, sc.mask))


def check_kernel(name: str, args) -> int:
    """Entry A against the plain version on the same inputs; returns the
    number of differing decisions (must be 0)."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    got = capsule.capsules_hit(*args)
    want = capsule.capsules_hit_reference(*args)
    n_diff = int((got != want).sum())
    L, B, C = args[0].shape[:3]
    print(
        f"  capsules_hit {name}: L={L} B={B} C={C} O={args[3].shape[1]} "
        f"lanes={capsule.lanes_for(L * B)} hits={int(want.sum())} differing={n_diff}",
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

    packed, scene = capsule.pack_chain(env.chain), lane_scene(env.device_scene())
    B, C = qs.shape[0], env.chain.cap_r.shape[0]
    want_free, want_cnt = capsule.chain_states_free_reference(qs[None], packed, scene)
    ends = (torch.empty(1, B, C, 3, device=qs.device), torch.empty(1, B, C, 3, device=qs.device))
    n_diff = 0
    for endpoints in (None, ends):
        free, cnt = capsule.chain_states_free(qs[None], packed, scene, endpoints=endpoints)
        n_diff += int((free != want_free).sum()) + int((cnt != want_cnt).sum())
    p0, p1, _ = capsules_world(env.chain, qs)
    p0, p1 = p0[None], p1[None]
    rows = torch.isfinite(qs).all(dim=1)[None]
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
def plain_box_family(env, record: list, entry: str = "capsules_hit"):
    """Run the env's oracle with the plain version of entry ``entry``
    (``capsules_hit``, or ``chain_states_free`` for kuka7 and kuka13) in
    place of the kernel; ``record`` receives the arguments of every
    call."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    module = sys.modules[type(env).__module__]
    reference = getattr(capsule, entry + "_reference")

    def plain(*args):
        record.append(args)
        return reference(*args)

    setattr(module, entry, plain)
    try:
        yield
    finally:
        setattr(module, entry, getattr(capsule, entry))


def check_env_oracle(config: str, env, qs, scene=None):
    """An entry-A env's oracle with the kernel against the same oracle with
    the plain version, and entry A against its plain version on the inputs
    the oracle gave it; ``qs`` (B, d) in the env's current scene, or
    (L, B, d) in the stacked ``scene`` of L problems. Returns (differing
    oracle decisions and counts, differing kernel decisions, entry A's
    inputs)."""

    kern = env.kernels()
    scene = env.device_scene() if scene is None else scene
    calls: list = []
    with plain_box_family(env, calls):
        want_free, want_cnt = kern.batch_state_free(scene, qs)
    free, cnt = kern.batch_state_free(scene, qs)
    n_oracle = int((free != want_free).sum()) + int((cnt != want_cnt).sum())
    where = f"problem {env.index}" if qs.dim() == 2 else f"L={qs.shape[0]} lanes"
    print(f"  {config} oracle {where}: B={qs.shape[-2]} valid={int(want_cnt.sum())} "
          f"free={int(want_free.sum())} differing={n_oracle}", flush=True)
    n_kernel = sum(check_kernel(f"{config} {where}", args) for args in calls)
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


def pairs_needed(contacts, active):
    """(L, B) pairs a configuration needs in the kernels' order: up to its
    first contact, capsule-major over its lane's ``active[l]`` boxes, or
    all of them when there is none."""

    import torch

    out = []
    for lane, a in enumerate(active.tolist()):
        flat = contacts[lane, :, :, :a].flatten(1)
        n = flat.shape[1]
        first = torch.where(flat.any(dim=1), flat.int().argmax(dim=1) + 1, n)
        out.append(first.to(torch.int64))
    return torch.stack(out)


def bound_ms(flops: float, nbytes: float):
    """(bound ms, "operations" or "bytes") at the H100's fp32 and HBM peaks."""

    ops_ms = flops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms else "bytes")


def bare_launchers(env, batch: int, seed: int, lanes: int = 1, scene=None):
    """Bare launches of both entry points at ``batch`` configurations a lane
    uniform in the limits, in ``lanes`` lanes of ``scene`` (stacked; by
    default the env's current scene, one lane): (entry A's launch, entry
    B's launch), each taking the lane-group width, and the inputs (qs
    (L, B, dof), entry A's arguments, the packed chain, the scene)."""

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import lane_capsules
    from gnn_motion_planning_tpu_torch.ops import capsule

    chain = env.chain
    scene = lane_scene(env.device_scene()) if scene is None else scene
    packed = capsule.pack_chain(chain)
    J, C, dof = packed.sizes
    O = scene.centers.shape[1]
    lo, hi = chain.lower.cpu().numpy(), chain.upper.cpu().numpy()
    qs = np.random.RandomState(seed).uniform(lo, hi, (lanes, batch, dof))
    qs = torch.as_tensor(qs.astype(np.float32), device=env.device)
    p0, p1 = lane_capsules(chain, qs)
    args_a = (p0, p1, chain.cap_r, scene.centers, scene.halfs, scene.mask)
    lib = capsule.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((lanes, batch), dtype=torch.bool, device=env.device)
    cnt = torch.empty((lanes, batch), dtype=torch.int32, device=env.device)
    ptr = [x.data_ptr() for x in args_a]

    def launch_a(width):
        return lib.capsules_hit_launch(*ptr, lanes, batch, C, O, out.data_ptr(), width, stream)

    def launch_b(width):
        return lib.chain_states_free_launch(
            qs.data_ptr(), lanes, batch, dof, packed.floats.data_ptr(), packed.ints.data_ptr(),
            J, C, scene.centers.data_ptr(), scene.halfs.data_ptr(), scene.mask.data_ptr(), O,
            out.data_ptr(), cnt.data_ptr(), None, None, width, stream)

    return launch_a, launch_b, (qs, args_a, packed, scene)


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


def time_batch(env, batch: int, card: str, lanes: int = 1, scene=None, label: str = "",
               reps: int = 21, calls: int = 10) -> dict:
    """Both entry points at one shape of configurations uniform in the
    limits, ``lanes`` lanes of ``batch`` in ``scene`` (by default the env's
    current scene, one lane): wrapper, plain version (``reps`` medians of
    ``calls`` calls each), bare kernel, bounds from this data."""

    import torch

    from gnn_motion_planning_tpu_torch.envs.kinematics import lane_capsules
    from gnn_motion_planning_tpu_torch.ops import capsule

    chain = env.chain
    launch_a, launch_b, (qs, args_a, packed, scene) = bare_launchers(
        env, batch, seed=batch + lanes, lanes=lanes, scene=scene)
    J, C, dof = packed.sizes
    O = scene.centers.shape[1]
    lo, hi = chain.lower, chain.upper
    total = lanes * batch

    def torch_fk_and_entry_a():
        # the oracle before the fused kernel: limits, torch FK, entry A
        valid = ((qs >= lo) & (qs <= hi)).all(dim=-1)
        e0, e1 = lane_capsules(chain, qs)
        hit = capsule.capsules_hit(e0, e1, chain.cap_r, scene.centers, scene.halfs, scene.mask)
        return valid & ~hit, valid.to(torch.int32)

    t = time_turns({
        "B": lambda: capsule.chain_states_free(qs, packed, scene),
        "B plain": lambda: capsule.chain_states_free_reference(qs, packed, scene),
        "torch FK + A": torch_fk_and_entry_a,
    }, reps=reps, calls=calls)
    t.update(time_turns({
        "A": lambda: capsule.capsules_hit(*args_a),
        "A plain": lambda: capsule.capsules_hit_reference(*args_a),
    }, reps=reps, calls=calls))

    t["B ops"] = count_ops(lambda: capsule.chain_states_free(qs, packed, scene))
    t["torch FK + A ops"] = count_ops(torch_fk_and_entry_a)

    t["A bare"] = bare_ms(lambda: launch_a(capsule.lanes_for(total)))
    t["B bare"] = bare_ms(lambda: launch_b(capsule.lanes_for(total)))

    # work this run's data needs, in the kernels' order: pairs up to the
    # first contact (each lane over its own active boxes); entry B skips FK
    # and pairs of out-of-limit states
    active = scene.mask.sum(dim=1)  # (L,)
    contacts = capsule.capsule_contacts(*args_a)
    pairs = pairs_needed(contacts, active)
    valid = ((qs >= lo) & (qs <= hi)).all(dim=-1)
    ops_a = int(pairs.sum()) * capsule.OPS_PER_PAIR
    ops_b = (total * dof * capsule.OPS_PER_DOF + int(valid.sum()) * (
        J * capsule.OPS_PER_JOINT + C * capsule.OPS_PER_CAPSULE)
        + int(pairs[valid].sum()) * capsule.OPS_PER_PAIR)
    scene_bytes = lanes * (4 * 6 * O + O)
    bytes_a = 4 * (2 * total * C * 3 + C) + scene_bytes + total
    bytes_b = 4 * total * dof + 4 * sum(capsule.packed_lengths(J, C, dof)) + \
        scene_bytes + total * 5
    t["A bound"], t["A bound_by"] = bound_ms(ops_a, bytes_a)
    t["B bound"], t["B bound_by"] = bound_ms(ops_b, bytes_b)
    all_pair_ops = batch * C * int(active.sum()) * capsule.OPS_PER_PAIR
    t["A bound all pairs"], _ = bound_ms(all_pair_ops, bytes_a)
    t["B bound all pairs"], _ = bound_ms(
        all_pair_ops + total * (J * capsule.OPS_PER_JOINT + C * capsule.OPS_PER_CAPSULE
                                + dof * capsule.OPS_PER_DOF), bytes_b)
    where = label or f"kuka7 problem {env.index}"
    print(
        f"  L={lanes} B={batch} ({where}, C={C} active={active.tolist() if lanes > 1 else int(active)}, "
        f"pairs needed {int(pairs.sum())} of {batch * C * int(active.sum())}; {card})\n"
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


def time_entry_a(config: str, args, card: str, reps: int = 21, calls: int = 10) -> dict:
    """Entry A on one oracle call's inputs: wrapper and plain version (CUDA
    events around 10 calls, median of 21, in turns), the bare kernel (200
    launches through its C entry point) and the bound from this data."""

    import torch

    from gnn_motion_planning_tpu_torch.ops import capsule

    L, B, C = args[0].shape[:3]
    O = args[3].shape[1]
    t = time_turns({"A": lambda: capsule.capsules_hit(*args),
                    "A plain": lambda: capsule.capsules_hit_reference(*args)},
                   reps=reps, calls=calls)
    lib = capsule.load_library()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty((L, B), dtype=torch.bool, device=args[0].device)
    ptr = [x.data_ptr() for x in args]
    t["A bare"] = bare_ms(lambda: lib.capsules_hit_launch(
        *ptr, L, B, C, O, out.data_ptr(), capsule.lanes_for(L * B), stream))
    active = args[5].sum(dim=1)
    pairs = int(pairs_needed(capsule.capsule_contacts(*args), active).sum())
    nbytes = 4 * (2 * L * B * C * 3 + C) + L * (4 * 6 * O + O) + L * B
    t["A bound"], t["A bound_by"] = bound_ms(pairs * capsule.OPS_PER_PAIR, nbytes)
    print(f"  capsules_hit {config}: L={L} B={B} C={C} O={O} active={active.tolist()} "
          f"pairs needed {pairs} of {B * C * int(active.sum())}: wrapper {t['A']:.4f} ms, "
          f"bare {t['A bare']:.4f} ms, plain {t['A plain']:.4f} ms, bound "
          f"{t['A bound']:.3g} ms ({t['A bound_by']}; {card})", flush=True)
    return t


def stage_breakdown(config: str, env, model, model_s, indexes) -> dict:
    """Seconds per stage of eval_gnn over ``indexes``, from host clocks
    around each stage with a device synchronise on both sides (a second
    pass over the same problems, after the main path's own run)."""

    import torch

    # the module (the package re-exports its function under the same name)
    evaluation = importlib.import_module("gnn_motion_planning_tpu_torch.api.eval_gnn")

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


def stacked_scenes(env, indexes):
    """The scenes of problems ``indexes`` stacked along a lane axis."""

    from gnn_motion_planning_tpu_torch.envs.base import stack_scenes

    scenes = []
    for index in indexes:
        env.init_new_problem(index)
        scenes.append(env.device_scene())
    return stack_scenes(scenes)


def lane_configs(env, lanes: int, batch: int, seed: int):
    """(lanes, batch, d) configurations, each lane as ``chain_configs``."""

    import torch

    return torch.stack([chain_configs(env, batch, seed + i) for i in range(lanes)])


def check_chain_lanes(name: str, env, qs, scene) -> int:
    """Entry B over L lanes of per-problem scenes against its plain version;
    returns the differing decisions and counts (must be 0)."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    packed = capsule.pack_chain(env.chain)
    want_free, want_cnt = capsule.chain_states_free_reference(qs, packed, scene)
    free, cnt = capsule.chain_states_free(qs, packed, scene)
    n_diff = int((free != want_free).sum()) + int((cnt != want_cnt).sum())
    L, B = qs.shape[:2]
    print(f"  chain_states_free {name}: L={L} B={B} lanes={capsule.lanes_for(L * B)} "
          f"active={scene.mask.sum(dim=1).tolist()} valid={int(want_cnt.sum())} "
          f"free={int(want_free.sum())} free a lane={want_free.sum(dim=1).tolist()} "
          f"differing={n_diff}", flush=True)
    return n_diff


def bisect_states(is_free, free, blocked, levels=(17, 18, 19, 20)):
    """States on both sides of a decision boundary: the segment from each
    free state to a blocked one bisected in float64 until it is 2**-k of
    its length, for k in ``levels``; ``is_free`` maps (n, d) float32 states
    to (n,) bool. Both ends at every level, float32."""

    import numpy as np

    lo, hi = free.astype(np.float64), blocked.astype(np.float64)
    out = []
    for k in range(1, max(levels) + 1):
        mid = 0.5 * (lo + hi)
        f = is_free(mid.astype(np.float32))
        lo = np.where(f[:, None], mid, lo)
        hi = np.where(f[:, None], hi, mid)
        if k in levels:
            out.append(np.concatenate([lo, hi]).astype(np.float32))
    return np.concatenate(out)


def near_contact_states(env, n_uniform: int = 2048):
    """States 2**-17 to 2**-20 of a segment from the oracle's contact
    boundary (the inputs of tests/test_torch_port_arms.py::
    test_near_contact_distances_equal_xla): bisection between free and
    colliding uniform states with the env's oracle, 512 a depth."""

    import numpy as np
    import torch

    kern, scene = env.kernels(), env.device_scene()

    def free_fn(q):
        return kern.batch_state_free(scene, torch.as_tensor(q, device=env.device))[0].cpu().numpy()

    pr = np.array(env.pose_range)
    qs = np.random.RandomState(env.index).uniform(
        pr[:, 0], pr[:, 1], (n_uniform, env.config_dim)).astype(np.float32)
    ok = free_fn(qs)
    m = min(int(ok.sum()), int((~ok).sum()), 256)
    return bisect_states(free_fn, qs[ok][:m], qs[~ok][:m])


@contextlib.contextmanager
def narrow_phase_calls(env, record: list):
    """Record the arguments of every narrow-phase call an env's oracle makes
    (entry A for the box family, ``pair_contacts`` for the self and
    cross-arm pairs) while it runs as usual."""

    module = sys.modules[type(env).__module__]
    saved = {name: getattr(module, name) for name in ("capsules_hit", "pair_contacts")
             if hasattr(module, name)}

    def recorder(name, fn):
        def call(*args):
            record.append((name, args))
            return fn(*args)
        return call

    for name, fn in saved.items():
        setattr(module, name, recorder(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _to(x, dev):
    """Tensors, and tuples of them, moved to ``dev``."""

    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        moved = [_to(t, dev) for t in x]
        return type(x)(*moved) if hasattr(x, "_fields") else tuple(moved)
    return x


def check_near_contact(config: str, dev) -> int:
    """Near-contact states (bisected on the CPU) on the card. Enforced: the
    oracle with the kernel equals the same oracle with the kernel's plain
    version on the card; and fed the CPU's own capsule endpoints, the
    narrow phase (entry A and its plain version, the pair families) on the
    card equals the CPU, whose fused multiply-adds it forms in float64
    (``envs/kinematics.py::fma32``); and the whole oracle on the card,
    its own FK included (glibc's cos and sin, ``kinematics.sincosf32``,
    and XLA's fused multiply-adds), equals the whole oracle on the CPU.
    Returns the differing decisions (must be 0)."""

    import torch

    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.envs.kinematics import lane_capsules
    from gnn_motion_planning_tpu_torch.ops import capsule

    cpu_env = str2env(config, device="cpu")[0]
    card_env = str2env(config, device=dev)[0]
    n_uniform = 16384 if config in FUSED_CONFIGS else 2048  # kuka7: few boxes
    n_diff = 0
    for index in (2000, 2001):
        cpu_env.init_new_problem(index)
        card_env.init_new_problem(index)
        qs = near_contact_states(cpu_env, n_uniform=n_uniform)
        q = torch.as_tensor(qs, device=dev)
        calls: list = []
        with narrow_phase_calls(cpu_env, calls):
            cpu_free, _ = cpu_env.kernels().batch_state_free(cpu_env.device_scene(),
                                                            torch.as_tensor(qs))
        kern, scene = card_env.kernels(), card_env.device_scene()
        free, cnt = kern.batch_state_free(scene, q)
        if config in FUSED_CONFIGS:
            packed = capsule.pack_chain(card_env.chain)
            pf, pc = capsule.chain_states_free_reference(q[None], packed, lane_scene(scene))
            kernel_vs_plain = int((free != pf[0]).sum()) + int((cnt != pc[0]).sum())
            # the narrow phase on the CPU's endpoints
            e0, e1 = lane_capsules(cpu_env.chain, torch.as_tensor(qs)[None])
            sc = cpu_env.device_scene()
            calls = [("capsules_hit", (e0, e1, cpu_env.chain.cap_r, *lane_scene(sc)))]
        else:
            n_oracle, n_kernel, _ = check_env_oracle(config, card_env, q)
            kernel_vs_plain = n_oracle + n_kernel
        narrow = 0
        module = sys.modules[type(cpu_env).__module__]
        for name, args in calls:
            card_args = _to(args, dev)
            if name == "capsules_hit":
                want = capsule.capsules_hit_reference(*args)
                got = [capsule.capsules_hit_reference(*card_args), capsule.capsules_hit(*card_args)]
            else:
                want = module.pair_contacts(*args)
                got = [module.pair_contacts(*card_args)]
            narrow += sum(int((g.cpu() != want).sum()) for g in got)
        oracle_vs_cpu = int((free.cpu() != cpu_free).sum())
        print(f"  near contact {config} problem {index}: {len(qs)} states at 2**-17..2**-20, "
              f"free={int(cpu_free.sum())}; kernel vs plain version differing={kernel_vs_plain}; "
              f"narrow phase on the CPU's endpoints, card vs CPU ({len(calls)} calls) "
              f"differing={narrow}; whole oracle card vs CPU differing={oracle_vs_cpu}",
              flush=True)
        n_diff += kernel_vs_plain + narrow + oracle_vs_cpu
    return n_diff


def check_path(config: str, env, row, smooth_path) -> None:
    """A solved problem's smoothed path is finite, starts at the start and
    ends in the goal region."""

    import numpy as np

    if not row["success"]:
        return
    p = np.asarray(smooth_path)
    env.init_new_problem(row["index"])
    if p.ndim != 2 or p.shape[1] != env.config_dim or not np.isfinite(p).all():
        raise AssertionError(f"{config} problem {row['index']}: bad path {p.shape}")
    if not np.allclose(p[0], env.init_state, atol=1e-5):
        raise AssertionError(f"{config} problem {row['index']}: path does not start at init")
    if np.asarray(env.distance(p[-1], env.goal_state)).max() >= env.RRT_EPS:
        raise AssertionError(f"{config} problem {row['index']}: path does not reach the goal")


def print_group_stats(config: str, stats: list) -> None:
    """The stats of the first lane group and of the scalar fallbacks."""

    g = stats[0]
    widths = [w for w, _ in g["search_rounds"]]
    print(f"  stats {config} first group: {g['group_size']} lanes, sample {g['sample_s']} s, "
          f"forward {g['forward_s']} s, search {g['search_s']} s in {len(widths)} calls "
          f"(stacked widths {widths}), smooth {g['smooth_s']} s, overflow redos "
          f"{g['smooth_overflow_redos']}, first-round failures {g['first_round_failures']}, "
          f"group {g['group_s']} s", flush=True)
    for extra in stats[1:]:
        if "scalar_fallbacks" in extra:
            print(f"  stats {config}: {extra['scalar_fallbacks']} scalar fallbacks in "
                  f"{extra['fallback_s']} s", flush=True)


def serve_composition(config: str, env, model, model_s, index: int) -> tuple:
    """``serve_full`` against the composition it fuses, serve_round -> host
    backtrack -> model_smooth, on the same draws (tests/test_batched_eval.py
    :115-184). Returns (checks equal, path max diff, smoothed path max
    diff)."""

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.api.eval_gnn import model_smooth
    from gnn_motion_planning_tpu_torch.api.planner_bundle import get_planner
    from gnn_motion_planning_tpu_torch.api.serve import draw, explore_serve, serve_generator
    from gnn_motion_planning_tpu_torch.config import problem_rng
    from gnn_motion_planning_tpu_torch.graphs.knn import k_scaled
    from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack

    batch = 500
    env.rng = problem_rng(SEED, index)
    env.init_new_problem(index)
    c0 = env.collision_check_count
    r = explore_serve(env, model, model_s, serve_generator(SEED, index, env.device), batch=batch)
    fused = env.collision_check_count - c0

    env.rng = problem_rng(SEED, index)
    env.init_new_problem(index)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=env.device)  # noqa: E731
    toks, tok_mask = env.obs_tokens()
    res, v, prefix, n_coll, enough = get_planner(env).serve_round(
        model, env.device_scene(), draw(env, serve_generator(SEED, index, env.device), 4 * batch),
        t(env.init_state), t(env.goal_state), t(toks),
        torch.as_tensor(tok_mask, device=env.device), batch, k_scaled(30, batch + 2), 5)
    if not (bool(enough) and res.success and r["success"]):
        raise AssertionError(f"{config} problem {index}: the serve round did not solve it")
    v_np = v.cpu().numpy()
    path = [v_np[i] for i in backtrack(res.prev.cpu().numpy(), res.success_node)]
    F = batch + 2
    c1 = env.collision_check_count
    smooth = model_smooth(model_s, [v_np[i] for i in range(F)],
                          [v_np[F + i] for i in range(int(n_coll))], path, env)
    two_call = int(prefix) + res.n_checks + env.collision_check_count - c1
    d_path = float(np.abs(np.asarray(r["path"]) - np.asarray(path)).max())
    d_smooth = float(np.abs(np.asarray(r["smooth_path"]) - np.asarray(smooth)).max())
    print(f"  serve_full vs serve_round + backtrack + model_smooth {config} problem {index}: "
          f"checks {fused} vs {two_call}, path max diff {d_path:.3g}, smoothed path max diff "
          f"{d_smooth:.3g}", flush=True)
    return fused == two_call, d_path, d_smooth


def print_kernels(launches: dict, max_abs_err: dict, at_4096: dict) -> None:
    """The kernels line: both entries' launches on the main paths, error
    against the plain version, and timing at B = 4096."""

    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": "gnn_motion_planning_tpu_torch/csrc/capsules_hit.cu",
        "replaces": "gnn_motion_planning_tpu/ops/pallas_capsule.py:120",
        "launches": launches.get(name, 0),
        "max_abs_err": max_abs_err[name],
        "ms": at_4096[key],
        "plain_ms": at_4096[f"{key} plain"],
        "bound_ms": at_4096[f"{key} bound"],
        "bound_by": at_4096[f"{key} bound_by"],
        "library_ms": None,
    } for name, key in (("capsules_hit", "A"), ("chain_states_free", "B"))]}), flush=True)


def launch_counter(launches: dict):
    """counted(name, run): run one path with the launch counts set to 0 just
    before and read just after; (run's result, the counts), which are also
    added to ``launches`` (the kernels line)."""

    from gnn_motion_planning_tpu_torch.ops import capsule

    def counted(config, run):
        for name in capsule.LAUNCHES:
            capsule.LAUNCHES[name] = 0
        out = run()
        counts = dict(capsule.LAUNCHES)
        for name, n in counts.items():
            print(f"  {name} launches on the {config} path: {n}", flush=True)
            launches[name] = launches.get(name, 0) + n
        return out, counts

    return counted


def quiet(fn, *args, **kwargs):
    """Call fn with its standard output (the drivers' metric blocks and
    progress) silenced."""

    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*args, **kwargs)


def check_baseline_path(config: str, env, index: int, path, tree: bool, cpu_env=None) -> None:
    """A solved problem's path: finite, from the start to the goal (into the
    goal region for a tree planner and the GNN); with ``cpu_env``, every edge free
    under that env's oracle on the CPU."""

    import numpy as np

    p = np.asarray(path, np.float64)
    env.init_new_problem(index)
    if p.ndim != 2 or p.shape[1] != env.config_dim or not np.isfinite(p).all():
        raise AssertionError(f"{config} problem {index}: bad path {p.shape}")
    if not np.allclose(p[0], env.init_state, atol=1e-5):
        raise AssertionError(f"{config} problem {index}: path does not start at the start")
    reach = (np.asarray(env.distance(p[-1], env.goal_state)).max() < env.RRT_EPS if tree
             else np.allclose(p[-1], env.goal_state, atol=1e-5))
    if not reach:
        raise AssertionError(f"{config} problem {index}: path does not reach the goal")
    if cpu_env is not None:
        cpu_env.init_new_problem(index)
        blocked = [i for i in range(len(p) - 1) if not cpu_env._edge_fp(p[i], p[i + 1])]
        if blocked:
            raise AssertionError(f"{config} problem {index}: edges {blocked} collide on the CPU")


def baseline_agree(label: str, got, want) -> bool:
    """Print a baseline row beside its JAX row: (success, checks, cost)."""

    same = want is not None and got[:2] == tuple(want[:2]) and (
        (got[2] is None and want[2] is None)
        or (got[2] is not None and want[2] is not None and abs(got[2] - want[2]) < 1e-6))
    print(f"  {label}: port {list(got)} jax {None if want is None else list(want)} "
          f"{'agree' if same else 'DIFFER'}", flush=True)
    return same


def snake7_baselines(env, counted, card: str) -> None:
    """Phase 8's snake7 rows: the four baselines on problem 2000 through
    its own host protocol (NEXT at T = SNAKE7_NEXT_T), each launching
    ``capsules_hit`` and not ``chain_states_free``, beside the JAX rows."""

    data = REPO / "tests" / "data"
    fx = json.loads((data / "torch_port_baselines_snake7_jax_rows.json").read_text())
    want = {r["method"]: (r["success"], r["checks"], r["cost"]) for r in fx["rows"]}
    want["next"] = next((r["success"], r["checks"], r["cost"]) for r in fx["cut_rows"]
                        if r["method"] == "next" and r["t_max"] == SNAKE7_NEXT_T)
    from gnn_motion_planning_tpu_torch.api import eval_baselines

    agree = 0
    for method in ("bit", "lazysp", "rrt", "next"):
        kw = {"t_max": SNAKE7_NEXT_T} if method == "next" else {}
        t0 = time.perf_counter()
        r, counts = counted(f"snake7 {method}", lambda: quiet(
            getattr(eval_baselines, "eval_" + method), "snake7", SEED, env, [SNAKE7_BASELINE],
            **kw))
        secs = time.perf_counter() - t0
        if counts["capsules_hit"] <= 0 or counts["chain_states_free"] != 0:
            raise AssertionError(f"snake7 {method}: launches {counts}, want capsules_hit only")
        cost = None if not math.isfinite(r[3]) else float(r[3])
        t_note = f", T {SNAKE7_NEXT_T}" if kw else ""
        agree += baseline_agree(
            f"snake7 {method} problem {SNAKE7_BASELINE} ({secs:.2f} s{t_note}, {card})",
            (int(r[0]), float(r[1]), cost), want[method])
        if r[0]:
            check_baseline_path("snake7", env, SNAKE7_BASELINE, r[5][0],
                                tree=method in ("rrt", "next"))
    print(f"  snake7 baseline rows agreeing with the JAX package: {agree} of 4", flush=True)


def baselines(dev, arm_envs: dict, counted, card: str) -> None:
    """Phase 8 (module docstring)."""

    from gnn_motion_planning_tpu_torch.api import eval_all as eval_all_mod
    from gnn_motion_planning_tpu_torch.api import eval_baselines
    from gnn_motion_planning_tpu_torch.api.eval_gnn import explore_batch, path_cost
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    data = REPO / "tests" / "data"
    # the native core (kuka7's and kuka14's host oracle) is built for
    # x86-64-v4 where the host has AVX-512, as the JAX package's library
    # was, else for the host, whose vector width can move a host row at a
    # near-tie (utils/geomcore.py, tools/torch_port_host_rows.py)
    import platform

    from gnn_motion_planning_tpu_torch.utils.geomcore import FLAGS

    cpuinfo = Path("/proc/cpuinfo").read_text() if Path("/proc/cpuinfo").exists() else ""
    model = next((line.split(":", 1)[1].strip() for line in cpuinfo.splitlines()
                  if line.split(":", 1)[0].strip() in ("model name", "CPU part")), "unknown")
    print(f"  host CPU: {platform.machine()} {model}, avx512f "
          f"{'yes' if ' avx512f' in cpuinfo else 'no'}; native core: g++ {' '.join(FLAGS)}",
          flush=True)

    def cost_or_none(c):
        return None if c is None or not math.isfinite(c) else float(c)

    methods = list(eval_all_mod.METHODS)
    want = {(r[0], r[1]): tuple(r[2:]) for r in
            json.loads((data / "torch_port_eval_all_jax_rows.json").read_text())["rows"]}
    table = {name: (factory, idx) for name, factory, idx in eval_all_mod.default_env_table(dev)}
    agree = total = 0
    for env_name in BASELINE_ENVS:
        t0 = time.perf_counter()
        result, counts = counted(f"eval_all {env_name}", lambda: quiet(
            eval_all_mod.eval_all, env_names=[env_name], method_names=methods, n_problems=1,
            out_path=str(REPO / "build" / "torch_port" / "eval_all_result.p"), device=dev))
        secs = time.perf_counter() - t0
        if env_name == "Kuka_7D" and counts["chain_states_free"] <= 0:
            raise AssertionError("Kuka_7D's GNN method never launched chain_states_free")
        factory, idx = table[env_name]
        env = factory()
        index = int(idx[0])
        for method in methods:
            r = result[env_name, method, str(SEED)]
            got = (int(r[0]), float(r[1]), cost_or_none(r[3]))
            total += 1
            agree += baseline_agree(f"{env_name} {method} problem {index} ({r[4]:.3f} s)", got,
                                    want.get((env_name, method)))
            if r[0]:
                # GNN: the smoothed paths (index 6); the others' paths at 5
                path = r[6][0] if method == "GNN" else r[5][0]
                check_baseline_path(env_name, env, index, path,
                                    tree=method in ("GNN", "RRT*", "NEXT"))
        print(f"  eval_all {env_name}: {len(methods)} methods in {secs:.2f} s ({card})",
              flush=True)
    print(f"  eval_all rows agreeing with the JAX package: {agree} of {total}", flush=True)

    env = arm_envs["ur5"][0]
    cpu_env = str2env("ur5", device="cpu")[0]
    fx = json.loads((data / "torch_port_baselines_ur5_jax_rows.json").read_text())
    ur5_want = {r["method"]: (r["success"], r["checks"], r["cost"]) for r in fx["rows"]}
    ur5_want["next"] = next((r["success"], r["checks"], r["cost"]) for r in fx["cut_rows"]
                            if r["method"] == "next" and r["t_max"] == UR5_NEXT_T)
    agree = 0
    for method in ("bit", "lazysp", "rrt", "next"):
        kw = {"t_max": UR5_NEXT_T} if method == "next" else {}
        t0 = time.perf_counter()
        r, counts = counted(f"ur5 {method}", lambda: quiet(
            getattr(eval_baselines, "eval_" + method), "ur5", SEED, env, [UR5_BASELINE], **kw))
        secs = time.perf_counter() - t0
        if counts["capsules_hit"] <= 0 or counts["chain_states_free"] != 0:
            raise AssertionError(f"ur5 {method}: launches {counts}, want capsules_hit only")
        got = (int(r[0]), float(r[1]), cost_or_none(r[3]))
        t_note = f", T {UR5_NEXT_T}" if kw else ""
        agree += baseline_agree(
            f"ur5 {method} problem {UR5_BASELINE} ({secs:.2f} s{t_note}, {card})",
            got, ur5_want[method])
        if r[0]:
            check_baseline_path("ur5", env, UR5_BASELINE, r[5][0],
                                tree=method in ("rrt", "next"), cpu_env=cpu_env)
    print(f"  ur5 baseline rows agreeing with the JAX package: {agree} of 4", flush=True)

    snake7_baselines(arm_envs["snake7"][0], counted, card)

    model = arm_envs["ur5"][1]
    sm_want = {r["index"]: r for r in json.loads(
        (data / "torch_port_oracle_smoother_ur5_jax_rows.json").read_text())["rows"]}
    t0 = time.perf_counter()
    results, counts = counted("ur5 oracle smoother", lambda: explore_batch(
        env, model, None, ORACLE_SMOOTHER_PROBLEMS, lanes=len(ORACLE_SMOOTHER_PROBLEMS),
        seed=SEED, **protocol("ur5")))
    secs = time.perf_counter() - t0
    if counts["capsules_hit"] <= 0 or counts["chain_states_free"] != 0:
        raise AssertionError(f"ur5 oracle smoother: launches {counts}, want capsules_hit only")
    agree = 0
    for index, res in zip(ORACLE_SMOOTHER_PROBLEMS, results):
        w = sm_want[index]
        got = (bool(res["success"]), int(res["c_explore"]), int(res["c_smooth"]))
        cost = path_cost(res["smooth_path"])
        same = got == (w["success"], w["c_explore"], w["c_smooth"]) and abs(cost - w["cost"]) < 1e-6
        agree += same
        print(f"  ur5 oracle smoother problem {index}: port {list(got) + [cost]} jax "
              f"{[w['success'], w['c_explore'], w['c_smooth'], w['cost']]} "
              f"{'agree' if same else 'DIFFER'}", flush=True)
        if res["success"]:
            if res["c_smooth"] <= 0:
                raise AssertionError(f"ur5 problem {index}: the oracle smoother spent no checks")
            check_baseline_path("ur5", env, index, res["smooth_path"], tree=False,
                                cpu_env=cpu_env)
    if not any(r["success"] for r in results):
        raise AssertionError("ur5 oracle smoother: no problem solved")
    print(f"  ur5 oracle smoother: {len(results)} problems in {secs:.2f} s, rows agreeing with "
          f"the JAX package: {agree} of {len(results)} ({card})", flush=True)


def strict_and_audit(dev, envs: dict, kuka14_models, counted, card: str) -> None:
    """Phase 10 (module docstring). ``envs``: the card's env of each of
    STRICT_CONFIGS; ``kuka14_models``: kuka14's (explorer, smoother)."""

    import hashlib

    import numpy as np
    import scipy
    import torch

    # the module (the package re-exports its function under the same name)
    evaluation = importlib.import_module("gnn_motion_planning_tpu_torch.api.eval_gnn")
    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.config import problem_rng
    from gnn_motion_planning_tpu_torch.envs import strict
    from gnn_motion_planning_tpu_torch.envs.strict import (
        AUDIT_CHUNK,
        SurfacePoints,
        audit_counts,
        build_surface_points,
        strict_checker,
        validate_path_strict,
        world_points,
    )
    from gnn_motion_planning_tpu_torch.graphs.audit import protocol_rgg_connected
    from gnn_motion_planning_tpu_torch.planners import strict_fallback as fallback
    from gnn_motion_planning_tpu_torch.utils.assets import asset_path

    fx = json.loads((REPO / "tests" / "data" / "torch_port_strict_jax.json").read_text())
    cpu_envs = {config: str2env(config, device="cpu")[0] for config in STRICT_CONFIGS}

    def t(a):
        return torch.as_tensor(a, device=dev)

    # (a) surface points: the host build, its hash beside the JAX package's
    print(f"  scipy {scipy.__version__}, numpy {np.__version__}", flush=True)
    surfaces = {}
    for config, urdf in STRICT_URDFS.items():
        t0 = time.perf_counter()
        sp = build_surface_points(envs[config].model, asset_path(urdf), device=dev)
        secs = time.perf_counter() - t0
        surfaces[config] = sp
        pts = sp.pts.cpu().numpy()
        digest = hashlib.sha256(pts.tobytes()).hexdigest()
        want = fx["surface"][config]
        same = len(pts) == want["P"] and digest == want["pts_sha256"]
        print(f"  surface points {urdf}: P={len(pts)} sha256 {digest[:16]}, built in "
              f"{secs:.2f} s; jax P={want['P']} sha256 {want['pts_sha256'][:16]} "
              f"{'equal' if same else 'DIFFER'}", flush=True)
    surfaces["kuka14"] = surfaces["kuka7"]

    # (b) strict_hit on the card against the same port code on the CPU
    n_diff = {}
    for config in STRICT_CONFIGS:
        env, cpu_env = envs[config], cpu_envs[config]
        env.init_new_problem(2000)
        cpu_env.init_new_problem(2000)
        hit, cpu_hit = strict_checker(env), strict_checker(cpu_env)
        scene = env.device_scene()
        pr = np.array(env.pose_range)
        qs = np.random.RandomState(len(config)).uniform(
            pr[:, 0], pr[:, 1], (STRICT_STATES, env.config_dim)).astype(np.float32)
        blocked = hit(scene, t(qs)).cpu().numpy()
        m = min(64, int(blocked.sum()), int((~blocked).sum()))
        near = bisect_states(lambda q: ~hit(scene, t(q)).cpu().numpy(),
                             qs[~blocked][:m], qs[blocked][:m])
        every = np.concatenate([qs, near])
        got = hit(scene, t(every)).cpu()
        want = cpu_hit(cpu_env.device_scene(), torch.as_tensor(every))
        n_diff[config] = int((got != want).sum())
        # world points of the near states, card against CPU, each arm
        sp = surfaces[config]
        sp_cpu = SurfacePoints(sp.pts.cpu(), sp.frame.cpu())
        dof = env.chain.lower.shape[0]
        bases = [env.base1, env.base2] if config == "kuka14" else [None]
        err = 0.0
        for arm, base in enumerate(bases):
            q = near[:64, arm * dof:(arm + 1) * dof]
            w_card = world_points(env.chain, sp, t(q), base).cpu()
            w_cpu = world_points(cpu_env.chain, sp_cpu, torch.as_tensor(q),
                                 None if base is None else base.cpu())
            err = max(err, float((w_card - w_cpu).abs().max()))
        q256 = t(qs[:AUDIT_CHUNK])
        ms = time_turns({"strict": lambda: hit(scene, q256)}, reps=5, calls=3)["strict"]
        ops = count_ops(lambda: hit(scene, q256))
        print(f"  strict_hit {config} problem 2000: {STRICT_STATES} uniform + {len(near)} states "
              f"2**-17..2**-20 from a strict-contact boundary, hits={int(want.sum())}, card vs "
              f"CPU differing={n_diff[config]}, world points max diff {err:.3g}; "
              f"{ms:.4f} ms per {AUDIT_CHUNK} states, {ops} aten ops a call ({card})",
              flush=True)
    if sum(n_diff.values()):
        raise AssertionError(f"strict_hit differs between the card and the CPU: {n_diff}")

    # (c) the batched edge oracle at its 256-edge chunk: the kernel against
    # its plain version at that shape (kuka7: entry B, ur5: entry A)
    edge_inputs = {}
    for config in EDGE_CONFIGS:
        env = envs[config]
        env.init_new_problem(2000)
        pr = np.array(env.pose_range)
        rs = np.random.RandomState(3)
        a = rs.uniform(pr[:, 0], pr[:, 1], (300, env.config_dim))
        b = a + rs.normal(0, 0.1 * (pr[:, 1] - pr[:, 0]), a.shape)
        b[::3] = rs.uniform(pr[:, 0], pr[:, 1], (len(b[::3]), env.config_dim))
        torch.cuda.reset_peak_memory_stats()
        (free, cnt), counts = counted(f"{config} _batch_edge_free",
                                      lambda: env._batch_edge_free(a, b))
        peak = torch.cuda.max_memory_allocated() / 2**20
        entry = "chain_states_free" if config in FUSED_CONFIGS else "capsules_hit"
        if counts[entry] <= 0:
            raise AssertionError(f"{config} _batch_edge_free never launched {entry}")
        calls: list = []
        with plain_box_family(env, calls, entry):
            want_free, want_cnt = env._batch_edge_free(a, b)
        n_oracle = int((free != want_free).sum()) + int((cnt != want_cnt).sum())
        if entry == "capsules_hit":
            n_kernel = sum(check_kernel(f"{config} _batch_edge_free chunk", args)
                           for args in calls)
        else:
            from gnn_motion_planning_tpu_torch.ops import capsule

            n_kernel = 0
            for args in calls:
                kf, kc = capsule.chain_states_free(*args)
                pf, pc = capsule.chain_states_free_reference(*args)
                n_kernel += int((kf != pf).sum()) + int((kc != pc).sum())
        states = calls[0][0].shape[1]
        edge_inputs[config] = calls[0]
        print(f"  _batch_edge_free {config} problem 2000: 300 edges in chunks of 256, "
              f"{states} states a call through {entry} ({len(calls)} calls), free="
              f"{int(free.sum())} checks={int(cnt.sum())}; kernel vs plain version: oracle "
              f"differing={n_oracle}, {entry} differing={n_kernel}; peak memory "
              f"{peak:.0f} MiB ({card})", flush=True)
        if n_oracle or n_kernel:
            raise AssertionError(f"{config} _batch_edge_free differs from its plain version")
    env7 = envs["kuka7"]
    env7.init_new_problem(2000)
    time_batch(env7, edge_inputs["kuka7"][0].shape[-2], card,
               label="kuka7 problem 2000, the _batch_edge_free chunk", reps=5, calls=3)
    time_entry_a("ur5 _batch_edge_free chunk", edge_inputs["ur5"], card, reps=5, calls=3)

    # seconds of the calls of a function, each between two synchronisations
    seconds: dict = {}

    def timed(name, fn):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
            return out
        return call

    # (d) the audit at scale: the capsule oracle against strict_hit, beside
    # the records and the JAX package's counts on the CPU; the strict_hit
    # calls inside it timed for their share of the audit's seconds
    checker = strict.strict_checker
    for config in STRICT_CONFIGS:
        env = envs[config]
        record = json.loads(Path(asset_path(f"calibration/strict_{config}.json")).read_text())
        name = f"{config} audit strict_hit"
        strict.strict_checker = lambda e, name=name: timed(name, checker(e))
        try:
            t0 = time.perf_counter()
            got, _ = counted(f"{config} audit", lambda: audit_counts(env, AUDIT_CONFIGS))
            secs = time.perf_counter() - t0
        finally:
            strict.strict_checker = checker
        n_calls = got["n_configs"] // AUDIT_CHUNK
        print(f"  audit {config}: {json.dumps(got)} in {secs:.2f} s ({got['n_configs'] / secs:.0f} "
              f"configurations a second); strict_hit {n_calls} calls {seconds[name]:.2f} s, "
              f"{100 * seconds[name] / secs:.1f} % of the audit ({card})", flush=True)
        for label, want in (("record", record), ("jax on the CPU", fx["audit"][config])):
            want = {k: want[k] for k in got}
            print(f"    {label}: {json.dumps(want)} {'equal' if got == want else 'DIFFER'}",
                  flush=True)

    # (e) protocol_rgg_connected beside the JAX package's dicts
    for config, index in RGG_CASES:
        env = envs[config] if config in envs else str2env(config, device=dev)[0]
        t0 = time.perf_counter()
        rep, _ = counted(f"{config} protocol_rgg_connected",
                         lambda: protocol_rgg_connected(env, SEED, index))
        want = next(r for r in fx["rgg"] if (r["config"], r["index"]) == (config, index))
        want = {k: v for k, v in want.items() if k not in ("config", "index")}
        print(f"  protocol_rgg_connected {config} {index}: {json.dumps(rep)} in "
              f"{time.perf_counter() - t0:.2f} s; jax {json.dumps(want)} "
              f"{'equal' if rep == want else 'DIFFER'}", flush=True)

    # (f) the witness: kuka14 2170 recovered by the strict fallback
    env = envs["kuka14"]
    model, model_s = kuka14_models
    saved = fallback.strict_fallback_path, evaluation.model_smooth
    fallback.strict_fallback_path = timed("fallback", fallback.strict_fallback_path)
    evaluation.model_smooth = timed("smoothing", evaluation.model_smooth)
    try:
        env.rng = problem_rng(SEED, WITNESS)
        env.init_new_problem(WITNESS)
        res, counts = counted("kuka14 2170 strict fallback", lambda: evaluation.explore(
            env, model, model_s, smooth=True, strict_fallback=True, **protocol("kuka14")))
    finally:
        fallback.strict_fallback_path, evaluation.model_smooth = saved
    if counts["capsules_hit"] <= 0 or counts["chain_states_free"] != 0:
        raise AssertionError(f"kuka14 2170: launches {counts}, want capsules_hit only")
    if not (res["success"] and res["strict_certified"]):
        raise AssertionError(f"kuka14 2170: success {res['success']}, strict_certified "
                             f"{res['strict_certified']}")
    path = np.asarray(res["path"])
    if not (np.isfinite(path).all()
            and np.array_equal(path[0], np.asarray(env.init_state, np.float32))
            and np.array_equal(path[-1], np.asarray(env.goal_state, np.float32))):
        raise AssertionError("kuka14 2170: the certified path does not join start to goal")
    cpu_env = cpu_envs["kuka14"]
    cpu_env.init_new_problem(WITNESS)
    hits = {"card": validate_path_strict(env, res["path"], strict_checker(env)),
            "CPU": validate_path_strict(cpu_env, res["path"], strict_checker(cpu_env))}
    smooth_hits = validate_path_strict(env, res["smooth_path"], strict_checker(env))
    if hits["card"] or hits["CPU"]:
        raise AssertionError(f"kuka14 2170: strict hits along the certified path {hits}")
    w = fx["witness"]
    got = (res["c_explore"] + res["c_smooth"], evaluation.path_cost(res["smooth_path"]))
    same = got[0] == w["checks"] and abs(got[1] - w["cost"]) < 1e-3
    fb = seconds.get("fallback", 0.0)
    print(f"  kuka14 {WITNESS} strict fallback: success and strict_certified, path "
          f"{len(path)} states, strict hits along it card {hits['card']} CPU {hits['CPU']} "
          f"(smoothed path: {smooth_hits}); checks {got[0]} cost {got[1]:.4f}; jax checks "
          f"{w['checks']} cost {w['cost']:.4f} {'agree' if same else 'DIFFER'}; seconds: "
          f"search {res['total_explore'] - fb:.2f} (sampling included), fallback {fb:.2f}, "
          f"smoothing {seconds.get('smoothing', 0.0):.2f}, all {res['total']:.2f} ({card})",
          flush=True)


# phase 9: the card's gradients against the CPU's, |diff| <= GRAD_RTOL *
# max|g_leaf| + GRAD_ATOL on every leaf. The backward of the forwards'
# scatter_reduce and index_put_ adds with atomics on the card, so the last
# bits can vary from run to run. On an H100 (700 W) the leaves used at most
# 0.12 of 1e-4 max|g| + 1e-6 (NEXT's hidden.bias, |diff| 2.6e-7); the
# tolerance leaves some 4x room over that
GRAD_RTOL, GRAD_ATOL = 5e-5, 5e-7
SMOOTHER_GRAD_LOOP = 4


def timed_steps(module, record: dict):
    """Wrap ``module.train_step`` (the trainers call it through the module):
    each call timed with CUDA events, the first call's arguments kept.
    Returns the wrapped function, to put back."""

    import torch

    inner = module.train_step

    def step(*args):
        record.setdefault("args", args)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = inner(*args)
        end.record()
        end.synchronize()
        record.setdefault("ms", []).append(start.elapsed_time(end))
        return loss

    module.train_step = step
    return inner


def grads_on(module, loss_of, device) -> tuple:
    """(loss, {name: gradient on the CPU}) of a copy of ``module`` on
    ``device``, every trained leaf (a leaf the loss does not reach: 0)."""

    import copy

    import torch

    from gnn_motion_planning_tpu_torch.training.optim import trainable_leaves

    m = copy.deepcopy(module).to(device)
    leaves = trainable_leaves(m)
    for t in leaves:
        t.grad = None
    loss = loss_of(m, device)
    loss.backward()
    grads = {k: torch.zeros(t.shape) if t.grad is None else t.grad.detach().cpu()
             for k, t in m.state_dict(keep_vars=True).items() if t.is_floating_point()}
    return float(loss.detach()), grads


def check_grads(label: str, module, loss_of, dev) -> float:
    """The loss and every gradient leaf on the card against the CPU through
    the same port code; raises beyond the tolerance. -> the largest share
    of its tolerance a leaf used."""

    loss_card, g_card = grads_on(module, loss_of, dev)
    loss_cpu, g_cpu = grads_on(module, loss_of, "cpu")
    worst, worst_leaf, bad = 0.0, None, []
    for name, want in g_cpu.items():
        scale = float(want.abs().max())
        diff = float((g_card[name] - want).abs().max())
        share = diff / (GRAD_RTOL * scale + GRAD_ATOL)
        if share > 1:
            bad.append((name, diff, scale))
        if share >= worst:
            worst, worst_leaf = share, (name, diff, scale)
    rel = abs(loss_card - loss_cpu) / max(abs(loss_cpu), 1e-30)
    print(f"  grads {label}: loss card {loss_card!r} cpu {loss_cpu!r} (rel {rel:.3g}); "
          f"{len(g_cpu)} leaves, the largest share of the tolerance {worst:.3g}: "
          f"{worst_leaf[0]} |diff| {worst_leaf[1]:.3g}, max|g| {worst_leaf[2]:.3g}", flush=True)
    if bad or rel > 1e-5:
        raise AssertionError(f"{label}: card and CPU gradients differ: loss rel {rel:.3g}, "
                             f"leaves {bad[:5]}")
    return worst


def steady_step_ms(module, make_optimizer, step, reps: int = 10, warmup: int = 3) -> float:
    """Median ms of ``step(model, optimizer, leaves)`` on a copy of
    ``module`` after ``warmup`` steps (CUDA events around each step)."""

    import copy

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.training.optim import trainable_leaves

    m = copy.deepcopy(module)
    leaves = trainable_leaves(m)
    opt = make_optimizer(leaves)
    times = []
    for i in range(warmup + reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(m, opt, leaves)
        end.record()
        end.synchronize()
        if i >= warmup:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def report_loop(name: str, losses, replay, want: dict, record: dict, samples: int,
                card: str) -> None:
    """A loop's losses beside the JAX package's (reported), its steps and
    replay size against the fixture's (enforced), its step time."""

    import numpy as np

    rel = [abs(g - w) / max(abs(w), 1e-12) for g, w in zip(losses, want["losses"])]
    print(f"  {name}: losses port {losses} jax {want['losses']} max rel diff "
          f"{max(rel) if rel else float('nan'):.3g}", flush=True)
    if len(losses) != want["steps"] or replay != want["replay"]:
        raise AssertionError(f"{name}: {len(losses)} losses, replay {replay}; the JAX package "
                             f"{want['steps']}, replay {want['replay']}")
    ms = float(np.median(record["ms"]))
    print(f"  {name}: {len(losses)} losses, replay {replay}, {len(record['ms'])} optimiser "
          f"steps, {ms:.3f} ms a step in the loop (median, CUDA events, the first steps warm "
          f"up), {samples / ms * 1e3:.1f} samples/s ({card})", flush=True)


def training(dev, counted, card: str) -> None:
    """Phase 9 (module docstring)."""

    import tempfile

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.api.eval_baselines import str2next
    from gnn_motion_planning_tpu_torch.api.registry import str2env, str2models, str2name
    from gnn_motion_planning_tpu_torch.models.convert import load_npz, save_npz
    from gnn_motion_planning_tpu_torch.models.explorer import Explorer, explorer_forward
    from gnn_motion_planning_tpu_torch.models.next_model import NextNet, pb_forward, state_forward
    from gnn_motion_planning_tpu_torch.models.smoother import Smoother, smoother_forward
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import pad_to_bucket
    from gnn_motion_planning_tpu_torch.training import explorer as t_explorer
    from gnn_motion_planning_tpu_torch.training import next as t_next
    from gnn_motion_planning_tpu_torch.training import smoother as t_smoother

    fixture = json.loads((REPO / "tests" / "data" / "torch_port_training_jax.json").read_text())
    settings, jax_runs = fixture["settings"], fixture["runs"]
    records = {name: {} for name in ("explorer", "smoother", "next")}
    replays: list = []
    inner_collect = t_smoother.collect_replay

    def collect(*args, **kwargs):
        replays.append(inner_collect(*args, **kwargs))
        return replays[-1]

    saved = [(mod, timed_steps(mod, records[key]))
             for mod, key in ((t_explorer, "explorer"), (t_smoother, "smoother"), (t_next, "next"))]
    t_smoother.collect_replay = collect
    tmp = tempfile.TemporaryDirectory()
    try:
        # (b) the three loops at full width, from the committed data
        spec = settings["explorer_kuka7"]
        env, explorer, _, _, _ = str2name("kuka7", device=dev)
        t0 = time.perf_counter()
        explorer, losses = t_explorer.train_explorer(
            data_path=str(REPO / spec["data"]), model=explorer, env=env, device=dev,
            model_path=str(Path(tmp.name) / "explorer.npz"), **spec["kwargs"])
        print(f"  train_explorer kuka7: {time.perf_counter() - t0:.2f} s", flush=True)
        report_loop("train_explorer kuka7", losses, None, jax_runs["explorer_kuka7"],
                    records["explorer"], records["explorer"]["args"][3].v.shape[0], card)

        spec = settings["smoother_kuka7"]
        env, explorer_s, _, smoother, _ = str2name("kuka7", device=dev)
        stats: dict = {}
        t0 = time.perf_counter()
        (smoother, losses), counts = counted("kuka7 train_smoother", lambda: t_smoother.train_smoother(
            model_explore=explorer_s, model=smoother, env=env, device=dev, stats=stats,
            model_path=str(Path(tmp.name) / "smoother.npz"), **spec["kwargs"]))
        print(f"  train_smoother kuka7: {time.perf_counter() - t0:.2f} s", flush=True)
        if counts["chain_states_free"] <= 0:
            raise AssertionError("train_smoother's data pass never launched chain_states_free")
        report_loop("train_smoother kuka7", losses, stats["replay"], jax_runs["smoother_kuka7"],
                    records["smoother"], records["smoother"]["args"][3][0].shape[0], card)

        spec = settings["next_maze2easy"]
        stats = {}
        t0 = time.perf_counter()
        next_model, losses = t_next.train_next(
            "maze2easy", device=dev, stats=stats, model_path=str(Path(tmp.name) / "next.npz"),
            **spec["kwargs"])
        print(f"  train_next maze2easy: {time.perf_counter() - t0:.2f} s, BIT* fallbacks "
              f"{stats['fallback']}", flush=True)
        report_loop("train_next maze2easy", losses, stats["replay"], jax_runs["next_maze2easy"],
                    records["next"], 1, card)
    finally:
        for mod, inner in saved:
            mod.train_step = inner
        t_smoother.collect_replay = inner_collect

    # (a) gradients on the card against the CPU, at full width, TF32 off
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    ex = records["explorer"]["args"][3]
    fresh_explorer, fresh_smoother = str2models("kuka7", dev)

    def explorer_loss(m, device):
        batch = t_explorer.ExplorerBatch(*(t.to(device) for t in ex))
        return t_explorer.frontier_cross_entropy(m, batch, 8)

    worst = {"explorer kuka7": check_grads(
        f"explorer kuka7 (embed 64, {ex.v.shape[0]} samples, N {ex.v.shape[1]}, "
        f"E {ex.src.shape[1]}, loop 8)", fresh_explorer, explorer_loss, dev)}

    items = [replays[0][i % len(replays[0])] for i in range(8)]
    l_pad = pad_to_bucket(max(len(it[1]) for it in items))
    cfg = fresh_smoother.cfg
    cols = [torch.as_tensor(np.stack(c)) for c in
            zip(*[t_smoother.build_sample(it, l_pad, cfg.config_size) for it in items])]

    def smoother_loss(m, device):
        return t_smoother.smoother_mse(m, tuple(c.to(device) for c in cols), SMOOTHER_GRAD_LOOP)

    worst["smoother kuka7"] = check_grads(
        f"smoother kuka7 (embed 128, batch 8 of the replay's {len(replays[0])} paths, l_pad "
        f"{l_pad}, loop {SMOOTHER_GRAD_LOOP})", fresh_smoother, smoother_loss, dev)

    nb = records["next"]["args"][4]
    fresh_next = str2next("maze2easy", str2env("maze2easy", dev)[0])[0].net
    loss_fn = t_next.make_next_loss()

    def next_loss(m, device):
        return loss_fn(m, *(t.to(device) for t in nb))

    worst["next maze2"] = check_grads(
        f"NEXT Model2D maze2 (one path of {int(nb[5].sum())} waypoints, padded to "
        f"{nb[0].shape[0]})", fresh_next, next_loss, dev)
    print(f"  grads: tolerance |diff| <= {GRAD_RTOL:g} max|g| + {GRAD_ATOL:g}; the largest "
          f"share of it {json.dumps(worst)}", flush=True)

    # a step at steady state: the captured batches, 3 warm-up steps, then 10
    from gnn_motion_planning_tpu_torch.training.optim import adam, sgd_decayed

    s_batch, s_loop = records["smoother"]["args"][3], records["smoother"]["args"][4]
    e_loop = records["explorer"]["args"][4]
    for label, module, make_opt, step, samples in (
            (f"train_explorer kuka7 (8 samples, loop {e_loop})", fresh_explorer, adam,
             lambda m, o, l: t_explorer.train_step(m, o, l, ex, e_loop), ex.v.shape[0]),
            (f"train_smoother kuka7 (2 samples, l_pad {s_batch[0].shape[1]}, loop {s_loop})",
             fresh_smoother, sgd_decayed,
             lambda m, o, l: t_smoother.train_step(m, o, l, s_batch, s_loop), 2),
            ("train_next maze2 (one path)", fresh_next, adam,
             lambda m, o, l: t_next.train_step(loss_fn, m, o, l, nb), 1)):
        ms = steady_step_ms(module, make_opt, step)
        print(f"  steady step {label}: {ms:.3f} ms (median of 10 after 3, CUDA events), "
              f"{samples / ms * 1e3:.1f} samples/s ({card})", flush=True)

    # (c) a checkpoint round trip: npz out and back, the forward bit for bit;
    # deterministic kernels (the segment sums' atomics would otherwise
    # round differently from call to call; warn_only: cuBLAS is left as is)
    import warnings

    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        path = Path(tmp.name) / "round_trip.npz"
        save_npz(explorer, path)
        back = load_npz(Explorer(explorer.cfg), path).to(dev)
        one = [t[0] for t in ex[:8]]
        same = {"explorer": torch.equal(explorer_forward(explorer, *one, loop=8),
                                        explorer_forward(back, *one, loop=8))}
        save_npz(smoother, path)
        back_s = load_npz(Smoother(smoother.cfg), path).to(dev)
        args = [c[0].to(dev) for c in cols]
        s_args = (*args[:4], int(args[4]), *args[5:8])
        same["smoother"] = torch.equal(smoother_forward(smoother, *s_args, loop=2),
                                       smoother_forward(back_s, *s_args, loop=2))
        net = next_model.net
        save_npz(net, path)
        back_n = load_npz(NextNet(net.cfg, net.attention_g.mlp[0].in_features), path).to(dev)
        same["next"] = torch.equal(state_forward(net, nb[0], pb_forward(net, nb[2], nb[1])),
                                   state_forward(back_n, nb[0], pb_forward(back_n, nb[2], nb[1])))
        torch.use_deterministic_algorithms(False)
    tmp.cleanup()
    print(f"  checkpoint round trip, the forwards bit for bit equal: {json.dumps(same)}",
          flush=True)
    if not all(same.values()):
        raise AssertionError("a trained module and its npz round trip differ")


def flat_proj_off_rows(dev, envs: dict, counted, card: str) -> None:
    """Phase 11 (b): eval_gnn on each env with ``GMP_FLAT_PROJ=0`` (the
    dense sweep at the K_CHEAP budget where the env has a cheap edge check,
    ur5; the full sweep on kuka7) against the default (flat) rows of the same
    call, with the smoothing's seconds and overflow redos of both."""

    import os

    import torch

    evaluation = importlib.import_module("gnn_motion_planning_tpu_torch.api.eval_gnn")
    fixture = json.loads((REPO / "tests" / "data" / "torch_port_cheap_jax.json").read_text())
    inner = evaluation.model_smooth
    for config, (env, model, model_s) in envs.items():
        out = {}
        for flag in ("auto", "0"):
            os.environ["GMP_FLAT_PROJ"] = flag
            env._torch_planner = None  # the planner reads the flag when it is built
            seconds = [0.0]

            def timed_smooth(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                path = inner(*args, **kwargs)
                torch.cuda.synchronize()
                seconds[0] += time.perf_counter() - t0
                return path

            evaluation.model_smooth = timed_smooth
            rows = []
            try:
                counted(f"{config} GMP_FLAT_PROJ={flag}", lambda: quiet(
                    evaluation.eval_gnn, config, SEED, env, PHASE11_PROJ_PROBLEMS, model=model,
                    model_s=model_s, rows=rows, **protocol(config)))
            finally:
                evaluation.model_smooth = inner
            redos = evaluation.get_planner(env).overflow_redos
            out[flag] = rows
            print(f"  {config} GMP_FLAT_PROJ={flag}: smoothing {seconds[0]:.3f} s over "
                  f"{len(rows)} problems, {redos} overflow redos "
                  f"({evaluation.get_planner(env).project_cheap.__qualname__}) ({card})",
                  flush=True)
        os.environ.pop("GMP_FLAT_PROJ")
        env._torch_planner = None
        for got, ref, want in zip(out["0"], out["auto"], fixture["rows"][config]):
            same = all(got[k] == want[k] for k in ("success", "c_explore", "c_smooth")) and \
                abs(got["cost"] - want["cost"]) < 1e-3
            print(f"  flag=0 {json.dumps(got)}", flush=True)
            print(f"  jax    {json.dumps(want)} {'agree' if same else 'DIFFER'}", flush=True)
            if not (all(got[k] == ref[k] for k in ("index", "success", "c_explore", "c_smooth"))
                    and abs(got["cost"] - ref["cost"]) < 1e-3):
                raise AssertionError(f"{config}: GMP_FLAT_PROJ=0 row {got} differs from the "
                                     f"default row {ref} of this run")


def sampler_biases(dev, envs: dict, counted, card: str) -> None:
    """Phase 11 (c): each bias's accepted stream on the card against the
    CPU (enforced), then one eval_gnn row each beside the JAX fixture."""

    import numpy as np

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn
    from gnn_motion_planning_tpu_torch.api.registry import str2env
    from gnn_motion_planning_tpu_torch.config import problem_rng

    fixture = json.loads((REPO / "tests" / "data" / "torch_port_bias_jax_rows.json").read_text())
    for config, bias in PHASE11_BIASES:
        env, model, model_s = envs[config]
        cpu_env = str2env(config, device="cpu")[0]
        streams = []
        for e in (env, cpu_env):
            e.sampler_bias = bias
            e.init_new_problem(PHASE11_BIAS_PROBLEM)
            e.rng = problem_rng(SEED, PHASE11_BIAS_PROBLEM)
            e._accept_rate = None

            def draw(e=e):
                return e.sample_n_points(PHASE11_BIAS_SAMPLES, need_negative=True)

            free, coll = counted(f"{config} {bias} sampling", draw)[0] if e is env else draw()
            streams.append((np.asarray(free), np.asarray(coll), e.collision_check_count))
        same = all(np.array_equal(a, b) for a, b in zip(*streams))
        print(f"  {config} {bias}: {len(streams[0][0])} accepted of {streams[0][2]} draws, card "
              f"and CPU streams {'equal' if same else 'DIFFER'}", flush=True)
        if not same:
            raise AssertionError(f"{config} {bias}: the card's stream differs from the CPU's")
        rows = []
        t0 = time.perf_counter()
        counted(f"{config} {bias} eval_gnn", lambda: quiet(
            eval_gnn, config, SEED, env, [PHASE11_BIAS_PROBLEM], model=model, model_s=model_s,
            rows=rows, **protocol(config)))
        want = fixture["rows"][f"{config}_{bias}"]
        agree = all(rows[0][k] == want[k] for k in ("success", "c_explore", "c_smooth")) and \
            abs(rows[0]["cost"] - want["cost"]) < 1e-3
        print(f"  port {json.dumps(rows[0])} {time.perf_counter() - t0:.2f} s", flush=True)
        print(f"  jax  {json.dumps(want)} {'agree' if agree else 'DIFFER'}", flush=True)
        env.sampler_bias = None


def the_rest(dev, env7, arm_envs: dict, counted, card: str) -> None:
    """Phase 11 (module docstring)."""

    import shutil
    import sys as _sys

    import numpy as np
    import torch

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn_batched
    from gnn_motion_planning_tpu_torch.api.registry import str2env, str2models, str2name
    from gnn_motion_planning_tpu_torch.envs import maze
    from gnn_motion_planning_tpu_torch.envs.snake import make_snake_grid_scene
    from gnn_motion_planning_tpu_torch.graphs import rgg
    from gnn_motion_planning_tpu_torch.models.convert import load_npz
    from gnn_motion_planning_tpu_torch.models.explorer import explorer_forward, scatter_policy
    from gnn_motion_planning_tpu_torch.models.smoother import smoother_forward
    from gnn_motion_planning_tpu_torch.parallel.mesh import make_mesh
    from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges
    from gnn_motion_planning_tpu_torch.training.explorer import (
        ExplorerBatch,
        frontier_cross_entropy,
        make_train_step,
    )
    from gnn_motion_planning_tpu_torch.training.optim import trainable_leaves
    from gnn_motion_planning_tpu_torch.utils.debug import jit_eager_consistent, profile_trace

    # (a) the scatter at repeated live (dst, src) pairs, card against CPU
    rng = np.random.RandomState(0)
    n, e = 64, 2048
    case = (rng.normal(size=e).astype(np.float32), rng.randint(0, n, e), rng.randint(0, n, e),
            rng.rand(e) < 0.8, rng.normal(size=(n, n)).astype(np.float32))
    out = {}
    for where in ("cpu", dev):
        score, src, dst, alive, weight = (torch.as_tensor(x, device=where) for x in case)
        score.requires_grad_(True)
        policy = scatter_policy(score, src, dst, alive, n)
        (policy * weight).sum().backward()
        out[str(where)] = (policy.detach().cpu(), score.grad.cpu())
    (p_cpu, g_cpu), (p_dev, g_dev) = out["cpu"], out[str(dev)]
    key = case[2] * n + case[1]
    live = np.flatnonzero(case[3])
    last = {k: i for i, k in zip(live, key[live])}  # the last live edge a key
    losers = np.setdiff1d(live, list(last.values()))
    winners_right = all(float(p_dev[k // n, k % n]) == case[0][i] for k, i in last.items())
    print(f"  scatter: {len(live)} live edges, {len(losers)} repeated (dst, src) losers; forward "
          f"card == CPU {torch.equal(p_cpu, p_dev)}, gradient card == CPU "
          f"{torch.equal(g_cpu, g_dev)}, losers' gradient 0 {bool((g_dev[losers] == 0).all())}, "
          f"last duplicate wins {winners_right}", flush=True)
    if not (torch.equal(p_cpu, p_dev) and torch.equal(g_cpu, g_dev) and len(losers)
            and bool((g_dev[losers] == 0).all()) and winners_right):
        raise AssertionError("the explorer's scatter at repeated pairs differs on the card")

    # (b) the cheap projection
    _, model7, _, model7_s, _ = str2name("kuka7", device=dev)
    flat_proj_off_rows(dev, {"kuka7": (env7, model7, model7_s), "ur5": arm_envs["ur5"]},
                       counted, card)

    # (c) the sampler biases
    k13 = str2name("kuka13", device=dev)
    sampler_biases(dev, {"kuka13": (k13[0], k13[1], k13[3]), "snake7": arm_envs["snake7"]},
                   counted, card)

    # (d) snake7's grid window against the full scan through entry A
    snake = arm_envs["snake7"][0]
    snake.init_new_problem(2000)
    oracle = snake.kernels().batch_state_free
    grid = make_snake_grid_scene(snake.map, dev)
    pr = np.array(snake.pose_range)
    qs = np.concatenate([np.random.RandomState(11).uniform(pr[:, 0], pr[:, 1], (4096, 7)),
                         near_contact_states(snake)]).astype(np.float32)
    q_t = torch.as_tensor(qs, device=dev)
    (full, _), counts = counted("snake7 full scan", lambda: oracle(snake.device_scene(), q_t))
    (win, _), _ = counted("snake7 grid window", lambda: oracle(grid, q_t))
    n_diff = int((full != win).sum())
    q4096 = q_t[:4096]
    ms = time_turns({"grid": lambda: oracle(grid, q4096),
                     "full": lambda: oracle(snake.device_scene(), q4096)}, reps=11, calls=5)
    print(f"  snake7 2000: grid window against the full scan on {len(qs)} states "
          f"({len(qs) - 4096} near contact): {n_diff} differ; ms per call at B = 4096: grid "
          f"{ms['grid']:.4f}, full scan (entry A) {ms['full']:.4f} ({card})", flush=True)
    if n_diff or counts["capsules_hit"] <= 0:
        raise AssertionError(f"snake7's grid window differs from the full scan: {n_diff}")

    # (e) the mesh on one card
    mesh = make_mesh(1)
    try:
        make_mesh(torch.cuda.device_count() + 1)
    except ValueError:
        pass
    else:
        raise AssertionError("make_mesh accepted more cards than exist")
    rows = {}
    for label, m in (("unsharded", None), ("mesh of 1", mesh)):
        rows[label] = []
        counted(f"kuka7 explore_batch {label}", lambda: quiet(
            eval_gnn_batched, "kuka7", SEED, env7, PHASE11_MESH_PROBLEMS, model7, model7_s,
            lanes=len(PHASE11_MESH_PROBLEMS), mesh=m, rows=rows[label], **protocol("kuka7")))
    same = len(rows["mesh of 1"]) == len(PHASE11_MESH_PROBLEMS) and all(
        all(a[k] == b[k] for k in ("index", "success", "c_explore", "c_smooth"))
        and abs(a["cost"] - b["cost"]) < 1e-3 for a, b in zip(rows["mesh of 1"], rows["unsharded"]))
    print(f"  explore_batch kuka7 {PHASE11_MESH_PROBLEMS} on make_mesh(1): rows "
          f"{'equal' if same else 'DIFFER'} to the unsharded", flush=True)
    if not same:
        raise AssertionError(f"sharded rows {rows['mesh of 1']} != {rows['unsharded']}")
    explorer = str2models("kuka7", dev, load=False)[0]
    b, n_nodes, n_edges = 8, 64, 512
    r = np.random.RandomState(1)
    frontier = np.zeros((b, n_nodes, n_nodes), bool)
    frontier[:, 0, :] = True
    ex = ExplorerBatch(*(torch.as_tensor(a, device=dev) for a in (
        r.uniform(-2, 2, (b, n_nodes, 7)).astype(np.float32), np.ones((b, n_nodes), bool),
        r.uniform(-2, 2, (b, 7)).astype(np.float32), r.randint(0, n_nodes, (b, n_edges)),
        r.randint(0, n_nodes, (b, n_edges)), np.ones((b, n_edges), bool),
        r.uniform(-1, 1, (b, 16, 6)).astype(np.float32), np.ones((b, 16), bool), frontier,
        np.full(b, 5), np.full(b, 5))))
    with torch.no_grad():
        want = float(frontier_cross_entropy(explorer, ex, 10))
    step, optimizer, _ = make_train_step(explorer.cfg, mesh=mesh)
    loss = step(explorer, optimizer(trainable_leaves(explorer)), ex)
    print(f"  make_train_step on make_mesh(1): loss {loss:.7f}, frontier_cross_entropy "
          f"{want:.7f}, relative difference {abs(loss - want) / abs(want):.2e}", flush=True)
    if not abs(loss - want) <= 1e-5 * abs(want):
        raise AssertionError("the mesh step's loss differs from frontier_cross_entropy")

    # (f) the scratch trainer on kuka7's committed slice, from a fresh init
    _sys.path.insert(0, str(REPO / "tools"))
    import torch_port_train_scratch as scratch

    out_dir = REPO / "build" / "torch_port" / "smoke_weights"
    shutil.rmtree(out_dir, ignore_errors=True)
    (e_path, e_model, e_losses), _ = counted("kuka7 scratch explorer", lambda: quiet(
        scratch.train_explorer_scratch, "kuka7", 8, PHASE11_SCRATCH_ITERS,
        data_path=REPO / "tests" / "data" / "torch_port_prm_kuka7_8.pkl", out_dir=out_dir,
        device=dev))
    (s_path, s_model, s_losses), counts = counted("kuka7 scratch smoother", lambda: quiet(
        scratch.train_smoother_scratch, "kuka7", PHASE11_SMOOTHER_PROBLEMS, 1,
        PHASE11_SCRATCH_STEPS, out_dir=out_dir, device=dev))
    print(f"  scratch explorer kuka7: losses {e_losses} -> {e_path.relative_to(REPO)}", flush=True)
    print(f"  scratch smoother kuka7: losses {s_losses} -> {s_path.relative_to(REPO)}", flush=True)
    if not (e_losses and s_losses and np.isfinite(e_losses + s_losses).all()):
        raise AssertionError("the scratch trainer's losses are missing or not finite")
    import warnings

    with torch.no_grad(), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.use_deterministic_algorithms(True, warn_only=True)
        fresh_e, fresh_s = str2models("kuka7", dev, load=False)
        back_e, back_s = load_npz(fresh_e, e_path), load_npz(fresh_s, s_path)
        one = [t[0] for t in ex[:8]]
        same_e = torch.equal(explorer_forward(e_model, *one, loop=5),
                             explorer_forward(back_e, *one, loop=5))
        L = 16
        path = torch.as_tensor(r.uniform(-2, 2, (L, 7)).astype(np.float32), device=dev)
        nodes = torch.as_tensor(r.uniform(-2, 2, (1000, 7)).astype(np.float32), device=dev)
        s_args = (path, torch.arange(L, device=dev) < 10, nodes,
                  torch.ones(1000, dtype=torch.bool, device=dev), 500,
                  *(torch.as_tensor(a, device=dev) for a in base_chain_edges(L, 10)))
        same_s = torch.equal(smoother_forward(s_model, *s_args, loop=1),
                             smoother_forward(back_s, *s_args, loop=1))
        torch.use_deterministic_algorithms(False)
    print(f"  scratch checkpoints read back, forwards bit for bit equal: explorer {same_e}, "
          f"smoother {same_s}", flush=True)
    if not (same_e and same_s):
        raise AssertionError("a scratch checkpoint does not read back to the trained model")

    # (g) rgg.Graph on kuka7 2000 (and maze2easy 2000, whose r-disc graph
    # has edges: kuka7's radius is the 3-D workspace's, so its 7-D graph
    # keeps only the self loops, in both packages), card env against CPU env
    m_env = str2env("maze2easy", device=dev)[0]
    for config, card_env in (("kuka7", env7), ("maze2easy", m_env)):
        graphs = []
        for e in (card_env, str2env(config, device="cpu")[0]):
            e.init_new_problem(2000)
            e.rng = None
            np.random.seed(0)
            g = rgg.Graph(e).initialize(PHASE11_RGG_SAMPLES)
            graphs.append((g.V, g.E, g.E_attr, g.random_problem(np.random.RandomState(1))))
        same = graphs[0] == graphs[1]
        print(f"  rgg.Graph {config} 2000: {len(graphs[0][0])} vertices, {len(graphs[0][1])} "
              f"edges, random problem {graphs[0][3]}; card == CPU {same}", flush=True)
        if not same:
            raise AssertionError(f"rgg.Graph on {config} on the card differs from the CPU's")

    # (h) debug: eager against a CUDA graph, and a profiler trace
    m_env.init_new_problem(2000)
    a = torch.as_tensor(r.uniform(-1, 1, (4096, 2)).astype(np.float32), device=dev)
    b2 = torch.as_tensor(r.uniform(-1, 1, (4096, 2)).astype(np.float32), device=dev)
    jit_eager_consistent(maze.edge_free_2d, m_env.device_scene(), a, b2)
    trace_dir = REPO / "build" / "torch_port" / "smoke_trace"
    with profile_trace(str(trace_dir)):
        maze.edge_free_2d(m_env.device_scene(), a, b2)
        torch.cuda.synchronize()
    size = (trace_dir / "trace.json").stat().st_size
    print(f"  jit_eager_consistent(maze edge_free_2d, 4096 edges): eager == CUDA graph; "
          f"profile_trace wrote {size} bytes", flush=True)
    if size <= 0:
        raise AssertionError("profile_trace wrote no trace")


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
        env7 = env  # phases 4 and 5 rebind env; phase 6 times kuka7's lane shapes
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

        # the lane axis at the shapes the batched and serve paths give it:
        # one search pop of L lanes (2 + k_max states a lane), the flat
        # projection and the serve sampling of one problem; every lane its
        # own problem's scene
        n_lane_b, n_lane_a, lane_a_inputs = [], [], {}
        k14 = arm_envs["kuka14"][0]
        for L, B_l in LANE_SHAPES:
            B_l = B_l or 2 + env._k_max()
            n_lane_b.append(check_chain_lanes(
                f"kuka7 problems 2000-{1999 + L}", env,
                lane_configs(env, L, B_l, seed=L + B_l), stacked_scenes(env, range(2000, 2000 + L))))
        for L, B_l in LANE_SHAPES:
            B_l = B_l or 2 + k14._k_max()
            n_oracle, n_kernel, args = check_env_oracle(
                "kuka14", k14, lane_configs(k14, L, B_l, seed=L + B_l),
                stacked_scenes(k14, range(2000, 2000 + L)))
            n_lane_a += [n_oracle, n_kernel]
            lane_a_inputs[(L, B_l)] = args
        env.init_new_problem(INDEXES[0])
        k14.init_new_problem(2000)
        if sum(n_lane_b) or sum(n_lane_a):
            raise AssertionError(f"the lane axis differs from the plain versions: entry B "
                                 f"{n_lane_b}, kuka14 oracle and entry A {n_lane_a}")
        near = {config: check_near_contact(config, dev) for config in NEAR_CONFIGS}
        if sum(near.values()):
            raise AssertionError(f"near-contact decisions differ: {near}")

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

    launches: dict = {}  # summed over the paths of phases 2 and 4-8
    with phase("2 eval_gnn kuka7 end to end"):
        main_path("kuka7", env, model, model_s, INDEXES)

    with phase("3 timing"):
        env.init_new_problem(INDEXES[0])  # phase 2 left the env on another problem
        # 4096 feeds the kernels line; the small batches take fewer turns
        timings = {4096: time_batch(env, 4096, card)}
        timings.update({batch: time_batch(env, batch, card, reps=5, calls=3)
                        for batch in (31, 1)})
        for batch in (31, 4096):
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
                staged = indexes[:1] if config == "maze3" else indexes
                print_stages(config, stage_breakdown(config, env, model, model_s, staged),
                             len(staged), card)
                time_oracle(env, card)
            if config == "maze2easy":  # one trace a phase (PERF.md keeps the others')
                device_busy_share(config, env, model, model_s, indexes[0], card)

    with phase("5 eval_gnn ur5, kuka14, snake7 end to end"):
        for config, indexes in PHASE5_PROBLEMS.items():
            env, model, model_s = arm_envs[config]
            main_path(config, env, model, model_s, indexes)
            time_entry_a(config, entry_a_inputs[config], card, reps=5, calls=3)
            if config in ("ur5", "snake7"):
                staged = indexes[:1]
                print_stages(config, stage_breakdown(config, env, model, model_s, staged),
                             len(staged), card)
                time_oracle(env, card)
            if config == "ur5":  # one trace a phase
                device_busy_share(config, env, model, model_s, indexes[0], card)

    from gnn_motion_planning_tpu_torch.api.eval_gnn import eval_gnn_batched, eval_gnn_serve

    counted = launch_counter(launches)

    with phase("6 eval_gnn_batched kuka7, kuka14, maze2easy"):
        for config, lanes, indexes in BATCHED_CELLS:
            b_env, b_model, _, b_model_s, _ = str2name(config, device=dev)
            stats, rows_b = [], []
            t0 = time.perf_counter()
            (out_b, counts) = counted(f"{config} batched", lambda: eval_gnn_batched(
                config, SEED, b_env, indexes, b_model, b_model_s, lanes=lanes, stats=stats,
                rows=rows_b, **protocol(config)))
            t_batched = time.perf_counter() - t0
            if config in FUSED_CONFIGS and counts["chain_states_free"] <= 0:
                raise AssertionError(f"the batched {config} path never launched chain_states_free")
            if config in PHASE5_PROBLEMS and counts["capsules_hit"] <= 0:
                raise AssertionError(f"the batched {config} path never launched capsules_hit")
            report_rows(config, b_env, rows_b[:5], out_b[6][:5])
            for row, path in zip(rows_b, out_b[6]):
                check_path(config, b_env, row, path)
            if out_b[0] == 0:
                raise AssertionError(f"batched {config}: no problem solved")
            print_group_stats(config, stats)
            rows_s = []
            t0 = time.perf_counter()
            eval_gnn(config, SEED, b_env, indexes, model=b_model, model_s=b_model_s, rows=rows_s,
                     **protocol(config))
            t_scalar = time.perf_counter() - t0
            agree = sum(
                all(a[k] == b[k] for k in ("success", "c_explore", "c_smooth")) and
                abs(a["cost"] - b["cost"]) < 1e-3 for a, b in zip(rows_b, rows_s))
            print(f"  {config}: batched rows agreeing with the port's scalar rows: {agree} of "
                  f"{len(rows_b)}", flush=True)
            print(f"  {config}: {len(indexes)} problems, batched {t_batched:.2f} s "
                  f"({len(indexes) / t_batched:.2f} problems/s, {lanes} lanes), scalar "
                  f"{t_scalar:.2f} s ({len(indexes) / t_scalar:.2f} problems/s) ({card})",
                  flush=True)
        # the lane shapes' timing: a search pop and the flat projection of
        # 25 and 8 lanes of kuka7 (entries A and B on its capsules), the
        # scalar projection and serve sampling shapes, and entry A on
        # kuka14's lane oracle inputs
        for L, B_l in LANE_SHAPES:
            B_l = B_l or 2 + env7._k_max()
            time_batch(
                env7, B_l, card, lanes=L, scene=stacked_scenes(env7, range(2000, 2000 + L)),
                label=f"kuka7 problems 2000-{1999 + L}", reps=5, calls=3)
        for (L, B_l), args in lane_a_inputs.items():
            time_entry_a(f"kuka14 L={L}", args, card, reps=5, calls=3)

    with phase("7 eval_gnn_serve kuka7, maze2easy"):
        for config, indexes in SERVE_CELLS.items():
            s_env, s_model, _, s_model_s, _ = str2name(config, device=dev)
            rows = []
            out_s, counts = counted(f"{config} serve", lambda: eval_gnn_serve(
                config, SEED, s_env, indexes, s_model, s_model_s, rows=rows, batch=500, k=30))
            if config in FUSED_CONFIGS and counts["chain_states_free"] <= 0:
                raise AssertionError(f"the {config} serve path never launched chain_states_free")
            for row in rows:
                print(f"  serve {json.dumps(row)}", flush=True)
            print(f"  serve {config}: solved {out_s[0]} of {len(indexes)}, p50 {out_s[5]:.4f} s, "
                  f"p95 {out_s[6]:.4f} s ({card})", flush=True)
            if out_s[0] == 0:
                raise AssertionError(f"serve {config}: no problem solved")
            same, d_path, d_smooth = serve_composition(config, s_env, s_model, s_model_s,
                                                       indexes[0])
            if not (same and d_path <= 1e-6 and d_smooth <= 1e-5):
                raise AssertionError(
                    f"{config}: serve_full differs from serve_round + backtrack + model_smooth")

    with phase("8 baselines"):
        baselines(dev, arm_envs, counted, card)

    with phase("9 training"):
        training(dev, counted, card)

    with phase("10 strict and audit"):
        envs = {config: arm_envs[config][0] for config in ("ur5", "kuka14")}
        envs["kuka7"] = env7
        envs["kuka13"] = KukaEnv(kuka_file="kuka_iiwa/model_3.urdf",
                                 map_file="maze_files/kukas_13_3000.pkl", device=dev)
        strict_and_audit(dev, envs, arm_envs["kuka14"][1:], counted, card)

    with phase("11 the rest"):
        the_rest(dev, env7, arm_envs, counted, card)

    faulthandler.cancel_dump_traceback_later()
    print_kernels(launches, max_abs_err, timings[4096])
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
