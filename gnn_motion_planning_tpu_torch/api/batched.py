"""Lane-batched planning: many problems per device call (port of
gnn_motion_planning_tpu/api/batched.py, the JAX package's serving shape).

:func:`explore_batch` plans a group of problems at once: per-lane host
sampling, the RGG build and explorer forward over the lane group, the greedy
search of every lane in ``chunk``-pop calls with finished lanes dropped
between them, and batched smoothing. Every problem keeps its own
``problem_rng(seed, index)`` stream, so its metrics equal the scalar
protocol path's (``api/eval_gnn.py``). :func:`eval_gnn_batched` is the
sweep driver printing the reference metric block.

Left out of the JAX driver: the padding of lane groups to power-of-two
widths with dummy lanes, which exists there only to reuse compiled
programs: here a call takes exactly the live lanes, and no result depends
on the grouping. With a ``mesh`` a group is padded to a multiple of the
mesh size, as there, so that its shards are even.
"""

from __future__ import annotations

import importlib
from time import time

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.api.planner_bundle import get_planner
from gnn_motion_planning_tpu_torch.config import problem_rng, set_random_seed
from gnn_motion_planning_tpu_torch.envs.base import stack_scenes
from gnn_motion_planning_tpu_torch.graphs.knn import build_rgg_edges_lanes, k_scaled
from gnn_motion_planning_tpu_torch.models.explorer import explorer_forward_lanes
from gnn_motion_planning_tpu_torch.models.smoother import Smoother, smoother_forward_lanes
from gnn_motion_planning_tpu_torch.parallel.mesh import same_device
from gnn_motion_planning_tpu_torch.planners.gnn_explore import backtrack
from gnn_motion_planning_tpu_torch.planners.gnn_smooth import base_chain_edges, pad_to_bucket
from gnn_motion_planning_tpu_torch.planners.oracle_smoother import joint_smoother

# the adaptive tail chunk never pops more than this in one call
MAX_CHUNK = 4096


def _protocol():
    """The scalar protocol drivers, imported at call time (api.eval_gnn
    re-exports this module's entry points)."""

    return importlib.import_module("gnn_motion_planning_tpu_torch.api.eval_gnn")


def _lane_rows(tensors, sel):
    """Rows ``sel`` of every tensor (or tuple of tensors) along the lane
    axis: the survivors of a lane group."""

    if isinstance(tensors, torch.Tensor):
        return tensors.index_select(0, sel)
    rows = [_lane_rows(t, sel) for t in tensors]
    return type(tensors)(*rows) if hasattr(tensors, "_fields") else tuple(rows)


def _sample_lane(env, seed: int, index: int, batch: int):
    """Problem ``index`` on its own stream: the scalar path's first round
    (nodes, masks, goal, obstacle tokens) and the checks its sampling took."""

    d = env.config_dim
    env.rng = problem_rng(seed, int(index))
    env.init_new_problem(int(index))
    c0 = env.collision_check_count
    free, collided = env.sample_n_points(batch, need_negative=True)
    collided = list(collided)[: len(free)]
    free = [np.asarray(env.init_state, np.float64), np.asarray(env.goal_state, np.float64)] + [
        np.asarray(f) for f in free
    ]
    F, C = len(free), len(collided)
    N = 2 * F
    v = np.zeros((N, d), np.float32)
    v[:F] = np.asarray(free, np.float32)
    if C:
        v[F : F + C] = np.asarray(collided, np.float32)
    valid = np.zeros(N, bool)
    valid[: F + C] = True
    coll = np.zeros(N, bool)
    coll[F : F + C] = True
    toks, tok_mask = env.obs_tokens()
    return dict(
        scene=env.device_scene(), v=v, valid=valid, coll=coll,
        goal=np.asarray(env.goal_state, np.float32), toks=toks, tok_mask=tok_mask,
        sample_checks=env.collision_check_count - c0, rng=env.rng,
    )


def _search(planner, st, chunk: int, round_log: list):
    """The lane-compaction search: each call advances every live lane by at
    most the chunk's pops; finished lanes drop out and the survivors resume
    from their carried state. Returns per lane (success, node, prev,
    explored, checks)."""

    B = st[1].shape[0]
    dev = st[1].device
    pool = np.arange(B)  # original lane of each stacked row
    out_success = np.zeros(B, bool)
    out_node = np.full(B, -1, np.int64)
    out_prev = [None] * B
    out_explored = [None] * B
    checks = np.zeros(B, np.int64)
    while True:
        t_r = time()
        # adaptive tail chunk (JAX batched.py:215-218): as compaction
        # narrows the group, a call's pop budget grows to match
        boost = 1
        while boost * 2 * len(pool) <= B:
            boost *= 2
        done0 = torch.zeros(len(pool), dtype=torch.bool, device=dev)
        res = planner.round_lanes(*st, done0, chunk=min(chunk * boost, MAX_CHUNK))
        done = res.done.cpu().numpy()
        checks[pool] += res.n_checks.cpu().numpy()
        round_log.append((len(pool), round(time() - t_r, 4)))
        fin = np.nonzero(done)[0]
        if fin.size:
            success = res.success.cpu().numpy()
            node = res.success_node.cpu().numpy()
            for r in fin:
                out_success[pool[r]] = success[r]
                out_node[pool[r]] = node[r]
                out_prev[pool[r]] = res.prev[r].cpu().numpy()
                out_explored[pool[r]] = res.explored[r].cpu().numpy()
        keep = np.nonzero(~done)[0]
        carried = st[:7] + (res.explored, res.prev, res.costs, res.edge_dead)
        if keep.size == 0:
            break
        if keep.size == len(pool):
            st = carried  # no lane finished: resume in place
            continue
        pool = pool[keep]
        st = _lane_rows(carried, torch.as_tensor(keep, device=dev))
    return out_success, out_node, out_prev, out_explored, checks


def _smooth_lanes(planner, model_s, lanes: dict, paths: dict, F: int, d: int, dev):
    """Five smoothing iterations of every successful lane together (JAX
    batched.py:303-369): the cheap projection over the lane group, and a
    lane whose cheap projection overflowed redone alone at the full budget.
    Returns ({lane: smoothed path}, {lane: checks}, redone lanes)."""

    order = sorted(paths)
    P = len(order)
    l_pad = pad_to_bucket(max(len(paths[li]) for li in order))
    path_arr = np.zeros((P, l_pad, d), np.float32)
    mask_arr = np.zeros((P, l_pad), bool)
    envn = np.zeros((P, 1000, d), np.float32)
    envv = np.zeros((P, 1000), bool)
    nfree = np.zeros(P, np.int64)
    bases = []
    for pi, li in enumerate(order):
        p = paths[li]
        L = len(p)
        path_arr[pi, :L] = np.asarray(p, np.float32)
        path_arr[pi, L:] = path_arr[pi, L - 1]
        mask_arr[pi, :L] = True
        bases.append(base_chain_edges(l_pad, L))
        # env nodes: the free prefix (truncated to 500), then the collided block
        v, coll = lanes[li]["v"], lanes[li]["coll"]
        fr = v[:F][:500]
        envn[pi, : len(fr)] = fr
        envv[pi, : len(fr)] = True
        co = v[F : F + 500][coll[F : F + 500]]
        envn[pi, 500 : 500 + len(co)] = co
        envv[pi, 500 : 500 + len(co)] = True
        nfree[pi] = len(fr)

    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    scene = stack_scenes([lanes[li]["scene"] for li in order])
    mask, env_nodes, env_valid = t(mask_arr), t(envn), t(envv)
    bs, bd, ba = (t(np.stack(x)) for x in zip(*bases))
    n_paths = mask_arr.sum(axis=1)
    path = t(path_arr)
    counts = np.zeros(P, np.int64)
    overflow = np.zeros(P, bool)
    for _ in range(5):
        proposal = smoother_forward_lanes(model_s, path, mask, env_nodes, env_valid, nfree,
                                          bs, bd, ba, loop=1)
        path, cnt, ovf = planner.project_lanes_cheap(scene, path, proposal, n_paths)
        counts += np.asarray(cnt, np.int64)
        overflow |= np.asarray(ovf, bool)
    out = path.cpu().numpy()
    smooth_paths, smooth_counts, redone = {}, {}, 0
    for pi, li in enumerate(order):
        L = len(paths[li])
        if overflow[pi]:
            # the cheap budget overflowed: redo this lane at the full budget,
            # whose counts are the protocol result (JAX batched.py:350-367)
            redone += 1
            p_full, c_full = planner.smooth_full(
                model_s, lanes[li]["scene"], t(path_arr[pi]), mask[pi], env_nodes[pi],
                env_valid[pi], int(nfree[pi]), bs[pi], bd[pi], ba[pi], L)
            smooth_counts[li] = int(c_full)
            p_full = p_full.cpu().numpy()
            smooth_paths[li] = [p_full[i] for i in range(L)]
            continue
        smooth_counts[li] = int(counts[pi])
        smooth_paths[li] = [out[pi, i] for i in range(L)]
    return smooth_paths, smooth_counts, redone


def _plan_lanes(env, planner, model, model_s, group, smooth: bool, batch: int, k: int,
                loop: int, chunk: int, seed: int, results: dict, stats):
    """One lane group through sampling, the RGG build, the explorer forward,
    the lane search and smoothing; the lanes that succeed go into
    ``results`` by problem index."""

    d = env.config_dim
    dev = env.device
    t = lambda a: torch.as_tensor(np.stack(a), device=dev)  # noqa: E731
    B = len(group)
    t0 = time()
    lane = [_sample_lane(env, seed, idx, batch) for idx in group]
    t_sample = time() - t0

    F = batch + 2
    t_f = time()
    scene_b = stack_scenes([x["scene"] for x in lane])
    v_b, valid_b, coll_b = (t([x[key] for x in lane]) for key in ("v", "valid", "coll"))
    goal_b, toks_b, tmask_b = (t([x[key] for x in lane]) for key in ("goal", "toks", "tok_mask"))
    edges = build_rgg_edges_lanes(v_b, valid_b, F, k_scaled(k, F))
    policy = explorer_forward_lanes(model, v_b, valid_b, goal_b, edges, toks_b, tmask_b, loop)
    t_forward = time() - t_f

    N = v_b.shape[1]
    explored0 = torch.zeros((B, N), dtype=torch.bool, device=dev)
    explored0[:, 0] = True
    st = (scene_b, v_b, goal_b, policy, edges, coll_b, valid_b, explored0,
          torch.zeros((B, N), dtype=torch.int64, device=dev),
          torch.zeros((B, N), dtype=torch.float32, device=dev),
          torch.zeros((B, N, N), dtype=torch.bool, device=dev))
    round_log: list = []
    success, node, prev, explored, checks = _search(planner, st, chunk, round_log)
    group_time = time() - t0

    paths = {}
    for li in range(B):
        if success[li]:
            paths[li] = [lane[li]["v"][i] for i in backtrack(prev[li], int(node[li]))]
    t_sm = time()
    smooth_paths, smooth_counts, redone = {}, {}, 0
    if smooth and paths and isinstance(model_s, Smoother):
        smooth_paths, smooth_counts, redone = _smooth_lanes(
            planner, model_s, dict(enumerate(lane)), paths, F, d, dev)
    elif smooth and paths:
        # no model smoother: the oracle smoother lane by lane, each on
        # its own stream where its sampling left it, as the scalar path
        for li in sorted(paths):
            env.rng = lane[li]["rng"]
            env.init_new_problem(int(group[li]))
            c_sm = env.collision_check_count
            smooth_paths[li] = joint_smoother(paths[li], env, iter=5)
            smooth_counts[li] = env.collision_check_count - c_sm
    smooth_time = time() - t_sm

    if stats is not None:
        stats.append({
            "group_size": B,
            "sample_s": round(t_sample, 4),
            "forward_s": round(t_forward, 4),
            "search_rounds": round_log,
            "search_s": round(sum(r[1] for r in round_log), 4),
            "smooth_s": round(smooth_time, 4),
            "smooth_overflow_redos": redone,
            "group_s": round(time() - t0, 4),
            "first_round_failures": int(B - success.sum()),
        })

    for li, idx in enumerate(group):
        if success[li]:
            results[idx] = {
                "c_explore": int(lane[li]["sample_checks"] + checks[li]),
                "c_smooth": int(smooth_counts.get(li, 0)),
                "explored": list(np.nonzero(explored[li])[0]),
                "forward": group_time / B,
                "total": group_time / B + smooth_time / max(len(paths), 1),
                "total_explore": group_time / B,
                "success": True,
                "path": paths[li],
                "smooth_path": smooth_paths.get(li, paths[li] if smooth else []),
            }


def _my_shards(mesh, group, env_device):
    """This process's shards of a lane group over ``mesh``: the group padded
    with copies of its first lane to a multiple of the mesh size (JAX
    batched.py:144-152), cut into equal contiguous shards. Every shard runs
    on the env's device: a card a process, the torch.distributed way."""

    W = max(mesh.size, -(-len(group) // mesh.size) * mesh.size)
    padded = list(group) + [group[0]] * (W - len(group))
    per = W // mesh.size
    out = []
    for i, dev in enumerate(mesh.devices):
        if not same_device(dev, env_device):
            raise ValueError(f"a shard on {dev} but the env on {env_device}: run one process "
                             "a card (parallel/mesh.py::init_distributed, global_mesh)")
        lo = (mesh.first_shard + i) * per
        out.append(padded[lo : lo + per])
    return out


@torch.no_grad()
def explore_batch(env, model, model_s, indexes, smooth: bool = True, batch: int = 500,
                  t_max: int = 500, k: int = 30, loop: int = 5, lanes: int = 25,
                  chunk: int = 64, seed: int = 1234, mesh=None, stats: list | None = None):
    """Plan a group of problems at once (JAX ``explore_batch``). The RGG
    build and the explorer forward run over the lane group; the greedy
    search runs in ``chunk``-pop calls that advance every live lane with one
    oracle call a pop, finished lanes dropping out between calls. Per-lane
    semantics (masks, collision counts) are exactly those of
    :func:`explore`'s first round; lanes that fail their first round fall
    back to the scalar multi-round path, re-seeded from the start of their
    stream, so each problem's metrics equal :func:`eval_gnn`'s.

    ``mesh`` (``parallel/mesh.py``): each lane group is padded to a
    multiple of the mesh size and cut into one shard a mesh entry, run on
    its device; the processes of a multi-process mesh then exchange their
    results, so each returns every problem's. The metrics do not change
    with the sharding.

    ``stats``: an optional list; one dict per lane group (per shard) is
    appended with its phase breakdown (host sampling, forward, the search
    calls with their stacked widths, smoothing, overflow redos), and one for
    the scalar fallbacks. Returns a list of per-problem result dicts (the
    payload of :func:`explore`).
    """

    planner = get_planner(env)
    indexes = list(indexes)
    results = {}
    mine = []  # the problems this process planned

    for g0 in range(0, len(indexes), lanes):
        group = indexes[g0 : g0 + lanes]
        for part in ([group] if mesh is None else _my_shards(mesh, group, env.device)):
            mine.extend(part)
            _plan_lanes(env, planner, model, model_s, part, smooth, batch, k, loop, chunk, seed,
                        results, stats)

    # the scalar fallback for lanes whose single batched round failed: the
    # problem's stream re-seeded from its start, so the fallback is the
    # scalar run of that problem (its first round repeats the failed one)
    t_fb = time()
    n_fb = 0
    for idx in dict.fromkeys(mine):
        if idx not in results:
            n_fb += 1
            env.rng = problem_rng(seed, int(idx))
            env.init_new_problem(int(idx))
            results[idx] = _protocol().explore(env, model, model_s, smooth=smooth, batch=batch,
                                               t_max=t_max, k=k, loop=loop)
    if stats is not None and n_fb:
        stats.append({"scalar_fallbacks": n_fb, "fallback_s": round(time() - t_fb, 4)})
    if mesh is not None and mesh.process_count > 1:
        gathered = [None] * mesh.process_count
        torch.distributed.all_gather_object(gathered, results)
        for part in gathered:
            results.update(part)
    return [results[idx] for idx in indexes]


def eval_gnn_batched(str_, seed, env, indexes, model=None, model_s=None, lanes: int = 25,
                     smooth: bool = True, batch: int = 500, t_max: int = 500, k: int = 30,
                     chunk: int = 64, mesh=None, stats: list | None = None,
                     rows: list | None = None):
    """Batched-lane benchmark sweep: the metrics of :func:`eval_gnn`, with
    problems planned ``lanes`` at a time (JAX ``eval_gnn_batched``).
    Success, checks and cost equal the scalar protocol's per problem; the
    "running time" is the group's wall time per problem (a throughput),
    not the reference's per-problem latency. ``mesh`` shards the lanes
    (:func:`explore_batch`; ``parallel.mesh.make_mesh(n)`` or
    ``global_mesh()``); the metrics do not change with it. ``rows``, if
    given, receives one dict per problem (index, success, c_explore,
    c_smooth, cost)."""

    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2models

    set_random_seed(seed)
    if model is None or model_s is None:
        m, m_s = str2models(str_, env.device, smoother_scale(str_, env))
        model = m if model is None else model
        model_s = m_s if model_s is None else model_s

    t0 = time()
    results = explore_batch(env, model, model_s, indexes, smooth=smooth, batch=batch,
                            t_max=t_max, k=k, lanes=lanes, chunk=chunk, seed=seed, mesh=mesh,
                            stats=stats)
    wall = time() - t0

    path_cost = _protocol().path_cost
    solutions = [
        (r["success"], path_cost(r["path"]), path_cost(r["smooth_path"]), r["c_explore"],
         r["c_smooth"], r["total"], r["total_explore"])
        for r in results
    ]
    if rows is not None:
        for index, s in zip(indexes, solutions):
            rows.append(dict(index=int(index), success=bool(s[0]), c_explore=int(s[3]),
                             c_smooth=int(s[4]), cost=s[2]))
    n_success = sum(s[0] for s in solutions)
    collision = float(np.mean([s[3] + s[4] for s in solutions]))
    collision_explore = float(np.mean([s[3] for s in solutions]))
    solution_cost = (
        float(sum(s[2] for s in solutions if s[0])) / n_success if n_success else float("nan")
    )

    print("success rate:", n_success)
    print("collision check: %.2f" % collision)
    print("collision check explore: %.2f" % collision_explore)
    print("running time: %.2f" % (wall / max(n_success, 1)))
    print("path cost: %.2f" % solution_cost)
    print("total time: %.2f" % wall)
    print("")
    return (
        n_success, collision, wall / max(n_success, 1), solution_cost, wall,
        [r["path"] for r in results], [r["smooth_path"] for r in results],
        collision_explore, wall,
    )
