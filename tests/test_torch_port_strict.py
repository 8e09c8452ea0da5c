"""The strict-hull verifier and the strict fallback in the port
(``envs/strict.py``, ``planners/strict_fallback.py``, ``explore(...,
strict_fallback=True)``) against the JAX package's, on the CPU.

- Surface points: the port's builder gives JAX's points and frames bit for
  bit (``model_0``, ``model_3``, ur5).
- ``strict_hit``: decisions equal to JAX's ``make_strict_hit`` (kuka7,
  kuka13), ur5's plane mask and ``make_strict_hit_dual`` (kuka14) on 1,024
  seeded states per env in problem 2000's scene, plus states bisected to
  2**-17 .. 2**-20 from a strict-contact boundary; world points within
  1e-6 (they are XLA's bit for bit: ``envs/strict.py``'s docstring).
- ``validate_path_strict`` counts on seeded paths; the JAX file's
  soundness tests (known-free starts and goals 2000-2015; the swallowing
  box) and the stub tests of ``tests/test_strict_fallback.py``, mirrored.
- kuka14 problem 2170, the ``oracle_conservatism`` witness: every edge
  that JAX's fallback re-admitted is capsule-blocked and hull-free in the
  port; the whole run (slow) gives JAX's row.

JAX's 2170 row, its path's node indices and its re-admitted edges, the
surface hashes, the audit's counts and the RGG audit dicts are a fixture
(``tests/data/torch_port_strict_jax.json``), written by the JAX package on
the CPU: ``python tests/test_torch_port_strict.py``.
"""

import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
FIXTURE = REPO / "tests" / "data" / "torch_port_strict_jax.json"
URDFS = {"kuka7": "kuka_iiwa/model_0.urdf", "kuka13": "kuka_iiwa/model_3.urdf",
         "ur5": "ur5/ur5.urdf"}
WITNESS = 2170  # kuka14, assets/benchmarks/strict_fallback_kuka14.json
PROTOCOL = dict(batch=500, t_max=500, k=30)
RGG_CASES = [("maze2easy", 2000), ("kuka7", 2000)]
STRICT_CONFIGS = ["kuka7", "kuka13", "ur5", "kuka14"]
# the audit's configurations: tools/strict_verifier.py's, and the CPU
# tests' (four chunks of 256)
AUDIT_CONFIGS, AUDIT_SMALL = 100_000, 1024
# the fallback at a cut budget: 2170 recovered, 2118 given up
CUT = dict(batch=50, t_max=50, k=30)
CUT_PROBLEMS = [2170, 2118]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: pytest-xdist runs six test files at once."""

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _jax_env(config):
    from gnn_motion_planning_tpu.api.registry import str2env

    return str2env(config)[0]


def _port_env(config):
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    return str2env(config, device="cpu")[0]


def witness_run(explore, problem_rng, env, model, model_s, fallback_module,
                index: int = WITNESS, protocol=None):
    """A kuka14 problem through ``explore(strict_fallback=True)`` (at the
    reference protocol unless ``protocol`` is given), with the fallback's
    hull verifications and its returned node path recorded: (result,
    record). ``explore``, ``problem_rng`` and ``fallback_module`` are one
    package's."""

    record = {"verified": [], "idx_path": None, "v": None}
    verify, plan = fallback_module._hull_verify_edge, fallback_module.strict_fallback_path

    def hull_verify_edge(env_, strict_hit, a, b):
        ok = verify(env_, strict_hit, a, b)
        record["verified"].append((np.asarray(a, np.float32), np.asarray(b, np.float32), bool(ok)))
        return ok

    def strict_fallback_path(env_, v_np, n_free, edges, edge_dead, **kw):
        record["v"] = v_np
        record["idx_path"] = plan(env_, v_np, n_free, edges, edge_dead, **kw)
        return record["idx_path"]

    fallback_module._hull_verify_edge = hull_verify_edge
    fallback_module.strict_fallback_path = strict_fallback_path
    try:
        env.rng = problem_rng(1234, index)
        env.init_new_problem(index)
        t0 = time.time()
        res = explore(env, model, model_s, smooth=True, strict_fallback=True,
                      **(protocol or PROTOCOL))
        res["seconds"] = time.time() - t0
    finally:
        fallback_module._hull_verify_edge = verify
        fallback_module.strict_fallback_path = plan
    return res, record


def node_index(v: np.ndarray, q: np.ndarray) -> int:
    return int(np.nonzero((v == q[None]).all(axis=1))[0][0])


def witness_row(env, index: int, res: dict, rec: dict, path_cost) -> dict:
    """A fallback run's row: the result, the returned node path, every hull
    verification as (node, node, free), and the env's capsule ``_edge_fp``
    of each edge the hull check re-admitted. The fallback hull-verifies
    every edge the failed search popped (``edge_dead``, free or blocked)
    and every edge ``_edge_fp`` blocks."""

    v = rec["v"]
    verified = [[node_index(v, a), node_index(v, b), ok] for a, b, ok in rec["verified"]]
    readmitted = [[i, j] for i, j, ok in verified if ok]
    return dict(
        index=index, success=bool(res["success"]),
        strict_certified=bool(res["strict_certified"]),
        checks=int(res["c_explore"] + res["c_smooth"]), c_explore=int(res["c_explore"]),
        c_smooth=int(res["c_smooth"]), cost=path_cost(res["smooth_path"]),
        raw_cost=path_cost(res["path"]), n_nodes=int(len(v)),
        idx_path=None if rec["idx_path"] is None else [int(i) for i in rec["idx_path"]],
        hull_verified=verified, readmitted=readmitted,
        readmitted_states=[[v[i].tolist(), v[j].tolist()] for i, j in readmitted],
        readmitted_capsule_free=[bool(env._edge_fp(v[i], v[j])) for i, j in readmitted],
        seconds=res["seconds"],
    )


def jax_audit_counts(config: str, n_configs: int) -> dict:
    """``tools/strict_verifier.py::audit``'s cross-tabulation in the JAX
    package on the CPU (its loop, without writing the record)."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.envs.strict import strict_checker

    env = _jax_env(config)
    env.init_new_problem(2000)
    strict, kern = strict_checker(env), env.kernels()
    judge = jax.jit(lambda scene, qs: (
        jax.vmap(lambda q: kern.state_free(scene, q)[0])(qs),
        jax.vmap(lambda q: strict(scene, q))(qs)))
    pr = np.array(env.pose_range, np.float64)
    rng, chunk = np.random.RandomState(0), 256
    problems = list(range(2000, min(3000, len(env.problems))))
    c = np.zeros(4, np.int64)
    done = 0
    while done < n_configs:
        env.init_new_problem(problems[(done // chunk) % len(problems)])
        qs = rng.uniform(pr[:, 0], pr[:, 1], (chunk, env.config_dim))
        free, hit = (np.asarray(x) for x in judge(env.device_scene(), jnp.asarray(qs, jnp.float32)))
        c += [np.sum(free & ~hit), np.sum(free & hit), np.sum(~free & ~hit), np.sum(~free & hit)]
        done += chunk
    return dict(n_configs=done, capsule_free=int(c[0] + c[1]), false_free_proven=int(c[1]),
                capsule_collide=int(c[2] + c[3]), possible_false_collide=int(c[2]))


def write():
    """Run the JAX package on the CPU and write the fixture."""

    from gnn_motion_planning_tpu.api.eval_gnn import explore, path_cost
    from gnn_motion_planning_tpu.api.registry import str2name
    from gnn_motion_planning_tpu.config import problem_rng
    from gnn_motion_planning_tpu.envs.strict import build_surface_points
    from gnn_motion_planning_tpu.graphs.audit import protocol_rgg_connected
    import gnn_motion_planning_tpu.planners.strict_fallback as sf

    surface = {}
    for config, urdf in URDFS.items():
        env = _jax_env(config)
        sp = build_surface_points(env.model, str(REPO / "assets" / urdf))
        pts, frames = np.asarray(sp.pts), np.asarray(sp.frame)
        surface[config] = dict(urdf=urdf, P=int(len(pts)), pts_sha256=sha(pts),
                               frame_sha256=sha(frames.astype(np.int32)))
    rgg = [dict(config=c, index=i, **protocol_rgg_connected(_jax_env(c), 1234, i))
           for c, i in RGG_CASES]
    env, model, _, model_s, _ = str2name("kuka14")
    run = lambda i, p=None: witness_row(  # noqa: E731
        env, i, *witness_run(explore, problem_rng, env, model, model_s, sf, i, p), path_cost)
    FIXTURE.write_text(json.dumps({
        "about": "JAX package on the CPU: surface points (spacing 0.01), "
                 "protocol_rgg_connected (seed 1234), the audit of "
                 "tools/strict_verifier.py (seed 0, chunks of 256; 100,096 and 1,024 "
                 "configurations), and kuka14 through "
                 "explore(strict_fallback=True) at seed 1234: 2170 at batch 500, "
                 "t_max 500, k 30 (witness), 2170 and 2118 at batch and t_max "
                 f"{CUT['batch']} (cut); tests/test_torch_port_strict.py",
        "surface": surface, "rgg": rgg,
        "audit": {c: jax_audit_counts(c, AUDIT_CONFIGS) for c in STRICT_CONFIGS},
        "audit_small": {c: jax_audit_counts(c, AUDIT_SMALL) for c in STRICT_CONFIGS},
        "witness": run(WITNESS),
        "cut": [run(i, CUT) for i in CUT_PROBLEMS],
    }, indent=1) + "\n")



@pytest.fixture(scope="module")
def checkers():
    """Per config, problem 2000 in both packages: (JAX env, port env,
    JAX's jitted batch of its strict_hit, the port's strict_hit)."""

    import jax

    from gnn_motion_planning_tpu.envs.strict import strict_checker as jax_checker
    from gnn_motion_planning_tpu_torch.envs.strict import strict_checker

    cache = {}

    def get(config):
        if config not in cache:
            jenv, tenv = _jax_env(config), _port_env(config)
            jenv.init_new_problem(2000)
            tenv.init_new_problem(2000)
            jh = jax_checker(jenv)
            batch = jax.jit(lambda sc, qs: jax.vmap(lambda q: jh(sc, q))(qs))
            cache[config] = (jenv, tenv, batch, strict_checker(tenv))
        return cache[config]

    return get


def uniform_states(env, n: int, seed: int = 0) -> np.ndarray:
    lo, hi = np.asarray(env.bound, float).reshape(2, -1)
    return np.random.RandomState(seed).uniform(lo, hi, (n, env.config_dim)).astype(np.float32)


def near_boundary_states(hit, free: np.ndarray, blocked: np.ndarray, levels=range(17, 21)):
    """States on both sides of a strict-contact boundary: each line from a
    free state to a blocked one bisected (in float64) until its interval
    is 2**-k of the line, for k in ``levels``; ``hit`` maps (n, d) float32
    states to (n,) bool. Returns float32 states, both ends at every
    level."""

    a, b = free.astype(np.float64), blocked.astype(np.float64)
    lo, hi = np.zeros(len(a)), np.ones(len(a))
    out = []
    for k in range(1, max(levels) + 1):
        mid = (lo + hi) / 2
        h = hit((a + mid[:, None] * (b - a)).astype(np.float32))
        hi, lo = np.where(h, mid, hi), np.where(h, lo, mid)
        if k in levels:
            out += [(a + lo[:, None] * (b - a)), (a + hi[:, None] * (b - a))]
    return np.concatenate(out).astype(np.float32)


@pytest.mark.parametrize("config", list(URDFS))
def test_surface_points_equal_jax(config):
    from gnn_motion_planning_tpu.envs.strict import build_surface_points as jax_build
    from gnn_motion_planning_tpu_torch.envs.strict import build_surface_points

    want = json.loads(FIXTURE.read_text())["surface"][config]
    urdf = str(REPO / "assets" / URDFS[config])
    jsp = jax_build(_jax_env(config).model, urdf)
    sp = build_surface_points(_port_env(config).model, urdf, device="cpu")
    np.testing.assert_array_equal(sp.pts.numpy(), np.asarray(jsp.pts))
    np.testing.assert_array_equal(sp.frame.numpy(), np.asarray(jsp.frame))
    assert sp.pts.dtype == torch.float32 and len(sp.pts) == want["P"]
    assert sha(sp.pts.numpy()) == want["pts_sha256"]
    assert sha(sp.frame.numpy().astype(np.int32)) == want["frame_sha256"]


@pytest.mark.parametrize("config", STRICT_CONFIGS)
def test_strict_hit_decisions_equal_jax(checkers, config):
    """1,024 uniform states of problem 2000's scene, then up to 64 lines
    from a free one to a blocked one bisected to 2**-17 .. 2**-20 (by JAX's
    decisions), both sides of each: the port decides as JAX's
    ``make_strict_hit`` (kuka7, kuka13; ur5 with its plane mask;
    ``make_strict_hit_dual`` on kuka14)."""

    import jax.numpy as jnp

    jenv, tenv, batch, strict = checkers(config)

    def jax_hit(qs):
        return np.asarray(batch(jenv.device_scene(), jnp.asarray(qs)))

    qs = uniform_states(tenv, 1024)
    want = jax_hit(qs)
    assert 16 <= want.sum() <= 1008, want.sum()
    n = min(64, int(want.sum()), int((~want).sum()))
    near = near_boundary_states(jax_hit, qs[~want][:n], qs[want][:n])
    want_near = jax_hit(near)
    assert 0 < want_near.sum() < len(near)
    got = strict(tenv.device_scene(), torch.as_tensor(np.concatenate([qs, near])))
    np.testing.assert_array_equal(got.numpy(), np.concatenate([want, want_near]))


@pytest.mark.parametrize("config", STRICT_CONFIGS)
def test_world_points_equal_jax(config):
    """Every surface point's world position, each arm from its base, for
    64 uniform states: within 1e-6 of the JAX package's
    ``einsum("pij,pj->pi", R, pts) + t`` over its FK."""

    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.envs.kinematics import fk_link_frames as jax_fk
    from gnn_motion_planning_tpu.envs.strict import build_surface_points as jax_build
    from gnn_motion_planning_tpu_torch.envs.strict import build_surface_points, world_points

    jenv, tenv = _jax_env(config), _port_env(config)
    urdf = str(REPO / "assets" / URDFS.get(config, "kuka_iiwa/model_0.urdf"))
    jsp = jax_build(jenv.model, urdf)
    sp = build_surface_points(tenv.model, urdf, device="cpu")
    dof = tenv.chain.lower.shape[0]
    bases = [tenv.base1, tenv.base2] if config == "kuka14" else [None]
    qs = uniform_states(tenv, 64, seed=1)
    for arm, base in enumerate(bases):
        jbase = jnp.zeros(3, jnp.float32) if base is None else jnp.asarray(base.numpy())

        def world(q):
            Rs, ts = jax_fk(jenv.chain, q, base_trans=jbase)
            return jnp.einsum("pij,pj->pi", Rs[jsp.frame], jsp.pts) + ts[jsp.frame]

        q = qs[:, arm * dof : (arm + 1) * dof]
        want = np.asarray(jax.jit(jax.vmap(world))(jnp.asarray(q)))
        got = world_points(tenv.chain, sp, torch.as_tensor(q), base).numpy()
        assert np.abs(got - want).max() <= 1e-6


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    import jax

    jax.config.update("jax_platforms", "cpu")
    write()
