"""The port's ``parallel/mesh.py`` and its two users against the JAX package:
``make_mesh``'s strictness, ``training/explorer.py::make_train_step`` on a
CPU mesh of one entry and of two against JAX's ``make_train_step`` (the
batch of tests/test_multichip.py:33-90 at its sizes),
``api/batched.py::explore_batch(mesh=)`` against the unsharded rows, and the
two-process smoke (``tools/torch_port_multiproc_smoke.py``).

Tolerances: the step's loss within rtol 1e-5 of JAX's (float32, summed in
another order); the two-shard update within 1e-5 max|g| + 1e-7 of the
one-shard update (tests/test_torch_port_training.py's gradient tolerance:
the update of an SGD step at lr 1 is the gradient); rows exactly.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.models.convert import params_from_numpy
from gnn_motion_planning_tpu_torch.parallel.mesh import data_sharding, make_mesh, replicated

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_make_mesh_strict():
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError):
        make_mesh(n + 1)
    if n == 0:
        with pytest.raises(ValueError):
            make_mesh()
    cpu = make_mesh(2, device="cpu")
    assert cpu.size == 2 and cpu.devices == (torch.device("cpu"),) * 2
    shards = data_sharding(cpu)(torch.arange(8))
    assert [s.tolist() for _, s in shards] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError):
        data_sharding(cpu)(torch.arange(7))
    module = torch.nn.Linear(2, 2)
    assert all(r is module for r in replicated(cpu)(module))


def _multichip_batch():
    """tests/test_multichip.py:52-70: b 8, n 16, e 64, m 4, d 2 (random
    edge lists, so repeated pairs)."""

    b, n, e, m, d = 8, 16, 64, 4, 2
    rng = np.random.RandomState(0)
    frontier = np.zeros((b, n, n), bool)
    frontier[:, 0, :] = True
    return (
        rng.uniform(-1, 1, (b, n, d)).astype(np.float32), np.ones((b, n), bool),
        rng.uniform(-1, 1, (b, d)).astype(np.float32), rng.randint(0, n, (b, e)),
        rng.randint(0, n, (b, e)), np.ones((b, e), bool),
        rng.uniform(-1, 1, (b, m, 2)).astype(np.float32), np.ones((b, m), bool), frontier,
        np.full(b, 5), np.full(b, 5),
    )


def _jax_step_loss(case) -> float:
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.models.explorer import ExplorerConfig, init_explorer_params
    from gnn_motion_planning_tpu.parallel.mesh import make_mesh as jax_mesh
    from gnn_motion_planning_tpu.training.explorer import ExplorerBatch, make_train_step

    cfg = ExplorerConfig(workspace_size=2, config_size=2, embed_size=16, obs_size=2)
    step, optimizer, _ = make_train_step(cfg, mesh=jax_mesh(1))
    params = jax.tree.map(jnp.asarray, init_explorer_params(jax.random.PRNGKey(0), cfg))
    ex = ExplorerBatch(*(jnp.asarray(a if a.dtype != np.int64 else a.astype(np.int32))
                         for a in case))
    _, _, loss = step(params, optimizer.init(params), ex)
    return float(loss), cfg, jax.tree.map(np.asarray, params)


def test_train_step_on_one_and_two_shards_equals_jax():
    from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
    from gnn_motion_planning_tpu_torch.training.explorer import ExplorerBatch, make_train_step
    from gnn_motion_planning_tpu_torch.training.optim import trainable_leaves

    case = _multichip_batch()
    want, jcfg, params = _jax_step_loss(case)
    cfg = ExplorerConfig(*jcfg)
    ex = ExplorerBatch(*(torch.as_tensor(a) for a in case))
    sgd = lambda leaves: torch.optim.SGD(leaves, lr=1.0)  # noqa: E731  the update is -grad
    out = {}
    for n in (1, 2):
        model = params_from_numpy(Explorer(cfg), params)
        before = [t.detach().clone() for t in trainable_leaves(model)]
        step, optimizer, mesh = make_train_step(cfg, optimizer=sgd, mesh=make_mesh(n, device="cpu"))
        assert mesh.size == n
        loss = step(model, optimizer(trainable_leaves(model)), ex)
        assert abs(loss - want) <= 1e-5 * abs(want), (n, loss, want)
        out[n] = [b - t.detach() for b, t in zip(before, trainable_leaves(model))]
    assert max(float(g.abs().max()) for g in out[1]) > 0
    for g1, g2 in zip(out[1], out[2]):
        assert float((g1 - g2).abs().max()) <= 1e-5 * float(g1.abs().max()) + 1e-7
    with pytest.raises(ValueError):
        make_train_step(cfg._replace(embed_size=8), mesh=make_mesh(1, device="cpu"))[0](
            params_from_numpy(Explorer(cfg), params), sgd(list(Explorer(cfg).parameters())), ex)


def test_explore_batch_on_a_mesh_equals_unsharded():
    """maze2easy, three problems a group of three: the two-entry mesh pads
    the group to four (a copy of its first lane) and runs two shards."""

    from gnn_motion_planning_tpu_torch.api.batched import eval_gnn_batched
    from gnn_motion_planning_tpu_torch.api.registry import smoother_scale, str2env, str2models

    env = str2env("maze2easy", device="cpu")[0]
    m, ms = str2models("maze2easy", "cpu", smoother_scale("maze2easy", env))
    kw = dict(lanes=3, batch=100, t_max=100)
    rows = {}
    for label, mesh in (("plain", None), ("mesh", make_mesh(2, device="cpu"))):
        rows[label], stats = [], []
        eval_gnn_batched("maze2easy", 1234, env, [2000, 2001, 2002], m, ms, mesh=mesh,
                         rows=rows[label], stats=stats, **kw)
        groups = [s["group_size"] for s in stats if "group_size" in s]
        assert groups == ([3] if mesh is None else [2, 2])
    assert rows["mesh"] == rows["plain"]
    assert any(r["success"] for r in rows["plain"])


def test_two_process_smoke():
    r = subprocess.run([sys.executable, str(REPO / "tools" / "torch_port_multiproc_smoke.py")],
                       capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "MULTIPROC_SMOKE_OK n=2" in r.stdout
