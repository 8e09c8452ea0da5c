"""The explorer's policy scatter at repeated (dst, src) pairs
(``models/explorer.py::scatter_policy``) against the JAX package's
``.at[row, src].set(score, mode="drop")``: the forward keeps the last live
duplicate, and the gradient goes to it alone, as ``jax.grad`` sends it.

Tolerances: the scatter's forward and gradients exactly; the explorer's
loss and gradients on edge lists with repeated live pairs as
tests/test_torch_port_training.py holds them (loss rtol 1e-5, each leaf
within 1e-5 max|g| + 1e-7).
"""

import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu_torch.models.convert import params_from_numpy
from test_torch_port_training import _grads_close, _jax_explorer, _port_grads, _rel


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_scatter(score, src, dst, alive, n, weight):
    """JAX's forward and the gradient of sum(policy * weight) by score."""

    import jax
    import jax.numpy as jnp

    def f(u):
        row = jnp.where(alive, dst, n)
        policy = jnp.zeros((n, n), jnp.float32).at[row, src].set(u, mode="drop")
        return (policy * weight).sum(), policy

    (_, policy), grad = jax.value_and_grad(f, has_aux=True)(jnp.asarray(score))
    return np.asarray(policy), np.asarray(grad)


def _port_scatter(score, src, dst, alive, n, weight):
    from gnn_motion_planning_tpu_torch.models.explorer import scatter_policy

    u = torch.tensor(score, requires_grad=True)
    policy = scatter_policy(u, torch.as_tensor(src), torch.as_tensor(dst),
                            torch.as_tensor(alive), n)
    (policy * torch.as_tensor(weight)).sum().backward()
    return policy.detach().numpy(), u.grad.numpy()


def test_probe_last_duplicate_wins_and_takes_the_gradient():
    """Updates [1, 2, 3, 4] at rows [1, 1, 2, 1], columns [0, 0, 2, 0]."""

    score = np.array([1, 2, 3, 4], np.float32)
    src = np.array([0, 0, 2, 0])
    dst = np.array([1, 1, 2, 1])
    alive = np.ones(4, bool)
    weight = np.arange(1, 10, dtype=np.float32).reshape(3, 3)
    want = _jax_scatter(score, src, dst, alive, 3, weight)
    got = _port_scatter(score, src, dst, alive, 3, weight)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0][1, 0] == 4 and got[1].tolist() == [0, 0, 9, 4]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_duplicates_and_dead_edges_equal_jax(seed):
    rng = np.random.RandomState(seed)
    n, e = 6, 40
    score = rng.normal(size=e).astype(np.float32)
    src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
    alive = rng.rand(e) < 0.7
    weight = rng.normal(size=(n, n)).astype(np.float32)
    want = _jax_scatter(score, src, dst, alive, n, weight)
    got = _port_scatter(score, src, dst, alive, n, weight)
    assert len(set(zip(dst[alive], src[alive]))) < alive.sum()  # repeated live pairs
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _repeated_case(seed: int = 0, B: int = 2, N: int = 16, E: int = 64, M: int = 4):
    """An explorer batch whose edge lists repeat live pairs: src and dst
    drawn with replacement (tests/test_multichip.py:59-60's way)."""

    rng = np.random.RandomState(seed)
    v = rng.uniform(-1, 1, (B, N, 2)).astype(np.float32)
    src = rng.randint(0, N, (B, E)).astype(np.int64)
    dst = rng.randint(0, N, (B, E)).astype(np.int64)
    src[:, 1], dst[:, 1] = src[:, 0], dst[:, 0]  # a repeat in every row at least
    e_alive = np.ones((B, E), bool)
    e_alive[:, -6:] = False
    obstacles = rng.uniform(-0.5, 0.5, (B, M, 2)).astype(np.float32)
    obs_mask = np.array([[True, True, True, False]] * B)
    frontier = rng.rand(B, N, N) < 0.3
    frontier[np.arange(B), dst[:, 0], src[:, 0]] = True  # a repeated pair reaches the loss
    target = np.array([rng.choice(np.flatnonzero(f)) for f in frontier.reshape(B, -1)])
    goal = v[:, 1]
    loop = np.full(B, 3, np.int64)
    return (v, np.ones((B, N), bool), goal, src, dst, e_alive, obstacles, obs_mask, frontier,
            target, loop)


def test_explorer_grads_with_repeated_pairs_equal_jax():
    import jax
    import jax.numpy as jnp

    from gnn_motion_planning_tpu.training import explorer as jex
    from gnn_motion_planning_tpu_torch.models.convert import flatten
    from gnn_motion_planning_tpu_torch.models.explorer import Explorer, ExplorerConfig
    from gnn_motion_planning_tpu_torch.training import explorer as tex

    jcfg, params = _jax_explorer()
    case = _repeated_case()
    fn = jax.jit(jax.value_and_grad(jex.frontier_cross_entropy), static_argnums=(1, 3))
    want, jgrads = fn(params, jcfg, jex.ExplorerBatch(*(jnp.asarray(a) for a in case)), 3)
    model = params_from_numpy(Explorer(ExplorerConfig(*jcfg)), params)
    got = tex.frontier_cross_entropy(model, tex.ExplorerBatch(*(torch.as_tensor(a) for a in case)),
                                     3)
    got.backward()
    assert _rel(float(got.detach()), float(want)) <= 1e-5
    _grads_close(_port_grads(model), flatten(jax.tree.map(np.asarray, jgrads)))
