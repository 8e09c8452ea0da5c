"""The port's NEXT models (``models/next_model.py``: ``Model2D`` on maze2
and snake7, ``Model3D`` on kuka7, kuka14 and ur5) against the JAX
package's, each loaded from the same shipped ``next_*.pt``.

Tolerance: ``pred_value`` and the policy means within atol 1e-5 times the
output's scale (at least 1), rtol 1e-4, the rule of
tests/test_model_parity.py for the model forwards, and the same argmax of
the values over the batch (the choice UCB selection and expansion make).
The conversion from the JAX package's numpy parameters is held to the same.
"""

import numpy as np
import pytest
import torch

CASES = {
    # config: (ckpt, class, point_dim)
    "maze2easy": ("data/weights/next_2.pt", "Model2D", None),
    "snake7": ("data/weights/next_snake.pt", "Model2D", None),
    "kuka7": ("data/weights/next_7.pt", "Model3D", 3),
    "kuka14": ("data/weights/next_14.pt", "Model3D", 6),
    "ur5": ("data/weights/next_ur5.pt", "Model3D", 3),
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _envs(config):
    from gnn_motion_planning_tpu.api.registry import str2env as jax_str2env
    from gnn_motion_planning_tpu_torch.api.registry import str2env

    jenv, tenv = jax_str2env(config)[0], str2env(config, device="cpu")[0]
    if config == "snake7":
        # the snake's host problem API is not ported: both models take the
        # same map and goal through set_problem
        jenv.init_new_problem(2000)
        return jenv, tenv, None
    pj, pt = jenv.init_new_problem(2000), tenv.init_new_problem(2000)
    np.testing.assert_array_equal(np.asarray(pt["map"]), np.asarray(pj["map"]))
    return jenv, tenv, pt


def _close(got, want):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=1e-5 * scale, rtol=1e-4)


@pytest.mark.parametrize("config", list(CASES))
def test_next_model_equals_jax(config):
    from gnn_motion_planning_tpu.models import next_model as jax_next
    from gnn_motion_planning_tpu.models.convert import load_params
    from gnn_motion_planning_tpu_torch.models import next_model

    ckpt, cls_name, point_dim = CASES[config]
    kw = {} if point_dim is None else {"point_dim": point_dim}
    jenv, tenv, problem = _envs(config)
    if problem is None:
        problem = {"map": np.asarray(jenv.get_problem()["map"]),
                   "goal_state": np.asarray(jenv.goal_state)}
    jm = getattr(jax_next, cls_name)(env=jenv, params=load_params(ckpt),
                                     dim=jenv.config_dim, **kw)
    tm = next_model.load_next(getattr(next_model, cls_name), tenv, ckpt, tenv.config_dim, **kw)
    jm.set_problem(problem)
    tm.set_problem(problem)
    lo, hi = np.asarray(tenv.bound, float).reshape(2, -1)
    qs = np.random.RandomState(5).uniform(lo, hi, (32, tenv.config_dim))
    want_a, want_v = jm.net_forward(qs)
    got_a, got_v = tm.net_forward(qs)
    _close(got_v, want_v)
    _close(got_a, want_a)
    assert int(np.argmax(got_v)) == int(np.argmax(want_v))
    # one state: the policy's mean and pred_value as the planners call them
    _close(np.asarray(tm.pred_value(qs[0])), np.asarray(jm.pred_value(qs[0])))
    _close(tm.net_forward(qs[0])[0], jm.net_forward(qs[0])[0])


def test_next_from_jax_params():
    """The port's modules built from the JAX package's numpy NEXT
    parameters give the forward of the modules loaded from the checkpoint,
    and both equal JAX's ``pb_forward``/``state_forward``."""

    import jax.numpy as jnp

    from gnn_motion_planning_tpu.models import next_model as jax_next
    from gnn_motion_planning_tpu.models.convert import load_params
    from gnn_motion_planning_tpu_torch.models import next_model
    from gnn_motion_planning_tpu_torch.models.convert import read_checkpoint

    ckpt = "data/weights/next_2.pt"
    params = load_params(ckpt)
    cfg = next_model.model_config("Model2D", 2)
    a = next_model.next_net_from_params(cfg, 2, params, "cpu")
    b = next_model.next_net(cfg, 2, read_checkpoint(ckpt), "cpu")
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb
        torch.testing.assert_close(va, vb, rtol=0, atol=0)
    rng = np.random.RandomState(13)
    maze_map = (rng.rand(1, 15, 15) < 0.3).astype(np.float32)
    goal = rng.uniform(-1, 1, (1, 2)).astype(np.float32)
    states = rng.uniform(-1, 1, (8, 2)).astype(np.float32)
    jcfg = jax_next.NextConfig(env_width=15, cap=8, dim=2, point_dim=0, nd=2)
    want_pb = jax_next.pb_forward(params, jcfg, jnp.asarray(goal), jnp.asarray(maze_map))
    want = np.asarray(jax_next.state_forward(params, jcfg, jnp.asarray(states), want_pb))
    with torch.no_grad():
        pb = next_model.pb_forward(a, torch.as_tensor(goal), torch.as_tensor(maze_map))
        got = next_model.state_forward(a, torch.as_tensor(states), pb).numpy()
    _close(pb.numpy(), np.asarray(want_pb))
    _close(got, want)
