"""The port's float32 cos and sin (``envs/kinematics.py::sincosf32``)
against XLA's on the CPU, which calls glibc's ``cosf`` and ``sinf``, and
the places that take them: maze3's stick endpoints and FK's capsule
endpoints.

Tolerance: none. Every value is held bit for bit against the compiled JAX
function on the same float32 inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_motion_planning_tpu.envs.maze import stick_endpoints as jax_stick_endpoints
from gnn_motion_planning_tpu_torch.envs.kinematics import TRIG_LIMIT, sincosf32
from gnn_motion_planning_tpu_torch.envs.maze import stick_endpoints


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _neighbours(values, ulps=4):
    """Each float32 value and its ``ulps`` neighbours on either side."""

    v = np.asarray(values, np.float32)
    bits = v.view(np.int32)[:, None] + np.arange(-ulps, ulps + 1, dtype=np.int32)
    # stepping the bits of a negative float moves it away from zero; both
    # directions are covered either way
    return bits.reshape(-1).view(np.float32)


def _angles():
    """2^20 float32 angles: uniform in [-7, 7], and the hard places: every
    joint limit of the arms (pi, 2 pi, the iiwa's) and the neighbours of
    k pi / 4 (|k| <= 8), each give or take a few ulps, +-0, 2^-12 and
    pi / 4 (the branch points of the algorithm) give or take one ulp."""

    limits = [np.pi, 2 * np.pi, 2.96705972839, 2.09439510239, 3.05432619099, 9.0]
    special = np.concatenate([
        _neighbours(np.concatenate([limits, np.negative(limits)]), 4),
        _neighbours([k * np.pi / 4 for k in range(-8, 9) if k], 8),
        _neighbours([2.0 ** -12, -(2.0 ** -12), np.pi / 4, -np.pi / 4, 0.75, -0.75], 1),
        np.array([0.0, -0.0], np.float32),
    ])
    rng = np.random.RandomState(0)
    uniform = rng.uniform(-7, 7, (1 << 20) - len(special)).astype(np.float32)
    return np.concatenate([special, uniform])


def test_sincosf32_bit_equal_to_xla():
    x = _angles()
    assert len(x) == 1 << 20
    c, s = sincosf32(torch.from_numpy(x))
    want_c = np.asarray(jax.jit(jnp.cos)(x))
    want_s = np.asarray(jax.jit(jnp.sin)(x))
    np.testing.assert_array_equal(c.numpy().view(np.int32), want_c.view(np.int32))
    np.testing.assert_array_equal(s.numpy().view(np.int32), want_s.view(np.int32))


def test_sincosf32_nan_and_range():
    x = np.array([np.nan, np.inf, -np.inf, 1.0], np.float32)
    c, s = sincosf32(torch.from_numpy(x))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jax.jit(jnp.cos)(x)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax.jit(jnp.sin)(x)))
    assert np.isnan(c[:3].numpy()).all() and np.isnan(s[:3].numpy()).all()
    for bad in (TRIG_LIMIT, -TRIG_LIMIT, 1e30):
        with pytest.raises(ValueError):
            sincosf32(torch.tensor([0.5, bad], dtype=torch.float32))
    # just below the limit glibc still takes this reduction
    x = np.float32(np.nextafter(np.float32(TRIG_LIMIT), np.float32(0)))
    c, s = sincosf32(torch.tensor([x, -x]))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jax.jit(jnp.cos)(np.array([x, -x]))))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax.jit(jnp.sin)(np.array([x, -x]))))


def test_maze3_stick_endpoints_bit_equal_to_xla():
    """4,096 maze3 configurations within the limits (x, y, theta):
    the stick's endpoints, whose cos and sin the port once took in float64
    and rounded (differing from glibc's float32 ones in the last bit)."""

    rng = np.random.RandomState(3)
    q = np.stack([rng.uniform(-1, 1, 4096), rng.uniform(-1, 1, 4096),
                  rng.uniform(-0.4, 0.4, 4096)], -1).astype(np.float32)
    a, b = stick_endpoints(torch.from_numpy(q))
    ja, jb = (np.asarray(t) for t in jax.jit(jax_stick_endpoints)(q))
    np.testing.assert_array_equal(a.numpy(), ja)
    np.testing.assert_array_equal(b.numpy(), jb)


def _jax_fk(name, jenv):
    from gnn_motion_planning_tpu.envs.kinematics import capsules_world as jcw
    from gnn_motion_planning_tpu.envs.snake import _yaw_rot

    if name == "snake7":
        def one(x):
            return jcw(jenv.chain, jnp.stack([x[2], x[3], x[4], x[5]]),
                       base_rot=_yaw_rot(x[3]).astype(jnp.float32),
                       base_trans=jnp.array([x[0], x[1], 0.5]).astype(jnp.float32))[:2]
    elif name == "kuka14":
        def one(x):
            a = jcw(jenv.chain, x[:7], base_trans=jenv.base1)
            b = jcw(jenv.chain, x[7:], base_trans=jenv.base2)
            return jnp.concatenate([a[0], b[0]]), jnp.concatenate([a[1], b[1]])
    else:
        def one(x):
            return jcw(jenv.chain, x)[:2]
    return jax.jit(jax.vmap(one))


def _port_fk(name, tenv, qs):
    from gnn_motion_planning_tpu_torch.envs.kinematics import capsules_world
    from gnn_motion_planning_tpu_torch.envs.snake import snake_capsules

    q = torch.from_numpy(qs)
    if name == "snake7":
        return snake_capsules(tenv.chain, q)[:2]
    if name == "kuka14":
        a = capsules_world(tenv.chain, q[:, :7].contiguous(), base_trans=tenv.base1)
        b = capsules_world(tenv.chain, q[:, 7:].contiguous(), base_trans=tenv.base2)
        return torch.cat([a[0], b[0]], 1), torch.cat([a[1], b[1]], 1)
    return capsules_world(tenv.chain, q)[:2]


@pytest.mark.parametrize("name", ["kuka7", "ur5", "kuka14", "snake7"])
def test_fk_endpoints_bit_equal_to_xla(name):
    """Capsule endpoints of 1,024 and 31 configurations uniform in the
    limits (31: XLA's vector loops leave a remainder): FK's cos, sin and
    fused multiply-adds as XLA's compiled ``vmap(capsules_world)``."""

    from gnn_motion_planning_tpu.envs.kuka import KukaEnv as JaxKukaEnv
    from gnn_motion_planning_tpu.envs.kuka2 import Kuka2Env as JaxKuka2Env
    from gnn_motion_planning_tpu.envs.snake import SnakeEnv as JaxSnakeEnv
    from gnn_motion_planning_tpu.envs.ur5 import UR5Env as JaxUR5Env
    from gnn_motion_planning_tpu_torch.envs.kuka import KukaEnv
    from gnn_motion_planning_tpu_torch.envs.kuka2 import Kuka2Env
    from gnn_motion_planning_tpu_torch.envs.snake import SnakeEnv
    from gnn_motion_planning_tpu_torch.envs.ur5 import UR5Env

    port_cls, jax_cls = {"kuka7": (KukaEnv, JaxKukaEnv), "ur5": (UR5Env, JaxUR5Env),
                         "kuka14": (Kuka2Env, JaxKuka2Env),
                         "snake7": (SnakeEnv, JaxSnakeEnv)}[name]
    tenv, jenv = port_cls(device="cpu"), jax_cls()
    fn = _jax_fk(name, jenv)
    pr = np.array(tenv.pose_range)
    for n in (1024, 31):
        qs = np.random.RandomState(n).uniform(pr[:, 0], pr[:, 1], (n, tenv.config_dim))
        qs = qs.astype(np.float32)
        want = [np.asarray(t) for t in fn(qs)]
        got = _port_fk(name, tenv, qs)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
