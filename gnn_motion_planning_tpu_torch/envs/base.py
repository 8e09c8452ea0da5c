"""Env kernel bundle: the device-side face of an environment (port of
gnn_motion_planning_tpu/envs/base.py).

The JAX package writes each kernel for one configuration and vmaps it; here
every kernel takes a batch along its first axis, and the collision-check
count is returned explicitly, as there.

Lanes. Many problems are checked at once (the port of ``jax.vmap`` over
the JAX oracles, ``api/batched.py``): :func:`stack_scenes` stacks the
scenes of L problems along a leading lane axis, and every oracle then
takes inputs with the same leading axis, (L, B, d), and returns (L, B). A
single scene with (B, d) inputs is the same oracle at L = 1.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

BIG = 1 << 30

# Static interpolation budget of the *cheap* edge kernel: segments needing
# more than K_CHEAP interior points raise its overflow flag, and the caller
# redoes the work with the full kernel (envs/base.py:24-30).
K_CHEAP = 128


def stack_scenes(scenes):
    """The device scenes of L problems as one scene with a leading lane
    axis. A scene is a tensor or a tuple of tensors (``BoxScene``); the
    first axis of each tensor is padded with zeros (False) to the longest
    in the group, so a padded box is masked off (JAX ``jax.tree.map(
    jnp.stack, *scenes)``, whose scenes have one size)."""

    def stack(ts):
        n = max(t.shape[0] for t in ts)
        return torch.stack([
            torch.cat([t, t.new_zeros((n - t.shape[0],) + tuple(t.shape[1:]))])
            if t.shape[0] < n else t
            for t in ts
        ])

    first = scenes[0]
    if isinstance(first, torch.Tensor):
        return stack(scenes)
    return type(first)(*(stack(ts) for ts in zip(*scenes)))


def one_lane(scene):
    """One problem's scene as a stacked scene of one lane."""

    if isinstance(scene, torch.Tensor):
        return scene[None]
    return type(scene)(*(t[None] for t in scene))


def lane_oracle(fn):
    """Let an oracle written for lanes, ``fn(scenes, *xs (L, B, d))``, also
    take one problem's scene with (B, d) inputs, as the same call at L = 1."""

    @functools.wraps(fn)
    def call(scene, *xs):
        if xs[0].dim() == 3:
            return fn(scene, *xs)
        return tuple(out[0] for out in fn(one_lane(scene), *(x[None] for x in xs)))

    return call


class EnvKernels(NamedTuple):
    """Batched device kernels for one environment family.

    batch_state_free(scene, qs (B, d)) -> (free (B,) bool, n_checks (B,) int)
    edge_free(scene, qa (E, d), qb (E, d)) -> (free (E,), n_checks (E,))
        Both also take a stacked scene (:func:`stack_scenes`) with inputs
        and outputs of a leading lane axis.
    distance(a (..., d), b (..., d)) -> (...,) the env's metric
    interpolate(a, b, ratio (...,)) -> (..., d) the env's steering rule
    edge_free_cheap(scene, qa, qb) -> (free, n_checks, overflow), or None
        when the env's worst-case budget is already small.
    bounds: (lower, upper) joint limits for fixed-step envs.
    """

    batch_state_free: Callable
    edge_free: Callable
    distance: Callable
    interpolate: Callable
    edge_free_cheap: Any = None
    bounds: Any = None


def make_fixed_step_edge_free(
    batch_state_free, distance, lower, upper, rrt_eps: float, k_pts: int,
    with_overflow: bool = False,
):
    """Fixed-step edge oracle shared by every serial-chain env
    (envs/base.py:62-106): endpoints first, then K = int(d / RRT_EPS) evenly
    spaced interior points checked in order with stop-at-first-collision
    counting. All 2 + k_pts states of a batch of E edges go through one
    ``batch_state_free`` call."""

    def edge_free(scene, qa, qb):
        lead, d = qa.shape[:-1], qa.shape[-1]  # (E,) or (L, E)
        valid = ((qa >= lower) & (qa <= upper)).all(-1) & (
            (qb >= lower) & (qb <= upper)
        ).all(-1)
        disp = qb - qa
        K = (distance(qa, qb) / rrt_eps).to(torch.int32)  # lead
        ks = torch.arange(k_pts, dtype=qa.dtype, device=qa.device)
        active = ks < K.to(qa.dtype)[..., None]  # lead + (k_pts,)
        coeff = ks / torch.clamp_min(K, 1).to(qa.dtype)[..., None]
        cs = qa[..., None, :] + coeff[..., :, None] * disp[..., None, :]
        states = torch.cat([qa[..., None, :], qb[..., None, :], cs], dim=-2)
        # every state of every edge (of every lane) in one oracle call
        free_all, _ = batch_state_free(scene, states.reshape(lead[:-1] + (-1, d)))
        free_all = free_all.reshape(lead + (2 + k_pts,))
        fa, fb, in_free = free_all[..., 0], free_all[..., 1], free_all[..., 2:]
        order = torch.arange(k_pts, dtype=torch.int32, device=qa.device)
        first_fail = torch.where(active & ~in_free, order, BIG).amin(dim=-1)
        interior_cnt = (active & (order <= first_fail[..., None])).sum(dim=-1)
        interior_free = first_fail == BIG
        free = valid & fa & fb & interior_free
        zero = torch.zeros_like(interior_cnt)
        count = torch.where(
            valid,
            1 + torch.where(fa, 1 + torch.where(fb, interior_cnt, zero), zero),
            zero,
        ).to(torch.int32)
        if not with_overflow:
            return free, count
        overflow = (K > k_pts) & valid & fa & fb & interior_free
        return free & ~overflow, count, overflow

    return edge_free


def rejection_sample(env, n: int, need_negative: bool, batch_free, adaptive: bool):
    """``n`` free configurations drawn uniformly in ``env.pose_range``, and
    the rejected draws (JAX envs/kuka.py:388-451, envs/snake.py:542-587).

    With ``env.rng`` None the draws come one at a time from numpy's global
    stream, one check each (JAX envs/kuka.py:404-415). Otherwise they come
    from ``env.rng`` in chunks through ``batch_free`` ((n, d) float64 ->
    (n,) bool); the state is restored and the consumed prefix re-drawn past
    the n-th acceptance, so the stream, and the count of every draw taken,
    equal a one-at-a-time loop's. ``adaptive`` sizes a chunk by the env's
    accept rate (a device oracle, one call for most requests); otherwise a
    chunk is twice what is still needed (the native core, which pays per
    draw). Each chunk goes through ``env._bias_draws`` at the problem's
    draw position ``env._draw_pos`` (an opt-in ``sampler_bias``; the
    identity without one), a function of each row and its position alone,
    so the accepted stream does not depend on the chunking."""

    samples: list = []
    negative: list = []
    rng = env.rng
    if rng is None:
        while len(samples) < n:
            s = env.uniform_sample()
            env.collision_check_count += 1
            if batch_free(s[None])[0]:
                samples.append(s)
            elif need_negative:
                negative.append(s)
        return (samples, negative) if need_negative else samples

    pr = np.array(env.pose_range)
    need = n
    rate = getattr(env, "_accept_rate", None)
    while need > 0:
        if adaptive and rate is not None:
            chunk = min(max(int(need / max(rate, 0.02) * 1.4), 512), 16384)
        else:
            chunk = max(2 * need, 512)
        state = rng.get_state()
        draws = env._bias_draws(rng.uniform(pr[:, 0], pr[:, 1], (chunk, env.config_dim)),
                                offset=env._draw_pos)
        ok = batch_free(draws)
        n_acc = int(ok.sum())
        rate = n_acc / chunk if rate is None else 0.8 * rate + 0.2 * n_acc / chunk
        env._accept_rate = rate
        if n_acc >= need:
            stop = int(np.nonzero(np.cumsum(ok) == need)[0][0]) + 1
            rng.set_state(state)
            rng.uniform(pr[:, 0], pr[:, 1], (stop, env.config_dim))
            draws, ok = draws[:stop], ok[:stop]
            need = 0
        else:
            need -= n_acc
        env._draw_pos += len(draws)
        env.collision_check_count += len(draws)
        samples.extend(draws[ok])
        negative.extend(draws[~ok])
    return (samples, negative) if need_negative else samples
