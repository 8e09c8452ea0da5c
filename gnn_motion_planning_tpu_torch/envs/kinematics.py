"""Batched forward kinematics over serial chains, in float32.

Port of gnn_motion_planning_tpu/envs/kinematics.py. The chain is a set of
static tensors on the env's device; FK is a Python loop over the joints,
batched over configurations. FK rounds as XLA's compiled CPU code rounds
the JAX package's, on the CPU and on the card alike:

* cos and sin are glibc's ``cosf`` and ``sinf``, which XLA's CPU code calls
  (``sincosf32``: their algorithm and coefficient table, in float64);
* the products are written out as elementwise multiplies and sums (no
  TF32), with a fused multiply-add (``fma32``, one rounding) exactly where
  LLVM contracts XLA's program at instruction selection. Read off
  ``XLA_FLAGS=--xla_dump_to=DIR --xla_dump_hlo_as_text`` of
  ``jit(vmap(state_free))``: ``objdump -d`` of the fusions' object files.
  Rodrigues (``_axis_angle``): the diagonal ``fma(a a, C, c)``, the
  entries with a minus ``fma(a b, C, -(w s))``, those with a plus
  ``fma(w, s, a b C)``. ``R @ origin_rot``: columns 0 and 1 in-order sums
  of rounded products, column 2 a chain of fused multiply-adds (LLVM packs
  the first two columns into one vector). ``@ Rq``, ``R @ origin_trans``
  and ``R @ cap_p``: chains of fused multiply-adds (``dot3_fused``), then
  ``+ t`` rounded on its own.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.envs.urdf import RobotModel, rpy_to_matrix


class ChainParams(NamedTuple):
    """Static kinematic-tree arrays: J joints (topo order), frame 0 = root
    link, frame j+1 = child of topo joint j, C capsules."""

    origin_rot: torch.Tensor  # (J, 3, 3)
    origin_trans: torch.Tensor  # (J, 3)
    axis: torch.Tensor  # (J, 3) unit
    cap_link: torch.Tensor  # (C,) frame index
    cap_p0: torch.Tensor  # (C, 3)
    cap_p1: torch.Tensor  # (C, 3)
    cap_r: torch.Tensor  # (C,)
    lower: torch.Tensor  # (dof,)
    upper: torch.Tensor  # (dof,)
    q_index: Tuple[int, ...]  # (J,) index into the config vector, -1 if fixed
    parent_frame: Tuple[int, ...]  # (J,) frame index of the parent link

    def numpy_arrays(self) -> dict:
        """Host copies of every array (the native core's input)."""

        out = {
            k: v.detach().cpu().numpy()
            for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)
        }
        out["q_index"] = np.asarray(self.q_index, np.int32)
        out["parent_frame"] = np.asarray(self.parent_frame, np.int32)
        return out


def chain_from_model(model: RobotModel, device) -> ChainParams:
    origin_rot = np.stack([rpy_to_matrix(j.origin_rpy) for j in model.joints])
    origin_trans = np.stack([j.origin_xyz for j in model.joints])
    axis = np.stack(
        [j.axis / max(np.linalg.norm(j.axis), 1e-12) for j in model.joints]
    )
    q_index = [-1] * len(model.joints)
    for qi, ji in enumerate(model.movable):
        q_index[ji] = qi
    frame_of = {name: i for i, name in enumerate(model.link_order)}
    pr = model.pose_range()

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ChainParams(
        origin_rot=f32(origin_rot),
        origin_trans=f32(origin_trans),
        axis=f32(axis),
        cap_link=torch.as_tensor(
            [frame_of[c.link] for c in model.capsules], dtype=torch.long, device=device
        ),
        cap_p0=f32(np.stack([c.p0 for c in model.capsules])),
        cap_p1=f32(np.stack([c.p1 for c in model.capsules])),
        cap_r=f32([c.radius for c in model.capsules]),
        lower=f32(pr[:, 0]),
        upper=f32(pr[:, 1]),
        q_index=tuple(q_index),
        parent_frame=tuple(frame_of[j.parent] for j in model.joints),
    )


def sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order, ((x0 + x1) + x2) + ...

    A fixed order keeps small reductions (3 coordinates, 7 joints) the same
    on every device, where ``torch.sum`` may split them into partial sums.
    """

    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, the value of a fused
    multiply-add (CUDA's ``fmaf``, and what XLA's CPU code forms where it
    contracts a product into a sum), on every device.

    The product of two float32 is exact in float64; the sum is split into
    its float64 rounding and the exact remainder (Knuth's two-sum), and the
    float64 result is rounded to odd before the final rounding to float32,
    so that the double rounding is exact (53 bits >= 24 + 2). ``a`` may be a Python number.
    """

    a = a.double() if isinstance(a, torch.Tensor) else float(a)
    p = a * b.double()
    c = c.double()
    s = c + p
    bb = s - c
    err = (c - (s - bb)).add_(p - bb)
    # round to odd: truncate toward zero, then set the last bit if inexact
    inexact = err != 0
    toward_zero = inexact & ((err > 0) != (s > 0))
    bits = (s.view(torch.int64) - toward_zero.to(torch.int64)) | inexact.to(torch.int64)
    return bits.view(torch.float64).float()


def dot3_fused(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (3 entries) of ``x * y`` as XLA's CPU code
    forms a product-sum reduction it does not vectorise across rows:
    ``fma(x2, y2, fma(x1, y1, x0 * y0))``."""

    acc = x[..., 0] * y[..., 0]
    acc = fma32(x[..., 1], y[..., 1], acc)
    return fma32(x[..., 2], y[..., 2], acc)


def norm_last(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis, ``sqrt(sum(x ** 2))``, rounded as
    XLA's CPU code rounds it, so that lengths, and the step counts
    ``int(d / eps)`` taken from them, are the JAX package's.

    XLA sums the squares in index order, each step a fused multiply-add,
    except where it vectorises: rows of 5 to 8 entries it takes four at a
    time in vector registers, each step a multiply and an add, and only the
    rows left over past a multiple of four get fused multiply-adds. Rows
    run along the second-to-last axis; an axis before it (lanes of
    problems) repeats the rule, so each lane rounds as its own call does. Fused steps are formed here in
    float64 and rounded once (the square of a float32 is exact there); the
    sqrt too, since torch's float32 sqrt on the CPU is not correctly
    rounded. The CPU and the card give the same bits.
    """

    d = x.shape[-1]
    x64 = x.double()
    acc = (x64[..., 0] * x64[..., 0]).float()
    for i in range(1, d):
        acc = (acc.double() + x64[..., i] * x64[..., i]).float()
    if 5 <= d <= 8 and x.dim() >= 2:
        plain = x[..., 0] * x[..., 0]
        for i in range(1, d):
            plain = plain + x[..., i] * x[..., i]
        rows = x.shape[-2]
        vector = torch.arange(rows, device=x.device) < rows // 4 * 4
        acc = torch.where(vector, plain, acc)
    return torch.sqrt(acc.double()).float()


# glibc's float32 sin and cos (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c:
# __sincosf_table, sincosf.h), which XLA's CPU code calls for jnp.cos and
# jnp.sin. For |x| < 120 they reduce x by the nearest multiple n of pi / 2
# in float64, n = ((int32) (x 2^24 2 / pi) + 2^23) >> 24, and evaluate one
# of two float64 polynomials at the remainder, rounded once to float32.
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")  # 2^24 * 2 / pi
_HPI = float.fromhex("0x1.921fb54442d18p+0")  # pi / 2
_C0 = float.fromhex("0x1p+0")
_C1 = float.fromhex("-0x1.ffffffd0c621cp-2")
_C2 = float.fromhex("0x1.55553e1068f19p-5")
_C3 = float.fromhex("-0x1.6c087e89a359dp-10")
_C4 = float.fromhex("0x1.99343027bf8c3p-16")
_S1 = float.fromhex("-0x1.555545995a603p-3")
_S2 = float.fromhex("0x1.1107605230bc4p-7")
_S3 = float.fromhex("-0x1.994eb3774cf24p-13")
# glibc takes another reduction from here on; FK never sees such angles
# (every joint limit lies within 9)
TRIG_LIMIT = 120.0


def sincosf32(x: torch.Tensor):
    """(cos x, sin x) of float32 angles, bit-equal to glibc's ``cosf`` and
    ``sinf`` (and so to ``jax.jit(jnp.cos)`` and ``jnp.sin`` on the CPU),
    on every device: one reduction and the two polynomials for all angles.

    NaN stays NaN, and an infinite angle gives NaN, as in glibc. A finite
    angle of 120 or more takes another reduction in glibc: on a CPU tensor
    it raises; on the card (where reading it back would cost a sync) it
    goes through the same reduction, which FK can afford because such a
    configuration is outside every joint limit, so its decision is "not
    free" whatever its endpoints."""

    if x.device.type == "cpu" and bool(((x.abs() >= TRIG_LIMIT) & x.isfinite()).any()):
        raise ValueError(f"sincosf32 takes |x| < {TRIG_LIMIT}, got {x.abs().max().item()}")
    y = x.double()
    n = ((y * _HPI_INV).trunc().to(torch.int64) + 0x800000) >> 24
    r = y - n.double() * _HPI
    # sign[n & 3] = 1, -1, -1, 1 multiplies the odd polynomial's argument;
    # for n & 2 the table's second entry negates c0..c4
    xs = torch.where(((n + 1) & 2) != 0, -r, r)
    x2 = r * r
    x3 = xs * x2
    odd = (xs + x3 * _S1) + (x3 * x2) * (_S2 + x2 * _S3)
    x4 = x2 * x2
    even = ((_C0 + x2 * _C1) + x4 * _C2) + (x4 * x2) * (_C3 + x2 * _C4)
    even = torch.where((n & 2) != 0, -even, even)
    n_odd = (n & 1) != 0
    cos = torch.where(n_odd, odd, even).float()
    sin = torch.where(n_odd, even, odd).float()
    # below 2^-12: cosf returns 1 and sinf its argument
    tiny = x.abs() < 2.0 ** -12
    cos, sin = torch.where(tiny, 1.0, cos), torch.where(tiny, x, sin)
    inf = x.isinf()
    return torch.where(inf, torch.nan, cos), torch.where(inf, torch.nan, sin)


def _rotations(axis: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotations about unit axes (J, 3) by angles with cosines c
    and sines s (B, J): (B, J, 3, 3), with XLA's contractions (module
    docstring), two ``fma32`` calls for all entries."""

    x, y, z = axis.unbind(-1)  # (J,)
    C = (1.0 - c)[..., None]
    # the diagonal fma(aa, C, c); (0,1), (1,2), (2,0): fma(ab, C, -(w s))
    ab = torch.stack([x * x, y * y, z * z, x * y, y * z, x * z], -1)
    ws = torch.stack([z, x, y], -1) * s[..., None]  # (B, J, 3)
    first = fma32(ab, C, torch.cat([c[..., None].expand_as(ws), -ws], -1))
    # (0,2), (1,0), (2,1): fma(w, s, ab C)
    second = fma32(torch.stack([y, z, x], -1), s[..., None],
                   torch.stack([x * z, x * y, y * z], -1) * C)
    d0, d1, d2, m01, m12, m20 = first.unbind(-1)
    p02, p10, p21 = second.unbind(-1)
    rows = [torch.stack(r, -1) for r in ((d0, m01, p02), (p10, d1, m12), (m20, p21, d2))]
    return torch.stack(rows, -2)


def fk_link_frames(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None,
                   trig=None):
    """World (R, t) of every link frame for configurations q (B, dof):
    (B, J+1, 3, 3) and (B, J+1, 3). The root frame is ``base_rot`` (3, 3)
    or (B, 3, 3) and ``base_trans`` (3,) or (B, 3); identity and the
    origin when None. ``trig``: the (cos, sin) (B, J) of every joint's
    angle, where the caller took them in its own pass; else one
    ``sincosf32`` pass here."""

    B = q.shape[0]
    if base_rot is None:
        base_rot = torch.eye(3, dtype=torch.float32, device=q.device)
    if base_trans is None:
        base_trans = torch.zeros(3, dtype=torch.float32, device=q.device)
    if trig is None:
        trig = sincosf32(joint_angles(chain, q))
    rots = _rotations(chain.axis, *trig)  # (B, J, 3, 3)
    Rs = [base_rot.expand(B, 3, 3)]
    ts = [base_trans.expand(B, 3)]
    # per joint: column 2 of origin_rot and origin_trans, the two fused
    # products with the parent's R, side by side (J, 3, 2)
    fused_cols = torch.stack([chain.origin_rot[:, :, 2], chain.origin_trans], -1)
    for j, pf in enumerate(chain.parent_frame):
        R, t = Rs[pf], ts[pf]
        Or = chain.origin_rot[j]
        # R @ origin_rot: columns 0 and 1 in-order sums, column 2 fused;
        # R @ origin_trans fused, then + t
        prod = R[..., :, :, None] * Or[:, :2]  # (B, 3, 3, 2)
        fused = dot3_fused(R[..., :, None, :], fused_cols[j].T)  # (B, 3, 2)
        m = torch.cat([(prod[..., 0, :] + prod[..., 1, :]) + prod[..., 2, :],
                       fused[..., :1]], -1)
        if chain.q_index[j] < 0:
            # a fixed joint's rotation is the identity (cos 0 = 1, sin 0 =
            # 0 exactly), and the fused product with it gives m exactly
            Rs.append(m)
        else:
            Rs.append(dot3_fused(m[..., :, None, :], rots[:, j].transpose(-1, -2)[:, None]))
        ts.append(fused[..., 1] + t)
    return torch.stack(Rs, dim=1), torch.stack(ts, dim=1)


def on_cpu(chain: ChainParams) -> ChainParams:
    """A copy of the chain's tensors on the CPU."""

    return ChainParams(*(t.cpu() if isinstance(t, torch.Tensor) else t for t in chain))


def link_translations(chain: ChainParams, q, base_trans=None) -> np.ndarray:
    """World translations of every link frame of configurations q, (dof,)
    or (B, dof) numbers: (J+1, 3) or (B, J+1, 3) float32 numpy, from one FK
    pass (JAX ``kinematics.link_translations``, per configuration there;
    FK's arithmetic is per row, so a batch gives each row's own bits). A
    host call: pass a CPU chain (:func:`on_cpu`); FK gives the same bits
    there as on the card, without a launch or a sync per call."""

    qs = torch.as_tensor(np.asarray(q, np.float32), device=chain.axis.device)
    if base_trans is not None:
        base_trans = base_trans.to(qs.device)
    one = qs.dim() == 1
    _, ts = fk_link_frames(chain, qs.reshape(-1, qs.shape[-1]), base_trans=base_trans)
    out = ts.cpu().numpy()
    return out[0] if one else out


def joint_angles(chain: ChainParams, q: torch.Tensor) -> torch.Tensor:
    """(B, J) the angle of every joint of the chain, 0 for a fixed one."""

    idx = torch.as_tensor([max(qi, 0) for qi in chain.q_index], device=q.device)
    fixed = torch.as_tensor([qi < 0 for qi in chain.q_index], device=q.device)
    return torch.where(fixed, 0.0, q[:, idx])


def capsules_world(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None,
                   trig=None):
    """Capsule endpoints in the world frame for q (B, dof): (B, C, 3) twice,
    and the radii (C,). ``base_rot``, ``base_trans`` and ``trig`` as in
    :func:`fk_link_frames`."""

    Rs, ts = fk_link_frames(chain, q, base_rot, base_trans, trig)
    R = Rs[:, chain.cap_link]  # (B, C, 3, 3)
    t = ts[:, chain.cap_link]  # (B, C, 3)
    ends = torch.stack([chain.cap_p0, chain.cap_p1])[:, None, :, None, :]  # (2, 1, C, 1, 3)
    p0, p1 = dot3_fused(R, ends.expand((2,) + R.shape)) + t
    return p0, p1, chain.cap_r


def lane_capsules(chain: ChainParams, q: torch.Tensor, base_rot=None, base_trans=None,
                  trig=None):
    """Capsule endpoints of configurations q (L, B, dof) in lanes: (L, B, C,
    3) twice, contiguous, from one :func:`capsules_world` over all L B
    configurations (``base_rot``, ``base_trans`` and ``trig`` per
    configuration, with the same leading axes, or shared)."""

    L, B, dof = q.shape

    def flat(t):
        per_config = t is not None and t.dim() >= 3 and tuple(t.shape[:2]) == (L, B)
        return t.reshape((L * B,) + tuple(t.shape[2:])) if per_config else t

    if trig is not None:
        trig = tuple(t.reshape(L * B, -1) for t in trig)
    p0, p1, _ = capsules_world(chain, q.reshape(L * B, dof), flat(base_rot), flat(base_trans),
                               trig)
    C = p0.shape[1]
    return p0.reshape(L, B, C, 3).contiguous(), p1.reshape(L, B, C, 3).contiguous()


def end_effector(chain: ChainParams, q: torch.Tensor, link_index: int = -1) -> torch.Tensor:
    """World translation of link frame ``link_index`` for configurations q
    (B, dof): (B, 3) (JAX envs/kinematics.py:161-163, per configuration
    there)."""

    _, ts = fk_link_frames(chain, q)
    return ts[:, link_index]
