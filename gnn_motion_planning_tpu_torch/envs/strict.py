"""Strict (mesh-hull surface-point) collision verifier for the arm envs
(port of gnn_motion_planning_tpu/envs/strict.py).

The production oracle approximates each link by calibrated capsules; the
reference's oracle is PyBullet mesh collision, which collides the *convex
hulls* of the link collision meshes against the obstacle boxes. This module
builds a sound-but-incomplete hull-exact check for auditing:

- every link collision mesh is convex-hulled (scipy) and its hull surface
  is point-sampled at a target spacing (plus all hull vertices), on the
  host in float64, with the JAX package's ``RandomState(0)`` stream, so the
  points are its points bit for bit;
- a configuration ``strict_hit`` iff any sampled surface point lies inside
  an obstacle AABB (inflated by ``margin``). A surface point inside a box
  proves hull-box intersection, so ``strict_hit`` never false-positives
  against the hull-vs-box ground truth; it can miss contacts whose
  penetration footprint is smaller than the sampling spacing.

Confusion semantics against the capsule oracle therefore are:
- ``capsule_free & strict_hit``  -> PROVEN false-"free" (lower bound);
- ``capsule_hit & ~strict_hit``  -> possible false-"collide" (upper bound).

``strict_hit`` is tensor ops over a batch of states on the env's device:
the link frames from ``kinematics.fk_link_frames`` (XLA's rounding), each
point placed as XLA's CPU code places it in the JAX package's
``einsum("pij,pj->pi", R, pts) + t`` (a chain of fused multiply-adds,
``kinematics.dot3_fused``, then ``+ t``), and the containment test against
the scene's active boxes. The states go in chunks so that the (states,
points, boxes) test stays within memory.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from gnn_motion_planning_tpu_torch import resolve_device
from gnn_motion_planning_tpu_torch.envs.kinematics import dot3_fused, fk_link_frames
from gnn_motion_planning_tpu_torch.envs.urdf import (
    _parse_origin,
    load_obj_vertices,
    load_stl_vertices,
    rpy_to_matrix,
)

# elements (states x points x box slots) of one chunk
CHUNK_ELEMENTS = {"cuda": 1 << 26, "cpu": 1 << 23}
# configurations a scene in the audit (tools/strict_verifier.py::audit)
AUDIT_CHUNK = 256


class SurfacePoints(NamedTuple):
    """Link-frame hull surface samples, concatenated over links."""

    pts: torch.Tensor  # (P, 3) float32, in link frame
    frame: torch.Tensor  # (P,) long frame index (matches fk_link_frames)


def _sample_triangles(verts, faces, spacing: float, seed: int = 0):
    """Area-weighted surface samples at roughly `spacing` resolution."""

    a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    area = 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)
    n_per = np.maximum((area / (spacing * spacing)).astype(int), 0)
    rng = np.random.RandomState(seed)
    out = []
    for tri_i in np.nonzero(n_per)[0]:
        n = n_per[tri_i]
        u = rng.uniform(size=(n, 2))
        flip = u.sum(1) > 1
        u[flip] = 1 - u[flip]
        p = (
            a[tri_i]
            + u[:, :1] * (b[tri_i] - a[tri_i])
            + u[:, 1:] * (c[tri_i] - a[tri_i])
        )
        out.append(p)
    return np.concatenate(out) if out else np.zeros((0, 3))


def _hull_surface(verts: np.ndarray, spacing: float) -> np.ndarray:
    from scipy.spatial import ConvexHull

    hull = ConvexHull(verts)
    pts = [verts[hull.vertices]]
    pts.append(_sample_triangles(verts, hull.simplices, spacing))
    return np.concatenate(pts)


def _primitive_surface(geom, spacing: float) -> np.ndarray:
    cyl = geom.find("cylinder")
    if cyl is None:
        cyl = geom.find("capsule")
    box = geom.find("box")
    sph = geom.find("sphere")
    if cyl is not None:
        L, r = float(cyl.get("length")), float(cyl.get("radius"))
        nz = max(int(L / spacing) + 1, 2)
        na = max(int(2 * np.pi * r / spacing) + 1, 8)
        z = np.linspace(-L / 2, L / 2, nz)
        th = np.linspace(0, 2 * np.pi, na, endpoint=False)
        zz, tt = np.meshgrid(z, th)
        side = np.stack([r * np.cos(tt), r * np.sin(tt), zz], -1).reshape(-1, 3)
        return side
    if sph is not None:
        r = float(sph.get("radius"))
        n = max(int(4 * np.pi * r * r / spacing**2), 16)
        u = np.random.RandomState(0).normal(size=(n, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        return r * u
    if box is not None:
        s = np.array([float(x) for x in box.get("size").split()]) / 2
        pts = []
        for ax in range(3):
            o = [i for i in range(3) if i != ax]
            n0 = max(int(2 * s[o[0]] / spacing) + 1, 2)
            n1 = max(int(2 * s[o[1]] / spacing) + 1, 2)
            g0, g1 = np.meshgrid(
                np.linspace(-s[o[0]], s[o[0]], n0),
                np.linspace(-s[o[1]], s[o[1]], n1),
            )
            for sign in (-1, 1):
                face = np.zeros((g0.size, 3))
                face[:, o[0]] = g0.ravel()
                face[:, o[1]] = g1.ravel()
                face[:, ax] = sign * s[ax]
                pts.append(face)
        return np.concatenate(pts)
    return np.zeros((0, 3))


def build_surface_points(model, urdf_path: str, spacing: float = 0.01,
                         device=None) -> SurfacePoints:
    """Hull surface samples for every collision element, in link frames, on
    ``device`` (None: CUDA); the sampling runs on the host.

    ``model`` is the RobotModel that ``parse_urdf`` gives for the same file
    (its link_order defines the frame indices used by fk_link_frames).
    """

    path = Path(urdf_path)
    root = ET.parse(str(path)).getroot()
    base_dir = path.parent
    frame_of = {name: i for i, name in enumerate(model.link_order)}

    all_pts, all_frames = [], []
    for link in root.findall("link"):
        name = link.get("name")
        if name not in frame_of:
            continue
        for col in link.findall("collision"):
            geom = col.find("geometry")
            if geom is None:
                continue
            xyz, rpy = _parse_origin(col)
            rot = rpy_to_matrix(rpy)
            mesh = geom.find("mesh")
            if mesh is not None:
                fname = mesh.get("filename")
                scale = np.ones(3)
                if mesh.get("scale"):
                    scale = np.array(
                        [float(x) for x in mesh.get("scale").split()]
                    )
                mpath = base_dir / fname
                verts = (
                    load_stl_vertices(str(mpath))
                    if mpath.suffix.lower() == ".stl"
                    else load_obj_vertices(str(mpath))
                ) * scale
                pts = _hull_surface(verts, spacing)
            else:
                pts = _primitive_surface(geom, spacing)
            if not len(pts):
                continue
            pts = pts @ rot.T + xyz
            all_pts.append(pts)
            all_frames.append(np.full(len(pts), frame_of[name], np.int32))

    device = resolve_device(device)
    pts = np.concatenate(all_pts).astype(np.float32)
    return SurfacePoints(torch.as_tensor(pts, device=device),
                         torch.as_tensor(np.concatenate(all_frames), dtype=torch.long,
                                         device=device))


def world_points(chain, surface: SurfacePoints, qs: torch.Tensor, base_trans=None):
    """World positions (B, P, 3) of every surface point for configurations
    qs (B, dof): ``R p`` as a chain of fused multiply-adds, then ``+ t``."""

    Rs, ts = fk_link_frames(chain, qs, base_trans=base_trans)
    R = Rs[:, surface.frame]  # (B, P, 3, 3)
    t = ts[:, surface.frame]  # (B, P, 3)
    return dot3_fused(R, surface.pts[None, :, None, :]) + t


def make_strict_hit(chain, surface: SurfacePoints, base_trans=None,
                    margin: float = 0.0, plane_point_mask=None):
    """strict_hit(scene, qs) -> bool: any hull surface point inside an
    obstacle AABB (+margin), for configurations qs (B, dof) -> (B,), or
    one configuration (dof,) -> a 0-d tensor. `scene` is the env's
    BoxScene.

    ``plane_point_mask`` (P,) bool marks surface points whose links are
    tested against the z = 0 ground plane (UR5): a marked point with world
    z < 0 is a strict hit (mesh-exact)."""

    plane_mask = (
        torch.as_tensor(np.asarray(plane_point_mask), device=surface.pts.device)
        if plane_point_mask is not None else None
    )
    P = surface.pts.shape[0]

    def hit_chunk(centers, lim, qs):
        world = world_points(chain, surface, qs, base_trans)  # (B, P, 3)
        inside = None
        for k in range(3):
            ax = (world[..., k, None] - centers[:, k]).abs() <= lim[:, k]  # (B, P, O)
            inside = ax if inside is None else inside & ax
        hit = inside.flatten(1).any(dim=1)
        if plane_mask is not None:
            hit |= (plane_mask & (world[..., 2] < -margin)).any(dim=1)
        return hit

    def strict_hit(scene, qs):
        if qs.dim() == 1:
            return strict_hit(scene, qs[None])[0]
        # the active boxes only (one read of the mask): a masked box never
        # counts, so the decisions are those of the padded test
        active = scene.mask.nonzero()[:, 0]
        centers, lim = scene.centers[active], scene.halfs[active] + margin  # (O, 3)
        # chunks sized for every box slot: the placement's float64 work
        # (states x points x 9) wants no larger ones
        step = max(1, CHUNK_ELEMENTS.get(qs.device.type, 1 << 23) // (P * scene.centers.shape[0]))
        return torch.cat([hit_chunk(centers, lim, qs[s0 : s0 + step])
                          for s0 in range(0, qs.shape[0], step)])

    return strict_hit


def make_strict_hit_dual(chain, surface: SurfacePoints, base1, base2, margin: float = 0.0):
    """Dual-arm obstacle-side strict check (cross-arm handled separately)."""

    h1 = make_strict_hit(chain, surface, base_trans=base1, margin=margin)
    h2 = make_strict_hit(chain, surface, base_trans=base2, margin=margin)
    dof = chain.lower.shape[0]

    def strict_hit(scene, qs):
        return h1(scene, qs[..., :dof]) | h2(scene, qs[..., dof:])

    return strict_hit


def validate_path_strict(env, path, strict_hit, chunk: int = 64) -> int:
    """Number of strict-hit states along `path`, interpolated at RRT_EPS
    (the resolution _edge_fp certifies) in float64, then float32, ``chunk``
    states a call. 0 = the returned path is hull-exactly collision-free (up
    to surface-sampling resolution)."""

    path = np.asarray(path, np.float64)
    if len(path) < 2:
        return 0
    states = []
    for a, b in zip(path[:-1], path[1:]):
        d = float(np.linalg.norm(b - a))
        K = max(int(d / env.RRT_EPS), 1)
        for k in range(K + 1):
            states.append(a + (b - a) * k / K)
    states = torch.as_tensor(np.asarray(states, np.float32), device=env.device)
    scene = env.device_scene()
    hits = 0
    for s0 in range(0, len(states), chunk):
        hits += int(strict_hit(scene, states[s0 : s0 + chunk]).sum())
    return hits


def strict_checker(env, spacing: float = 0.01):
    """Hull-surface strict checker for an arm env instance, or None for
    envs whose production oracle is already exact (maze, snake grids).

    Builds the link-hull surface sampling once per env instance and caches
    it on the env. Used by the audit and by the opt-in strict-fallback
    planner stage (planners/strict_fallback.py).
    """

    cached = getattr(env, "_strict_hit_fn", None)
    if cached is not None:
        return cached
    kind = type(env).__name__
    if kind not in ("KukaEnv", "Kuka2Env", "UR5Env"):
        return None
    from gnn_motion_planning_tpu_torch.utils.assets import asset_path

    urdf = asset_path(getattr(env, "kuka_file", "ur5/ur5.urdf"))
    surface = build_surface_points(env.model, str(urdf), spacing=spacing, device=env.device)
    if kind == "Kuka2Env":
        fn = make_strict_hit_dual(env.chain, surface, env.base1, env.base2)
    else:
        plane_point_mask = None
        if kind == "UR5Env":
            # surface points on the links whose capsules meet the plane test
            cap_link = env.chain.cap_link.cpu().numpy()
            plane_frames = set(cap_link[env.geom.plane_mask.cpu().numpy()].tolist())
            plane_point_mask = np.isin(surface.frame.cpu().numpy(), sorted(plane_frames))
        fn = make_strict_hit(
            env.chain,
            surface,
            base_trans=getattr(env, "base_trans", None),
            plane_point_mask=plane_point_mask,
        )
    env._strict_hit_fn = fn
    return fn


def audit_counts(env, n_configs: int = 100_000) -> dict:
    """The capsule oracle against ``strict_hit`` on uniform configurations
    (the cross-tabulation of ``tools/strict_verifier.py::audit``): chunks of
    ``AUDIT_CHUNK`` draws from ``RandomState(0)``, each in the next
    eval-split scene (problems 2000 on), until ``n_configs`` are done.
    Returns the counts: configurations, capsule-free, of those strict-hit
    (proven false-free), capsule-collide, of those not strict-hit (possible
    false-collide). The counts stay on the env's device until the end."""

    hit, kern = strict_checker(env), env.kernels()
    pr = np.array(env.pose_range)
    rng = np.random.RandomState(0)
    problems = list(range(2000, min(3000, len(env.problems))))
    tally = torch.zeros(4, dtype=torch.int64, device=env.device)
    done = 0
    while done < n_configs:
        env.init_new_problem(problems[(done // AUDIT_CHUNK) % len(problems)])
        qs = torch.as_tensor(rng.uniform(pr[:, 0], pr[:, 1], (AUDIT_CHUNK, env.config_dim))
                             .astype(np.float32), device=env.device)
        scene = env.device_scene()
        free = kern.batch_state_free(scene, qs)[0]
        s_hit = hit(scene, qs)
        tally += torch.stack([(free & ~s_hit).sum(), (free & s_hit).sum(),
                              (~free & ~s_hit).sum(), (~free & s_hit).sum()])
        done += AUDIT_CHUNK
    c = tally.cpu().numpy()
    return dict(n_configs=done, capsule_free=int(c[0] + c[1]), false_free_proven=int(c[1]),
                capsule_collide=int(c[2] + c[3]), possible_false_collide=int(c[2]))
