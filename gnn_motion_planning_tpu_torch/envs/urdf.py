"""Offline URDF -> kinematic chain + capsule decomposition.

The port's own copy of gnn_motion_planning_tpu/envs/urdf.py (pure numpy):
each URDF is parsed once on the host into a serial-chain parameterisation
for the batched FK (envs/kinematics.py) and conservative capsules: one per
mesh cluster (principal-axis segment + max perpendicular radius), one per
cylinder, capsule, box or sphere. The same arithmetic as the JAX package,
so both build bit-identical chains.
"""

from __future__ import annotations

import struct
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np


def rpy_to_matrix(rpy) -> np.ndarray:
    """URDF fixed-axis roll-pitch-yaw -> rotation matrix (R = Rz Ry Rx)."""

    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def load_stl_vertices(path: str) -> np.ndarray:
    """Binary or ASCII STL -> unique vertex array (n, 3)."""

    raw = Path(path).read_bytes()
    is_ascii = raw[:6].strip().lower().startswith(b"solid") and b"facet" in raw[:500]
    if is_ascii:
        verts = []
        for line in raw.decode("ascii", "ignore").splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                verts.append([float(x) for x in parts[1:4]])
        return np.unique(np.asarray(verts, np.float64), axis=0)
    (n_tri,) = struct.unpack("<I", raw[80:84])
    data = np.frombuffer(raw[84 : 84 + n_tri * 50], dtype=np.uint8)
    data = data.reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3)
    return np.unique(tri.reshape(-1, 3).astype(np.float64), axis=0)


def _kmeans(x: np.ndarray, k: int, iters: int = 30, seed: int = 0) -> np.ndarray:
    rng = np.random.RandomState(seed)
    c = x[rng.choice(len(x), min(k, len(x)), replace=False)]
    assign = np.zeros(len(x), int)
    for _ in range(iters):
        d = ((x[:, None] - c[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        for j in range(len(c)):
            m = assign == j
            if m.any():
                c[j] = x[m].mean(0)
    return assign


def fit_capsules(verts: np.ndarray, n_caps: int = 3):
    """Cluster the mesh into n_caps regions and fit one capsule per region.

    Handles bent links better than a single principal-axis capsule; each
    capsule is conservative over its cluster's vertices.
    """

    if n_caps <= 1 or len(verts) < 4 * n_caps:
        return [fit_capsule(verts)]
    assign = _kmeans(verts, n_caps)
    caps = []
    for j in range(n_caps):
        m = assign == j
        if m.sum() >= 4:
            caps.append(fit_capsule(verts[m]))
    return caps or [fit_capsule(verts)]


def fit_capsule(verts: np.ndarray, shrink: float = 1.0):
    """Conservative capsule fit: principal-axis segment + max radius.

    Returns (p0, p1, radius) in the same frame as `verts`.
    """

    c = verts.mean(axis=0)
    x = verts - c
    cov = x.T @ x / len(x)
    w, vecs = np.linalg.eigh(cov)
    axis = vecs[:, -1]
    t = x @ axis
    radial = x - np.outer(t, axis)
    radius = float(np.linalg.norm(radial, axis=1).max()) * shrink
    # pull segment ends in by the radius so the capsule end-caps cover the
    # extreme vertices without overshooting the mesh ends
    t0, t1 = float(t.min()), float(t.max())
    t0c = min(t0 + radius, 0.0)
    t1c = max(t1 - radius, 0.0)
    p0 = c + t0c * axis
    p1 = c + t1c * axis
    return p0, p1, radius


@dataclass
class JointSpec:
    name: str
    joint_type: str  # revolute / prismatic / fixed
    parent: str
    child: str
    origin_xyz: np.ndarray
    origin_rpy: np.ndarray
    axis: np.ndarray
    lower: float
    upper: float


@dataclass
class LinkCapsule:
    link: str
    p0: np.ndarray  # in link frame
    p1: np.ndarray
    radius: float


@dataclass
class RobotModel:
    """Parsed robot: serial chain + per-link capsules.

    `link_order` lists links base-first; `capsules` are expressed in their
    link's frame (collision origin already applied).
    """

    name: str
    joints: List[JointSpec]
    link_order: List[str]
    capsules: List[LinkCapsule]
    movable: List[int] = field(default_factory=list)  # joint indices

    @property
    def config_dim(self) -> int:
        return len(self.movable)

    def pose_range(self) -> np.ndarray:
        return np.array(
            [[self.joints[j].lower, self.joints[j].upper] for j in self.movable]
        )


def _parse_origin(elem) -> Tuple[np.ndarray, np.ndarray]:
    xyz = np.zeros(3)
    rpy = np.zeros(3)
    if elem is not None:
        o = elem.find("origin")
        if o is not None:
            if o.get("xyz"):
                xyz = np.array([float(x) for x in o.get("xyz").split()])
            if o.get("rpy"):
                rpy = np.array([float(x) for x in o.get("rpy").split()])
    return xyz, rpy


def _geometry_capsule(link_name, col, base_dir, n_caps: int = 3) -> Optional[List[LinkCapsule]]:
    """Capsules of one collision element: fitted to an STL mesh (n_caps
    clusters), or one capsule for a cylinder, capsule, box or sphere
    (JAX envs/urdf.py:177-231). Other meshes are not ported and raise."""

    geom = col.find("geometry")
    if geom is None:
        return None
    xyz, rpy = _parse_origin(col)
    rot = rpy_to_matrix(rpy)
    mesh = geom.find("mesh")
    if mesh is not None:
        if Path(mesh.get("filename")).suffix.lower() != ".stl":
            raise NotImplementedError(f"{link_name}: only STL collision meshes are ported")
        scale = np.ones(3)
        if mesh.get("scale"):
            scale = np.array([float(x) for x in mesh.get("scale").split()])
        verts = load_stl_vertices(str(base_dir / mesh.get("filename"))) * scale
        return [
            LinkCapsule(link=link_name, p0=rot @ p0 + xyz, p1=rot @ p1 + xyz, radius=r)
            for p0, p1, r in fit_capsules(verts, n_caps)
        ]
    cyl = geom.find("cylinder")
    if cyl is None:
        cyl = geom.find("capsule")
    box = geom.find("box")
    sph = geom.find("sphere")
    if cyl is not None:
        L = float(cyl.get("length"))
        r = float(cyl.get("radius"))
        p0 = np.array([0, 0, -L / 2.0])
        p1 = np.array([0, 0, L / 2.0])
    elif box is not None:
        # the major axis becomes the segment, the other two the radius
        size = np.array([float(x) for x in box.get("size").split()])
        major = int(np.argmax(size))
        half = size[major] / 2.0
        r = float(np.linalg.norm(np.delete(size, major)) / 2.0)
        p0 = np.zeros(3)
        p1 = np.zeros(3)
        p0[major], p1[major] = -max(half - r, 0.0), max(half - r, 0.0)
    elif sph is not None:
        r = float(sph.get("radius"))
        p0 = p1 = np.zeros(3)
    else:
        return None
    return [LinkCapsule(link=link_name, p0=rot @ p0 + xyz, p1=rot @ p1 + xyz, radius=r)]


def parse_urdf(path: str, n_caps: int = 3) -> RobotModel:
    path = Path(path)
    root = ET.parse(str(path)).getroot()
    base_dir = path.parent

    joints: List[JointSpec] = []
    children = set()
    for j in root.findall("joint"):
        xyz, rpy = _parse_origin(j)
        axis_el = j.find("axis")
        axis = (
            np.array([float(x) for x in axis_el.get("xyz").split()])
            if axis_el is not None
            else np.array([1.0, 0, 0])
        )
        limit = j.find("limit")
        lower = float(limit.get("lower")) if limit is not None and limit.get("lower") else 0.0
        upper = float(limit.get("upper")) if limit is not None and limit.get("upper") else 0.0
        joints.append(
            JointSpec(
                name=j.get("name"),
                joint_type=j.get("type"),
                parent=j.find("parent").get("link"),
                child=j.find("child").get("link"),
                origin_xyz=xyz,
                origin_rpy=rpy,
                axis=axis,
                lower=lower,
                upper=upper,
            )
        )
        children.add(j.find("child").get("link"))

    link_names = [l.get("name") for l in root.findall("link")]
    roots = [n for n in link_names if n not in children]
    root_link = roots[0]

    # topological joint order (kinematic tree; parents before children).
    by_parent: Dict[str, List[JointSpec]] = {}
    for j in joints:
        by_parent.setdefault(j.parent, []).append(j)
    topo: List[JointSpec] = []
    stack = [root_link]
    order = [root_link]
    while stack:
        link = stack.pop(0)
        for j in by_parent.get(link, []):
            topo.append(j)
            order.append(j.child)
            stack.append(j.child)

    # configuration indices follow *declaration order* of movable joints
    # (PyBullet joint-index parity: reference ur5_env.py:113-118 selects
    # revolute joints in file order)
    decl_movable = [
        j.name
        for j in joints
        if j.joint_type in ("revolute", "prismatic", "continuous")
    ]
    movable = [
        i
        for i, j in enumerate(topo)
        if j.joint_type in ("revolute", "prismatic", "continuous")
    ]
    # sort `movable` (topo indices) by declaration rank so q order matches
    movable.sort(key=lambda i: decl_movable.index(topo[i].name))

    capsules: List[LinkCapsule] = []
    for l in root.findall("link"):
        if l.get("name") not in order:
            continue
        for col in l.findall("collision"):
            caps = _geometry_capsule(l.get("name"), col, base_dir, n_caps=n_caps)
            if caps:
                capsules.extend(caps)

    return RobotModel(
        name=root.get("name"),
        joints=topo,
        link_order=order,
        capsules=capsules,
        movable=movable,
    )
