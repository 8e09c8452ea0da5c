"""ctypes binding to the native float64 geometry core (runtime/geomcore.cpp).

Port of gnn_motion_planning_tpu/utils/geomcore.py: one serial chain
(``GeomChain``) and the dual-arm rig of kuka14 (``GeomDual``). At
first use it builds ``runtime/geomcore.cpp`` into ``build/torch_port/``
(``FLAGS``). It never loads the committed ``runtime/libgeomcore.so``, whose
instructions may not exist on the host, and a failed build raises.

The JAX package loads that committed library: GCC 12.2's build, whose
instructions are those of ``-march=x86-64-v4``. The vector width g++ picks
sets the order in which the core sums an edge's squared differences, and so
an edge's step count at a near-tie, and ``-march=native`` lets it follow the
host's compiler and tuning (GCC 13.3 on an H100 host picks x86-64-v3's:
Kuka_7D RRT* 2000 then counts 746 checks against 744;
``tools/torch_port_host_rows.py``). So on a host with AVX-512 the core is
built for x86-64-v4, elsewhere for the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnn_motion_planning_tpu_torch.utils.assets import REPO
from gnn_motion_planning_tpu_torch.utils.build import build_shared_library

SRC = REPO / "runtime" / "geomcore.cpp"
FLAGS = ["-O3", "-march=x86-64-v4" if torch.backends.cpu.get_cpu_capability() == "AVX512"
          else "-march=native", "-shared", "-fPIC"]

_lib = None


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_shared_library(SRC, "geomcore", ["g++"], FLAGS)))
    d = ctypes.POINTER(ctypes.c_double)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.geom_new_chain.restype = ctypes.c_int64
    lib.geom_new_chain.argtypes = (
        [ctypes.c_int] * 3 + [d] * 3 + [i32] * 3 + [d] * 5 + [ctypes.c_double]
    )
    lib.geom_new_scene.restype = ctypes.c_int64
    lib.geom_new_scene.argtypes = [ctypes.c_int, d, d]
    lib.geom_free_scene.argtypes = [ctypes.c_int64]
    lib.geom_free_chain.argtypes = [ctypes.c_int64]
    lib.geom_states_free.argtypes = [ctypes.c_int64, ctypes.c_int64, d, ctypes.c_int, u8, i32]
    lib.geom_edge_free.argtypes = [ctypes.c_int64, ctypes.c_int64, d, d, u8, i32]
    lib.geom_new_dual.restype = ctypes.c_int64
    lib.geom_new_dual.argtypes = [ctypes.c_int64, d, d]
    lib.geom_free_dual.argtypes = [ctypes.c_int64]
    lib.geom_dual_states_free.argtypes = [ctypes.c_int64, ctypes.c_int64, d, ctypes.c_int, u8, i32]
    lib.geom_dual_edge_free.argtypes = [ctypes.c_int64, ctypes.c_int64, d, d, u8, i32]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _states_free(fn, handle, scene, qs: np.ndarray):
    """(free (n,) bool, n_checks (n,) int32) of the n rows of qs."""

    qs = np.ascontiguousarray(qs, np.float64)
    n = len(qs)
    free = np.zeros(n, np.uint8)
    cnt = np.zeros(n, np.int32)
    fn(handle, scene, _ptr(qs, ctypes.c_double), n, _ptr(free, ctypes.c_uint8),
       _ptr(cnt, ctypes.c_int32))
    return free.astype(bool), cnt


def _edge_free(fn, handle, scene, qa: np.ndarray, qb: np.ndarray):
    """(free, n_checks) of the edge qa -> qb under the fixed-step rule."""

    qa = np.ascontiguousarray(qa, np.float64)
    qb = np.ascontiguousarray(qb, np.float64)
    free = np.zeros(1, np.uint8)
    cnt = np.zeros(1, np.int32)
    fn(handle, scene, _ptr(qa, ctypes.c_double), _ptr(qb, ctypes.c_double),
       _ptr(free, ctypes.c_uint8), _ptr(cnt, ctypes.c_int32))
    return bool(free[0]), int(cnt[0])


class GeomChain:
    """Native oracle bound to one serial chain among AABB obstacles.

    ``arrays`` holds the chain's float32 values as numpy arrays (the same
    values the device kernels use), handed to the core in float64.
    """

    def __init__(self, arrays: dict, rrt_eps: float):
        lib = get_lib()
        f64 = lambda k: np.ascontiguousarray(arrays[k], np.float64)  # noqa: E731
        i32 = lambda k: np.ascontiguousarray(arrays[k], np.int32)  # noqa: E731
        self._keep = [
            f64("origin_rot").reshape(-1, 9), f64("origin_trans"), f64("axis"),
            i32("q_index"), i32("parent_frame"), i32("cap_link"),
            f64("cap_p0"), f64("cap_p1"), f64("cap_r"), f64("lower"), f64("upper"),
        ]
        ctypes_of = [ctypes.c_double] * 3 + [ctypes.c_int32] * 3 + [ctypes.c_double] * 5
        self.dof = self._keep[9].shape[0]
        self.handle = lib.geom_new_chain(
            self._keep[0].shape[0],
            self._keep[8].shape[0],
            self.dof,
            *[_ptr(a, t) for a, t in zip(self._keep, ctypes_of)],
            float(rrt_eps),
        )
        self._scene = None

    def set_scene(self, centers: np.ndarray, halfs: np.ndarray):
        lib = get_lib()
        if self._scene is not None:
            lib.geom_free_scene(self._scene)
        self._centers = np.ascontiguousarray(centers, np.float64)
        self._halfs = np.ascontiguousarray(halfs, np.float64)
        self._scene = lib.geom_new_scene(
            len(self._centers),
            _ptr(self._centers, ctypes.c_double),
            _ptr(self._halfs, ctypes.c_double),
        )

    def states_free(self, qs: np.ndarray):
        return _states_free(get_lib().geom_states_free, self.handle, self._scene, qs)

    def edge_free(self, qa: np.ndarray, qb: np.ndarray):
        return _edge_free(get_lib().geom_edge_free, self.handle, self._scene, qa, qb)

    def __del__(self):
        lib = _lib
        if lib is None:
            return
        if self._scene is not None:
            lib.geom_free_scene(self._scene)
            self._scene = None
        lib.geom_free_chain(self.handle)


class GeomDual:
    """Native oracle for the dual-arm rig (kuka14): one chain at two base
    translations; box contact of both arms and cross-arm capsule pairs, as
    envs/kuka2.py's device oracle. Rows of ``states_free`` are 2 * dof long,
    the first arm's angles first."""

    def __init__(self, arrays: dict, base1, base2, rrt_eps: float):
        self._single = GeomChain(arrays, rrt_eps)
        self._bases = [np.ascontiguousarray(b, np.float64) for b in (base1, base2)]
        self.dof = 2 * self._single.dof
        self.handle = get_lib().geom_new_dual(
            self._single.handle, *(_ptr(b, ctypes.c_double) for b in self._bases)
        )

    def set_scene(self, centers: np.ndarray, halfs: np.ndarray):
        self._single.set_scene(centers, halfs)

    def states_free(self, qs: np.ndarray):
        return _states_free(get_lib().geom_dual_states_free, self.handle,
                            self._single._scene, qs)

    def edge_free(self, qa: np.ndarray, qb: np.ndarray):
        return _edge_free(get_lib().geom_dual_edge_free, self.handle, self._single._scene,
                          qa, qb)

    def __del__(self):
        # the native rig refers to the chain: free it first
        if _lib is not None:
            _lib.geom_free_dual(self.handle)
