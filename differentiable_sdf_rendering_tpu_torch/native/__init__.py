"""Host C++ helpers of the mesh → SDF pipeline, bound with ctypes.

Counterpart of the JAX package's ``native/``, from this package's own copy
of ``voxelize.cpp``, built with ``g++`` at first use (never at import) into
``build/libsdfnative-<host>.so`` beside the CUDA kernels' libraries, with
the install step of ``kernels.py`` (a per-process temporary, then an atomic
rename).  ``<host>`` is a hash of the CPU's feature flags: the library is
built with ``-march=native``, so a copy built on another machine is never
loaded here.  Rebuilt when the source is newer.  A failed build or load
raises: nothing here falls back to the numpy versions.

  * :func:`fsm_redistance`    — exact sequential 8-sweep fast-sweeping
    eikonal solver (a cross-check of ``ops/redistance.py``).
  * :func:`mesh_occupancy`    — ray-parity occupancy of a triangle mesh on
    the unit-cube voxel lattice.
  * :func:`mesh_min_distance` — exact closest-point-on-triangle distances
    for the near-surface band.

:func:`occupancy_plain` and :func:`min_distance_plain` are the numpy
versions of the last two, for the tests.  (The JAX package's numpy
fallback ``_tri_dist2_np`` takes the closest of seven candidate points, one
of which is the projection onto the triangle's plane even where it falls
outside the triangle, so it can return less than the distance;
:func:`min_distance_plain` follows the C++ code's Voronoi regions.)
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess

import numpy as np

from .. import kernels

__all__ = ["GXX_FLAGS", "library", "fsm_redistance", "mesh_occupancy", "mesh_min_distance",
           "occupancy_plain", "min_distance_plain"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "voxelize.cpp")
# the JAX package's flags: -march=native lets g++ contract multiply-adds as
# it does there, so that both builds agree bit for bit on one machine
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
_LIB = None


@functools.lru_cache(maxsize=None)
def _host_tag() -> str:
    """A short hash of what ``-march=native`` resolves from: the CPU's
    feature flags (the machine's name where they cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((line for line in f if line.startswith("flags")), "")
    except OSError:
        flags = ""
    return hashlib.sha1((flags or platform.machine()).encode()).hexdigest()[:12]


def _lib_path() -> str:
    return os.path.join(kernels.build_dir(), f"libsdfnative-{_host_tag()}.so")


def _build():
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native helpers cannot be built here")
    lib = _lib_path()
    os.makedirs(kernels.build_dir(), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [gxx, *GXX_FLAGS, _SRC, "-o", tmp]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    kernels._finish_build(proc, cmd, tmp, lib)


def library() -> ctypes.CDLL:
    """The loaded ``libsdfnative-<host>.so`` (built first when missing or stale)."""
    global _LIB
    if _LIB is None:
        lib_path = _lib_path()
        if not os.path.exists(lib_path) or os.path.getmtime(lib_path) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(lib_path)
        i64 = ctypes.c_int64
        i32p, f32p = np.ctypeslib.ndpointer(np.int32), np.ctypeslib.ndpointer(np.float32)
        lib.fsm_redistance.argtypes = [f32p, f32p, i64, ctypes.c_int]
        lib.mesh_occupancy.argtypes = [f32p, i64, i32p, i64, i64, f32p]
        lib.mesh_min_distance.argtypes = [f32p, i64, i32p, i64, f32p, i64, f32p]
        for fn in (lib.fsm_redistance, lib.mesh_occupancy, lib.mesh_min_distance):
            fn.restype = None
        _LIB = lib
    return _LIB


def _mesh_arrays(verts, tris):
    return np.ascontiguousarray(verts, np.float32), np.ascontiguousarray(tris, np.int32)


def fsm_redistance(phi: np.ndarray, n_passes: int = 2) -> np.ndarray:
    """Exact FSM signed distance of a (res, res, res) level set (or with a
    trailing channel of 1), float32."""
    phi = np.ascontiguousarray(phi, np.float32)
    if phi.ndim == 4:
        phi = np.ascontiguousarray(phi[..., 0])
    res = phi.shape[0]
    if phi.shape != (res, res, res):
        raise ValueError(f"fsm_redistance takes a cubic grid, got {phi.shape}")
    out = np.empty_like(phi)
    library().fsm_redistance(phi.ravel(), out.ravel(), res, n_passes)
    return out


def mesh_occupancy(verts, tris, res: int) -> np.ndarray:
    """(res, res, res) float32 occupancy (z, y, x): −1 inside, +1 outside,
    by the parity of the crossings of a +y ray from each voxel center."""
    verts, tris = _mesh_arrays(verts, tris)
    out = np.empty(res**3, np.float32)
    library().mesh_occupancy(verts.ravel(), len(verts), tris.ravel(), len(tris), res, out)
    return out.reshape(res, res, res)


def mesh_min_distance(verts, tris, points) -> np.ndarray:
    """(n,) float32 distance of each point to the closest triangle."""
    verts, tris = _mesh_arrays(verts, tris)
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty(len(points), np.float32)
    library().mesh_min_distance(verts.ravel(), len(verts), tris.ravel(), len(tris), points.ravel(), len(points),
                                out)
    return out


def occupancy_plain(verts, tris, res: int) -> np.ndarray:
    """numpy version of :func:`mesh_occupancy` (float64, as the C++ code)."""
    verts, tris = _mesh_arrays(verts, tris)
    a, b, c = (verts[tris[:, k]].astype(np.float64) for k in range(3))
    centers = (np.arange(res) + 0.5) / res
    out = np.ones((res, res, res), np.float32)
    for iz, pz in enumerate(centers):
        for ix, px in enumerate(centers):
            ax, az = a[:, 0] - px, a[:, 2] - pz
            bx, bz = b[:, 0] - px, b[:, 2] - pz
            cx, cz = c[:, 0] - px, c[:, 2] - pz
            d1 = ax * bz - az * bx
            d2 = bx * cz - bz * cx
            d3 = cx * az - cz * ax
            inside = ~(((d1 < 0) | (d2 < 0) | (d3 < 0)) & ((d1 > 0) | (d2 > 0) | (d3 > 0)))
            area = d1 + d2 + d3
            ok = inside & (np.abs(area) >= 1e-18)
            if not ok.any():
                continue
            w0, w1, w2 = d2[ok] / area[ok], d3[ok] / area[ok], d1[ok] / area[ok]
            hits = np.sort(w0 * a[ok, 1] + w1 * b[ok, 1] + w2 * c[ok, 1])
            crossings = len(hits) - np.searchsorted(hits, centers, side="right")
            out[iz, crossings % 2 == 1, ix] = -1.0
    return out


def _tri_dist2_plain(p, A, B, C):
    """Squared distance from points ``p`` (P, 1, 3) to triangles (1, T, 3):
    the closest point by the C++ code's Voronoi regions, in float64."""
    ab, ac, ap = B - A, C - A, p - A
    bp, cp = p - B, p - C
    d1, d2 = (ab * ap).sum(-1), (ac * ap).sum(-1)
    d3, d4 = (ab * bp).sum(-1), (ac * bp).sum(-1)
    d5, d6 = (ab * cp).sum(-1), (ac * cp).sum(-1)
    vc = d1 * d4 - d3 * d2
    vb = d5 * d2 - d1 * d6
    va = d3 * d6 - d5 * d4
    with np.errstate(divide="ignore", invalid="ignore"):
        v_ab = (d1 / (d1 - d3))[..., None]
        w_ac = (d2 / (d2 - d6))[..., None]
        w_bc = ((d4 - d3) / ((d4 - d3) + (d5 - d6)))[..., None]
        denom = 1.0 / (va + vb + vc)
    v_in, w_in = (vb * denom)[..., None], (vc * denom)[..., None]
    conds = [
        (d1 <= 0) & (d2 <= 0),
        (d3 >= 0) & (d4 <= d3),
        (vc <= 0) & (d1 >= 0) & (d3 <= 0),
        (d6 >= 0) & (d5 <= d6),
        (vb <= 0) & (d2 >= 0) & (d6 <= 0),
        (va <= 0) & (d4 - d3 >= 0) & (d5 - d6 >= 0),
    ]
    cands = [A, B, A + v_ab * ab, C, A + w_ac * ac, B + w_bc * (C - B)]
    best = A + ab * v_in + ac * w_in
    for cond, cand in zip(reversed(conds), reversed(cands)):  # the first region that holds wins
        best = np.where(cond[..., None], cand, best)
    return ((p - best) ** 2).sum(-1)


def min_distance_plain(verts, tris, points) -> np.ndarray:
    """numpy version of :func:`mesh_min_distance`."""
    verts, tris = _mesh_arrays(verts, tris)
    a, b, c = (verts[tris[:, k]].astype(np.float64)[None] for k in range(3))
    points = np.asarray(points, np.float64)
    out = np.empty(len(points), np.float32)
    step = max(1, (1 << 18) // max(len(tris), 1))
    for i in range(0, len(points), step):
        p = points[i:i + step, None, :]
        out[i:i + step] = np.sqrt(_tri_dist2_plain(p, a, b, c).min(-1))
    return out
