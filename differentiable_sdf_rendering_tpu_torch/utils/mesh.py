"""Mesh loading, procedural test meshes and mesh → SDF conversion.

Counterpart of the JAX package's ``utils/mesh.py``.  The OBJ loader and the
mesh generators are numpy, copied.  :func:`create_sdf` is the pipeline that
built the checked-in ``scenes/assets/sdfs/*.vol``: ray-parity occupancy on
the voxel lattice (``native``, host C++), redistancing
(``ops/redistance.py``, the CUDA kernel on the card), exact distances to the
triangles in the near-surface band (``native``), and redistancing again.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import native, resolve_device
from ..ops.initializers import voxel_centers
from ..ops.redistance import redistance

__all__ = ["load_obj", "icosphere", "trefoil", "cinquefoil", "blob", "create_sdf"]


def load_obj(path: str):
    """Minimal wavefront OBJ loader → (verts (n,3) f32, tris (m,3) i32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                for k in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def icosphere(subdiv: int = 2, center=(0.5, 0.5, 0.5), radius: float = 0.3):
    """Procedural test mesh (watertight)."""
    t = (1.0 + 5**0.5) / 2.0
    verts = np.asarray(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        np.float64,
    )
    faces = np.asarray(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        np.int64,
    )
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    for _ in range(subdiv):
        edge_mid = {}
        new_faces = []
        verts_list = list(verts)

        def midpoint(i, j):
            key = (min(i, j), max(i, j))
            if key not in edge_mid:
                m = verts_list[i] + verts_list[j]
                m /= np.linalg.norm(m)
                edge_mid[key] = len(verts_list)
                verts_list.append(m)
            return edge_mid[key]

        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts_list)
        faces = np.asarray(new_faces, np.int64)
    verts = verts * radius + np.asarray(center)
    return verts.astype(np.float32), faces.astype(np.int32)


def trefoil(n_u: int = 192, n_v: int = 48, tube_r: float = 0.065,
            center=(0.5, 0.5, 0.5), scale: float = 0.145):
    """Watertight trefoil-knot tube — a non-trivial (knotted, genus-1) test
    shape.  Parametric torus-knot centerline with a circular tube swept
    along a rotation-minimizing-ish frame."""
    u = np.linspace(0.0, 2 * np.pi, n_u, endpoint=False)
    # trefoil centerline
    cx = np.sin(u) + 2 * np.sin(2 * u)
    cy = np.cos(u) - 2 * np.cos(2 * u)
    cz = -np.sin(3 * u)
    C = np.stack([cx, cy, cz], -1) * scale + np.asarray(center)
    # frame from centered-difference tangents
    T = np.roll(C, -1, 0) - np.roll(C, 1, 0)
    T /= np.linalg.norm(T, axis=-1, keepdims=True)
    ref = np.asarray([0.13, 0.97, 0.21])
    N = np.cross(T, ref)
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    B = np.cross(T, N)
    v = np.linspace(0.0, 2 * np.pi, n_v, endpoint=False)
    ring = (np.cos(v)[:, None, None] * N[None] + np.sin(v)[:, None, None] * B[None])
    verts = (C[None] + tube_r * ring).reshape(-1, 3)  # (n_v * n_u, 3)

    def vid(i, j):  # ring i, segment j
        return (i % n_v) * n_u + (j % n_u)

    faces = []
    for j in range(n_u):
        for i in range(n_v):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces += [[a, b, c], [a, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def cinquefoil(n_u: int = 288, n_v: int = 40, tube_r: float = 0.042,
               center=(0.5, 0.5, 0.5), scale: float = 0.115):
    """Watertight (5,2)-torus-knot tube with a modulated tube radius —
    a denser, thinner-featured companion to :func:`trefoil` for the
    hq/hqq-scale assets (five interleaved strands stress 128³/256³
    reconstruction)."""
    p, q = 5, 2
    u = np.linspace(0.0, 2 * np.pi, n_u, endpoint=False)
    r = np.cos(q * u) + 2.0
    C = np.stack([r * np.cos(p * u), r * np.sin(p * u), -np.sin(q * u) * 1.4], -1)
    C = C * scale + np.asarray(center)
    T = np.roll(C, -1, 0) - np.roll(C, 1, 0)
    T /= np.linalg.norm(T, axis=-1, keepdims=True)
    ref = np.asarray([0.21, 0.93, 0.29])
    N = np.cross(T, ref)
    N /= np.linalg.norm(N, axis=-1, keepdims=True)
    B = np.cross(T, N)
    v = np.linspace(0.0, 2 * np.pi, n_v, endpoint=False)
    # gentle radius modulation along the strand (thin + thick features)
    rr = tube_r * (1.0 + 0.35 * np.sin(3.0 * u))[None, :, None]
    ring = (np.cos(v)[:, None, None] * N[None] + np.sin(v)[:, None, None] * B[None])
    verts = (C[None] + rr * ring).reshape(-1, 3)

    def vid(i, j):
        return (i % n_v) * n_u + (j % n_u)

    faces = []
    for j in range(n_u):
        for i in range(n_v):
            a, b = vid(i, j), vid(i + 1, j)
            c, d = vid(i + 1, j + 1), vid(i, j + 1)
            faces += [[a, b, c], [a, c, d]]
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def blob(subdiv: int = 3, center=(0.5, 0.5, 0.5), radius: float = 0.27, amp: float = 0.35):
    """Watertight irregular blob: an icosphere displaced by smooth
    low-frequency harmonics (asymmetric, concave in places)."""
    verts, faces = icosphere(subdiv, center=(0, 0, 0), radius=1.0)
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2]
    disp = (
        0.55 * np.sin(3.1 * x + 1.3) * np.cos(2.3 * y)
        + 0.45 * np.sin(2.7 * y * z + 0.7)
        + 0.35 * np.cos(3.7 * z + 2.1) * np.sin(1.9 * x * y)
    )
    r = 1.0 + amp * disp
    verts = verts * r[:, None] * radius + np.asarray(center, np.float32)
    return verts.astype(np.float32), faces


def create_sdf(mesh, res: int = 128, refine_band: float | None = None, device=None, timer=None):
    """Watertight mesh → (res, res, res) float32 SDF grid on ``device``.

    Args:
      mesh: ``(verts, tris)`` or the path of an ``.obj`` file.
      res: grid resolution (unit-cube lattice).
      refine_band: half-width (world units) of the near-surface band whose
        voxels take exact distances to the triangles; default 1.5 voxels.
      device: where the grid is redistanced and returned; ``None`` means the
        card (raises when there is none).
      timer: an optional ``utils/profiling.Timer``; its sections
        ``"native"`` (occupancy and band distances on the host) and
        ``"redistance"`` (both passes, synchronised) time the two parts.
    """
    device = resolve_device(device)
    if isinstance(mesh, str):
        mesh = load_obj(mesh)
    verts, tris = mesh

    def section(name):
        return timer.section(name) if timer is not None else contextlib.nullcontext()

    with section("native"):
        occ = native.mesh_occupancy(verts, tris, res)  # +1 outside / −1 inside
    with section("redistance"):
        sdf = redistance(torch.from_numpy(occ * np.float32(0.5)).to(device)).cpu().numpy()

    band = refine_band if refine_band is not None else 1.5 / res
    near = np.abs(sdf) < band
    with section("native"):
        pts = voxel_centers(res, "cpu").reshape(-1, 3).numpy()[near.ravel()]
        if len(pts):
            dist = native.mesh_min_distance(verts, tris, pts)
            sdf[near] = np.where(occ[near] < 0, -dist, dist)
    with section("redistance"):
        out = redistance(torch.from_numpy(sdf).to(device))
    return out
