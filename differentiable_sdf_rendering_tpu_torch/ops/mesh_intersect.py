"""Batched triangle-mesh ray intersection for hybrid SDF + mesh scenes.

Counterpart of the JAX package's ``ops/mesh_intersect.py``.  The mixed
scenes carry small auxiliary meshes (a floor, a mirror rect), so the whole
triangle soup is intersected as one dense Möller–Trumbore computation: rays
broadcast against a chunk of triangles, the nearest hit kept, and a Python
loop over chunks bounds the (rays × triangles) intermediates.  The JAX
package runs the same loop as an XLA ``lax.scan``, not as a Pallas kernel,
and so does this module in plain PyTorch.

The hit distance is differentiable with respect to the ray (origin and
direction) through the Möller–Trumbore solve, so attached shadow-ray origins
and reparameterized directions keep their gradients; the mesh itself is
fixed geometry.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device

__all__ = ["TriangleMesh", "mesh_intersect", "mesh_intersect_full"]

_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class TriangleMesh:
    """Triangle soup in edge form (v0 + u·e1 + v·e2).

    ``albedo`` is the per-triangle (T, 3) reflectance and ``mirror`` a
    per-triangle delta-material bit; ``material`` is the static summary in
    {"diffuse", "mirror", "mixed"}, so that the integrator runs the mirror
    bounce only where a scene has mirror triangles.
    """

    v0: torch.Tensor      # (T, 3)
    e1: torch.Tensor      # (T, 3)
    e2: torch.Tensor      # (T, 3)
    n: torch.Tensor       # (T, 3) unit geometric normals
    albedo: torch.Tensor  # (T, 3) per-triangle reflectance
    material: str = "diffuse"
    mirror: torch.Tensor | None = None  # (T,) bool

    def __post_init__(self):
        if self.mirror is None:
            object.__setattr__(self, "mirror", torch.full((self.v0.shape[0],), self.material == "mirror",
                                                          dtype=torch.bool, device=self.v0.device))

    @classmethod
    def create(cls, vertices, faces, albedo=(0.5, 0.5, 0.5), material="diffuse", device=None):
        if material not in ("diffuse", "mirror"):
            raise ValueError(f"material must be 'diffuse' or 'mirror', got '{material}'")
        device = resolve_device(device)
        v = torch.as_tensor(np.asarray(vertices, np.float32), device=device)
        f = torch.as_tensor(np.asarray(faces, np.int64), device=device)
        v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
        e1, e2 = v1 - v0, v2 - v0
        n = torch.linalg.cross(e1, e2)
        n = n / torch.clamp_min(torch.sqrt(torch.sum(n * n, -1, keepdim=True)), _EPS)
        alb = torch.as_tensor(albedo, dtype=torch.float32, device=device).expand(v0.shape[0], 3).contiguous()
        return cls(v0=v0, e1=e1, e2=e2, n=n, albedo=alb, material=material)

    @classmethod
    def merge(cls, meshes):
        """Concatenate several meshes, each with its own material, into one
        soup."""
        meshes = list(meshes)
        if not meshes:
            raise ValueError("merge() needs at least one mesh")
        if len(meshes) == 1:
            return meshes[0]
        mats = {m.material for m in meshes}
        material = mats.pop() if len(mats) == 1 else "mixed"
        cat = lambda f: torch.cat([f(m) for m in meshes], dim=0)
        return cls(
            v0=cat(lambda m: m.v0), e1=cat(lambda m: m.e1), e2=cat(lambda m: m.e2), n=cat(lambda m: m.n),
            albedo=cat(lambda m: m.albedo), material=material, mirror=cat(lambda m: m.mirror),
        )

    @classmethod
    def rect(cls, corner, e0, e1, albedo=(0.5, 0.5, 0.5), material="diffuse", device=None):
        """Parallelogram ``corner + s·e0 + t·e1`` as two triangles."""
        c = np.asarray(corner, np.float32)
        a = np.asarray(e0, np.float32)
        b = np.asarray(e1, np.float32)
        verts = [c, c + a, c + a + b, c + b]
        return cls.create(verts, [[0, 1, 2], [0, 2, 3]], albedo, material, device=device)

    @classmethod
    def floor(cls, height=0.0, half_extent=10.0, albedo=(0.5, 0.5, 0.5), center_xz=(0.5, 0.5),
              material="diffuse", device=None):
        """Axis-aligned y = height quad, centered under the unit-cube SDF
        domain by default."""
        h, s = float(height), float(half_extent)
        cx, cz = (float(c) for c in center_xz)
        verts = [[cx - s, h, cz - s], [cx + s, h, cz - s], [cx + s, h, cz + s], [cx - s, h, cz + s]]
        return cls.create(verts, [[0, 2, 1], [0, 3, 2]], albedo, material, device=device)

    @property
    def n_triangles(self):
        return self.v0.shape[0]


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def _intersect_chunk(v0, e1, e2, tn, alb, mir, o, d, mint, maxt):
    """Möller–Trumbore of rays (N, 3) against a (C, 3) triangle chunk: the
    per-lane nearest ``(t, normal, albedo, mirror bit)``, t = inf on a
    miss."""
    ox = o[..., None, :]                         # (N, 1, 3)
    dx = d[..., None, :]
    pvec = _cross(dx, e2)            # (N, C, 3)
    det = torch.sum(pvec * e1, -1)               # (N, C)
    ok = det.abs() > _EPS
    det_safe = torch.where(ok, det, torch.ones_like(det))  # NaN-free backward on degenerate lanes
    inv_det = torch.where(ok, 1.0 / det_safe, torch.zeros_like(det))
    tvec = ox - v0
    u = torch.sum(tvec * pvec, -1) * inv_det
    qvec = _cross(tvec, e1)
    v = torch.sum(dx * qvec, -1) * inv_det
    t = torch.sum(e2 * qvec, -1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > mint[..., None]) & (t < maxt[..., None])
    t = torch.where(hit, t, torch.full_like(t, math.inf))
    j = torch.argmin(t.detach(), dim=-1)         # the first of equal minima, as jnp.argmin
    t_best = torch.gather(t, -1, j[..., None])[..., 0]
    return t_best, tn[j], alb[j], mir[j]


def mesh_intersect_full(mesh: TriangleMesh, o, d, mint=1e-4, maxt=math.inf, chunk: int = 128):
    """Nearest-hit distance, geometric normal and hit-triangle attributes of
    rays (N, 3) against ``mesh``: ``(t, n, albedo, mirror)`` with t = inf on
    a miss, the normal turned to face the ray (two-sided geometry), the hit
    triangle's (N, 3) reflectance and its (N,) delta-material bit.
    A mesh of more than ``chunk`` triangles goes ``chunk`` at a time from a
    miss (t = inf, zero normal and albedo), and a chunk replaces the nearest
    hit only where it is strictly nearer."""
    lead = torch.broadcast_shapes(o.shape, d.shape)[:-1]
    # a scalar bound becomes a fill on the device, not a copy from the host
    # (which would wait for the queued work)
    mint, maxt = (v.expand(lead) if torch.is_tensor(v) else torch.full(lead, v, dtype=o.dtype, device=o.device)
                  for v in (mint, maxt))
    attrs = (mesh.v0, mesh.e1, mesh.e2, mesh.n, mesh.albedo, mesh.mirror)
    if mesh.n_triangles <= chunk:
        t, n, alb, mir = _intersect_chunk(*attrs, o, d, mint, maxt)
    else:
        t = torch.full(lead, math.inf, dtype=o.dtype, device=o.device)
        n = torch.zeros(lead + (3,), dtype=o.dtype, device=o.device)
        alb = torch.zeros_like(n)
        mir = torch.zeros(lead, dtype=torch.bool, device=o.device)
        for lo in range(0, mesh.n_triangles, chunk):
            tc, nc, ac, mc = _intersect_chunk(*(a[lo:lo + chunk] for a in attrs), o, d, mint, maxt)
            closer = tc < t
            c3 = closer[..., None]
            t, n, alb, mir = (torch.where(closer, tc, t), torch.where(c3, nc, n), torch.where(c3, ac, alb),
                              torch.where(closer, mc, mir))
    n = torch.where(torch.sum(n * d, -1, keepdim=True) > 0.0, -n, n)
    return t, n, alb, mir


def mesh_intersect(mesh: TriangleMesh, o, d, mint=1e-4, maxt=math.inf, chunk: int = 128):
    """Nearest-hit ``(t, n)`` only."""
    t, n, _, _ = mesh_intersect_full(mesh, o, d, mint, maxt, chunk)
    return t, n
