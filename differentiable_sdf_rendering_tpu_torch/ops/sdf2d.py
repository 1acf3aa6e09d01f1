"""2-D SDFs and the 2-D weighted sphere trace — the low-dimensional
executable spec of the tracer's accumulators.

Counterpart of the JAX package's ``ops/sdf2d.py``: :class:`Grid2d` (bicubic
B-spline), :class:`DiskSDF`, :class:`RectangleSDF`, the smooth-min
:class:`UnionSDF`, :class:`HalfSpaceSDF`, the helpers :func:`disk_sdf` and
:func:`arc_sdf`, and :func:`trace_2d`.  Plain PyTorch on the tensors' own
device.  Each SDF has ``eval``, ``eval_and_grad`` and ``eval_all``
(value, gradient, Hessian).

The rectangle's and the union's derivatives are written out here, where the
JAX package differentiates ``eval`` with ``jax.grad``/``jax.hessian``; they
agree wherever ``eval`` is differentiable.  Inside the rectangle the JAX
package's gradient is NaN (the norm of a zero vector); here it is the
gradient of the largest face term, and the Hessian is zero.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from .grid import bspline_weights

__all__ = ["Grid2d", "DiskSDF", "RectangleSDF", "UnionSDF", "HalfSpaceSDF", "disk_sdf", "arc_sdf", "trace_2d"]


def _norm(v):
    return torch.sqrt(torch.sum(v * v, -1))


def _f32(v, like):
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _bspline_eval_2d(data, p):
    """Bicubic B-spline value, gradient and Hessian of the (Y, X) grid
    ``data`` at points ``p`` (..., 2) in the unit square."""
    yres, xres = data.shape
    c = p * torch.tensor([xres, yres], dtype=p.dtype, device=p.device) - 0.5
    base = torch.floor(c)
    f = c - base
    base = base.to(torch.int64)
    offs = torch.arange(-1, 3, device=p.device)
    ix = torch.clamp(base[..., 0:1] + offs, 0, xres - 1)
    iy = torch.clamp(base[..., 1:2] + offs, 0, yres - 1)
    taps = data.reshape(-1)[iy[..., :, None] * xres + ix[..., None, :]]  # (..., 4y, 4x)
    wx = torch.stack(bspline_weights(f[..., 0]), -1)  # (..., 4x, 3): w, dw, ddw
    wy = torch.stack(bspline_weights(f[..., 1]), -1)
    t = torch.einsum("...yx,...xi->...yi", taps, wx)
    out = torch.einsum("...yi,...yj->...ji", t, wy)  # (..., 3y, 3x)
    v = out[..., 0, 0]
    g = torch.stack([out[..., 0, 1] * xres, out[..., 1, 0] * yres], -1)
    hxy = out[..., 1, 1] * xres * yres
    h = torch.stack([
        torch.stack([out[..., 0, 2] * xres * xres, hxy], -1),
        torch.stack([hxy, out[..., 2, 0] * yres * yres], -1),
    ], -2)
    return v, g, h


@dataclasses.dataclass(frozen=True)
class Grid2d:
    """Dense 2-D SDF grid (Y, X) with bicubic B-spline interpolation."""

    data: torch.Tensor

    def eval(self, p):
        return _bspline_eval_2d(self.data, p)[0]

    def eval_and_grad(self, p):
        v, g, _ = _bspline_eval_2d(self.data, p)
        return v, g

    def eval_all(self, p):
        return _bspline_eval_2d(self.data, p)


@dataclasses.dataclass(frozen=True)
class DiskSDF:
    p: torch.Tensor  # (2,) center
    r: torch.Tensor  # () radius

    @classmethod
    def create(cls, p=(0.5, 0.5), r=0.3, device=None):
        device = resolve_device(device)
        return cls(p=torch.tensor(p, dtype=torch.float32, device=device),
                   r=torch.tensor(r, dtype=torch.float32, device=device))

    def eval(self, x):
        return _norm(x - self.p) - self.r

    def eval_and_grad(self, x):
        d = x - self.p
        n = torch.clamp_min(_norm(d), 1e-20)
        return n - self.r, d / n[..., None]

    def eval_all(self, x):
        v, g = self.eval_and_grad(x)
        n = torch.clamp_min(_norm(x - self.p), 1e-20)
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        h = (eye - g[..., :, None] * g[..., None, :]) / n[..., None, None]
        return v, g, h


@dataclasses.dataclass(frozen=True)
class RectangleSDF:
    p: torch.Tensor  # (2,) center
    b: torch.Tensor  # (2,) half extents

    @classmethod
    def create(cls, p=(0.5, 0.5), b=(0.2, 0.1), device=None):
        device = resolve_device(device)
        return cls(p=torch.tensor(p, dtype=torch.float32, device=device),
                   b=torch.tensor(b, dtype=torch.float32, device=device))

    def _parts(self, x):
        d = x - self.p
        q = torch.abs(d) - self.b
        m = torch.clamp_min(q, 0.0)
        return torch.sign(d), q, m, _norm(m)

    def eval(self, x):
        _, q, _, n = self._parts(x)
        return n + torch.clamp_max(torch.amax(q, -1), 0.0)

    def eval_all(self, x):
        s, q, m, n = self._parts(x)
        outside = (n > 0)[..., None]
        n_safe = torch.where(n > 0, n, torch.ones_like(n))[..., None]
        m_hat = m / n_safe
        # inside: the largest face term, the first of equal ones
        face = torch.nn.functional.one_hot(torch.argmax(q, -1), 2).to(x.dtype)
        g = s * torch.where(outside, m_hat, face)
        act = s * (q > 0).to(x.dtype)  # d(m)/dx on the diagonal
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        h_m = (eye - m_hat[..., :, None] * m_hat[..., None, :]) / n_safe[..., None]
        h = torch.where(outside[..., None], act[..., :, None] * h_m * act[..., None, :], torch.zeros_like(h_m))
        return self.eval(x), g, h

    def eval_and_grad(self, x):
        v, g, _ = self.eval_all(x)
        return v, g


@dataclasses.dataclass(frozen=True)
class HalfSpaceSDF:
    n: torch.Tensor       # (2,) unit normal
    offset: torch.Tensor  # ()

    @classmethod
    def create(cls, n=(0.0, 1.0), offset=0.5, device=None):
        device = resolve_device(device)
        n = torch.tensor(n, dtype=torch.float32, device=device)
        return cls(n=n / _norm(n), offset=torch.tensor(offset, dtype=torch.float32, device=device))

    def eval(self, x):
        return torch.sum(x * self.n, -1) - self.offset

    def eval_and_grad(self, x):
        return self.eval(x), self.n.expand(x.shape)

    def eval_all(self, x):
        v, g = self.eval_and_grad(x)
        return v, g, torch.zeros(x.shape[:-1] + (2, 2), dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class UnionSDF:
    """Smooth-min union of two SDFs with blend width ``k``."""

    a: object
    b: object
    k: float = 0.05

    def _blend(self, d1, d2):
        return torch.clamp(0.5 + 0.5 * (d2 - d1) / self.k, 0.0, 1.0)

    def eval(self, x):
        d1, d2 = self.a.eval(x), self.b.eval(x)
        h = self._blend(d1, d2)
        return d2 * (1 - h) + d1 * h - self.k * h * (1 - h)

    def eval_all(self, x):
        # inside the blend the terms of dh cancel: ∇v = (1-h)∇d2 + h∇d1 and
        # H = (1-h)H2 + hH1 - (∇d1-∇d2)(∇d1-∇d2)ᵀ/(2k); outside it h is 0 or 1
        _, g1, h1 = self.a.eval_all(x)
        _, g2, h2 = self.b.eval_all(x)
        v = self.eval(x)
        h = self._blend(self.a.eval(x), self.b.eval(x))
        blend = ((h > 0) & (h < 1)).to(x.dtype)[..., None, None]
        dg = g1 - g2
        g = (1 - h)[..., None] * g2 + h[..., None] * g1
        hess = (1 - h)[..., None, None] * h2 + h[..., None, None] * h1 \
            - blend * dg[..., :, None] * dg[..., None, :] * (0.5 / self.k)
        return v, g, hess

    def eval_and_grad(self, x):
        v, g, _ = self.eval_all(x)
        return v, g


def disk_sdf(pts, center=(0.5, 0.5), r=0.3):
    """Signed distance of ``pts`` (..., 2) to a disk."""
    return _norm(pts - _f32(center, pts)) - r


def arc_sdf(pts, center=(0.5, 0.5), r=0.3, aperture=1.0, thickness=0.02):
    """Signed distance of ``pts`` (..., 2) to an arc of half-aperture
    ``aperture`` (radians) about +y."""
    p = pts - _f32(center, pts)
    sc = torch.stack([torch.sin(_f32(aperture, pts)), torch.cos(_f32(aperture, pts))])
    px = torch.abs(p[..., 0])
    p = torch.stack([px, p[..., 1]], -1)
    in_sector = sc[1] * px > sc[0] * p[..., 1]
    d_end = _norm(p - sc * r)
    d_ring = torch.abs(_norm(p) - r)
    return torch.where(in_sector, d_end, d_ring) - thickness


def trace_2d(sdf, o, d, n_steps: int = 64, trace_eps: float = 1e-5, extra_thresh: float = 0.05):
    """2-D weighted sphere trace of rays ``o + t·d`` (float32 tensors (..., 2))
    against ``sdf``: trapezoid ``warp_t`` and weight sums with the approach
    ("extra") weighting, ``n_steps`` steps, no derivatives.

    Returns ``dict(its_t, warp_t, weight_sum, i)``."""
    o = o.to(torch.float32)
    d = d.to(torch.float32)
    d = d / torch.clamp_min(_norm(d), 1e-20)[..., None]
    shape, dev = o.shape[:-1], o.device
    zeros = lambda: torch.zeros(shape, dtype=torch.float32, device=dev)  # noqa: E731
    t, prev_surf, ws, wt, extra = zeros(), zeros(), zeros(), zeros(), zeros()
    its_t = torch.full(shape, float("inf"), dtype=torch.float32, device=dev)
    act = torch.ones(shape, dtype=torch.bool, device=dev)
    steps = torch.zeros(shape, dtype=torch.int32, device=dev)
    for _ in range(n_steps):
        f, g, _ = sdf.eval_all(o + t[..., None] * d)
        intersected = f < trace_eps
        its_t = torch.where(act & intersected, t, its_t)
        surf = torch.abs(f)
        n_dot_d = torch.sum(g * d, -1)
        n_dot_n = torch.clamp_min(torch.sum(g * g, -1), 1e-20)
        w = (1e-6 + surf + 0.05 * n_dot_d * n_dot_d / n_dot_n) ** -3.0
        inv_den = 1.0 / torch.clamp_min(torch.clamp_max(surf, extra_thresh), 1e-12)
        diff = prev_surf - surf
        ew = torch.clamp_max(extra + torch.where(diff >= 0, diff * inv_den, torch.zeros_like(diff)), 1.0)
        seg = torch.where(intersected, torch.zeros_like(surf), surf)
        inc = 0.5 * (seg + prev_surf) * w * ew
        ws = ws + torch.where(act, inc, torch.zeros_like(inc))
        wt = wt + torch.where(act, inc * t, torch.zeros_like(inc))
        t = torch.where(act, t + seg, t)
        act = act & ~intersected & (t < 4.0)
        prev_surf = torch.where(act, surf, prev_surf)
        extra = torch.where(act, ew, extra)
        steps = steps + act.to(torch.int32)
    warp_t = torch.where(ws > 1e-7, wt / torch.clamp_min(ws, 1e-20), torch.full_like(ws, float("inf")))
    return {"its_t": its_t, "warp_t": warp_t, "weight_sum": ws, "i": steps}
