"""Small batched 3-D vector/matrix helpers shared by the tracer and warp field.

Counterpart of the JAX package's ``ops/vecmath.py``: normalize Jacobians,
outer products, box-interior distances and ray/AABB intersection as batched
functions over trailing-dim-3 tensors.
"""

from __future__ import annotations

import torch

__all__ = [
    "dot",
    "integer_pow",
    "nearest_axis_mask",
    "norm",
    "normalize",
    "normalize_with_jac",
    "normalize_sqr_with_jac",
    "outer",
    "bbox_distance_inside_d",
    "ray_bbox_intersect",
    "replace_grad",
]


def dot(a, b):
    return torch.sum(a * b, dim=-1)


def integer_pow(x, n: int):
    """``x ** n`` for a Python int ``n`` by repeated squaring (and one
    reciprocal for negative ``n``) — the multiplication sequence XLA uses,
    so the rounding matches the JAX package's ``x ** n``."""
    y = abs(int(n))
    if y == 0:
        return torch.ones_like(x)
    acc = None
    while y > 0:
        if y & 1:
            acc = x if acc is None else acc * x
        y >>= 1
        if y > 0:
            x = x * x
    return 1.0 / acc if n < 0 else acc


def norm(v):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=-1), 1e-30))


def normalize(v):
    return v / norm(v)[..., None]


def outer(a, b):
    """Outer product of trailing-3 vectors → (..., 3, 3)."""
    return a[..., :, None] * b[..., None, :]


def _eye_like(x):
    return torch.eye(3, dtype=x.dtype, device=x.device).expand(x.shape[:-1] + (3, 3))


def normalize_with_jac(x):
    """``x/|x|`` and the Jacobian d(x/|x|)/dx."""
    x2 = torch.clamp_min(torch.sum(x * x, dim=-1), 1e-30)
    inv_v = 1.0 / torch.sqrt(x2)
    jac = inv_v[..., None, None] * _eye_like(x) - (inv_v / x2)[..., None, None] * outer(x, x)
    return x * inv_v[..., None], jac


def normalize_sqr_with_jac(x):
    """``x/|x|^2`` and its Jacobian."""
    x2 = torch.clamp_min(torch.sum(x * x, dim=-1), 1e-30)
    jac = _eye_like(x) / x2[..., None, None] - (2.0 / (x2 * x2))[..., None, None] * outer(x, x)
    return x / x2[..., None], jac


def nearest_axis_mask(min_ax):
    """One-hot (..., 3) mask of the strictly smallest axis of ``min_ax``
    (ties → zero vector)."""
    mx, my, mz = min_ax[..., 0], min_ax[..., 1], min_ax[..., 2]
    ex = (mx < my) & (mx < mz)
    ey = (my < mz) & (my < mx)
    ez = (mz < mx) & (mz < my)
    return torch.stack([ex, ey, ez], dim=-1).to(min_ax.dtype)


def bbox_distance_inside_d(x, bmin, bmax):
    """Distance to the nearest box face from inside (clamped to 0) and its
    spatial derivative.

    Returns ``(dist (...,), dist_d (..., 3))``; the derivative picks the
    single nearest axis with strict comparisons (ties → zero vector).
    """
    lo = x - bmin
    hi = bmax - x
    dist = torch.clamp_min(torch.minimum(lo.amin(dim=-1), hi.amin(dim=-1)), 0.0)

    min_ax = torch.minimum(lo.abs(), hi.abs())  # per-axis distance to nearer face
    n = nearest_axis_mask(min_ax)
    sign = torch.sign(hi.abs() - lo.abs())
    dist_d = torch.where((dist > 0.0)[..., None], n * sign, torch.zeros_like(n))
    return dist, dist_d


def ray_bbox_intersect(o, d, bmin, bmax):
    """Slab test. Returns ``(hit, mint, maxt)`` with safe handling of
    axis-parallel rays; mint/maxt are the entry/exit parameters (mint may be
    negative if the origin is inside)."""
    tiny = torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype)
    safe_d = torch.where(d.abs() < 1e-12, tiny, d)
    inv_d = 1.0 / safe_d
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    hit = (tmax >= tmin) & (tmax > 0.0)
    return hit, tmin, tmax


def replace_grad(a, b):
    """Value of ``a``, gradient of ``b``."""
    return a.detach() + (b - b.detach())
