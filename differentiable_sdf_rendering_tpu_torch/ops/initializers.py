"""SDF grid initializers and upsampling.

Counterpart of the JAX package's ``ops/initializers.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import resolve_device
from . import grid as gridops
from .redistance import redistance
from .sampling import _threefry2x32

__all__ = [
    "voxel_centers",
    "normal_noise",
    "create_sphere_sdf",
    "create_block_sdf",
    "upsample_sdf",
    "upsample_volume",
]

# Points per interpolation call when resampling a grid: bounds the
# (N, 4, 4, 4) tap tensor of one call.
_UPSAMPLE_CHUNK = 1 << 20


def _res3(res):
    return (res, res, res) if isinstance(res, int) else tuple(res)


def voxel_centers(res, device=None):
    """(Z, Y, X, 3) world positions of voxel centers in the unit cube."""
    device = resolve_device(device)
    res = _res3(res)
    zs, ys, xs = (
        (torch.arange(n, device=device).to(torch.float32) + 0.5) / n for n in res
    )
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    return torch.stack([x, y, z], dim=-1)


# Coefficients of the single-precision inverse error function of M. Giles,
# "Approximating the erfinv function" (GPU Computing Gems, 2011), the
# polynomial that XLA evaluates for ``jax.scipy.special.erfinv`` in float32:
# for w = -log(1 - x²) < 5 in w - 2.5, else in sqrt(w) - 3.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                  -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                  -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _erfinv(x):
    """float32 inverse error function on (-1, 1) by Giles' polynomial (see
    above), evaluated in Horner order as XLA evaluates it; within a few ulps
    of the JAX package's (log1p and the contraction of the multiply-adds
    may round differently)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = None
    for a, b in zip(_ERFINV_W_LT_5, _ERFINV_W_GE_5):
        c = torch.where(lt, torch.full_like(x, a), torch.full_like(x, b))
        p = c if p is None else c + p * w
    return p * x


def normal_noise(seed: int, shape, device=None):
    """Standard normal float32 samples of ``shape``: the draw of
    ``jax.random.normal(jax.random.PRNGKey(seed), shape)`` under threefry2x32
    with partitionable bits.  The uniform bits are bit-equal (counter
    ``(0, i)`` for the i-th element, the two output words xor-ed), mapped to
    [nextafter(-1, 0), 1) as JAX maps them, then ``√2·erfinv`` with
    :func:`_erfinv`: equal to the JAX package's draw within a few ulps."""
    device = resolve_device(device)
    seed = int(seed)
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise ValueError(f"normal_noise draws fewer than 2^32 samples, got {n}")
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = _threefry2x32((seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF, torch.zeros_like(i), i)
    mant = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = float(np.float32(1.0) - lo)  # 2.0 in float32
    u = torch.clamp_min((mant.view(torch.float32) - 1.0) * span + float(lo), float(lo))
    return (np.float32(math.sqrt(2.0)) * _erfinv(u)).reshape(shape)


def create_sphere_sdf(res, center=(0.5, 0.5, 0.5), radius=0.3, noise_sigma=0.0, seed=0, device=None):
    """Sphere SDF grid sampled at voxel centers, plus, for ``noise_sigma`` >
    0, normal noise of deviation ``noise_sigma / 4`` (:func:`normal_noise`
    of ``seed``), then redistanced."""
    pts = voxel_centers(res, device)
    c = torch.tensor(center, dtype=torch.float32, device=pts.device)
    d = torch.linalg.norm(pts - c, dim=-1) - radius
    if noise_sigma > 0:
        d = d + normal_noise(seed, tuple(d.shape), pts.device) * (noise_sigma / 4)
    return redistance(d)


def create_block_sdf(res, center=(0.5, 0.5, 0.5), device=None):
    """Block occupancy → SDF: -1 inside a block of (1/3, 1/3, 1) × res/2
    voxels (z, y, x) about the middle of the grid, +1 outside, then
    redistanced.  ``center`` is accepted and unused, as in the JAX
    package."""
    res = _res3(res)
    r2 = res[0] // 2
    occ = torch.ones(res, dtype=torch.float32, device=resolve_device(device))
    occ[r2 - r2 // 6: r2 + r2 // 6, r2 - r2 // 6: r2 + r2 // 6, r2 - r2 // 2: r2 + r2 // 2] = -1.0
    return redistance(occ)


def _resample(eval_fn, data, new_res):
    pts = voxel_centers(new_res, data.device).reshape(-1, 3)
    outs = [
        eval_fn(data, pts[i : i + _UPSAMPLE_CHUNK])
        for i in range(0, pts.shape[0], _UPSAMPLE_CHUNK)
    ]
    return torch.cat(outs).reshape(new_res)


def upsample_sdf(data):
    """Double SDF resolution: the cubic B-spline interpolant evaluated at the
    new voxel centers.  (The caller redistances afterwards as part of
    ``SdfVariableSpec.validate``.)"""
    if data.ndim == 4:
        data = data[..., 0]
    new_res = tuple(2 * s for s in data.shape)
    with torch.no_grad():
        return _resample(gridops.grid_eval, data, new_res)


def upsample_volume(data):
    """Double a (Z, Y, X, C) texture volume with trilinear interpolation."""
    assert data.ndim == 4
    new_res = tuple(2 * s for s in data.shape[:3])
    with torch.no_grad():
        chans = [
            _resample(gridops.grid_eval_trilinear, data[..., c], new_res)
            for c in range(data.shape[-1])
        ]
    return torch.stack(chans, dim=-1)
