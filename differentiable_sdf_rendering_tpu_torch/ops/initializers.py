"""SDF grid initializers and upsampling.

Counterpart of the JAX package's ``ops/initializers.py``.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from . import grid as gridops
from .redistance import redistance

__all__ = [
    "voxel_centers",
    "create_sphere_sdf",
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


def create_sphere_sdf(res, center=(0.5, 0.5, 0.5), radius=0.3, device=None):
    """Sphere SDF grid sampled at voxel centers, then redistanced."""
    pts = voxel_centers(res, device)
    c = torch.tensor(center, dtype=torch.float32, device=pts.device)
    d = torch.linalg.norm(pts - c, dim=-1) - radius
    return redistance(d)


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
