"""Dense-grid cubic B-spline interpolation: value, gradient, Hessian.

Counterpart of the JAX package's ``ops/grid.py``, per-tap path only: the 64
taps of the 4x4x4 window are gathered straight from the ``(Z, Y, X)`` grid
and contracted against the separable basis weights elementwise.  The
backward pass w.r.t. the grid is autograd's scatter-add of the gather
(``index_add_``, whose atomics sum in a run-to-run varying order on the
card).  The JAX package's stencil tables and matmul jet are TPU layout
devices and have no counterpart here.

Conventions (matching the reference / Mitsuba):
  * grid ``data`` has shape (Z, Y, X); a point ``p = (x, y, z)`` in the unit
    cube indexes ``data[z, y, x]``.
  * continuous voxel coordinate ``c = p * res - 0.5``; taps at
    ``floor(c) + {-1, 0, 1, 2}``, clamped to the grid (Mitsuba "clamp" wrap).
  * gradients/Hessians are w.r.t. the *normalized* point coordinates, i.e.
    include the ``res`` / ``res**2`` chain factors.
"""

from __future__ import annotations

import torch

__all__ = [
    "bspline_weights",
    "grid_eval",
    "grid_eval_grad",
    "grid_eval_all",
    "grid_eval_trilinear",
]


def bspline_weights(f):
    """Uniform cubic B-spline basis and its first two derivatives.

    Args:
      f: fractional coordinate, any shape ``(...)``.

    Returns:
      ``(w, dw, ddw)`` each of shape ``(..., 4)`` for taps at offsets
      ``{-1, 0, 1, 2}`` from the base voxel.  Derivatives are w.r.t. ``f``
      (continuous voxel units; multiply by ``res`` per derivative order to
      get normalized-coordinate derivatives).
    """
    f2 = f * f
    f3 = f2 * f
    one_m = 1.0 - f
    w = torch.stack(
        [
            one_m * one_m * one_m * (1.0 / 6.0),
            (3.0 * f3 - 6.0 * f2 + 4.0) * (1.0 / 6.0),
            (-3.0 * f3 + 3.0 * f2 + 3.0 * f + 1.0) * (1.0 / 6.0),
            f3 * (1.0 / 6.0),
        ],
        dim=-1,
    )
    dw = torch.stack(
        [
            -0.5 * one_m * one_m,
            (3.0 * f2 - 4.0 * f) * 0.5,
            (-3.0 * f2 + 2.0 * f + 1.0) * 0.5,
            0.5 * f2,
        ],
        dim=-1,
    )
    ddw = torch.stack([one_m, 3.0 * f - 2.0, 1.0 - 3.0 * f, f], dim=-1)
    return w, dw, ddw


def _res_vector(data, p):
    zres, yres, xres = data.shape[-3], data.shape[-2], data.shape[-1]
    return torch.tensor([xres, yres, zres], dtype=p.dtype, device=p.device)


def _tap_setup(data, p, offsets=(-1, 0, 1, 2)):
    """Tap values (..., nz, ny, nx) and per-axis fractions for the window
    ``floor(c) + offsets`` (clamped per axis)."""
    zres, yres, xres = data.shape[-3], data.shape[-2], data.shape[-1]
    res = _res_vector(data, p)
    c = p * res - 0.5
    base = torch.floor(c)
    f = c - base
    base = base.detach().to(torch.int64)

    offs = torch.tensor(offsets, dtype=torch.int64, device=p.device)
    ix = torch.clamp(base[..., 0:1] + offs, 0, xres - 1)  # (..., n)
    iy = torch.clamp(base[..., 1:2] + offs, 0, yres - 1)
    iz = torch.clamp(base[..., 2:3] + offs, 0, zres - 1)
    lin = (
        iz[..., :, None, None] * (yres * xres)
        + iy[..., None, :, None] * xres
        + ix[..., None, None, :]
    )  # (..., n, n, n)
    # index_select (not advanced indexing): its backward is index_add_'s
    # atomic scatter, not the sort-based accumulation of index_put_
    taps = data.reshape(-1).index_select(0, lin.reshape(-1)).reshape(lin.shape)
    return taps, f, res


def _jet_contract(taps, wxs, wys, wzs, orders):
    """Separable B-spline contractions, elementwise.

    Each requested output order ``(ox, oy, oz)`` is a multiply-reduce of the
    (..., 4, 4, 4) taps against the broadcast outer product of the per-axis
    weight rows.

    Args:
      taps: (..., 4, 4, 4) tap values (z, y, x).
      wxs/wys/wzs: tuples of (..., 4) weight rows per derivative order.
      orders: list of (ox, oy, oz) derivative multi-indices.

    Returns a list of (...,) outputs, one per order.
    """
    taps64 = taps.reshape(taps.shape[:-3] + (64,))
    outs = []
    for ox, oy, oz in orders:
        w = (
            wzs[oz][..., :, None, None]
            * wys[oy][..., None, :, None]
            * wxs[ox][..., None, None, :]
        ).reshape(taps64.shape)
        outs.append(torch.sum(taps64 * w, dim=-1))
    return outs


def _eval_orders(taps, f, orders):
    wx = bspline_weights(f[..., 0])
    wy = bspline_weights(f[..., 1])
    wz = bspline_weights(f[..., 2])
    return _jet_contract(taps, wx, wy, wz, orders)


def grid_eval(data, p):
    """Cubic B-spline value at points ``p`` (..., 3) → (...,)."""
    taps, f, _ = _tap_setup(data, p)
    (value,) = _eval_orders(taps, f, ((0, 0, 0),))
    return value


def grid_eval_grad(data, p):
    """Value and spatial gradient → ``(value (...,), grad (..., 3))``."""
    taps, f, res = _tap_setup(data, p)
    value, gx, gy, gz = _eval_orders(
        taps, f, ((0, 0, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    )
    grad = torch.stack([gx * res[0], gy * res[1], gz * res[2]], dim=-1)
    return value, grad


def grid_eval_all(data, p):
    """Full derivative jet: ``(value (...,), grad (..., 3), hess (..., 3, 3))``."""
    taps, f, res = _tap_setup(data, p)
    value, gx, gy, gz, hxx, hyy, hzz, hxy, hxz, hyz = _eval_orders(
        taps, f,
        (
            (0, 0, 0),
            (1, 0, 0), (0, 1, 0), (0, 0, 1),
            (2, 0, 0), (0, 2, 0), (0, 0, 2),
            (1, 1, 0), (1, 0, 1), (0, 1, 1),
        ),
    )
    rx, ry, rz = res[0], res[1], res[2]
    grad = torch.stack([gx * rx, gy * ry, gz * rz], dim=-1)
    hxx = hxx * (rx * rx)
    hyy = hyy * (ry * ry)
    hzz = hzz * (rz * rz)
    hxy = hxy * (rx * ry)
    hxz = hxz * (rx * rz)
    hyz = hyz * (ry * rz)
    row_x = torch.stack([hxx, hxy, hxz], dim=-1)
    row_y = torch.stack([hxy, hyy, hyz], dim=-1)
    row_z = torch.stack([hxz, hyz, hzz], dim=-1)
    hess = torch.stack([row_x, row_y, row_z], dim=-2)
    return value, grad, hess


def grid_eval_trilinear(data, p):
    """Trilinear value (cheap path for texture volumes / previews)."""
    taps, f, _ = _tap_setup(data, p, offsets=(0, 1))  # (..., 2, 2, 2)
    wx = torch.stack([1.0 - f[..., 0], f[..., 0]], dim=-1)
    wy = torch.stack([1.0 - f[..., 1], f[..., 1]], dim=-1)
    wz = torch.stack([1.0 - f[..., 2], f[..., 2]], dim=-1)
    w = wz[..., :, None, None] * wy[..., None, :, None] * wx[..., None, None, :]
    return torch.sum((taps * w).reshape(taps.shape[:-3] + (8,)), dim=-1)
