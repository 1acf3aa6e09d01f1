"""Dense-grid cubic B-spline interpolation: value, gradient, Hessian.

Counterpart of the JAX package's ``ops/grid.py``, per-tap path only: the 64
taps of the 4x4x4 window are gathered straight from the ``(Z, Y, X)`` grid
and contracted against the separable basis weights elementwise.  The
backward pass w.r.t. the grid is autograd's scatter-add of the gather
(``index_add_``, whose atomics sum in a run-to-run varying order on the
card).  The JAX package's stencil tables and matmul jet are TPU layout
devices and have no counterpart here.

:func:`grid_eval_grad_detached` is the wrapper of the hand-written CUDA
kernel ``csrc/grid_eval.cu`` (value and gradient without a graph): a CUDA
tensor goes through the kernel (or the call raises), a CPU tensor through
its plain version :func:`grid_eval_grad_detached_plain`.

Conventions (matching the reference / Mitsuba):
  * grid ``data`` has shape (Z, Y, X); a point ``p = (x, y, z)`` in the unit
    cube indexes ``data[z, y, x]``.
  * continuous voxel coordinate ``c = p * res - 0.5``; taps at
    ``floor(c) + {-1, 0, 1, 2}``, clamped to the grid (Mitsuba "clamp" wrap).
  * gradients/Hessians are w.r.t. the *normalized* point coordinates, i.e.
    include the ``res`` / ``res**2`` chain factors.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "bspline_weights",
    "grid_eval",
    "grid_eval_grad",
    "grid_eval_grad_detached",
    "grid_eval_grad_detached_plain",
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
    return _bspline_rows(f, 2)


def _bspline_rows(f, order):
    """The first ``order + 1`` of :func:`bspline_weights`' ``(w, dw, ddw)``."""
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
    if order == 0:
        return (w,)
    dw = torch.stack(
        [
            -0.5 * one_m * one_m,
            (3.0 * f2 - 4.0 * f) * 0.5,
            (-3.0 * f2 + 2.0 * f + 1.0) * 0.5,
            0.5 * f2,
        ],
        dim=-1,
    )
    if order == 1:
        return w, dw
    ddw = torch.stack([one_m, 3.0 * f - 2.0, 1.0 - 3.0 * f, f], dim=-1)
    return w, dw, ddw


_CONSTS: dict = {}


def _consts(data, p, offsets):
    """Per-(grid shape, device, dtype) constants of :func:`_tap_setup`:
    ``res`` (x, y, z), the tap offsets, the per-axis last index and the
    per-axis strides of the flattened grid."""
    zres, yres, xres = data.shape[-3], data.shape[-2], data.shape[-1]
    key = (xres, yres, zres, offsets, p.dtype, p.device)
    hit = _CONSTS.get(key)
    if hit is None:
        i64 = dict(dtype=torch.int64, device=p.device)
        with torch.inference_mode(False):  # a cached tensor may be saved for a backward later
            hit = (
                torch.tensor([xres, yres, zres], dtype=p.dtype, device=p.device),
                torch.tensor(offsets, **i64),
                torch.tensor([[xres - 1], [yres - 1], [zres - 1]], **i64),
                torch.tensor([[1], [xres], [yres * xres]], **i64),
            )
        _CONSTS[key] = hit
    return hit


def _tap_setup(data, p, offsets=(-1, 0, 1, 2)):
    """Tap values (..., nz, ny, nx) and per-axis fractions for the window
    ``floor(c) + offsets`` (clamped per axis)."""
    res, offs, last, strides = _consts(data, p, offsets)
    c = p * res - 0.5
    base = torch.floor(c)
    f = c - base
    base = base.detach().to(torch.int64)

    # the three axes at once: (..., 3, n) clamped indices, times the strides
    idx = torch.minimum((base[..., None] + offs).clamp_min(0), last) * strides
    lin = (
        idx[..., 2, :, None, None]
        + idx[..., 1, None, :, None]
        + idx[..., 0, None, None, :]
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
    order = max(max(o) for o in orders)  # the weight rows the orders read
    rows = _bspline_rows(f, order)  # the three axes at once: (..., 3, 4) each
    wx = tuple(r[..., 0, :] for r in rows)
    wy = tuple(r[..., 1, :] for r in rows)
    wz = tuple(r[..., 2, :] for r in rows)
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


@torch.no_grad()
def grid_eval_grad_detached_plain(data, x, origin):
    """Plain PyTorch version of the grid-evaluation kernel: value and
    gradient at ``x - origin``, without a graph."""
    return grid_eval_grad(data.detach(), x.detach() - origin.detach())


def _grid_eval_grad_kernel(data, x, origin):
    """Launch ``csrc/grid_eval.cu::grid_eval_grad_run`` on the current stream."""
    from .. import kernels

    data, x, origin = data.detach(), x.detach(), origin.detach()
    if data.ndim != 3 or not data.is_contiguous():
        raise ValueError(f"the CUDA grid evaluation takes a contiguous (Z, Y, X) grid, got {tuple(data.shape)}")
    if not (data.dtype == x.dtype == origin.dtype == torch.float32):
        raise ValueError("the CUDA grid evaluation takes float32 grid, points and origin")
    if not (data.device == x.device == origin.device):
        raise ValueError("grid, points and origin must lie on one device")
    if x.shape[-1] != 3 or origin.shape != (3,):
        raise ValueError(f"points (..., 3) and origin (3,) expected, got {tuple(x.shape)} and {tuple(origin.shape)}")
    lead = x.shape[:-1]
    pts = x.reshape(-1, 3).contiguous()
    origin = origin.contiguous()
    n = pts.shape[0]
    value = torch.empty(n, dtype=torch.float32, device=x.device)
    grad = torch.empty(n, 3, dtype=torch.float32, device=x.device)
    zres, yres, xres = data.shape
    with torch.cuda.device(x.device):
        err = kernels.library("grid_eval").grid_eval_grad_run(
            data.data_ptr(), xres, yres, zres, origin.data_ptr(), pts.data_ptr(),
            value.data_ptr(), grad.data_ptr(), n, torch.cuda.current_stream().cuda_stream,
        )
    grid_eval_grad_detached.kernel_launches += 1
    if err != 0:
        raise RuntimeError(f"grid_eval_grad_run: CUDA error {err} at launch")
    return value.reshape(lead), grad.reshape(lead + (3,))


def grid_eval_grad_detached(data, x, origin):
    """Value and spatial gradient at ``x - origin`` without a graph →
    ``(value (...,), grad (..., 3))``; the same function as
    :func:`grid_eval_grad` of ``x - origin``.

    On a CUDA tensor it runs in ``csrc/grid_eval.cu``; on a CPU tensor in
    :func:`grid_eval_grad_detached_plain`.
    ``grid_eval_grad_detached.kernel_launches`` counts the kernel's launches.
    """
    if x.is_cuda:
        return _grid_eval_grad_kernel(data, x, origin)
    return grid_eval_grad_detached_plain(data, x, origin)


grid_eval_grad_detached.kernel_launches = 0


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
