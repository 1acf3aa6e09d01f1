"""Eikonal redistancing of a level-set grid.

Counterpart of the JAX package's ``ops/redistance.py`` and
``ops/pallas_redistance.py``: after every optimizer step the SDF grid must
again satisfy ``|grad f| = 1`` with an unchanged zero level set.  The scheme
is a parallel Godunov-Jacobi iteration:

  1. freeze first-order-accurate distances in the one-ring around the zero
     crossing (sub-cell linear interpolation, combined across crossing axes),
  2. iterate the monotone Godunov upwind update ``K`` times; each pass is a
     6-point stencil (neighbour min + quadratic solve) on the whole grid, so
     information travels one voxel per pass.

``K = max(resolution)`` reaches the first-order fixed point; a smaller ``K``
still yields correct distances within ``K`` voxels of the surface.

:func:`redistance` is the wrapper: sign and interface initialisation are
plain tensor code for every input; the passes run in the hand-written CUDA
kernel ``csrc/redistance.cu`` when the tensor lies on the card, and in
:func:`redistance_plain` when it lies on the host.  A CUDA tensor never
reaches the plain version: the kernel launches or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["redistance", "redistance_plain"]

_BIG = 1e5
# Far-field ceiling: no point in the expanded unit cube is farther than the
# diagonal (~1.87) from any surface inside it.  Cells the Jacobi sweep has
# not reached within `iterations` passes are clamped here instead of keeping
# the 1e5 sentinel, which would poison the Laplacian regulariser and the
# tracer.
_FAR = 2.0


def _neighbor_min(u, axis: int):
    """min(u[i-1], u[i+1]) along ``axis`` with +BIG beyond the boundary."""
    n = u.shape[axis]
    edge = torch.full_like(u.narrow(axis, 0, 1), _BIG)
    fwd = torch.cat([u.narrow(axis, 1, n - 1), edge], dim=axis)
    bwd = torch.cat([edge, u.narrow(axis, 0, n - 1)], dim=axis)
    return torch.minimum(fwd, bwd)


def _uniform_constants(hx: float, device):
    """0-dim device tensors ``(h, w, 2w, 3w, 3)`` with ``w = 1/(h*h)``, each
    rounded to float32 once, in the order the CUDA kernel computes them."""
    h = torch.tensor(hx, dtype=torch.float32)
    w = torch.tensor(1.0, dtype=torch.float32) / (h * h)
    three = torch.tensor(3.0, dtype=torch.float32)
    return tuple(torch.stack([h, w, 2.0 * w, three * w, three]).to(device))


def _godunov_update(u, h, consts=None):
    """One Jacobi pass of the Godunov upwind eikonal update.

    ``h = (hz, hy, hx)`` as Python floats.  Uniform spacing takes the
    3-element sorting network and the exact operation sequence of the CUDA
    kernel: one IEEE rounding per operation, and every divisor a device
    tensor (``consts``, from :func:`_uniform_constants`) — PyTorch turns a
    division by a Python scalar into a multiplication by its reciprocal,
    which rounds differently.  Non-uniform spacing takes the general
    per-axis-weight solve.
    """
    hz, hy, hx = h
    a = _neighbor_min(u, 0)  # z neighbours
    b = _neighbor_min(u, 1)  # y
    c = _neighbor_min(u, 2)  # x

    # Solve sum_i max((unew - a_i)/h_i, 0)^2 = 1 for the up-to-3 active axes.
    if abs(hz - hy) < 1e-12 and abs(hy - hx) < 1e-12:
        if consts is None:
            consts = _uniform_constants(hx, u.device)
        hh, w, s12, s123, three = consts
        lo, hi = torch.minimum(a, b), torch.maximum(a, b)
        a1 = torch.minimum(lo, c)
        a3 = torch.maximum(hi, c)
        a2 = a + b + c - a1 - a3

        u1 = a1 + hh
        m12 = (a1 + a2) * 0.5
        q12 = (w * (a1 * a1 + a2 * a2) - 1.0) / s12
        u2 = m12 + torch.sqrt(torch.clamp_min(m12 * m12 - q12, 0.0))
        m123 = (a1 + a2 + a3) / three
        q123 = (w * (a1 * a1 + a2 * a2 + a3 * a3) - 1.0) / s123
        u3 = m123 + torch.sqrt(torch.clamp_min(m123 * m123 - q123, 0.0))
    else:
        vals = torch.stack([a, b, c], dim=-1)
        hs = torch.tensor([hz, hy, hx], dtype=u.dtype, device=u.device).expand(vals.shape)
        order = torch.argsort(vals, dim=-1, stable=True)
        vals = torch.gather(vals, -1, order)
        hs = torch.gather(hs, -1, order)
        a1, a2, a3 = vals[..., 0], vals[..., 1], vals[..., 2]
        h1, h2, h3 = hs[..., 0], hs[..., 1], hs[..., 2]
        # 1-axis solution
        u1 = a1 + h1
        # 2-axis solution of ((u-a1)/h1)^2 + ((u-a2)/h2)^2 = 1
        w1, w2 = 1.0 / (h1 * h1), 1.0 / (h2 * h2)
        s12 = w1 + w2
        m12 = (w1 * a1 + w2 * a2) / s12
        q12 = (w1 * a1 * a1 + w2 * a2 * a2 - 1.0) / s12
        u2 = m12 + torch.sqrt(torch.clamp_min(m12 * m12 - q12, 0.0))
        # 3-axis solution
        w3 = 1.0 / (h3 * h3)
        s123 = s12 + w3
        m123 = (w1 * a1 + w2 * a2 + w3 * a3) / s123
        q123 = (w1 * a1 * a1 + w2 * a2 * a2 + w3 * a3 * a3 - 1.0) / s123
        u3 = m123 + torch.sqrt(torch.clamp_min(m123 * m123 - q123, 0.0))

    unew = torch.where(u1 <= a2, u1, torch.where(u2 <= a3, u2, u3))
    return torch.minimum(u, unew)


def _interface_init(phi, h):
    """First-order sub-cell distances next to the zero crossing.

    For each axis with a sign change to a neighbour, the distance to the
    crossing is ``h * |phi| / |phi - phi_neighbour|``; multiple axes combine
    as distance-to-plane ``1/sqrt(sum 1/d_k^2)``.  Returns ``(dist, frozen)``.
    """
    apos = phi >= 0.0
    inv_d2 = torch.zeros_like(phi)
    frozen = torch.zeros_like(apos)
    for axis, ha in zip((0, 1, 2), h):
        n = phi.shape[axis]
        for shift in (-1, 1):
            nb = torch.roll(phi, shift, dims=axis)
            nb_pos = torch.roll(apos, shift, dims=axis)
            # Exclude the wrapped boundary slice.
            idx = torch.arange(n, device=phi.device)
            valid_line = (idx < n - 1) if shift == -1 else (idx > 0)
            shape = [1, 1, 1]
            shape[axis] = n
            crossing = (apos != nb_pos) & valid_line.reshape(shape)
            denom = torch.abs(phi - nb)
            d = ha * torch.abs(phi) / torch.clamp_min(denom, 1e-12)
            d = torch.clamp_min(d, 1e-2 * ha)  # guard exact-zero voxels
            inv_d2 = torch.where(crossing, inv_d2 + 1.0 / (d * d), inv_d2)
            frozen = frozen | crossing
    dist = torch.where(
        frozen, 1.0 / torch.sqrt(torch.clamp_min(inv_d2, 1e-20)), torch.full_like(phi, _BIG)
    )
    return dist, frozen


def _spacing(shape):
    """Voxel spacing per axis, rounded to float32 as the kernel computes it."""
    one = torch.tensor(1.0, dtype=torch.float32)
    return tuple(float(one / torch.tensor(float(n), dtype=torch.float32)) for n in shape)


def redistance_plain(dist0, frozen, sign, iterations: int):
    """Plain PyTorch version of the redistancing kernel: ``iterations`` Jacobi
    passes from ``dist0`` with the ``frozen`` voxels held, then
    ``sign * min(u, 2)``.  Runs on whatever device its inputs lie on; also
    covers non-cubic grids (per-axis spacing)."""
    h = _spacing(dist0.shape)
    consts = _uniform_constants(h[2], dist0.device) if h[0] == h[1] == h[2] else None
    u = dist0
    for _ in range(iterations):
        u = torch.where(frozen, dist0, _godunov_update(u, h, consts))
    return sign * torch.clamp_max(u, _FAR)


def _redistance_kernel(dist0, frozen, sign, iterations: int):
    """Launch ``csrc/redistance.cu::redistance_run`` on the current stream."""
    from .. import kernels

    res = dist0.shape[0]
    if not (dist0.shape[1] == res and dist0.shape[2] == res):
        raise NotImplementedError(
            f"the CUDA redistancing kernel takes cubic grids only, got {tuple(dist0.shape)}"
        )
    dist0 = dist0.contiguous()
    sign = sign.contiguous()
    frozen_u8 = frozen.to(torch.uint8).contiguous()
    out = torch.empty_like(dist0)
    u_a = torch.empty_like(dist0)
    u_b = torch.empty_like(dist0)
    lib = kernels.library("redistance")
    launched = ctypes.c_int(0)
    with torch.cuda.device(dist0.device):
        err = lib.redistance_run(
            dist0.data_ptr(), frozen_u8.data_ptr(), sign.data_ptr(),
            u_a.data_ptr(), u_b.data_ptr(), out.data_ptr(),
            int(res), int(iterations), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched),
        )
    redistance.kernel_launches += 1
    redistance.cuda_launches += launched.value
    if err != 0:
        raise RuntimeError(f"redistance_run: CUDA error {err} at launch")
    return out


def redistance(phi, iterations: int | None = None):
    """Recompute a signed distance function with the same zero level set.

    Args:
      phi: (Z, Y, X) or (Z, Y, X, 1) level-set values (any valid level set,
        not necessarily a distance).  The result is detached.
      iterations: Jacobi-Godunov passes; defaults to ``max(res)``, which
        reaches the fixed point everywhere in the grid.

    A CUDA tensor goes through the CUDA kernel (cubic grids; anything else
    raises ``NotImplementedError``), a CPU tensor through
    :func:`redistance_plain`.  ``redistance.kernel_launches`` counts the
    calls that went to the kernel, ``redistance.cuda_launches`` the CUDA
    launches those calls made, as ``redistance_run`` reports them.

    Returns:
      Signed distance grid of the same shape, float32.
    """
    squeeze = phi.ndim == 4
    if squeeze:
        phi = phi[..., 0]
    if iterations is None:
        iterations = max(phi.shape)

    phi = phi.detach().to(torch.float32)
    sign = torch.where(phi >= 0.0, 1.0, -1.0).to(torch.float32)
    dist0, frozen = _interface_init(phi, _spacing(phi.shape))

    if phi.is_cuda:
        out = _redistance_kernel(dist0, frozen, sign, int(iterations))
    else:
        out = redistance_plain(dist0, frozen, sign, int(iterations))
    if squeeze:
        out = out[..., None]
    return out


redistance.kernel_launches = 0
redistance.cuda_launches = 0
