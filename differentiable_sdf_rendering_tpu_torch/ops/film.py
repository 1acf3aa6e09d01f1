"""Differentiable film: gaussian reconstruction-filter splatting.

Counterpart of the JAX package's ``ops/film.py``: per-sample values are
scatter-added into the image with filter weights evaluated at the *attached*
splat position, so moving silhouettes propagate gradients through the filter
weights; ``develop`` divides by the accumulated weight channel.

Filter: truncated gaussian, σ = 0.5, radius 2, weights offset to reach zero
at the radius.  The scatter is ``index_add_`` on the flat padded film; on the
card its atomics sum in a run-to-run varying order.
"""

from __future__ import annotations

import math

import torch

__all__ = ["FILTER_RADIUS", "BORDER", "gaussian_weight", "splat", "develop"]

FILTER_RADIUS = 2.0
BORDER = 2  # ceil(radius): padding when sample_border=True
_SIGMA = 0.5


def gaussian_weight(x):
    """1-D truncated gaussian filter weight at offset ``x`` (pixels)."""
    alpha = -1.0 / (2.0 * _SIGMA * _SIGMA)
    w = torch.exp(alpha * x * x) - math.exp(alpha * FILTER_RADIUS * FILTER_RADIUS)
    return torch.clamp_min(w, 0.0)


def splat(pos, values, height: int, width: int, border: int = BORDER, active=None):
    """Scatter samples into a padded image with 4×4 gaussian filter taps.

    Args:
      pos: (N, 2) continuous film positions in *unpadded pixel* coordinates
        (pixel (i, j) has center (i+0.5, j+0.5)); may be attached — the
        filter weights then carry position gradients.
      values: (N, C) per-sample channel values.
      height, width: unpadded film size.
      border: padding on each side (sample_border).
      active: optional (N,) mask.

    Returns:
      (height + 2·border, width + 2·border, C) accumulated image.
    """
    n = pos.shape[0]
    c = values.shape[-1]
    ph, pw = height + 2 * border, width + 2 * border

    # 4 taps per axis around the sample (pixel centers at integer + 0.5)
    base = torch.floor(pos.detach() - 0.5).to(torch.int64) - 1  # (N, 2)
    offs = torch.arange(4, dtype=torch.int64, device=pos.device)
    tx = base[:, 0:1] + offs  # (N, 4) unpadded pixel indices (x)
    ty = base[:, 1:2] + offs
    wx = gaussian_weight(pos[:, 0:1] - (tx.to(pos.dtype) + 0.5))  # (N, 4)
    wy = gaussian_weight(pos[:, 1:2] - (ty.to(pos.dtype) + 0.5))

    w = wy[:, :, None] * wx[:, None, :]  # (N, 4y, 4x)
    ix = tx[:, None, :] + border  # (N, 1, 4)
    iy = ty[:, :, None] + border  # (N, 4, 1)
    inb = (ix >= 0) & (ix < pw) & (iy >= 0) & (iy < ph)
    if active is not None:
        inb = inb & active[:, None, None]
    w = torch.where(inb, w, torch.zeros_like(w))

    flat_idx = torch.clamp(iy * pw + ix, 0, ph * pw - 1).reshape(n * 16)
    contrib = w.reshape(n, 16, 1) * values[:, None, :]  # (N, 16, C)

    img = torch.zeros((ph * pw, c), dtype=values.dtype, device=values.device)
    img = img.index_add(0, flat_idx, contrib.reshape(n * 16, c))
    return img.reshape(ph, pw, c)


def develop(block, border: int = BORDER, eps: float = 1e-8):
    """Crop the border and normalize by the (last) weight channel.
    Returns (H, W, C-1)."""
    if border > 0:
        block = block[border:-border, border:-border]
    w = block[..., -1]
    safe = torch.where(w.abs() > eps, w, torch.ones_like(w))
    return block[..., :-1] / safe[..., None]
