"""Image losses.

Counterpart of the JAX package's ``opt/losses.py``.  Note: the reference's
``downsample`` gathers the 2×2 neighborhood *without striding* and returns an
image of the same resolution — it is a box blur, not a decimation.
``multiscale`` therefore sums the loss over progressively blurred (same-size)
images; this is reproduced exactly.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["l1", "l2", "mape", "box_blur_2x2", "multiscale", "multiscale_l1", "downsample_half", "ema_smooth"]


def l1(img, ref):
    return torch.mean(torch.abs(img - ref))


def l2(img, ref):
    return torch.mean((img - ref) ** 2)


def mape(img, ref):
    rel = torch.abs(img - ref) / torch.abs(1e-2 + torch.mean(ref, dim=-1, keepdim=True))
    return torch.mean(rel)


def box_blur_2x2(img):
    """Same-resolution 2×2 box filter with clamped edges."""
    right = torch.cat([img[:, 1:], img[:, -1:]], dim=1)
    down = torch.cat([img[1:], img[-1:]], dim=0)
    down_right = torch.cat([right[1:], right[-1:]], dim=0)
    return 0.25 * (img + right + down + down_right)


def multiscale(img, ref, loss_fn=l1, levels: int = 4):
    loss = loss_fn(img, ref)
    for _ in range(levels - 1):
        img = box_blur_2x2(img)
        ref = box_blur_2x2(ref)
        loss = loss + loss_fn(img, ref)
    return loss / levels


def multiscale_l1(img, ref, levels: int = 4):
    return multiscale(img, ref, l1, levels)


def downsample_half(img):
    """True 2× decimation (average pooling) — used to build reference-image
    pyramids for the multiscale *rendering* schedule."""
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    x = img[:h, :w]
    return 0.25 * (x[0::2, 0::2] + x[1::2, 0::2] + x[0::2, 1::2] + x[1::2, 1::2])


def ema_smooth(values, beta: float = 0.9):
    """Exponential-moving-average smoothing of a loss curve, in float64 on the
    host (a figure helper, as in the JAX package)."""
    out = np.asarray(values, dtype=np.float64).copy()
    for i in range(1, len(out)):
        out[i] = beta * out[i - 1] + (1.0 - beta) * out[i]
    return out
