"""SDF grid regularizers (counterpart of the JAX package's
``opt/regularizations.py``)."""

from __future__ import annotations

import torch

__all__ = ["discrete_laplacian_reg"]


def _shift(x, delta, axis):
    """Shift with clamped (replicated) boundary."""
    n = x.shape[axis]
    if delta == 1:
        return torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)
    return torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis)


def discrete_laplacian_reg(data):
    """Σ (f − mean of 6-neighborhood)²; default weight 1e-5."""
    if data.ndim == 4:
        data = data[..., 0]
    nb = (
        _shift(data, 1, 0) + _shift(data, -1, 0)
        + _shift(data, 1, 1) + _shift(data, -1, 1)
        + _shift(data, 1, 2) + _shift(data, -1, 2)
    )
    return torch.sum((data - nb / 6.0) ** 2)
