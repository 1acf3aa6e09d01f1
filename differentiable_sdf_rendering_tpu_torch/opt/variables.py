"""Optimized-variable lifecycle: init, gradient/param validation, EMA.

Counterpart of the JAX package's ``opt/variables.py`` (``SdfVariableSpec``,
``VolumeVariableSpec``): specs are frozen dataclasses; all state (the grids,
their EMA means) lives in plain dicts owned by the training loop.
Per-iteration semantics:

  * SDF: sphere init at ``res / 2^#upsamples``; cubic upsample at the
    scheduled iterations; bbox clamp ``max(sdf, box₀.₄₉)``; **redistance
    every iteration**; adaptive LR ``32/res · lr/(1+0.02·i)`` (+halvings at
    480/500); gradient NaN-suppression and clamp to ±0.1.
  * Volume textures (albedo, roughness): constant init at
    ``res / 2^#upsamples`` (at least 2); trilinear upsample; value clamps
    (albedo [1e-5, 1], roughness [0.1, 0.8]); gradient NaN-suppression
    only; their own LR or the global one, without decay.
  * EMA of parameters with per-variable β, reset on shape change.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from ..ops.initializers import create_sphere_sdf, upsample_sdf, upsample_volume
from ..ops.redistance import redistance
from ..ops.sdf import BoxSDF
from .adam import simple_lr_decay

__all__ = ["SdfVariableSpec", "VolumeVariableSpec", "box_sdf_grid", "ema_update"]


@dataclasses.dataclass(frozen=True)
class VolumeVariableSpec:
    """A (Z, Y, X, C) texture volume (albedo or roughness)."""

    key: str
    resolution: int             # final (Z=Y=X) resolution
    channels: int = 3
    init_value: float = 0.5
    upsample_iter: tuple = (100, 128, 160, 170, 192)
    beta: float | None = 0.95
    lr: float | None = None     # None → the global LR
    clamp: tuple | None = None  # (lo, hi) value clamp

    @property
    def initial_resolution(self):
        return self.resolution // 2 ** len(self.upsample_iter or ())

    def initialize(self, device=None):
        r = max(self.initial_resolution, 2)
        return torch.full((r, r, r, self.channels), self.init_value, dtype=torch.float32,
                          device=resolve_device(device))

    @torch.no_grad()
    def validate(self, data, i):
        """Upsample (if scheduled) + value clamp."""
        if self.upsample_iter and i in self.upsample_iter:
            data = upsample_volume(data)
        if self.clamp is not None:
            data = torch.clamp(data, self.clamp[0], self.clamp[1])
        return data

    def validate_gradient(self, g):
        return torch.where(torch.isnan(g), torch.zeros_like(g), g)

    def lr_for(self, lr0, i):
        return self.lr if self.lr is not None else lr0


def box_sdf_grid(res, device=None):
    """Box-SDF (extents 0.49, smoothing 0.01) on the *inclusive* ±0.5
    lattice: the outermost voxel layer sits outside the box and is clamped
    positive by ``max(sdf, box)``, which keeps the zero level set strictly
    inside the grid."""
    device = resolve_device(device)
    if isinstance(res, int):
        res = (res, res, res)
    res = tuple(res)
    box = BoxSDF.create(p=(0.0, 0.0, 0.0), extents=(0.49, 0.49, 0.49), smoothing=0.01, device=device)
    zs, ys, xs = (torch.linspace(-0.5, 0.5, n, dtype=torch.float32, device=device) for n in res)
    z, y, x = torch.meshgrid(zs, ys, xs, indexing="ij")
    pts = torch.stack([x, y, z], dim=-1)
    return box.eval(pts.reshape(-1, 3)).reshape(res)


@dataclasses.dataclass(frozen=True)
class SdfVariableSpec:
    """The SDF grid variable."""

    key: str = "sdf"
    resolution: int = 64
    upsample_iter: tuple = (64, 128)
    sphere_radius: float = 0.3
    bbox_constraint: bool = True
    adaptive_lr: bool = True
    lr_decay: float = 0.02
    beta: float | None = 0.95
    regularizer_weight: float = 1e-5
    grad_clamp: float = 0.1
    redistance_iters: int | None = None  # None → full fixed point

    @property
    def initial_resolution(self):
        return self.resolution // 2 ** len(self.upsample_iter or ())

    def initialize(self, device=None):
        return create_sphere_sdf(self.initial_resolution, radius=self.sphere_radius, device=device)

    @torch.no_grad()
    def validate(self, data, i):
        """Upsample (if scheduled) + bbox clamp + redistance."""
        if self.upsample_iter and i in self.upsample_iter:
            data = upsample_sdf(data)
        if self.bbox_constraint:
            data = torch.maximum(data, box_sdf_grid(data.shape, data.device))
        return redistance(data, iterations=self.redistance_iters)

    def validate_gradient(self, g):
        r = self.grad_clamp
        return torch.where(torch.isnan(g), torch.zeros_like(g), torch.clamp(g, -r, r))

    def lr_for(self, lr0, i, current_res):
        lr = simple_lr_decay(lr0, self.lr_decay, i)
        if self.adaptive_lr:
            lr = lr * (32.0 / current_res)
        return lr


def ema_update(mean, param, beta):
    """EMA with shape-change reset."""
    if mean is None or mean.shape != param.shape:
        return param
    return beta * mean + (1.0 - beta) * param
