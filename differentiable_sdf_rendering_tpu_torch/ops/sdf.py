"""SDF shape representations as plain dataclasses holding tensors.

Counterpart of the JAX package's ``ops/sdf.py``: shapes are immutable
dataclasses; evaluation functions are batched over arbitrary leading dims.
Tracer hyper-parameters live in the frozen ``TraceParams``.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import resolve_device
from . import grid as gridops

__all__ = [
    "TraceParams",
    "GridSDF",
    "SphereSDF",
    "BoxSDF",
]


@dataclasses.dataclass(frozen=True)
class TraceParams:
    """Sphere-tracer hyper-parameters (defaults equal the JAX package's,
    value for value, so configs compare equal across the two)."""

    step_scale: float = 1.0
    # Over-relaxation factor of the non-differential trace; only 1.0 (off)
    # is implemented in this package.
    over_relax: float = 1.0
    trace_eps: float = 1e-6
    refine_intersection: bool = True
    # Intersection root polisher: only 'fixed' (the reference's
    # decreasing-rate iteration) is implemented in this package.
    refine: str = "fixed"
    use_extra_weight: bool = True
    extra_thresh: float = 0.05
    sil_weight_offset: float = 0.05
    sil_weight_epsilon: float = 1e-6
    weight_power: int = 3
    use_weight_sum_weight: bool = True
    max_steps: int = 192
    refine_steps: int = 10
    bbox_expand: float = 0.05
    # Inert here: the JAX package's loop-staging knobs.  Kept so that a
    # config carries the same fields; the trace loops of this package
    # compact their active lanes on their own schedule.
    compact_stages: tuple = (4, 16, 128)
    unroll: int = 1


def _vec3(v, device, dtype=torch.float32):
    return torch.as_tensor(v, dtype=dtype, device=device)


@dataclasses.dataclass(frozen=True)
class GridSDF:
    """Dense-voxel SDF in the unit cube.

    Attributes:
      data: (Z, Y, X) float32 signed distances.
      p:    (3,) translation of the unit cube (differentiable).
    """

    data: torch.Tensor
    p: torch.Tensor

    @classmethod
    def create(cls, data, p=None, device=None):
        """``device=None`` keeps a tensor where it is (and places anything
        else through :func:`resolve_device`, i.e. on the card)."""
        if not isinstance(data, torch.Tensor) or device is not None:
            data = torch.as_tensor(data, dtype=torch.float32, device=resolve_device(device))
        data = data.to(torch.float32)
        if data.ndim == 4:  # tolerate trailing channel dim (.vol convention)
            data = data[..., 0]
        if p is None:
            p = torch.zeros(3, dtype=torch.float32, device=data.device)
        return cls(data=data, p=_vec3(p, data.device))

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def with_data(self, data):
        return self.replace(data=data)

    def detach(self):
        return self.replace(data=self.data.detach(), p=self.p.detach())

    @property
    def resolution(self):
        return tuple(self.data.shape)

    def eval(self, x):
        return gridops.grid_eval(self.data, x - self.p)

    def eval_and_grad(self, x):
        return gridops.grid_eval_grad(self.data, x - self.p)

    def eval_grad(self, x):
        return gridops.grid_eval_grad(self.data, x - self.p)[1]

    def eval_grad_detached(self, x):
        """Gradient without a graph (the CUDA kernel of
        ``ops/grid.grid_eval_grad_detached`` on the card)."""
        return gridops.grid_eval_grad_detached(self.data, x, self.p)[1]

    def eval_all(self, x):
        """(value, grad, hessian) jet."""
        return gridops.grid_eval_all(self.data, x - self.p)

    def bbox(self, expand: float = 0.05):
        p = self.p.detach()
        return p - expand, p + 1.0 + expand


@dataclasses.dataclass(frozen=True)
class SphereSDF:
    """Analytic sphere SDF used as a test oracle."""

    p: torch.Tensor  # (3,) center
    r: torch.Tensor  # () radius

    @classmethod
    def create(cls, p=(0.5, 0.5, 0.5), r=0.3, device=None):
        """``device=None`` means the card (raises when there is none)."""
        device = resolve_device(device)
        return cls(p=_vec3(p, device), r=_vec3(r, device))

    def detach(self):
        return dataclasses.replace(self, p=self.p.detach(), r=self.r.detach())

    def eval(self, x):
        return torch.linalg.norm(x - self.p, dim=-1) - self.r

    def eval_and_grad(self, x):
        d = x - self.p
        n = torch.linalg.norm(d, dim=-1)
        return n - self.r, d / torch.clamp_min(n, 1e-20)[..., None]

    def eval_grad(self, x):
        return self.eval_and_grad(x)[1]

    def eval_all(self, x):
        d = x - self.p
        n = torch.sqrt(torch.sum(d * d, dim=-1))
        v = n - self.r
        inv_n = 1.0 / torch.clamp_min(n, 1e-20)
        g = d * inv_n[..., None]
        # Hessian of |x - p|: (I - g g^T) / |x - p|
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        h = (eye - g[..., :, None] * g[..., None, :]) * inv_n[..., None, None]
        return v, g, h

    def bbox(self, expand: float = 0.05):
        p = self.p.detach()
        return p - 0.5 - expand, p + 0.5 + expand


@dataclasses.dataclass(frozen=True)
class BoxSDF:
    """Smooth box SDF (iquilezles.org).  Value only: its one user here is
    the bounding-box constraint grid of ``opt/variables.box_sdf_grid``."""

    p: torch.Tensor          # (3,) center
    extents: torch.Tensor    # (3,) half-extents
    smoothing: torch.Tensor  # () corner rounding

    @classmethod
    def create(cls, p=(0.0, 0.0, 0.0), extents=(0.49, 0.49, 0.49), smoothing=0.01, device=None):
        """``device=None`` means the card (raises when there is none)."""
        device = resolve_device(device)
        return cls(p=_vec3(p, device), extents=_vec3(extents, device), smoothing=_vec3(smoothing, device))

    def eval(self, x):
        q = torch.abs(x - self.p) - self.extents
        outside = torch.linalg.norm(torch.clamp_min(q, 0.0), dim=-1)
        inside = torch.clamp_max(q.amax(dim=-1), 0.0)
        return outside + inside - self.smoothing
