"""Differentiable surface interactions for SDF intersections.

Counterpart of the JAX package's ``ops/interaction.py``: the detached trace
distance is re-attached through the implicit-function theorem,

    t_attached = replace_grad(t, f(p) / detach(⟨∇f, −d⟩)),

the shading normal is the attached normalized SDF gradient, and a shading
frame is built with the branchless Duff et al. orthonormal basis.  Without
``differentiable`` and with autograd off (the primal render), the normal
comes from the detached grid evaluation (the CUDA kernel
``csrc/grid_eval.cu`` on the card).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .vecmath import dot, normalize, replace_grad

__all__ = ["SurfaceInteraction", "coordinate_frame", "compute_surface_interaction"]


@dataclasses.dataclass(frozen=True)
class SurfaceInteraction:
    """Batched surface interaction (tensors (...,) / (..., 3))."""

    valid: torch.Tensor  # bool — finite intersection
    t: torch.Tensor      # attached hit distance
    p: torch.Tensor      # attached hit point
    n: torch.Tensor      # attached shading normal (unit)
    s: torch.Tensor      # frame tangent
    b: torch.Tensor      # frame bitangent
    wi: torch.Tensor     # incident dir in local frame (-ray.d)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_local(self, v):
        return torch.stack([dot(v, self.s), dot(v, self.b), dot(v, self.n)], dim=-1)

    def to_world(self, v):
        return v[..., 0:1] * self.s + v[..., 1:2] * self.b + v[..., 2:3] * self.n


def coordinate_frame(n):
    """Branchless orthonormal basis around unit ``n`` (Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b, -sign * n[..., 0]], dim=-1
    )
    t = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return s, t


def compute_surface_interaction(sdf, o, d, its_t, differentiable: bool = True):
    """Build an attached :class:`SurfaceInteraction` at ``o + its_t·d``.

    ``its_t`` is the detached tracer output (inf = miss); ``d`` may carry
    warp gradients.  Invalid lanes get t=inf but finite (zero-point) frame
    data so downstream math stays NaN-free.
    """
    valid = torch.isfinite(its_t)
    t_safe = torch.where(valid, its_t, torch.zeros_like(its_t))
    p0 = o + t_safe[..., None] * d

    if differentiable:
        f, g = sdf.eval_and_grad(p0)
        denom = dot(g, -d).detach()
        denom = torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))
        t_att = replace_grad(t_safe, f / denom)
    else:
        t_att = t_safe

    p = o + t_att[..., None] * d
    if differentiable or torch.is_grad_enabled():
        n = normalize(sdf.eval_grad(p))
    else:
        n = normalize(sdf.eval_grad_detached(p))
    s, b = coordinate_frame(n.detach())
    si = SurfaceInteraction(
        valid=valid,
        t=torch.where(valid, t_att, torch.full_like(t_att, math.inf)),
        p=p,
        n=n,
        s=s,
        b=b,
        wi=torch.zeros_like(d),
    )
    wi = si.to_local(-d)
    return si.replace(wi=torch.where(valid[..., None], wi, -d))
