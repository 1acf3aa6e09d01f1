"""BSDF models: Lambertian diffuse with a constant albedo.

Counterpart of the JAX package's ``models/bsdf.py`` (``DiffuseBSDF`` only).
Evaluation is in the local shading frame (+z = normal) and returns values
*premultiplied by the outgoing cosine*.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..ops.sampling import cosine_hemisphere_pdf, square_to_cosine_hemisphere

__all__ = ["DiffuseBSDF"]


@dataclasses.dataclass(frozen=True)
class DiffuseBSDF:
    """Lambertian BSDF with a constant albedo.  ``albedo_tex`` is kept as a
    field for parity with the JAX package; volume textures are not
    implemented here and it must stay ``None``."""

    albedo: torch.Tensor           # (3,)
    albedo_tex: torch.Tensor | None = None
    delta = False

    @classmethod
    def create(cls, albedo=(0.8, 0.8, 0.8), albedo_tex=None, device=None):
        if albedo_tex is not None:
            raise NotImplementedError("volume-textured albedo is not ported")
        return cls(albedo=torch.as_tensor(albedo, dtype=torch.float32, device=resolve_device(device)))

    def _albedo_at(self, p):
        return self.albedo.expand(p.shape[:-1] + (3,))

    def eval(self, si, wo_local):
        """f(wi, wo)·cosθo; zero below the horizon (two-sided off)."""
        a = self._albedo_at(si.p)
        cos_i = si.wi[..., 2]
        cos_o = wo_local[..., 2]
        valid = (cos_i > 0) & (cos_o > 0)
        val = a / math.pi * cos_o[..., None]
        return torch.where(valid[..., None], val, torch.zeros_like(val))

    def pdf(self, si, wo_local):
        pdf = cosine_hemisphere_pdf(wo_local)
        return torch.where(si.wi[..., 2] > 0, pdf, torch.zeros_like(pdf))

    def eval_pdf(self, si, wo_local):
        return self.eval(si, wo_local), self.pdf(si, wo_local)

    def sample(self, si, u2):
        """→ (wo_local, pdf, weight = f·cos/pdf)."""
        wo = square_to_cosine_hemisphere(u2)
        pdf = cosine_hemisphere_pdf(wo)
        a = self._albedo_at(si.p)
        valid = (si.wi[..., 2] > 0) & (pdf > 0)
        weight = torch.where(valid[..., None], a, torch.zeros_like(a))  # (f·cos)/pdf = albedo
        return wo, torch.where(valid, pdf, torch.zeros_like(pdf)), weight
