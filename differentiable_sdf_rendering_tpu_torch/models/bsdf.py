"""BSDF models: Lambertian diffuse, a principled-lite (diffuse + GGX) and a
smooth (delta) conductor.

Counterpart of the JAX package's ``models/bsdf.py`` (``DiffuseBSDF``,
``PrincipledBSDF`` and ``ConductorBSDF``).  Evaluation is in the local shading frame (+z = normal) and returns
values *premultiplied by the outgoing cosine*.

Albedo and roughness are constants or (Z, Y, X, C) volume textures sampled
trilinearly at the (unit-cube) hit point ``si.p``: the textured
reconstructions optimize those volumes, and autograd reaches them through
the texture data and through an attached ``si.p``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..ops import grid as gridops
from ..ops.sampling import cosine_hemisphere_pdf, square_to_cosine_hemisphere

__all__ = ["ConductorBSDF", "DiffuseBSDF", "PrincipledBSDF"]


def _eval_texture(const, tex, p):
    """Constant or per-channel trilinear volume-texture lookup at unit-cube
    points ``p`` (..., 3) → (..., C)."""
    if tex is None:
        return const.expand(p.shape[:-1] + const.shape)
    return torch.stack([gridops.grid_eval_trilinear(tex[..., c], p) for c in range(tex.shape[-1])], dim=-1)


@dataclasses.dataclass(frozen=True)
class ConductorBSDF:
    """Smooth (delta) specular conductor.

    Delta-lobe conventions: ``eval`` and ``eval_pdf`` are identically zero (a
    delta has no continuous density); ``sample`` returns the mirror direction
    with ``pdf = 1`` and ``weight = reflectance``.  Integrators read
    ``delta`` and give a BSDF-sampled delta bounce MIS weight 1.
    """

    reflectance: torch.Tensor  # (3,)
    delta = True

    @classmethod
    def create(cls, reflectance=(0.95, 0.95, 0.95), device=None):
        return cls(reflectance=torch.as_tensor(reflectance, dtype=torch.float32, device=resolve_device(device)))

    def eval(self, si, wo_local):
        return torch.zeros(wo_local.shape[:-1] + (3,), dtype=wo_local.dtype, device=wo_local.device)

    def eval_pdf(self, si, wo_local):
        return self.eval(si, wo_local), torch.zeros_like(wo_local[..., 0])

    def sample(self, si, u2):
        """→ (wo_local = mirror(wi), pdf = 1, weight = reflectance); zero
        below the horizon."""
        wi = si.wi
        wo = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
        valid = wi[..., 2] > 0
        pdf = valid.to(wi.dtype)
        weight = torch.where(valid[..., None], self.reflectance, torch.zeros_like(self.reflectance))
        return wo, pdf, weight


@dataclasses.dataclass(frozen=True)
class DiffuseBSDF:
    """Lambertian BSDF; albedo constant or volume-textured."""

    albedo: torch.Tensor                   # (3,) constant fallback
    albedo_tex: torch.Tensor | None = None  # optional (Z, Y, X, 3)
    delta = False

    @classmethod
    def create(cls, albedo=(0.8, 0.8, 0.8), albedo_tex=None, device=None):
        return cls(albedo=torch.as_tensor(albedo, dtype=torch.float32, device=resolve_device(device)),
                   albedo_tex=albedo_tex)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def eval(self, si, wo_local):
        """f(wi, wo)·cosθo; zero below the horizon (two-sided off)."""
        a = _eval_texture(self.albedo, self.albedo_tex, si.p)
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
        a = _eval_texture(self.albedo, self.albedo_tex, si.p)
        valid = (si.wi[..., 2] > 0) & (pdf > 0)
        weight = torch.where(valid[..., None], a, torch.zeros_like(a))  # (f·cos)/pdf = albedo
        return wo, torch.where(valid, pdf, torch.zeros_like(pdf)), weight


def _ggx_d(cos_h, alpha):
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp_min(math.pi * d * d, 1e-10)


def _smith_g1(cos_v, alpha):
    a2 = alpha * alpha
    return 2.0 * cos_v / torch.clamp_min(cos_v + torch.sqrt(a2 + (1.0 - a2) * cos_v * cos_v), 1e-10)


def _schlick(f0, cos_t):
    # (1 - cosθ)^5 multiplied out as XLA lowers an integer power: c·(c²·c²)
    c = 1.0 - cos_t
    c2 = c * c
    return f0 + (1.0 - f0) * (c * (c2 * c2))


@dataclasses.dataclass(frozen=True)
class PrincipledBSDF:
    """Simplified principled BSDF: Lambertian base + GGX specular lobe, with
    cosine-hemisphere sampling (adequate for roughness in [0.1, 0.8], where
    it is clipped)."""

    base_color: torch.Tensor                    # (3,)
    roughness: torch.Tensor                     # ()
    base_color_tex: torch.Tensor | None = None  # (Z, Y, X, 3)
    roughness_tex: torch.Tensor | None = None   # (Z, Y, X, 1)
    specular: float = 0.04
    delta = False

    @classmethod
    def create(cls, base_color=(0.8, 0.8, 0.8), roughness=0.4, base_color_tex=None, roughness_tex=None,
               device=None):
        device = resolve_device(device)
        return cls(
            base_color=torch.as_tensor(base_color, dtype=torch.float32, device=device),
            roughness=torch.as_tensor(roughness, dtype=torch.float32, device=device),
            base_color_tex=base_color_tex,
            roughness_tex=roughness_tex,
        )

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def _params_at(self, p):
        color = _eval_texture(self.base_color, self.base_color_tex, p)
        rough = _eval_texture(self.roughness[None], self.roughness_tex, p)[..., 0]
        # min(max(·)) with tensor bounds, not clamp: at a value equal to a
        # bound it passes half the gradient, as the JAX package's clip does
        return color, torch.minimum(torch.maximum(rough, rough.new_tensor(0.1)), rough.new_tensor(0.8))

    def eval(self, si, wo_local):
        color, rough = self._params_at(si.p)
        wi, wo = si.wi, wo_local
        cos_i, cos_o = wi[..., 2], wo[..., 2]
        valid = (cos_i > 0) & (cos_o > 0)
        h = wi + wo
        h = h / torch.clamp_min(torch.linalg.norm(h, dim=-1, keepdim=True), 1e-10)
        alpha = rough * rough
        D = _ggx_d(h[..., 2], alpha)
        G = _smith_g1(cos_i, alpha) * _smith_g1(cos_o, alpha)
        F = _schlick(self.specular, torch.sum(wi * h, -1))
        # f_spec·cosθo = D·G·F/(4 cosθi cosθo) · cosθo = D·G·F/(4 cosθi)
        spec = D * G * F / torch.clamp_min(4.0 * cos_i, 1e-10)
        diff = color / math.pi * cos_o[..., None]
        val = diff + spec[..., None]
        return torch.where(valid[..., None], val, torch.zeros_like(val))

    def eval_pdf(self, si, wo_local):
        pdf = cosine_hemisphere_pdf(wo_local)
        return self.eval(si, wo_local), torch.where(si.wi[..., 2] > 0, pdf, torch.zeros_like(pdf))

    def sample(self, si, u2):
        """→ (wo_local, pdf, weight = f·cos/pdf)."""
        wo = square_to_cosine_hemisphere(u2)
        pdf = cosine_hemisphere_pdf(wo)
        val = self.eval(si, wo)
        valid = pdf > 1e-8
        weight = torch.where(valid[..., None], val / torch.clamp_min(pdf, 1e-8)[..., None], torch.zeros_like(val))
        return wo, torch.where(valid, pdf, torch.zeros_like(pdf)), weight
