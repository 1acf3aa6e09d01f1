"""Emitters: constant and vMF environment lights, an equirect grid envmap,
and a rectangular area light.

Counterpart of the JAX package's ``models/emitter.py`` (``ConstantEmitter``,
``VMFEmitter``, ``GridEnvmap``, ``AreaEmitter``, ``make_gradient_envmap``).
Each environment emitter provides:

  * ``eval(d)``              — radiance arriving from direction d (world)
  * ``sample_direction(u2)`` — (d, pdf, radiance) importance sample
  * ``pdf_direction(d)``     — density of that sampler
  * ``power_proxy()``        — approximate emitted power (emitter selection)

Directions always point *away* from the shading point, and environment
emitters are "at infinity".  The :class:`AreaEmitter` sits at a finite
position: its sampler returns the distance that bounds the shadow ray.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import resolve_device
from ..ops.interaction import coordinate_frame
from ..ops.sampling import square_to_uniform_sphere, square_to_vmf, vmf_pdf
from ..ops.vecmath import normalize

__all__ = ["ConstantEmitter", "VMFEmitter", "GridEnvmap", "AreaEmitter", "make_gradient_envmap"]

_INV_4PI = 1.0 / (4.0 * math.pi)


def _build_alias_table(p):
    """Walker alias table of a discrete distribution ``p`` (host numpy):
    Vose pairing with preallocated index stacks and integer cursors."""
    p = np.asarray(p, np.float64)
    n = p.shape[0]
    scaled = p * n
    alias_prob = np.ones(n, np.float32)
    alias_idx = np.arange(n, dtype=np.int32)
    small_ix = np.flatnonzero(scaled < 1.0)
    large_ix = np.flatnonzero(scaled >= 1.0)
    # stacks big enough for every re-push (each pairing retires one cell)
    small = np.empty(n, np.int64)
    large = np.empty(n, np.int64)
    small[: small_ix.size] = small_ix
    large[: large_ix.size] = large_ix
    ns, nl = small_ix.size, large_ix.size
    while ns and nl:
        s = small[ns - 1]
        l = large[nl - 1]
        ns -= 1
        nl -= 1
        alias_prob[s] = scaled[s]
        alias_idx[s] = l
        scaled[l] -= 1.0 - scaled[s]
        if scaled[l] < 1.0:
            small[ns] = l
            ns += 1
        else:
            large[nl] = l
            nl += 1
    return alias_prob, alias_idx


@dataclasses.dataclass(frozen=True)
class ConstantEmitter:
    """Uniform environment radiance."""

    radiance: torch.Tensor  # (3,)

    @classmethod
    def create(cls, radiance=(1.0, 1.0, 1.0), device=None):
        return cls(radiance=torch.as_tensor(radiance, dtype=torch.float32, device=resolve_device(device)))

    def eval(self, d):
        return self.radiance.expand(d.shape[:-1] + (3,))

    def sample_direction(self, u2):
        d = square_to_uniform_sphere(u2)
        return d, self.pdf_direction(d), self.eval(d)

    def pdf_direction(self, d):
        return torch.full(d.shape[:-1], _INV_4PI, dtype=d.dtype, device=d.device)

    def power_proxy(self):
        """Approximate emitted power ∫ L dω (emitter-selection weights)."""
        return 4.0 * math.pi * torch.mean(self.radiance)


@dataclasses.dataclass(frozen=True)
class VMFEmitter:
    """vMF-lobe environment light plus an ambient floor, so that silhouettes
    stay visible from every view."""

    mu: torch.Tensor       # (3,) unit lobe direction
    scale: torch.Tensor    # (3,) lobe radiance scale
    ambient: torch.Tensor  # (3,)
    kappa: float = 20.0

    # share of the sampling effort on the lobe (the rest: uniform sphere)
    LOBE_WEIGHT = 0.7

    @classmethod
    def create(cls, mu=(0.5, 0.8, -0.3), scale=(6.0, 6.0, 6.0), ambient=(0.15, 0.15, 0.15), kappa=20.0,
               device=None):
        device = resolve_device(device)
        return cls(
            mu=normalize(torch.as_tensor(mu, dtype=torch.float32, device=device)),
            scale=torch.as_tensor(scale, dtype=torch.float32, device=device),
            ambient=torch.as_tensor(ambient, dtype=torch.float32, device=device),
            kappa=float(kappa),
        )

    def eval(self, d):
        lobe = vmf_pdf(torch.sum(d * self.mu, -1), self.kappa)
        return lobe[..., None] * self.scale + self.ambient

    def sample_direction(self, u2):
        """The lobe with probability 0.7, else the uniform sphere; ``u[0]``
        picks the component and is re-stretched for reuse."""
        w = self.LOBE_WEIGHT
        pick_lobe = u2[..., 0] < w
        u0 = torch.where(pick_lobe, u2[..., 0] / w, (u2[..., 0] - w) / (1.0 - w))
        u = torch.stack([u0, u2[..., 1]], -1)
        local = square_to_vmf(u, self.kappa)
        # rotate +z onto mu
        mu = self.mu.expand(local.shape)
        s, t = coordinate_frame(mu)
        d_lobe = local[..., 0:1] * s + local[..., 1:2] * t + local[..., 2:3] * mu
        d = torch.where(pick_lobe[..., None], d_lobe, square_to_uniform_sphere(u))
        return d, self.pdf_direction(d), self.eval(d)

    def pdf_direction(self, d):
        w = self.LOBE_WEIGHT
        return w * vmf_pdf(torch.sum(d * self.mu, -1), self.kappa) + (1.0 - w) * _INV_4PI

    def power_proxy(self):
        # the vMF lobe density integrates to 1 over the sphere
        return torch.mean(self.scale) + 4.0 * math.pi * torch.mean(self.ambient)


@dataclasses.dataclass(frozen=True)
class GridEnvmap:
    """Equirectangular environment map with piecewise-constant importance
    sampling (a Walker alias table over the H·W texels: O(1) per sample) and
    bilinear radiance lookups.

    ``pdf_direction`` is the exact density of the (texel-uniform, jittered)
    sampler: it is uniform in (θ,φ) within each texel, so the per-steradian
    density is the piecewise-constant planar density divided by sin θ of the
    *actual* direction.
    """

    image: torch.Tensor       # (H, W, 3)
    image_rows: torch.Tensor  # (H·W, 3) row-gatherable texels
    pdf_table: torch.Tensor   # (H·W,) planar pdf of each texel: p/(Δθ·Δφ)
    alias_prob: torch.Tensor  # (H·W,) Walker alias acceptance threshold
    alias_idx: torch.Tensor   # (H·W,) int64 alias cell

    @classmethod
    def create(cls, image, device=None):
        """Build the sampling tables on the host (numpy) from ``image``
        (H, W, 3), then place everything on ``device``."""
        device = resolve_device(device)
        # a copy: the source may be a read-only view of another framework's array
        img_np = np.array(
            image.detach().cpu().numpy() if isinstance(image, torch.Tensor) else image, np.float32
        )
        h, w, _ = img_np.shape
        lum = np.maximum(img_np.mean(-1), 1e-8)
        # texel solid angle dω = (2π/w)(π/h) sinθ; selection prob ∝ lum·dω
        theta = (np.arange(h) + 0.5) / h * np.pi
        d_omega = (2.0 * np.pi / w) * (np.pi / h) * np.sin(theta)[:, None]
        weight = (lum * d_omega).reshape(-1)
        p = weight / weight.sum()
        # planar density in (θ,φ) space
        pdf = p / ((np.pi / h) * (2.0 * np.pi / w))
        alias_prob, alias_idx = _build_alias_table(p)
        return cls(
            image=torch.as_tensor(img_np, device=device),
            image_rows=torch.as_tensor(img_np.reshape(-1, 3), device=device),
            pdf_table=torch.as_tensor(pdf.astype(np.float32), device=device),
            alias_prob=torch.as_tensor(alias_prob, device=device),
            alias_idx=torch.as_tensor(alias_idx.astype(np.int64), device=device),
        )

    @classmethod
    def from_image(cls, path: str, scale: float = 1.0, device=None):
        """Load an equirectangular environment map from an ``.exr`` file
        (linear radiance) or an 8-bit PNG (normalised, then inverse gamma
        2.2); a grey image is expanded to RGB.  The tables are built by
        :meth:`create`."""
        from ..utils import io as uio

        if path.endswith(".exr"):
            img = uio.read_exr(path)
        else:
            img = (uio.read_png(path).astype(np.float32) / 255.0) ** 2.2
        img = np.asarray(img, np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        return cls.create(img[..., :3] * np.float32(scale), device=device)

    @classmethod
    def _cell_index(cls, image, d):
        h, w, _ = image.shape
        theta = torch.arccos(torch.clamp(d[..., 1], -1.0, 1.0))
        phi = torch.atan2(d[..., 2], d[..., 0])
        x = torch.clamp((torch.remainder(phi / (2.0 * math.pi), 1.0) * w).to(torch.int64), 0, w - 1)
        y = torch.clamp(((theta / math.pi) * h).to(torch.int64), 0, h - 1)
        return y * w + x

    def _eval_cell(self, cell):
        return self.image_rows[cell]

    def eval(self, d):
        """Bilinearly filtered radiance from direction ``d``: 4 row gathers,
        φ wraps, θ clamps at the poles."""
        h, w, _ = self.image.shape
        # clip strictly inside ±1: eval is differentiable w.r.t. d (bilinear
        # weights) and d/dy arccos(y) → ∞ at |y| = 1
        theta = torch.arccos(torch.clamp(d[..., 1], -1.0 + 1e-7, 1.0 - 1e-7))
        phi = torch.atan2(d[..., 2], d[..., 0])
        fx = torch.remainder(phi / (2.0 * math.pi), 1.0) * w - 0.5
        fy = (theta / math.pi) * h - 0.5
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        tx = (fx - x0)[..., None]
        ty = (fy - y0)[..., None]
        x0i = torch.remainder(x0.detach().to(torch.int64), w)
        x1i = torch.remainder(x0i + 1, w)
        y0i = torch.clamp(y0.detach().to(torch.int64), 0, h - 1)
        y1i = torch.clamp(y0i + 1, 0, h - 1)
        c00 = self._eval_cell(y0i * w + x0i)
        c01 = self._eval_cell(y0i * w + x1i)
        c10 = self._eval_cell(y1i * w + x0i)
        c11 = self._eval_cell(y1i * w + x1i)
        return (
            (1.0 - ty) * ((1.0 - tx) * c00 + tx * c01)
            + ty * ((1.0 - tx) * c10 + tx * c11)
        )

    def sample_direction(self, u2):
        h, w, _ = self.image.shape
        n = h * w
        # Walker alias sampling: u0 picks the column, u1 is the acceptance
        # coin (an independent full-precision uniform).
        s = torch.clamp(u2[..., 0], 0.0, 1.0 - 1e-7) * n
        c = torch.clamp(s.to(torch.int64), 0, n - 1)
        pc = self.alias_prob[c]
        take_alias = u2[..., 1] > pc
        cell = torch.where(take_alias, self.alias_idx[c], c)
        y = torch.div(cell, w, rounding_mode="floor")
        x = cell % w
        # Intra-texel jitter: jx re-maps the acceptance coin within its
        # accepted branch (exactly uniform); jy re-uses the fraction of u0·n.
        jx = torch.clamp(
            torch.where(take_alias, (u2[..., 1] - pc) / torch.clamp_min(1.0 - pc, 1e-9),
                        u2[..., 1] / torch.clamp_min(pc, 1e-9)),
            0.0, 1.0 - 1e-6,
        )
        jy = torch.clamp(s - torch.floor(s), 0.0, 1.0 - 1e-6)
        theta = (y.to(torch.float32) + jy) / h * math.pi
        phi = (x.to(torch.float32) + jx) / w * 2.0 * math.pi
        st = torch.sin(theta)
        d = torch.stack([st * torch.cos(phi), torch.cos(theta), st * torch.sin(phi)], -1)
        # The pdf is re-derived from the direction (the same path as
        # pdf_direction), as in the JAX package: on a rounding-width sliver
        # this can pick the neighbouring texel.
        return d, self.pdf_direction(d), self.eval(d)

    def pdf_direction(self, d):
        planar = self.pdf_table[GridEnvmap._cell_index(self.image, d)]
        sin_theta = torch.sqrt(torch.clamp_min(1.0 - d[..., 1] * d[..., 1], 1e-12))
        return planar / sin_theta

    def power_proxy(self):
        h, w, _ = self.image.shape
        theta = (torch.arange(h, dtype=torch.float32, device=self.image.device) + 0.5) / h * math.pi
        d_omega = (2.0 * math.pi / w) * (math.pi / h) * torch.sin(theta)
        return torch.sum(self.image.mean(-1) * d_omega[:, None])


@dataclasses.dataclass(frozen=True)
class AreaEmitter:
    """One-sided rectangular area light ``corner + s·e0 + t·e1``, s, t ∈
    [0, 1], emitting from the face its normal ``normalize(e0 × e1)`` points
    toward.  It sits at a finite position: NEE returns a sample distance,
    so that shadow rays are traced with ``maxt``, and camera and BSDF rays
    can hit the emitting surface itself.  The rect is opaque geometry from
    both sides."""

    corner: torch.Tensor    # (3,)
    e0: torch.Tensor        # (3,) first edge vector
    e1: torch.Tensor        # (3,) second edge vector
    radiance: torch.Tensor  # (3,)

    @classmethod
    def create(cls, corner, e0, e1, radiance=(10.0, 10.0, 10.0), device=None):
        device = resolve_device(device)
        f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
        return cls(corner=f(corner), e0=f(e0), e1=f(e1), radiance=f(radiance))

    @property
    def _normal_area(self):
        c = torch.linalg.cross(self.e0, self.e1)
        area = torch.sqrt(torch.sum(c * c))
        return c / torch.clamp_min(area, 1e-20), area

    def sample_from(self, p_ref, u2):
        """A point on the rect, seen from ``p_ref``: ``(d, dist, pdf,
        radiance)`` — unit direction, distance to the sample, solid-angle
        density ``dist² / (A cos θ_l)`` and radiance (zero from the back
        face)."""
        n, area = self._normal_area
        q = self.corner + u2[..., 0:1] * self.e0 + u2[..., 1:2] * self.e1
        vec = q - p_ref
        dist = torch.sqrt(torch.sum(vec * vec, -1))
        d = vec / torch.clamp_min(dist, 1e-12)[..., None]
        cos_l = torch.sum(-d * n, -1)  # emission only from the front face
        front = cos_l > 1e-6
        pdf = dist**2 / (area * torch.clamp_min(cos_l, 1e-6))
        pdf = torch.where(front, pdf, torch.zeros_like(pdf))
        rad = torch.where(front[..., None], self.radiance, torch.zeros_like(self.radiance))
        return d, dist, pdf, rad

    def _plane_hit(self, o, d):
        n, _ = self._normal_area
        denom = torch.sum(d * n, -1)
        grazing = denom.abs() < 1e-8
        t = torch.sum((self.corner - o) * n, -1) / torch.where(grazing, torch.ones_like(denom), denom)
        q = o + t[..., None] * d - self.corner
        s0 = torch.sum(q * self.e0, -1) / torch.clamp_min(torch.sum(self.e0 * self.e0), 1e-20)
        s1 = torch.sum(q * self.e1, -1) / torch.clamp_min(torch.sum(self.e1 * self.e1), 1e-20)
        inside = (s0 >= 0) & (s0 <= 1) & (s1 >= 0) & (s1 <= 1)
        valid = ~grazing & (t > 1e-6) & inside
        front = denom < 0  # the ray approaches the emitting face
        return t, valid, front

    def ray_hit(self, o, d):
        """Ray–rect intersection of the front face → t (inf = miss or back
        face)."""
        t, valid, front = self._plane_hit(o, d)
        return torch.where(valid & front, t, torch.full_like(t, math.inf))

    def occlude_t(self, o, d):
        """Hit distance of either face (inf = miss)."""
        t, valid, _ = self._plane_hit(o, d)
        return torch.where(valid, t, torch.full_like(t, math.inf))

    def eval_hit(self, o, d):
        """Radiance seen along (o, d) where it hits the front face, else 0;
        and the hit distance."""
        t = self.ray_hit(o, d)
        rad = torch.where(torch.isfinite(t)[..., None], self.radiance, torch.zeros_like(self.radiance))
        return rad, t

    def pdf_direction_from(self, p_ref, d):
        """Solid-angle density of :meth:`sample_from` producing ``d``."""
        n, area = self._normal_area
        t = self.ray_hit(p_ref, d)
        cos_l = torch.clamp_min(torch.sum(-d * n, -1), 1e-6)
        pdf = t**2 / (area * cos_l)
        return torch.where(torch.isfinite(t), pdf, torch.zeros_like(pdf))

    def power_proxy(self):
        # one-sided Lambertian rect: ∫ L cos θ dω dA = π · A · L
        _, area = self._normal_area
        return math.pi * area * torch.mean(self.radiance)


def make_gradient_envmap(h=64, w=128, top=(1.2, 1.1, 1.0), bottom=(0.15, 0.18, 0.25),
                         sun_dir=(0.4, 0.7, -0.4), sun_power=40.0, sun_scale=25.0, device=None):
    """Procedural sky-like envmap, computed on the host in float32."""
    f32 = np.float32
    theta = (np.arange(h).astype(f32) + f32(0.5)) / f32(h) * f32(np.pi)
    phi = (np.arange(w).astype(f32) + f32(0.5)) / f32(w) * f32(2.0) * f32(np.pi)
    st = np.sin(theta)[:, None]
    d = np.stack(
        [st * np.cos(phi)[None, :], np.broadcast_to(np.cos(theta)[:, None], (h, w)), st * np.sin(phi)[None, :]],
        -1,
    ).astype(f32)
    tvec = np.asarray(top, f32)
    bvec = np.asarray(bottom, f32)
    m = (d[..., 1:2] + f32(1.0)) * f32(0.5)
    img = m * tvec + (f32(1.0) - m) * bvec
    sun = np.asarray(sun_dir, f32)
    sun = sun / np.sqrt(np.maximum(np.sum(sun * sun, dtype=f32), f32(1e-30)))
    img = img + f32(sun_scale) * np.power(np.maximum(np.sum(d * sun, -1, dtype=f32), f32(0.0)), f32(sun_power))[..., None]
    return GridEnvmap.create(img.astype(f32), device=device)
