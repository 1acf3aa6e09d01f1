"""Perspective cameras, the reference's regular multi-view rigs and the
turntable rig.

Counterpart of the JAX package's ``models/camera.py``: fov 39°, look-at
(0.5, 0.5, 0.5), radius-2 ring with sin-wobbled elevation.  A rig is one
dataclass with a leading view axis on every tensor; ``view(i)`` picks one.
The rig geometry is computed on the host in float32 numpy and then placed on
the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..ops.vecmath import integer_pow, normalize

__all__ = [
    "PerspectiveCamera",
    "look_at",
    "regular_cameras",
    "regular_cameras_top",
    "turntable_cameras",
]


@dataclasses.dataclass(frozen=True)
class PerspectiveCamera:
    """Pinhole camera. ``rot`` columns are (right, up, forward) in world space."""

    origin: torch.Tensor        # (..., 3)
    rot: torch.Tensor           # (..., 3, 3)
    tan_half_fov: torch.Tensor  # (...,) — x-axis field of view
    resx: int = 128
    resy: int = 128

    @property
    def n_views(self):
        return self.origin.shape[0] if self.origin.ndim > 1 else 1

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def view(self, i):
        i = int(i)
        return self.replace(
            origin=self.origin[i], rot=self.rot[i], tan_half_fov=self.tan_half_fov[i]
        )

    def sample_ray(self, pos_pixels):
        """Film position (N, 2) in pixel coords → (origin (N,3), dir (N,3)).

        Pixel (0,0) is top-left; position units are unpadded pixels (may lie
        outside [0, res) when sample_border is active).
        """
        u = pos_pixels[..., 0] / self.resx
        v = pos_pixels[..., 1] / self.resy
        aspect = self.resy / self.resx
        x = (2.0 * u - 1.0) * self.tan_half_fov
        y = (1.0 - 2.0 * v) * self.tan_half_fov * aspect
        d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
        d = normalize(torch.sum(self.rot * d_cam[..., None, :], dim=-1))
        o = self.origin.expand(d.shape)
        return o, d

    def project(self, p):
        """World point → (film position (N, 2) in pixels, importance (N,)).

        The importance is the perspective sensor importance ∝ 1/cos³θ (up to
        a constant, which cancels in the attached reweighting ``w/detach(w)``).
        """
        rel = p - self.origin
        p_cam = torch.sum(self.rot * rel[..., :, None], dim=-2)  # rotᵀ @ rel
        z = torch.clamp_min(p_cam[..., 2], 1e-8)
        x = p_cam[..., 0] / z
        y = p_cam[..., 1] / z
        aspect = self.resy / self.resx
        u = (x / self.tan_half_fov + 1.0) * 0.5
        v = (1.0 - y / (self.tan_half_fov * aspect)) * 0.5
        pos = torch.stack([u * self.resx, v * self.resy], dim=-1)
        cos_theta = z / torch.sqrt(torch.clamp_min(torch.sum(p_cam * p_cam, -1), 1e-20))
        importance = integer_pow(cos_theta, -3)
        return pos, importance


def _np_normalize(v):
    v = np.asarray(v, np.float32)
    return v / np.sqrt(np.maximum(np.sum(v * v, axis=-1, dtype=np.float32), np.float32(1e-30)))


def look_at(origin, target, up=(0.0, 1.0, 0.0)):
    """Rotation (3, 3) float32 numpy with columns (right, up, forward),
    world y-up convention."""
    origin = np.asarray(origin, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    f = _np_normalize(target - origin)
    s = _np_normalize(np.cross(up, f))
    u = np.cross(f, s)
    return np.stack([s, u, f], axis=-1).astype(np.float32)


def _camera_from_origins(origins, resx, resy, fov_deg=39.0, target=(0.5, 0.5, 0.5), device=None):
    device = resolve_device(device)
    origins = np.asarray(origins, np.float32)
    rots = np.stack([look_at(o, target) for o in origins])
    th = np.full((len(origins),), np.tan(np.deg2rad(np.float32(fov_deg)) / np.float32(2.0)), np.float32)
    return PerspectiveCamera(
        origin=torch.as_tensor(origins, device=device),
        rot=torch.as_tensor(rots, device=device),
        tan_half_fov=torch.as_tensor(th, device=device),
        resx=resx,
        resy=resy,
    )


def regular_cameras(
    n_sensors: int,
    angle_shift: float = 0.0,
    resx: int = 128,
    resy: int = 128,
    radius: float = 2.0,
    height_scale: float = 1.0,
    device=None,
) -> PerspectiveCamera:
    """The reference's regularly spaced optimization rig: ring of radius 2
    around (0.5, 0.5, 0.5), elevation 1.15/height_scale + 0.5·sin(angle·n/4)
    clamped to the upper hemisphere, fov 39°."""
    f32 = np.float32
    angles = (np.arange(n_sensors).astype(f32) / f32(n_sensors) + f32(angle_shift / n_sensors)) * f32(2.0) * f32(np.pi)
    if n_sensors > 1:
        elevation = f32(1.15 / height_scale) + np.sin(angles * f32(n_sensors) / f32(4.0)) * f32(0.5)
        elevation = np.clip(elevation, f32(0.0), f32(np.pi / 2.0 + 0.05))
    else:
        elevation = np.full((1,), 1.15 / height_scale, f32)
    origins = np.stack(
        [
            np.cos(angles) * np.sin(elevation) * f32(radius) + f32(0.5),
            np.cos(elevation) * f32(radius),
            np.sin(angles) * np.sin(elevation) * f32(radius) + f32(0.5),
        ],
        axis=-1,
    ).astype(f32)
    return _camera_from_origins(origins, resx, resy, device=device)


def regular_cameras_top(n_sensors, angle_shift=0.0, resx=128, resy=128, radius=2.0, device=None):
    """Top-view variant."""
    return regular_cameras(n_sensors, angle_shift, resx, resy, radius, height_scale=1.3, device=device)


def turntable_cameras(n_frames: int, resx=128, resy=128, radius=1.5, height=0.8, device=None):
    """Turntable rig for videos: ``n_frames`` cameras on a ring of radius
    1.5 at height 0.8 around (0.5, 0.5, 0.5), fov 39°.  ``device=None``
    means the card (raises when there is none)."""
    f32 = np.float32
    angles = np.arange(n_frames).astype(f32) / f32(n_frames) * f32(2.0) * f32(np.pi)
    origins = np.stack(
        [
            np.cos(angles) * f32(radius) + f32(0.5),
            np.full((n_frames,), height, f32),
            np.sin(angles) * f32(radius) + f32(0.5),
        ],
        axis=-1,
    ).astype(f32)
    return _camera_from_origins(origins, resx, resy, device=device)
