"""Named scenes: procedural target SDFs + the default lighting/BSDF rig.

Counterpart of the JAX package's ``models/scenes_zoo.py``, procedural branch:
analytic target SDFs (redistanced onto grids) registered under the
reference's scene names, and the default rig (diffuse BSDF under the
procedural gradient sky).  ``.vol`` assets and the mesh / area-light rigs are
not implemented here.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..ops.initializers import voxel_centers
from ..ops.redistance import redistance
from .bsdf import DiffuseBSDF
from .emitter import make_gradient_envmap

__all__ = ["target_sdf", "scene_rig_full", "scene_rig", "SCENE_NAMES"]


def _vec(v, like):
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def _length(v, dim=-1):
    return torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=dim), 1e-30))


def _torus(p, R=0.25, r=0.11, center=(0.5, 0.45, 0.5)):
    q = p - _vec(center, p)
    ring = torch.sqrt(torch.clamp_min(q[..., 0] ** 2 + q[..., 2] ** 2, 1e-30)) - R
    return torch.sqrt(ring**2 + q[..., 1] ** 2) - r


def _sphere(p, c, r):
    return _length(p - _vec(c, p)) - r


def _box(p, c, b, rounding=0.02):
    q = torch.abs(p - _vec(c, p)) - _vec(b, p)
    return (
        _length(torch.clamp_min(q, 0.0))
        + torch.clamp_max(q.amax(dim=-1), 0.0)
        - rounding
    )


def _capsule(p, a, b, r):
    a = _vec(a, p)
    b = _vec(b, p)
    pa = p - a
    ba = b - a
    h = torch.clamp(torch.sum(pa * ba, -1) / torch.sum(ba * ba), 0.0, 1.0)
    return _length(pa - ba * h[..., None]) - r


def _smooth_union(d1, d2, k=0.03):
    h = torch.clamp(0.5 + 0.5 * (d2 - d1) / k, 0.0, 1.0)
    return d2 * (1 - h) + d1 * h - k * h * (1 - h)


def _dragon_like(p):
    """Multi-lobe serpentine body with horns/legs — a silhouette-complexity
    stand-in for the dragon asset."""
    t = (p[..., 0] - 0.2) / 0.6
    spine_y = 0.45 + 0.12 * torch.sin(t * 5.0)
    spine_z = 0.5 + 0.10 * torch.sin(t * 3.0 + 1.0)
    body_r = 0.085 * (1.0 - 0.55 * torch.abs(t - 0.5)) + 0.025 * torch.sin(t * 11.0) ** 2
    spine = torch.stack([p[..., 0], spine_y, spine_z], -1)
    d = _length(p - spine) - torch.clamp(body_r, 0.02, 0.12)
    d = torch.where(torch.abs(t - 0.5) > 0.55, d + 0.2, d)  # cap the ends
    head = _sphere(p, (0.78, 0.58, 0.52), 0.09)
    horn1 = _capsule(p, (0.80, 0.62, 0.50), (0.88, 0.74, 0.46), 0.02)
    horn2 = _capsule(p, (0.76, 0.63, 0.55), (0.80, 0.75, 0.62), 0.02)
    leg1 = _capsule(p, (0.35, 0.40, 0.45), (0.33, 0.22, 0.42), 0.03)
    leg2 = _capsule(p, (0.55, 0.40, 0.56), (0.58, 0.22, 0.60), 0.03)
    tail = _capsule(p, (0.22, 0.42, 0.48), (0.10, 0.55, 0.60), 0.022)
    d = _smooth_union(d, head, 0.04)
    for part in (horn1, horn2, leg1, leg2, tail):
        d = _smooth_union(d, part, 0.025)
    return d


def _bunny_like(p):
    body = _sphere(p, (0.5, 0.40, 0.5), 0.17)
    head = _sphere(p, (0.5, 0.60, 0.62), 0.10)
    ear1 = _capsule(p, (0.45, 0.64, 0.60), (0.40, 0.84, 0.55), 0.035)
    ear2 = _capsule(p, (0.55, 0.64, 0.60), (0.60, 0.84, 0.55), 0.035)
    tail = _sphere(p, (0.5, 0.42, 0.30), 0.055)
    d = _smooth_union(body, head, 0.05)
    d = _smooth_union(d, ear1, 0.02)
    d = _smooth_union(d, ear2, 0.02)
    return _smooth_union(d, tail, 0.02)


def _chair_like(p):
    seat = _box(p, (0.5, 0.42, 0.5), (0.16, 0.02, 0.16))
    back = _box(p, (0.5, 0.58, 0.35), (0.16, 0.16, 0.02))
    legs = None
    for cx in (0.37, 0.63):
        for cz in (0.37, 0.63):
            leg = _capsule(p, (cx, 0.2, cz), (cx, 0.42, cz), 0.022)
            legs = leg if legs is None else torch.minimum(legs, leg)
    return torch.minimum(torch.minimum(seat, back), legs)


def _cubes(p):
    d = None
    for c in [(0.35, 0.35, 0.35), (0.65, 0.4, 0.6), (0.45, 0.62, 0.45)]:
        b = _box(p, c, (0.1, 0.1, 0.1), rounding=0.015)
        d = b if d is None else torch.minimum(d, b)
    return d


_PROCEDURAL = {
    "dragon": _dragon_like,
    "bunny": _bunny_like,
    "chair": _chair_like,
    "chair-diffuse": _chair_like,
    "head": lambda p: _smooth_union(
        _sphere(p, (0.5, 0.5, 0.5), 0.2), _sphere(p, (0.5, 0.42, 0.68), 0.08), 0.05
    ),
    "boar": _bunny_like,
    "hotdog-diffuse": lambda p: _capsule(p, (0.3, 0.45, 0.5), (0.7, 0.45, 0.5), 0.11),
    "lego": _cubes,
    "cubes": _cubes,
    "cranium": lambda p: _sphere(p, (0.5, 0.5, 0.5), 0.24),
    "bench": _chair_like,
    "torus": _torus,
    "sphere": lambda p: _sphere(p, (0.5, 0.5, 0.5), 0.3),
    "block": lambda p: _box(p, (0.5, 0.5, 0.5), (0.25, 0.12, 0.18)),
}

# Scenes of the JAX package whose rig needs a mesh, an area light or a vMF
# emitter: named so that asking for one says what is missing.
_UNPORTED_RIGS = ("torus-shadow", "mirror-opt", "plane_area", "plane_red_object")

SCENE_NAMES = sorted(_PROCEDURAL)


def _check_scene(scene_name: str):
    if scene_name in _UNPORTED_RIGS or scene_name.endswith("-hdr") or "principled" in scene_name:
        raise NotImplementedError(f"the rig of scene '{scene_name}' is not ported")
    if scene_name not in _PROCEDURAL:
        raise ValueError(f"Unknown scene '{scene_name}'; valid: {SCENE_NAMES}")


def target_sdf(scene_name: str, res: int = 128, scene_dir: str | None = None, device=None):
    """Target SDF grid for a named scene: the procedural shape sampled at the
    voxel centers and redistanced to a valid SDF."""
    if scene_dir is not None:
        raise NotImplementedError(".vol scene assets are not ported")
    _check_scene(scene_name)
    pts = voxel_centers(res, resolve_device(device))
    d = _PROCEDURAL[scene_name](pts.reshape(-1, 3)).reshape(res, res, res)
    return redistance(d)


def scene_rig_full(scene_name: str, param_keys=("sdf",), device=None):
    """Per-scene emitter + BSDF.  Returns a dict with keys ``bsdf``,
    ``emitter``, ``area_emitter``, ``mesh`` (the last two always ``None``
    here)."""
    _check_scene(scene_name)
    if tuple(param_keys) != ("sdf",):
        raise NotImplementedError("texture parameters (albedo, roughness) are not ported")
    device = resolve_device(device)
    return {
        "bsdf": DiffuseBSDF.create(albedo=(0.8, 0.8, 0.8), device=device),
        "emitter": make_gradient_envmap(device=device),
        "area_emitter": None,
        "mesh": None,
    }


def scene_rig(scene_name: str, param_keys=("sdf",), device=None):
    """Per-scene ``(bsdf, emitter)``: the 2-tuple view of :func:`scene_rig_full`."""
    rig = scene_rig_full(scene_name, param_keys, device=device)
    return rig["bsdf"], rig["emitter"]
