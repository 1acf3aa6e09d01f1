"""Named scenes: target SDFs + the lighting/BSDF rigs of reconstruction runs.

Counterpart of the JAX package's ``models/scenes_zoo.py``: the checked-in
``.vol`` assets (``scenes/assets/sdfs/<name>_<res>.vol``, or a caller's scene
directory), analytic target SDFs registered under the reference's scene
names (both redistanced onto grids), and the per-scene rigs: a diffuse or
principled BSDF under the procedural gradient sky or, for a ``-hdr`` scene,
the checked-in HDR envmap; a floor or a mirror rect under a vMF sun
(``torus-shadow``, ``mirror-opt``); an area light over a dim ambient
(``plane_area``, ``plane_red_object``).
"""

from __future__ import annotations

import os

import torch

from .. import resolve_device
from ..ops.initializers import voxel_centers
from ..ops.redistance import redistance
from ..utils.io import read_vol
from ..ops.mesh_intersect import TriangleMesh
from .bsdf import DiffuseBSDF, PrincipledBSDF
from .emitter import AreaEmitter, ConstantEmitter, GridEnvmap, VMFEmitter, make_gradient_envmap

__all__ = ["target_sdf", "scene_rig_full", "scene_rig", "studio_hdr_envmap", "SCENE_NAMES", "ASSET_DIR"]


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


def _torus_shadow(p):
    """Torus floating above the floor of its rig (shadow-driven
    reconstruction)."""
    return _torus(p, R=0.22, r=0.09, center=(0.5, 0.55, 0.5))


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
    "torus-shadow": _torus_shadow,
    "mirror-opt": _torus,
    "sphere": lambda p: _sphere(p, (0.5, 0.5, 0.5), 0.3),
    "block": lambda p: _box(p, (0.5, 0.5, 0.5), (0.25, 0.12, 0.18)),
    # objects above a plane, lit by a finite area light
    "plane_area": lambda p: _smooth_union(
        _sphere(p, (0.5, 0.52, 0.5), 0.17),
        _box(p, (0.5, 0.33, 0.5), (0.17, 0.03, 0.17)),
        0.03,
    ),
    "plane_red_object": lambda p: _torus(p, R=0.2, r=0.08, center=(0.5, 0.5, 0.5)),
}

SCENE_NAMES = sorted(_PROCEDURAL)

#: the checked-in assets: ``sdfs/<name>_<res>.vol``, ``envmaps/studio_sky.exr``
#: and the golden images
ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "scenes", "assets")


def studio_hdr_envmap(device=None):
    """The checked-in equirect HDR envmap (``envmaps/studio_sky.exr``) as a
    :class:`GridEnvmap`; the procedural gradient sky where the file is
    absent, as in the JAX package."""
    path = os.path.join(ASSET_DIR, "envmaps", "studio_sky.exr")
    if os.path.exists(path):
        return GridEnvmap.from_image(path, device=device)
    return make_gradient_envmap(device=device)


def target_sdf(scene_name: str, res: int = 128, scene_dir: str | None = None, device=None):
    """Target SDF grid for a named scene: the ``.vol`` asset
    ``sdfs/<name>_<res>.vol`` from ``scene_dir`` or the checked-in
    ``scenes/assets`` if there is one, else the procedural stand-in sampled at
    the voxel centers; redistanced to a valid SDF.  A ``-hdr`` suffix (a
    lighting variant) is ignored."""
    device = resolve_device(device)
    if scene_name.endswith("-hdr"):
        scene_name = scene_name[: -len("-hdr")]
    for sdir in (scene_dir, ASSET_DIR):
        if sdir is None:
            continue
        vol = os.path.join(sdir, "sdfs", f"{scene_name}_{res}.vol")
        if os.path.exists(vol):
            return redistance(torch.from_numpy(read_vol(vol)[..., 0].copy()).to(device))
    if scene_name not in _PROCEDURAL:
        raise ValueError(f"Unknown scene '{scene_name}'; valid: {SCENE_NAMES} or an asset sdfs/<name>_{res}.vol")
    pts = voxel_centers(res, device)
    d = _PROCEDURAL[scene_name](pts.reshape(-1, 3)).reshape(res, res, res)
    return redistance(d)


def scene_rig_full(scene_name: str, param_keys=("sdf",), device=None):
    """Per-scene BSDF, emitter, area light and auxiliary mesh: a dict with
    keys ``bsdf``, ``emitter``, ``area_emitter``, ``mesh``.

    ``torus-shadow`` and ``mirror-opt`` are lit by a vMF sun and carry a
    diffuse floor under the shape or a mirror rect beside it;
    ``plane_area`` and ``plane_red_object`` an overhead area panel over a
    dim ambient (a red diffuse albedo for the latter); a ``-hdr`` name the
    HDR envmap; any other the gradient sky.  A name holding
    ``principled``, or more than two optimized parameters, gives a
    :class:`PrincipledBSDF`."""
    device = resolve_device(device)
    if "principled" in scene_name:
        bsdf = PrincipledBSDF.create(device=device)
    else:
        bsdf = DiffuseBSDF.create(albedo=(0.8, 0.8, 0.8), device=device)
    area = mesh = None
    if scene_name in ("torus-shadow", "mirror-opt"):
        emitter = VMFEmitter.create(mu=(0.2, 0.9, 0.1), scale=(30.0,) * 3, ambient=(0.05,) * 3, kappa=60.0,
                                    device=device)
        if scene_name == "torus-shadow":
            # the reconstruction signal is the torus's shadow on this floor
            mesh = TriangleMesh.floor(height=0.22, half_extent=4.0, albedo=(0.65, 0.65, 0.65), device=device)
        else:
            # a vertical mirror behind the shape as sensor 0 sees it: the
            # sensor sees the torus directly and reflected
            mesh = TriangleMesh.rect(corner=(-0.35, -0.6, -0.6), e0=(0.0, 2.2, 0.0), e1=(0.0, 0.0, 2.2),
                                     albedo=(0.88, 0.88, 0.92), material="mirror", device=device)
    elif scene_name in ("plane_area", "plane_red_object"):
        emitter = ConstantEmitter.create((0.05, 0.05, 0.05), device=device)
        area = AreaEmitter.create(corner=(0.2, 1.25, 0.2), e0=(0.6, 0.0, 0.0), e1=(0.0, 0.0, 0.6),
                                  radiance=(14.0, 14.0, 14.0), device=device)
        if scene_name == "plane_red_object":
            bsdf = DiffuseBSDF.create(albedo=(0.75, 0.25, 0.2), device=device)
    elif scene_name.endswith("-hdr"):
        emitter = studio_hdr_envmap(device)
    else:
        emitter = make_gradient_envmap(device=device)
    if len(param_keys) > 2:
        bsdf = PrincipledBSDF.create(device=device)
    return {"bsdf": bsdf, "emitter": emitter, "area_emitter": area, "mesh": mesh}


def scene_rig(scene_name: str, param_keys=("sdf",), device=None):
    """Per-scene ``(bsdf, emitter)``: the 2-tuple view of :func:`scene_rig_full`."""
    rig = scene_rig_full(scene_name, param_keys, device=device)
    return rig["bsdf"], rig["emitter"]
