"""Scene files: JSON scene descriptions.

Counterpart of the JAX package's ``models/scene_file.py``, same format::

    {
      "sdf": {"vol": "sdfs/bunny_64.vol"}      // or {"procedural": "bunny", "res": 64}
      "bsdf": {"type": "diffuse", "albedo": [0.8, 0.8, 0.8]},   // | principled
      "emitter": {"type": "gradient_envmap"}   // | constant | vmf | envmap_png | envmap_exr
      "area_emitter": {"corner": [...], "e0": [...], "e1": [...], "radiance": [...]},
      "cameras": {"type": "regular", "n": 12, "resx": 128, "resy": 128}
                                               // | {"type": "lookat", "origins": [...], "target": [...]}
      "mesh": {"type": "floor", "height": 0.1, "albedo": [0.6, 0.6, 0.6]}
                                               // | rect | {"obj": "floor.obj"}; "meshes": [...] adds more
    }

Relative asset paths resolve against the JSON file's directory.  ``resx``,
``resy`` and ``sdf_res`` override the file's film and procedural grid
sizes.  A ``vol`` grid is redistanced on load, a procedural one comes from
``scenes_zoo.target_sdf``: both through ``ops/redistance.py`` (the CUDA
kernel on the card).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import resolve_device
from ..ops.mesh_intersect import TriangleMesh
from ..ops.redistance import redistance
from ..ops.sdf import GridSDF
from ..utils.io import read_png, read_vol
from ..utils.mesh import load_obj
from .bsdf import DiffuseBSDF, PrincipledBSDF
from .camera import _camera_from_origins, regular_cameras
from .emitter import AreaEmitter, ConstantEmitter, GridEnvmap, VMFEmitter, make_gradient_envmap
from .scene import Scene
from .scenes_zoo import target_sdf

__all__ = ["load_scene_file"]


def _load_sdf(spec, base_dir, res_override, device):
    if "vol" in spec:
        data = read_vol(os.path.join(base_dir, spec["vol"]))[..., 0]
        return redistance(torch.from_numpy(np.ascontiguousarray(data)).to(device))
    return target_sdf(spec.get("procedural", "sphere"), res_override or spec.get("res", 64), device=device)


def _load_bsdf(spec, device):
    if spec.get("type", "diffuse") == "principled":
        return PrincipledBSDF.create(base_color=tuple(spec.get("base_color", (0.8, 0.8, 0.8))),
                                     roughness=spec.get("roughness", 0.4), device=device)
    return DiffuseBSDF.create(albedo=tuple(spec.get("albedo", (0.8, 0.8, 0.8))), device=device)


def _load_emitter(spec, base_dir, device):
    kind = spec.get("type", "gradient_envmap")
    if kind == "constant":
        return ConstantEmitter.create(tuple(spec.get("radiance", (1.0, 1.0, 1.0))), device=device)
    if kind == "vmf":
        return VMFEmitter.create(
            mu=tuple(spec.get("mu", (0.5, 0.8, -0.3))),
            scale=tuple(spec.get("scale", (6.0, 6.0, 6.0))),
            ambient=tuple(spec.get("ambient", (0.15, 0.15, 0.15))),
            kappa=spec.get("kappa", 20.0),
            device=device,
        )
    if kind == "envmap_png":
        img = read_png(os.path.join(base_dir, spec["path"])).astype(np.float32) / 255.0
        return GridEnvmap.create(img[..., :3] ** 2.2 * spec.get("scale", 1.0), device=device)
    if kind in ("envmap", "envmap_exr"):
        return GridEnvmap.from_image(os.path.join(base_dir, spec["path"]), scale=spec.get("scale", 1.0),
                                     device=device)
    return make_gradient_envmap(device=device)


def _load_area_emitter(spec, device):
    """Optional rectangular area light."""
    if spec is None:
        return None
    return AreaEmitter.create(corner=tuple(spec["corner"]), e0=tuple(spec["e0"]), e1=tuple(spec["e1"]),
                              radiance=tuple(spec.get("radiance", (10.0, 10.0, 10.0))), device=device)


def _load_mesh(spec, base_dir, device):
    """One auxiliary triangle mesh: an ``obj`` file (optionally scaled, then
    translated), a ``rect`` or a ``floor``, diffuse or mirror."""
    albedo = tuple(spec.get("albedo", (0.5, 0.5, 0.5)))
    material = spec.get("material", "diffuse")
    if material not in ("diffuse", "mirror"):
        raise ValueError(f"unknown mesh material {material!r}")
    if "obj" in spec:
        verts, faces = load_obj(os.path.join(base_dir, spec["obj"]))
        if "scale" in spec:
            verts = verts * np.float32(spec["scale"])
        if "translate" in spec:
            verts = verts + np.asarray(spec["translate"], np.float32)
        return TriangleMesh.create(verts, faces, albedo, material=material, device=device)
    kind = spec.get("type", "floor")
    if kind == "rect":
        return TriangleMesh.rect(corner=tuple(spec["corner"]), e0=tuple(spec["e0"]), e1=tuple(spec["e1"]),
                                 albedo=albedo, material=material, device=device)
    if kind != "floor":
        raise ValueError(f"unknown mesh type {kind!r} (expected 'floor', 'rect' or an 'obj' entry)")
    return TriangleMesh.floor(height=spec.get("height", 0.0), half_extent=spec.get("half_extent", 10.0),
                              albedo=albedo, material=material, device=device)


def _load_meshes(spec, base_dir, device):
    """``"mesh": {...}`` and the entries of ``"meshes": [...]``, merged into
    one soup with per-triangle materials; ``None`` without any."""
    specs = ([spec["mesh"]] if spec.get("mesh") is not None else []) + list(spec.get("meshes", []))
    if not specs:
        return None
    return TriangleMesh.merge([_load_mesh(s, base_dir, device) for s in specs])


def _load_cameras(spec, resx, resy, device):
    rx = resx or spec.get("resx", 128)
    ry = resy or spec.get("resy", 128)
    if spec.get("type", "regular") == "lookat":
        return _camera_from_origins([tuple(o) for o in spec["origins"]], rx, ry, fov_deg=spec.get("fov", 39.0),
                                    target=tuple(spec.get("target", (0.5, 0.5, 0.5))), device=device)
    return regular_cameras(spec.get("n", 12), spec.get("angle_shift", 0.0), rx, ry,
                           radius=spec.get("radius", 2.0), device=device)


def load_scene_file(path: str, resx: int | None = None, resy: int | None = None, sdf_res: int | None = None,
                    device=None) -> Scene:
    """Load a JSON scene description → :class:`Scene` on ``device``
    (``None``: the card, raising when there is none)."""
    device = resolve_device(device)
    with open(path) as f:
        spec = json.load(f)
    base_dir = os.path.dirname(os.path.abspath(path))
    return Scene(
        sdf=GridSDF.create(_load_sdf(spec.get("sdf", {}), base_dir, sdf_res, device)),
        bsdf=_load_bsdf(spec.get("bsdf", {}), device),
        emitter=_load_emitter(spec.get("emitter", {}), base_dir, device),
        cameras=_load_cameras(spec.get("cameras", {}), resx, resy, device),
        mesh=_load_meshes(spec, base_dir, device),
        area_emitter=_load_area_emitter(spec.get("area_emitter"), device),
    )
