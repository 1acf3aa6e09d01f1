"""Carry scene state, parameters and optimizer state between plain numpy
dicts and this package's objects.

The dict layouts are framework-neutral (numpy arrays and Python scalars), so
state of the JAX package crosses over as ``np.asarray(leaf)`` per entry — the
caller does that step; this module imports numpy and torch only.

scene dict:
  ``sdf``       (Z, Y, X) f32 grid            ``sdf_p``  (3,) f32 (optional)
  ``cam_origin`` (V, 3)  ``cam_rot`` (V, 3, 3)  ``cam_tan_half_fov`` (V,)
  ``cam_resx``, ``cam_resy``  ints
  or, with ``cam_kind`` = ``"spherical"``, ``cam_origin`` (3,), ``cam_resx``,
  ``cam_resy`` and ``cam_uniform`` (bool)
  BSDF, ``bsdf`` = ``"diffuse"`` (the default when absent) or ``"principled"``:
    diffuse:    ``albedo`` (3,) f32 [+ ``albedo_tex`` (Z, Y, X, 3)]
    principled: ``base_color`` (3,), ``roughness`` () f32, ``specular`` float
                [+ ``base_color_tex`` (Z, Y, X, 3), ``roughness_tex`` (Z, Y, X, 1)]
  emitter, one of:
    ``envmap_image`` (H, W, 3) [+ ``envmap_pdf_table``, ``envmap_alias_prob``,
    ``envmap_alias_idx`` (H·W,) — rebuilt from the image when absent]
    ``radiance`` (3,)  — constant emitter
params dict:      ``{key: array}``: ``sdf`` (Z, Y, X), ``albedo`` and
                  ``roughness`` (Z, Y, X, C)
adam state dict:  ``{"m": {key: array}, "v": {key: array}, "t": {key: int}}``
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.bsdf import DiffuseBSDF, PrincipledBSDF
from ..models.camera import PerspectiveCamera, SphericalCamera
from ..models.emitter import ConstantEmitter, GridEnvmap
from ..models.scene import Scene
from ..ops.sdf import GridSDF

__all__ = [
    "scene_from_numpy", "scene_to_numpy",
    "params_from_numpy", "params_to_numpy",
    "adam_state_from_numpy", "adam_state_to_numpy",
]


def _t(a, device, dtype=torch.float32):
    # torch.tensor copies: the source may be a read-only view of another
    # framework's buffer
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def _n(t):
    return t.detach().cpu().numpy()


def _opt_t(d, key, device):
    return _t(d[key], device) if d.get(key) is not None else None


def _bsdf_from_numpy(d: dict, device):
    kind = d.get("bsdf", "diffuse")
    if kind == "diffuse":
        return DiffuseBSDF(albedo=_t(d["albedo"], device), albedo_tex=_opt_t(d, "albedo_tex", device))
    if kind == "principled":
        return PrincipledBSDF(
            base_color=_t(d["base_color"], device), roughness=_t(d["roughness"], device),
            base_color_tex=_opt_t(d, "base_color_tex", device), roughness_tex=_opt_t(d, "roughness_tex", device),
            specular=float(d["specular"]),
        )
    raise ValueError(f"unknown BSDF kind '{kind}'")


def _bsdf_to_numpy(bsdf) -> dict:
    if isinstance(bsdf, PrincipledBSDF):
        d = {"bsdf": "principled", "base_color": _n(bsdf.base_color), "roughness": _n(bsdf.roughness),
             "specular": bsdf.specular}
        texs = {"base_color_tex": bsdf.base_color_tex, "roughness_tex": bsdf.roughness_tex}
    else:
        d = {"bsdf": "diffuse", "albedo": _n(bsdf.albedo)}
        texs = {"albedo_tex": bsdf.albedo_tex}
    d.update({k: _n(v) for k, v in texs.items() if v is not None})
    return d


def _cameras_from_numpy(d: dict, device):
    if d.get("cam_kind", "perspective") == "spherical":
        return SphericalCamera(origin=_t(d["cam_origin"], device), resx=int(d["cam_resx"]), resy=int(d["cam_resy"]),
                               uniform=bool(d["cam_uniform"]))
    return PerspectiveCamera(
        origin=_t(d["cam_origin"], device),
        rot=_t(d["cam_rot"], device),
        tan_half_fov=_t(d["cam_tan_half_fov"], device),
        resx=int(d["cam_resx"]),
        resy=int(d["cam_resy"]),
    )


def _cameras_to_numpy(c) -> dict:
    if isinstance(c, SphericalCamera):
        return {"cam_kind": "spherical", "cam_origin": _n(c.origin), "cam_resx": c.resx, "cam_resy": c.resy,
                "cam_uniform": c.uniform}
    return {"cam_origin": _n(c.origin), "cam_rot": _n(c.rot), "cam_tan_half_fov": _n(c.tan_half_fov),
            "cam_resx": c.resx, "cam_resy": c.resy}


def scene_from_numpy(d: dict, device) -> Scene:
    sdf = GridSDF.create(_t(d["sdf"], device), p=d.get("sdf_p"))
    cams = _cameras_from_numpy(d, device)
    if "envmap_image" in d:
        if "envmap_alias_idx" in d:
            img = _t(d["envmap_image"], device)
            emitter = GridEnvmap(
                image=img,
                image_rows=img.reshape(-1, 3),
                pdf_table=_t(d["envmap_pdf_table"], device),
                alias_prob=_t(d["envmap_alias_prob"], device),
                alias_idx=_t(d["envmap_alias_idx"], device, torch.int64),
            )
        else:
            emitter = GridEnvmap.create(np.asarray(d["envmap_image"]), device=device)
    else:
        emitter = ConstantEmitter(radiance=_t(d["radiance"], device))
    return Scene(sdf=sdf, bsdf=_bsdf_from_numpy(d, device), emitter=emitter, cameras=cams)


def scene_to_numpy(scene: Scene) -> dict:
    d = {
        "sdf": _n(scene.sdf.data),
        "sdf_p": _n(scene.sdf.p),
        **_cameras_to_numpy(scene.cameras),
        **_bsdf_to_numpy(scene.bsdf),
    }
    if isinstance(scene.emitter, GridEnvmap):
        e = scene.emitter
        d.update(
            envmap_image=_n(e.image), envmap_pdf_table=_n(e.pdf_table),
            envmap_alias_prob=_n(e.alias_prob), envmap_alias_idx=_n(e.alias_idx).astype(np.int32),
        )
    else:
        d["radiance"] = _n(scene.emitter.radiance)
    return d


def params_from_numpy(d: dict, device) -> dict:
    return {k: _t(v, device) for k, v in d.items()}


def params_to_numpy(params: dict) -> dict:
    return {k: _n(v) for k, v in params.items()}


def adam_state_from_numpy(d: dict, device) -> dict:
    return {
        "m": params_from_numpy(d["m"], device),
        "v": params_from_numpy(d["v"], device),
        "t": {k: int(np.asarray(v)) for k, v in d["t"].items()},
    }


def adam_state_to_numpy(state: dict) -> dict:
    return {
        "m": params_to_numpy(state["m"]),
        "v": params_to_numpy(state["v"]),
        "t": {k: int(v) for k, v in state["t"].items()},
    }
