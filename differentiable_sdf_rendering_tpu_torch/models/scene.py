"""Scene: SDF + BSDF + emitter + camera rig.

Counterpart of the JAX package's ``models/scene.py``: the SDF is a
first-class scene member, the BSDF attached to it is explicit, and the
differentiable parameters are the tensors of the members.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .. import resolve_device, same_device
from ..ops.sdf import GridSDF
from .bsdf import DiffuseBSDF, PrincipledBSDF
from .camera import PerspectiveCamera, regular_cameras
from .emitter import ConstantEmitter

__all__ = ["Scene"]


@dataclasses.dataclass(frozen=True)
class Scene:
    sdf: GridSDF
    bsdf: DiffuseBSDF | PrincipledBSDF
    emitter: Any
    cameras: PerspectiveCamera
    # Optional auxiliary TriangleMesh of a mixed scene (a floor, a mirror);
    # None = pure-SDF scene, and the mesh path does not run.
    mesh: Any = None
    # Optional finite-position AreaEmitter: camera and BSDF rays can see it,
    # NEE samples it with a finite-distance shadow ray.  None = environment
    # lighting only.
    area_emitter: Any = None

    @classmethod
    def create(cls, sdf_data, bsdf=None, emitter=None, cameras=None, n_views=12, res=128,
               mesh=None, area_emitter=None, device=None):
        device = resolve_device(device)
        sdf = sdf_data if isinstance(sdf_data, GridSDF) else GridSDF.create(sdf_data, device=device)
        return cls(
            sdf=sdf,
            bsdf=bsdf if bsdf is not None else DiffuseBSDF.create(device=device),
            emitter=emitter if emitter is not None else ConstantEmitter.create(device=device),
            cameras=cameras if cameras is not None else regular_cameras(n_views, resx=res, resy=res, device=device),
            mesh=mesh,
            area_emitter=area_emitter,
        )

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def device(self):
        return self.sdf.data.device

    def require_device(self, device):
        """Raise unless the scene's grid lies on ``device``."""
        if not same_device(self.device, device):
            raise ValueError(f"scene lies on {self.device}, but device={device} was asked for")

    @property
    def n_views(self):
        return self.cameras.origin.shape[0]
