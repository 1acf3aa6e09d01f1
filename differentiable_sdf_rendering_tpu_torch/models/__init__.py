"""Scene model: cameras, BSDF, emitters, integrator."""

from . import bsdf, camera, emitter, integrator, scene, scenes_zoo  # noqa: F401
