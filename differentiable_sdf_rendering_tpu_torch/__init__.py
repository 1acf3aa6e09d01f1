"""differentiable_sdf_rendering_tpu_torch — the PyTorch/CUDA port of the
differentiable SDF renderer, written for one NVIDIA Hopper card.

It sits beside the JAX package ``differentiable_sdf_rendering_tpu`` (the
numeric reference) and mirrors its layout, so the counterpart of
``ops/trace.py::sphere_trace`` there is ``ops/trace.py::sphere_trace`` here:

  ops/       — grid interpolation, sphere tracing, warp fields, redistancing,
               film splatting, sampling, the 2-D SDFs
  models/    — cameras, BSDF, emitters, scene, scene files, integrator
  opt/       — variables, losses, regularizer, Adam, configs, the training
               loop, gradient-image validation
  utils/     — numpy <-> port state conversion, .vol / PNG / EXR / metadata
               I/O, mesh loading and mesh -> SDF, turntable and convergence
               videos, timing and tracing
  csrc/      — hand-written CUDA sources (built at first use by kernels.py):
               redistancing, sphere tracing, detached grid evaluation
  native/    — host C++ of the mesh -> SDF tools (built at first use by g++)

Plain tensor code runs eagerly; there is no ``jit``.  Every entry point takes
an explicit ``device``: ``None`` means the CUDA card and raises when there is
none — nothing here looks for a GPU and carries on without one.

Numerics: float32 everywhere.  TF32 is switched off for matrix products and
convolutions at import: the sphere tracer's hit test is ``f < 1e-6``, and a
1e-3 relative error in an SDF value flips it.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card (raises without one); else ``torch.device(device)``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' explicitly to run "
                "the plain PyTorch path on the host"
            )
        return torch.device("cuda")
    return torch.device(device)


def same_device(a: torch.device, b: torch.device) -> bool:
    """Device equality that treats ``cuda`` and ``cuda:<current>`` as equal."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (b.index if b.index is not None else cur)
