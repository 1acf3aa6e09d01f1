"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` next to this file, at
first use, then loaded with ``ctypes``.  A library is rebuilt when its source
or a header under ``csrc/`` is newer.  No PyTorch header is included, so a
build takes seconds.  Nothing here runs at import: a host without ``nvcc`` can
import every module of the package.  A failing build or a missing compiler raises — there is no
fallback to the plain PyTorch versions.

Pointers are passed as ``tensor.data_ptr()`` and the stream as
``torch.cuda.current_stream().cuda_stream``; ``argtypes`` declares them as
``c_void_p`` so that ctypes does not truncate them to 32 bits.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

__all__ = ["SOURCES", "FMAD", "build_dir", "library", "build_all", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# FMA contraction (-fmad) per source.  Off where a kernel must round like its
# plain PyTorch version: the redistancing kernel equals it bit for bit, and
# the grid evaluation measured no faster with it.  On for the sphere trace,
# which it makes faster within the trace's limits; its box and its trace
# options round each operation apart all the same (csrc/sphere_trace.cu).
FMAD = {"redistance": False, "sphere_trace": True, "grid_eval": False}

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_FLOAT = ctypes.c_float

# name → {C function: (restype, argtypes)}
SOURCES = {
    "redistance": {
        "redistance_run": (_INT, [_VOIDP] * 3 + [_INT] * 4 + [_VOIDP, ctypes.POINTER(_INT)]),
        "redistance_launch_shape": (_INT, [_INT] * 3 + [ctypes.POINTER(_INT)] * 3),
        "redistance_barrier_probe": (_INT, [_INT, _INT, _INT, _VOIDP]),
    },
    "sphere_trace": {
        "sphere_trace_run": (
            _INT,
            [_INT, _VOIDP, _INT, _INT, _INT, _VOIDP, _VOIDP]  # SDF
            + [_VOIDP, _I64, _VOIDP, _I64]  # o, d
            + [_VOIDP, _I64, _FLOAT] + [_VOIDP, _I64, _INT] * 2  # maxt, active, refine_active
            + [_FLOAT] * 5 + [_INT]  # bbox_expand, trace_eps, step_scale, over_relax, 1 - over_relax, newton
            + [_INT, _INT]  # max_steps, refine_steps
            + [_VOIDP] * 3 + [_I64, _VOIDP],  # its_t, num_steps, ray counter, n, stream
        ),
    },
    "grid_eval": {
        "grid_eval_grad_run": (_INT, [_VOIDP, _INT, _INT, _INT] + [_VOIDP] * 4 + [_I64, _VOIDP]),
    },
}

_LIBS: dict = {}


def build_dir() -> str:
    return os.path.join(_HERE, "build")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of this package cannot be built here")


def _paths(name: str):
    return os.path.join(_CSRC, f"{name}.cu"), os.path.join(build_dir(), f"lib{name}.so")


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    if not os.path.exists(lib):
        return True
    headers = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith(".cuh")]
    return os.path.getmtime(lib) < max(os.path.getmtime(f) for f in [src, *headers])


def _start_build(name: str, extra_flags=()):
    """Start ``nvcc`` on ``csrc/<name>.cu``; returns ``(process, command, tmp, lib)``."""
    src, lib = _paths(name)
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, f"-fmad={str(FMAD[name]).lower()}", *extra_flags, "-o", tmp, src]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, cmd, tmp, lib


def _finish_build(proc, cmd, tmp, lib) -> str:
    """Wait for one compiler run, install its library; returns its output."""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        name = os.path.basename(cmd[0])
        raise RuntimeError(f"{name} failed ({proc.returncode}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib)
    return out


def _build(name: str, extra_flags=()) -> str:
    """Compile ``csrc/<name>.cu`` into its library; returns the compiler's output."""
    return _finish_build(*_start_build(name, extra_flags))


def build_all(verbose_ptxas: bool = False) -> dict:
    """Build every stale kernel library: one ``nvcc`` run per source, all
    started together.  Returns ``{"seconds": float, "built": [names], "log": str}``."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose_ptxas else ()
    built = [name for name in SOURCES if _stale(name)]
    runs = [_start_build(name, extra) for name in built]
    try:
        log = "".join(_finish_build(*run) for run in runs)
    finally:
        for proc, *_ in runs:  # after a failure, stop the compilers still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {"seconds": time.perf_counter() - t0, "built": built, "log": log}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built first when stale)."""
    lib = _LIBS.get(name)
    if lib is None:
        if _stale(name):
            _build(name)
        lib = ctypes.CDLL(_paths(name)[1])
        for fn, (restype, argtypes) in SOURCES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _LIBS[name] = lib
    return lib
