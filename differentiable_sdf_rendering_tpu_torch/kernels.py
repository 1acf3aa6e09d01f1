"""Build and bind the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>.so`` next to this file, at
first use, then loaded with ``ctypes``.  A library is rebuilt when its source
is newer.  No PyTorch header is included, so a build takes seconds.  Nothing
here runs at import: a host without ``nvcc`` can import every module of the
package.  A failing build or a missing compiler raises — there is no
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

__all__ = ["SOURCES", "build_dir", "library", "build_all", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")

# -fmad=false: the redistancing kernel must round like its plain PyTorch
# version (no FMA contraction); see csrc/redistance.cu.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int

# name → {C function: (restype, argtypes)}
SOURCES = {
    "redistance": {
        "redistance_run": (_INT, [_VOIDP] * 6 + [_INT, _INT, _VOIDP, ctypes.POINTER(_INT)]),
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
    return not os.path.exists(lib) or os.path.getmtime(lib) < os.path.getmtime(src)


def _build(name: str, extra_flags=()) -> str:
    """Compile ``csrc/<name>.cu`` into its library; returns the compiler's output."""
    src, lib = _paths(name)
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, src]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, lib)
    return proc.stdout


def build_all(verbose_ptxas: bool = False) -> dict:
    """Build every stale kernel library, one ``nvcc`` run per source.
    Returns ``{"seconds": float, "built": [names], "log": str}``."""
    t0 = time.perf_counter()
    extra = ("-Xptxas", "-v") if verbose_ptxas else ()
    built = [name for name in SOURCES if _stale(name)]
    log = "".join(_build(name, extra) for name in built)
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
