"""The port imports torch only: no jax, no flax, nothing of the JAX package
(its modules, its two command-line entry points and ``chip_smoke.py``)."""

import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "differentiable_sdf_rendering_tpu_torch")

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
before = set(sys.modules)             # whatever the interpreter preloaded
for name in ("jax", "jaxlib", "flax", "optax", "differentiable_sdf_rendering_tpu"):
    sys.modules[name] = None          # any import of it now raises ImportError
import differentiable_sdf_rendering_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
import chip_smoke                     # imported, not run
import optimize_torch, render_turntable_torch
leaked = [m for m in set(sys.modules) - before
          if m.split(".")[0] in ("jax", "jaxlib", "flax") and sys.modules[m] is not None]
assert not leaked, leaked
print("IMPORTED", len(mods))
"""


def _py_files():
    for base, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)
    for name in ("chip_smoke.py", "optimize_torch.py", "render_turntable_torch.py"):
        yield os.path.join(ROOT, name)


def test_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED_IMPORT],
        cwd=ROOT, env=env, capture_output=True, text=True,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "IMPORTED" in out.stdout and int(out.stdout.split()[-1]) >= 25


@pytest.mark.parametrize("path", sorted(_py_files()), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_import_statement(path):
    src = open(path, encoding="utf-8").read()
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|differentiable_sdf_rendering_tpu)(\.|\s|$)", re.M)
    assert not pat.search(src), path


def test_explicit_device_no_fallback():
    """Without a card, an entry point called without ``device`` raises; it
    does not carry on on the host."""
    import torch

    from differentiable_sdf_rendering_tpu_torch import resolve_device
    from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("this check is about hosts without a CUDA card")
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        create_sphere_sdf(8)


def test_tf32_off():
    import torch

    import differentiable_sdf_rendering_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
