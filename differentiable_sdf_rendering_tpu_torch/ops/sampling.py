"""Counter-based per-lane RNG and sampling warps.

Counterpart of the JAX package's ``ops/sampling.py``.  Every lane derives its
stream from ``fold_in(PRNGKey(seed), global_lane_index)``, so estimates do
not depend on how a wavefront is cut into chunks.  :func:`lane_uniforms`
reproduces the JAX package's numbers bit for bit: it is threefry2x32 written
in integer tensor ops, with JAX's key derivation (``PRNGKey``, ``fold_in``)
and its partitionable random-bits layout, so that images rendered by the two
packages from one seed are comparable sample by sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "lane_uniforms",
    "square_to_cosine_hemisphere",
    "cosine_hemisphere_pdf",
    "square_to_uniform_sphere",
    "square_to_vmf",
    "vmf_pdf",
    "mis_weight",
]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds.  All operands are int64 tensors (or ints)
    holding 32-bit words; every sum is masked back to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for block in range(5):
        for r in _ROTATIONS[block % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & _M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & _M32
    return x0, x1


def lane_uniforms(seed: int, lane_idx, n: int):
    """(len(lane_idx), n) uniforms in [0, 1), deterministic per
    (seed, lane index); equal to ``jax.random.uniform(fold_in(PRNGKey(seed),
    lane), (n,))`` under threefry2x32 with partitionable bit generation."""
    seed = int(seed)
    lane = lane_idx.to(torch.int64) & _M32
    zero = torch.zeros_like(lane)
    # PRNGKey(seed) = (high word, low word); fold_in hashes the counter (0, lane)
    k0, k1 = _threefry2x32((seed >> 32) & _M32, seed & _M32, zero, lane)
    # one 32-bit draw per counter (0, i): the two output words xor-ed
    i = torch.arange(n, dtype=torch.int64, device=lane.device)
    b0, b1 = _threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(i)[None, :], i[None, :])
    bits = b0 ^ b1
    # 23 mantissa bits under exponent 0 → [1, 2), minus 1
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return torch.clamp_min(mant.view(torch.float32) - 1.0, 0.0)


def square_to_cosine_hemisphere(u):
    """[0,1)² → cosine-weighted hemisphere around +z (local frame)."""
    r = torch.sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    z = torch.sqrt(torch.clamp_min(1.0 - u[..., 0], 0.0))
    return torch.stack([x, y, z], dim=-1)


def cosine_hemisphere_pdf(wo_local):
    return torch.clamp_min(wo_local[..., 2], 0.0) / math.pi


def square_to_uniform_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def _neg_expm1_2k(kappa: float):
    """``1 - e^{-2κ}`` as the float32 ``-expm1(-2κ)`` (1 for κ ≳ 9), a host
    scalar (PyTorch's host expm1: numpy's float32 one is an ulp off XLA's
    at κ = 2)."""
    return np.float32(-torch.expm1(torch.tensor(-2.0 * kappa, dtype=torch.float32)).item())


def square_to_vmf(u, kappa: float):
    """[0,1)² → von Mises-Fisher sample around +z, stable for large κ:
    cos θ = 1 + log1p((u - 1)(1 - e^{-2κ})) / κ."""
    ck = 1.0 + torch.log1p((u[..., 0] - 1.0) * float(_neg_expm1_2k(kappa))) / kappa
    ck = torch.clamp(ck, -1.0, 1.0)
    sk = torch.sqrt(torch.clamp_min(1.0 - ck * ck, 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    return torch.stack([sk * torch.cos(phi), sk * torch.sin(phi), ck], dim=-1)


def vmf_pdf(cos_theta, kappa: float):
    """vMF density on the sphere in the stable form
    κ / (2π (1 − e^{-2κ})) · e^{κ(cos θ − 1)}; the normalisation is
    rounded in float32 on the host, as the JAX package rounds it."""
    norm = np.float32(kappa) / (np.float32(2.0 * math.pi) * _neg_expm1_2k(kappa))
    return float(norm) * torch.exp(kappa * (cos_theta - 1.0))


def mis_weight(pdf_a, pdf_b):
    """Power heuristic (β=2)."""
    a2 = pdf_a * pdf_a
    w = a2 / torch.clamp_min(a2 + pdf_b * pdf_b, 1e-20)
    return torch.where(pdf_a > 0, w, torch.zeros_like(w))
