"""Convolution (Bangaru et al. 2020) reparameterization baseline.

Counterpart of the JAX package's ``ops/warp_conv.py``: the harmonic-weight
vMF convolution over auxiliary rays, written once — detached weights,
attached warp vectors, ``replace_grad`` to pin the primal direction — and
differentiated by autograd.

Math:
  ω_i ~ vMF(d, κ);   B_i = (n·−ω_i)² (1 for misses);  D_i = e^{κ(1−d·ω_i)}−1
  w_i = 1/(D_i+B_i)^p / pdf(ω_i)                     (detached)
  V_i = normalize(detach(p_hit) + (warp − detach(warp)) − o),  warp = −f·∇f/|∇f|²
  V(d) = Σ w_i V_i / Z,   div = (Σ (∂_ω w_i)·V_i − V·Σ ∂_ω w_i)/Z
  direction = replace_grad(d, normalize(d + V)),  det = replace_grad(1, div)

Each auxiliary ray is traced by :func:`ops.trace.sphere_trace` (the CUDA
kernel on the card).  At its hit only the SDF value ``f`` is attached; the
gradient ``∇f`` is used detached, so it comes from the detached grid
evaluation (the CUDA kernel ``csrc/grid_eval.cu`` on the card).
"""

from __future__ import annotations

import dataclasses

import torch

from .interaction import coordinate_frame
from .sampling import square_to_vmf, vmf_pdf
from .sdf import GridSDF, TraceParams
from .trace import sphere_trace
from .vecmath import dot, normalize, replace_grad

__all__ = ["ConvWarpConfig", "aux_directions", "conv_reparameterize"]


@dataclasses.dataclass(frozen=True)
class ConvWarpConfig:
    """Convolution-warp hyper-parameters (the JAX package's defaults)."""

    n_aux_rays: int = 16
    kappa: float = 1e5
    power: float = 3.0
    antithetic: bool = False


def _detached_gradient(sdf, x):
    if isinstance(sdf, GridSDF):
        return sdf.eval_grad_detached(x)
    with torch.no_grad():
        return sdf.eval_grad(x)


def aux_directions(d_det, u2, kappa: float):
    """Auxiliary directions ``ω ~ vMF(d, κ)`` from uniforms ``u2`` (..., 2)
    and their density: ``(ω, pdf(ω))``."""
    offset = square_to_vmf(u2, kappa)  # local frame, +z = d
    s, t = coordinate_frame(d_det)
    omega = offset[..., 0:1] * s + offset[..., 1:2] * t + offset[..., 2:3] * d_det
    return omega, vmf_pdf(offset[..., 2], kappa)


def _sample_warp_field(sdf, o, d_det, u2, cfg: ConvWarpConfig, trace_params: TraceParams):
    """One auxiliary ray per lane.  ``o`` may be attached (nested
    reparameterization); everything else is detached except the warp.
    Returns ``(w, ∂_ω w, w·V_i, (∂_ω w)·V_i)``."""
    omega, pdf_omega = aux_directions(d_det, u2, cfg.kappa)

    its_t = sphere_trace(sdf, o.detach(), omega, trace_params)
    hit = torch.isfinite(its_t)
    t_safe = torch.where(hit, its_t, torch.ones_like(its_t))
    p_hit = (o + t_safe[..., None] * omega).detach()

    f = sdf.eval(p_hit)
    g_det = _detached_gradient(sdf, p_hit)
    n_sqr = g_det / torch.clamp_min(dot(g_det, g_det), 1e-30)[..., None]
    warp = -n_sqr * f[..., None]
    v_direct = normalize(p_hit + replace_grad(torch.zeros_like(warp), warp) - o)
    v_direct = torch.where(hit[..., None], v_direct, omega)

    n_surf = normalize(g_det)
    boundary_test = dot(n_surf, -omega) ** 2
    B = torch.where(hit, boundary_test, torch.ones_like(boundary_test))
    D = torch.exp(torch.clamp_max(cfg.kappa * (1.0 - dot(d_det, omega)), 60.0)) - 1.0
    div_eps = 1e-7
    w_denom = D + B
    zero = torch.zeros_like(w_denom)
    w = torch.where(w_denom > div_eps, w_denom ** (-cfg.power), zero) / torch.clamp_min(pdf_omega, 1e-30)

    # analytic ∂w/∂ω projected to the tangent plane of d
    tmp1 = (D + 1.0) * torch.where(w_denom > div_eps, w_denom ** (-(cfg.power + 1.0)), zero)
    tmp1 = tmp1 * cfg.kappa * cfg.power
    tmp2 = omega - d_det * dot(d_det, omega)[..., None]
    d_w_omega = torch.clamp(tmp1, -1e10, 1e10)[..., None] * tmp2
    d_w_omega = d_w_omega / torch.clamp_min(pdf_omega, 1e-30)[..., None]

    w = w.detach()
    d_w_omega = d_w_omega.detach()
    return w, d_w_omega, w[..., None] * v_direct, dot(d_w_omega, v_direct)


def conv_reparameterize(sdf, o, d, u, cfg: ConvWarpConfig = ConvWarpConfig(),
                        trace_params: TraceParams = TraceParams(), active=True):
    """Reparameterize ``d`` by the vMF convolution.

    Args:
      u: (..., n_aux, 2) uniforms (antithetic: each pair also as ``1 − u``).

    Returns ``(d_reparam, det)`` with primal values ``(d, 1)``.
    """
    d_det = normalize(d).detach()
    Z = torch.zeros(d.shape[:-1], dtype=d.dtype, device=d.device)
    dZ = torch.zeros_like(d_det)
    Vnum = torch.zeros_like(d_det)
    div_lhs = torch.zeros_like(Z)

    for i in range(cfg.n_aux_rays):
        samples = [u[..., i, :]]
        if cfg.antithetic:
            samples.append(1.0 - u[..., i, :])
        for u2 in samples:
            w, dw, wV, dlhs = _sample_warp_field(sdf, o, d_det, u2, cfg, trace_params)
            Z = Z + w
            dZ = dZ + dw
            Vnum = Vnum + wV
            div_lhs = div_lhs + dlhs

    Z = torch.clamp_min(Z, 1e-8)
    V = replace_grad(torch.zeros_like(Vnum), Vnum) / Z[..., None]
    div = (replace_grad(torch.zeros_like(div_lhs), div_lhs) - dot(V, dZ)) / Z
    direction = normalize(d + V)

    active = torch.as_tensor(active, dtype=torch.bool, device=d.device).expand(Z.shape)
    direction = torch.where(active[..., None], direction, d)
    div = torch.where(active, div, torch.zeros_like(div))
    return replace_grad(d, direction), replace_grad(torch.ones_like(div), div)
