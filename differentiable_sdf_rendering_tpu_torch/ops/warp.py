"""Warp-field reparameterization of ray directions (the paper's core).

Counterpart of the JAX package's ``ops/warp.py``: the trace is fully detached
(``ops/trace.py``); this module attaches gradients by evaluating the warp
vector field at the weighted mean free-flight point ``x = ray(warp_t)``:

    V(x) = -f(x) · n̂(x) · w(x),   n̂ = ∇f_detached / |∇f_detached|²

with analytic spatial Jacobian and divergence.  The reparameterized ray
direction is ``replace_grad(d, normalize(d·max(c, t) + V − detach(V)))`` and
the change-of-variables determinant is ``replace_grad(1, div)`` where ``div``
is the trace of the Jacobian projected to the unit sphere, including the
dependence of ``x`` on ``d`` through ``warp_t`` (``dt_dx`` = ∂warp_t/∂d from
the tracer).

Gradients flow to the SDF grid (and its translation ``p``) through ``f`` and
``∇f`` only — the Hessian and all weight factors are detached; every
``.detach()`` below sits where the JAX package has a ``stop_gradient``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .sdf import TraceParams
from .trace import TraceResult, sphere_trace_warp
from .vecmath import (
    bbox_distance_inside_d,
    normalize,
    normalize_sqr_with_jac,
    outer,
    replace_grad,
)

__all__ = ["WarpConfig", "warp_weight", "warp_vector_and_jac", "warp_eval", "reparameterize"]


@dataclasses.dataclass(frozen=True)
class WarpConfig:
    """Warp-field hyper-parameters (the JAX package's defaults)."""

    edge_eps: float = 0.01
    weight_strategy: int = 6        # 6 ⇒ ε·t distance scaling
    clamping_thresh: float = 0.05
    normalize_warp_field: bool = True
    max_reparam_depth: int = -1     # <0 ⇒ reparam at every depth


def warp_weight(sdf, x, f_det, g_det, edge_eps):
    """Distance-based warp weight ``w = max(0, 1 − |f|/ε)`` with ε shrunk to
    the bbox-interior distance near the boundary.

    All inputs detached.  Returns ``(w, w_d (...,3), edge_eps_d (...,))`` —
    the spatial gradient and the ∂w/∂ε term used by the strategy-6 ε(t)
    chain rule.
    """
    bmin, bmax = sdf.bbox()
    bbox_dist, bbox_dist_d = bbox_distance_inside_d(x, bmin, bmax)
    use_edge_eps = edge_eps <= bbox_dist
    eps_spatial_d = torch.where(use_edge_eps[..., None], torch.zeros_like(bbox_dist_d), bbox_dist_d)
    eps = torch.minimum(edge_eps, bbox_dist)
    inv_eps = 1.0 / torch.clamp_min(eps, 1e-12)
    surf_dist = f_det.abs()
    fac = 1.0 - surf_dist * inv_eps
    w = torch.clamp_min(fac, 0.0)
    w_d = (
        -torch.sign(f_det)[..., None] * g_det * inv_eps[..., None]
        + (surf_dist * inv_eps * inv_eps)[..., None] * eps_spatial_d
    )
    w_d = torch.where((fac >= 0.0)[..., None], w_d, torch.zeros_like(w_d))
    edge_eps_d = torch.where(
        use_edge_eps & (fac >= 0), surf_dist * inv_eps * inv_eps, torch.zeros_like(surf_dist)
    )
    return w, w_d, edge_eps_d


def _mat3(a, b):
    """Batched 3×3 matmul as broadcast-multiply-reduce."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def warp_vector_and_jac(sdf, x, cfg: WarpConfig):
    """Unweighted warp vector ``V₀ = -f·n̂`` and its spatial Jacobian.

    ``f`` and ``∇f`` attached; normalization direction and Hessian detached.
    Returns ``(V0, jac, f, g)``.
    """
    f, g, h = sdf.eval_all(x)
    h = h.detach()
    g_det = g.detach()
    if cfg.normalize_warp_field:
        n_hat, norm_jac = normalize_sqr_with_jac(g_det)
        v0 = -n_hat * f[..., None]
        jac = -_mat3(norm_jac, h) * f[..., None, None] - outer(n_hat, g)
    else:
        v0 = -g_det * f[..., None]
        jac = -h * f[..., None, None] - outer(g_det, g)
    return v0, jac, f, g


def warp_eval(
    sdf,
    x,
    ray_d,
    t,
    dt_dx,
    cfg: WarpConfig,
    active=True,
    warp_weight_mult=None,
    warp_weight_mult_d=None,
):
    """Reparameterized direction + divergence.

    Args:
      sdf: SDF (attached — gradients flow to its parameters).
      x: (..., 3) evaluation points ``ray(warp_t)``.
      ray_d: (..., 3) unit ray directions (may carry gradients at depth>0).
      t: (...,) warp_t from the tracer (detached).
      dt_dx: (..., 3) ∂warp_t/∂d from the tracer (detached).
      warp_weight_mult(_d): optional clamped weight-sum multiplier + gradient.

    Returns:
      (warp, div): ``warp`` has the primal value of ``ray_d`` and the
      gradient of the normalized warped direction; ``div`` is the (attached)
      divergence, zero where inactive.
    """
    active = torch.as_tensor(active, dtype=torch.bool, device=t.device).expand(t.shape)
    active = active & torch.isfinite(t)
    # Pin inactive lanes to a safe point so their (discarded) math is finite.
    t_safe = torch.where(active, t, torch.ones_like(t))
    x = torch.where(active[..., None], x, torch.full_like(x, 0.5))
    dt_dx = torch.where(active[..., None], dt_dx, torch.zeros_like(dt_dx))

    v0, jac, f, g = warp_vector_and_jac(sdf, x, cfg)

    x_det = x.detach()
    f_det = f.detach()
    g_det = g.detach()
    d_det = ray_d.detach()

    if cfg.weight_strategy == 6:
        eps = cfg.edge_eps * t_safe.detach()
    else:
        eps = torch.full_like(t_safe, cfg.edge_eps)
    w, w_grad, eps_d = warp_weight(sdf, x_det, f_det, g_det, eps)
    # strategy-6 chain term: ∂w/∂ε · ∂ε/∂x with ∂t/∂x ≈ d
    w_grad = w_grad + eps_d[..., None] * d_det * cfg.edge_eps

    if warp_weight_mult is not None:
        w_grad = w_grad * warp_weight_mult[..., None] + w[..., None] * warp_weight_mult_d
        w = w * warp_weight_mult

    jac = outer(v0, w_grad) + w[..., None, None] * jac
    warp = v0 * w[..., None]

    # normalize(d·max(c, t) + warp − detach(warp))
    warp = replace_grad(torch.zeros_like(warp), warp)
    warp = ray_d * torch.clamp_min(t_safe, cfg.clamping_thresh)[..., None] + warp
    warp = normalize(warp)

    eye = torch.eye(3, dtype=x.dtype, device=x.device).expand(jac.shape)
    proj = _mat3(eye - outer(d_det, d_det), jac)
    jac_full = proj + _mat3(proj, outer(d_det, dt_dx / t_safe[..., None]))
    div = jac_full[..., 0, 0] + jac_full[..., 1, 1] + jac_full[..., 2, 2]

    active = active & (w.detach() > 0)
    div = torch.where(active, div, torch.zeros_like(div))
    warp = torch.where(active[..., None], warp, ray_d)
    warp = replace_grad(ray_d, warp)
    return warp, div


def reparameterize(
    sdf,
    o,
    d,
    cfg: WarpConfig = WarpConfig(),
    trace_params: TraceParams = TraceParams(),
    maxt=math.inf,
    active=True,
    reparam=True,
    refine_active=True,
):
    """Detached warp trace + attached warp eval.

    Returns ``(its_t, d_reparam, div)`` where ``its_t`` is the detached
    intersection distance (inf = miss), ``d_reparam`` carries the warp
    gradient (primal = d), and ``div`` is ``replace_grad(1, divergence)``.
    """
    res: TraceResult = sphere_trace_warp(
        sdf, o, d, trace_params, maxt=maxt, active=active, refine_active=refine_active
    )
    if not reparam:
        return res.its_t, d, torch.ones_like(res.warp_t)

    # NOTE: o and d stay attached here — for secondary (shadow/bounce) rays
    # the warp point x = ray(warp_t) moves with the attached ray origin,
    # which is what makes *nested* reparameterization correct.
    wt = torch.where(torch.isfinite(res.warp_t), res.warp_t, torch.zeros_like(res.warp_t))
    x = o + wt[..., None] * d
    use_mult = trace_params.use_weight_sum_weight
    warp, div = warp_eval(
        sdf,
        x,
        d,
        res.warp_t,
        res.warp_t_d,
        cfg,
        active=active,
        warp_weight_mult=res.warp_weight if use_mult else None,
        warp_weight_mult_d=res.warp_weight_d if use_mult else None,
    )
    d_reparam = replace_grad(d, warp)
    div = replace_grad(torch.ones_like(div), div)
    return res.its_t, d_reparam, div
