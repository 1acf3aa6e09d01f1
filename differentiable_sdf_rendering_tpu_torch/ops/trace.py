"""Sphere tracing against SDFs, with in-loop warp-field accumulators.

Counterpart of the JAX package's ``ops/trace.py``.  Two entry points:

* ``sphere_trace``      — plain intersection (primal rendering fast path),
  including the 10-step decreasing-rate refinement.  It is the wrapper of
  the hand-written CUDA kernel ``csrc/sphere_trace.cu``: a CUDA tensor goes
  through the kernel (or the call raises), a CPU tensor through the kernel's
  plain version :func:`sphere_trace_plain`.
* ``sphere_trace_warp`` — intersection + the paper's weighted warp-field
  accumulators computed *during* the trace: the weighted mean depth
  ``warp_t = Σ w·t·Δ / Σ w·Δ`` (trapezoid rule over trace segments), its
  hand-derived derivative ``warp_t_d = ∂warp_t/∂(ray direction)``, and the
  clamped weight-sum warp multiplier.  Everything here is *detached* (the
  loops run under ``torch.no_grad``): gradients are attached later by the
  warp field (``ops/warp.py``) evaluated at ``x = ray(warp_t)``.

The per-step silhouette weight is ``w = 1/(ε + |f| + c·(n·d)²/|n|²)^p`` with
bounding-box down-weighting, and an analytic spatial weight gradient that
uses the SDF Hessian.  Derivatives w.r.t. the ray direction are converted
from spatial gradients via ``∇_d g = t·∇_x g + (d·∇_x g)·t_d``.

Loop mechanics of the plain versions: trip counts are heavily skewed (a few
grazing lanes run to ``max_steps`` while most finish in a handful of steps),
so each loop is a Python ``while`` over a working set of lanes that is
re-compacted to the still-active lanes whenever at most half of it remains
active.  Every body
update is masked by ``active``, so compaction is pure lane reordering: a
lane's values do not depend on which other lanes share its batch.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from .sdf import GridSDF, TraceParams
from .vecmath import (
    bbox_distance_inside_d, dot, integer_pow, nearest_axis_mask, normalize, ray_bbox_intersect,
)

__all__ = ["TraceResult", "sphere_trace", "sphere_trace_plain", "sphere_trace_warp"]

_INF = math.inf
# Below this many lanes a working set is no longer re-compacted.
_MIN_COMPACT = 1024


@dataclasses.dataclass(frozen=True)
class TraceResult:
    """Output of a (warp-)sphere-trace; all tensors detached, shape (N,) / (N,3)."""

    its_t: torch.Tensor          # intersection distance, inf if none
    warp_t: torch.Tensor         # weighted mean free-flight distance, inf if invalid
    warp_t_d: torch.Tensor       # ∂warp_t/∂d (3,)
    warp_weight: torch.Tensor    # clamped weight-sum warp multiplier in [0,1]
    warp_weight_d: torch.Tensor  # ∂warp_weight/∂d (3,)
    num_steps: torch.Tensor      # trace iterations used (int32)
    weight_sum: torch.Tensor     # raw accumulated weight (debug AOV)

    @property
    def valid(self):
        return torch.isfinite(self.its_t)


def _where3(mask, a, b):
    """``where`` with a (N,) mask broadcast over trailing-3 operands."""
    return torch.where(mask[..., None], a, b)


def _masked_loop(body, state, consts):
    """``while any(active): state = body(state, consts)`` with active-lane
    compaction.

    ``body(state, consts) -> state``: ``state`` is a dict of (N,)/(N,3)
    tensors incl. boolean ``active``; ``consts`` a dict of per-lane read-only
    tensors.  The loop runs on a working subset of lanes; whenever at most
    half of the subset is still active, the finished lanes are written back
    and the subset shrinks to the active ones.
    """
    idx = None  # None = the working set is the whole batch
    work_s, work_c = state, consts

    def flush():
        if idx is None:
            return work_s
        return {k: state[k].index_copy(0, idx, work_s[k]) for k in state}

    while True:
        m = work_s["active"].shape[0]
        n_act = int(work_s["active"].sum())
        if n_act == 0:
            break
        if m > _MIN_COMPACT and 2 * n_act <= m:
            state = flush()
            keep = work_s["active"].nonzero().squeeze(1)
            idx = keep if idx is None else idx[keep]
            work_s = {k: v[keep] for k, v in work_s.items()}
            work_c = {k: v[keep] for k, v in work_c.items()}
        work_s = body(work_s, work_c)
    return flush()


def _ray_setup(sdf, o, d, params: TraceParams, maxt):
    """Shared entry logic: normalize, clip to the (expanded) SDF bbox.

    Rays starting inside the box begin at t=0, outside rays at the box entry
    + 1e-5; the trace tolerance scales with ray extent:
    ``trace_eps * max(maxt, 1)``.
    """
    d = normalize(d)
    bmin, bmax = sdf.bbox(params.bbox_expand)
    hit, mint, tmax = ray_bbox_intersect(o, d, bmin, bmax)
    inside = torch.all((o >= bmin) & (o <= bmax), dim=-1)
    # honor the caller's ray extent: the box must be entered within it
    hit = hit & ((mint > 0) | inside) & (mint <= maxt)
    maxt = torch.minimum(tmax, maxt)
    trace_eps = params.trace_eps * torch.clamp_min(maxt, 1.0)
    # Non-hitting lanes never trace; pin them to t=0 so their (unused)
    # position evaluations stay finite.
    zero = torch.zeros_like(mint)
    t0 = torch.where(hit, torch.where(inside, zero, mint + 1e-5), zero)
    return d, (bmin, bmax), hit, inside, t0, maxt, trace_eps


def _lane_tensor(v, like, dtype):
    """Broadcast a scalar or (N,) value to a (N,) tensor on ``like``'s device."""
    return torch.as_tensor(v, dtype=dtype, device=like.device).expand(like.shape[:-1])


def _check_trace_params(params: TraceParams):
    if params.over_relax != 1.0:
        raise NotImplementedError("over-relaxed sphere tracing (over_relax > 1) is not ported")
    if params.refine_intersection and params.refine != "fixed":
        raise NotImplementedError(f"refine='{params.refine}' is not ported (only 'fixed')")


@torch.no_grad()
def sphere_trace(sdf, o, d, params: TraceParams = TraceParams(), maxt=_INF, active=True,
                 refine_active=True):
    """Non-differential sphere trace → intersection distance (N,), inf = miss.

    ``maxt``, ``active`` and ``refine_active`` are scalars or per-lane
    tensors; ``refine_active`` masks the refinement per lane (False =
    occlusion-only lanes whose ``isfinite`` bit is invariant under
    refinement).

    On a CUDA tensor the trace runs in ``csrc/sphere_trace.cu`` (a grid SDF
    only: anything else raises ``NotImplementedError``); on a CPU tensor in
    :func:`sphere_trace_plain`.  ``sphere_trace.kernel_launches`` counts the
    kernel's launches.
    """
    if o.is_cuda:
        return _sphere_trace_kernel(sdf, o, d, params, maxt, active, refine_active)[0]
    return sphere_trace_plain(sdf, o, d, params, maxt, active, refine_active)


sphere_trace.kernel_launches = 0


def _sphere_trace_kernel(sdf, o, d, params: TraceParams, maxt=_INF, active=True, refine_active=True):
    """Ray setup, then the kernel.  Returns ``(its_t, num_steps)``: the
    intersection distance and, per lane, the grid evaluations of the trace
    loop and the refinement together."""
    lanes, lead = _kernel_lanes(sdf, o, d, params, maxt, active, refine_active)
    out = _launch_sphere_trace(sdf.data.detach(), sdf.p.detach(), lanes, params)
    return tuple(x.reshape(lead) for x in out)


def _kernel_lanes(sdf, o, d, params: TraceParams, maxt=_INF, active=True, refine_active=True):
    """The kernel's operands: the ray setup of :func:`_ray_setup` as flat,
    contiguous per-lane tensors (the kernel indexes lane i directly).
    Returns ``(lanes, leading shape)``."""
    _check_trace_params(params)
    if not isinstance(sdf, GridSDF):
        raise NotImplementedError(f"the CUDA sphere tracer takes a GridSDF, got {type(sdf).__name__}")
    o = o.detach()
    d = d.detach()
    maxt = _lane_tensor(maxt, o, o.dtype)
    d, _, hit, _, t0, maxt, trace_eps = _ray_setup(sdf, o, d, params, maxt)
    lead = d.shape[:-1]
    lanes = {
        "o": o.expand(d.shape).reshape(-1, 3).contiguous(),
        "d": d.reshape(-1, 3).contiguous(),
        "t0": t0.expand(lead).reshape(-1).contiguous(),
        "maxt": maxt.expand(lead).reshape(-1).contiguous(),
        "trace_eps": trace_eps.expand(lead).reshape(-1).contiguous(),
        "active": (_lane_tensor(active, d, torch.bool) & hit).reshape(-1).to(torch.uint8).contiguous(),
        "refine_active": _lane_tensor(refine_active, d, torch.bool).reshape(-1).to(torch.uint8).contiguous(),
    }
    return lanes, lead


def _launch_sphere_trace(data, origin, lanes: dict, params: TraceParams):
    """Launch ``csrc/sphere_trace.cu::sphere_trace_run`` on the current
    stream over the flat per-lane operands ``lanes`` of :func:`_kernel_lanes`.
    Returns flat ``(its_t, num_steps)``."""
    from .. import kernels

    if data.ndim != 3 or data.dtype != torch.float32 or not data.is_contiguous():
        raise ValueError(f"the CUDA sphere tracer takes a contiguous (Z, Y, X) float32 grid, got "
                         f"{tuple(data.shape)} {data.dtype}")
    if origin.shape != (3,) or origin.dtype != torch.float32:
        raise ValueError(f"the grid origin must be (3,) float32, got {tuple(origin.shape)} {origin.dtype}")
    n = lanes["t0"].shape[0]
    for key, dtype, shape in (("o", torch.float32, (n, 3)), ("d", torch.float32, (n, 3)),
                              ("t0", torch.float32, (n,)), ("maxt", torch.float32, (n,)),
                              ("trace_eps", torch.float32, (n,)), ("active", torch.uint8, (n,)),
                              ("refine_active", torch.uint8, (n,))):
        x = lanes[key]
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() or x.device != data.device:
            raise ValueError(f"sphere-trace operand '{key}' must be a contiguous {shape} {dtype} on "
                             f"{data.device}, got {tuple(x.shape)} {x.dtype} on {x.device}")
    origin = origin.contiguous()
    its_t = torch.empty(n, dtype=torch.float32, device=data.device)
    num_steps = torch.empty(n, dtype=torch.int32, device=data.device)
    refine_steps = params.refine_steps if params.refine_intersection else 0
    zres, yres, xres = data.shape
    with torch.cuda.device(data.device):
        err = kernels.library("sphere_trace").sphere_trace_run(
            data.data_ptr(), xres, yres, zres, origin.data_ptr(),
            *(lanes[k].data_ptr() for k in ("o", "d", "t0", "maxt", "trace_eps", "active", "refine_active")),
            ctypes.c_float(params.step_scale), int(params.max_steps), int(refine_steps),
            its_t.data_ptr(), num_steps.data_ptr(), n,
            torch.cuda.current_stream().cuda_stream,
        )
    sphere_trace.kernel_launches += 1
    if err != 0:
        raise RuntimeError(f"sphere_trace_run: CUDA error {err} at launch")
    return its_t, num_steps


@torch.no_grad()
def sphere_trace_plain(sdf, o, d, params: TraceParams = TraceParams(), maxt=_INF, active=True,
                       refine_active=True):
    """Plain PyTorch version of the sphere-trace kernel (any SDF, any
    device): the masked, lane-compacted loop of the trace, then the
    refinement."""
    _check_trace_params(params)
    sdf = sdf.detach()
    o = o.detach()
    d = d.detach()
    maxt = _lane_tensor(maxt, o, o.dtype)
    d, _, hit, _, t0, maxt, trace_eps = _ray_setup(sdf, o, d, params, maxt)
    active0 = _lane_tensor(active, o, torch.bool) & hit
    scale = params.step_scale

    def body(s, c):
        act, t, its_t, i = s["active"], s["t"], s["its_t"], s["i"]
        x = c["o"] + t[..., None] * c["d"]
        f = sdf.eval(x) * scale
        intersected = f < c["trace_eps"]
        its_t = torch.where(act & intersected, t, its_t)
        step = torch.where(intersected, torch.zeros_like(f), f.abs())
        t_new = torch.where(act, t + step, t)
        act = act & (t_new <= c["maxt"]) & ~intersected & (i + 1 < params.max_steps)
        return {"active": act, "t": t_new, "its_t": its_t, "i": i + 1}

    state = {
        "active": active0,
        "t": t0,
        "its_t": torch.full_like(t0, _INF),
        "i": torch.zeros_like(t0, dtype=torch.int32),
    }
    consts = {"o": o.expand(d.shape), "d": d, "maxt": maxt, "trace_eps": trace_eps}
    its_t = _masked_loop(body, state, consts)["its_t"]

    if params.refine_intersection:
        its_t = _refine(sdf, consts["o"], d, its_t, trace_eps, params, refine_active)
    return its_t


def _refine(sdf, o, d, its_t, trace_eps, params: TraceParams, refine_active=True):
    """Intersection refinement into the (0, ε] shell: the reference's
    decreasing-rate iteration ``t += f·10/(10+i)``.  Only hit lanes refine,
    and a lane stops once it converges into the shell."""
    if params.refine != "fixed":
        raise NotImplementedError(f"refine='{params.refine}' is not ported (only 'fixed')")

    def body(s, c):
        refining, t, i = s["active"], s["t"], s["i"]
        x = c["o"] + t[..., None] * c["d"]
        f = sdf.eval(x) * params.step_scale
        step = f * (10.0 / (10.0 + i))
        t_new = torch.where(refining, t + step, t)
        refining = refining & ((f <= 0) | (f > c["trace_eps"])) & (i + 1 < params.refine_steps)
        return {"active": refining, "t": t_new, "i": i + 1}

    refining0 = torch.isfinite(its_t) & (params.refine_steps > 0)
    refining0 = refining0 & torch.as_tensor(refine_active, dtype=torch.bool, device=its_t.device)
    state = {
        "active": refining0,
        "t": torch.where(refining0, its_t, torch.zeros_like(its_t)),
        "i": torch.zeros_like(its_t, dtype=torch.int32),
    }
    consts = {"o": o, "d": d, "trace_eps": trace_eps.expand(its_t.shape)}
    s = _masked_loop(body, state, consts)
    return torch.where(refining0, s["t"], its_t)


def _trace_weight(d, i, bbox, x, f, g, h, params: TraceParams):
    """Per-step silhouette weight + its spatial gradient.

    ``w = bbox_w / (ε_sil + |f| + c·(n·d)²/|n|²)^p`` with the analytic
    gradient using the Hessian ``h``; the bbox factor ramps the weight to
    zero within 0.01 of the (expanded) bounding box for steps i>0.
    """
    bmin, bmax = bbox
    n_dot_d = dot(g, d)
    n_dot_n = torch.clamp_min(dot(g, g), 1e-20)
    dot_ratio = n_dot_d / n_dot_n
    denom = params.sil_weight_epsilon + f.abs() + params.sil_weight_offset * n_dot_d * dot_ratio
    dist_weight = integer_pow(denom, -params.weight_power)

    bbox_dist, bbox_dist_d = bbox_distance_inside_d(x, bmin, bmax)
    bbox_eps = 0.01
    first = i == 0
    bbox_weight = torch.where(
        first, torch.ones_like(bbox_dist), torch.clamp_max(bbox_dist, bbox_eps) / bbox_eps
    )
    weight = dist_weight * bbox_weight

    bbox_weight_d = _where3(
        ~first & (bbox_dist < bbox_eps), bbox_dist_d / bbox_eps, torch.zeros_like(bbox_dist_d)
    )
    # ∇(n·d)²/|n|² = 2·r·(d − r·n) with r = (n·d)/|n|², then chain through H
    gradient = 2.0 * dot_ratio[..., None] * (d - dot_ratio[..., None] * g)
    denom_d = torch.sign(f)[..., None] * g + params.sil_weight_offset * torch.sum(
        gradient[..., :, None] * h, dim=-2
    )
    dist_weight_d = (-params.weight_power * dist_weight / denom)[..., None] * denom_d
    weight_d = dist_weight[..., None] * bbox_weight_d + bbox_weight[..., None] * dist_weight_d
    return weight, weight_d


@torch.no_grad()
def sphere_trace_warp(
    sdf, o, d, params: TraceParams = TraceParams(), maxt=_INF, active=True,
    refine_active=True,
) -> TraceResult:
    """Differential sphere trace with warp-field accumulators.

    Returns a fully detached :class:`TraceResult`; NaN-free for inactive and
    missed lanes (``warp_t = inf``, derivative terms zero).
    """
    sdf = sdf.detach()
    o = o.detach()
    d = d.detach()
    maxt = _lane_tensor(maxt, o, o.dtype)
    d, bbox, hit, inside, t0, maxt, trace_eps = _ray_setup(sdf, o, d, params, maxt)
    o = o.expand(d.shape)
    bmin, bmax = bbox
    active0 = _lane_tensor(active, o, torch.bool) & hit

    # Initial dt/dd: entry point slides along the nearest bbox face as d
    # rotates; zero for rays starting inside.
    x0 = o + t0[..., None] * d
    min_dist = torch.minimum((bmin - x0).abs(), (bmax - x0).abs())
    n_face = nearest_axis_mask(min_dist)
    d_dot_n = dot(d, n_face)
    ok_dn = d_dot_n.abs() > 1e-12
    safe_dn = torch.where(ok_dn, d_dot_n, torch.ones_like(d_dot_n))
    zero3 = torch.zeros_like(d)
    t_d0 = _where3(~inside & ok_dn, -n_face / safe_dn[..., None] * t0[..., None], zero3)

    scale = params.step_scale
    use_extra = params.use_extra_weight

    def convert_deriv(in_d, t, t_d, d):
        # spatial gradient → gradient w.r.t. ray direction
        return t[..., None] * in_d + dot(d, in_d)[..., None] * t_d

    def body(s, c):
        o, d, maxt, trace_eps = c["o"], c["d"], c["maxt"], c["trace_eps"]
        act = s["active"]
        t = s["t"]
        zero = torch.zeros_like(t)
        zero3 = torch.zeros_like(d)
        x = o + t[..., None] * d
        f, g, h = sdf.eval_all(x)
        f, g, h = f * scale, g * scale, h * scale

        intersected = f < trace_eps
        its_t = torch.where(act & intersected, t, s["its_t"])
        surf_dist = f.abs()
        weight, weight_d = _trace_weight(d, s["i"], bbox, x, f, g, h, params)

        prev_surf_dist = s["prev_surf_dist"]
        if use_extra:
            # "approach" weight: ramps in as a new surface is approached
            inv_ew_den = 1.0 / torch.clamp_min(torch.clamp_max(surf_dist, params.extra_thresh), 1e-12)
            dist_difference = prev_surf_dist - surf_dist
            ew_sum = s["extra_weight_sum"] + torch.where(
                dist_difference >= 0, dist_difference * inv_ew_den, zero
            )
            ew_sum = torch.clamp_max(ew_sum, 1.0)
        else:
            ew_sum = torch.ones_like(t)

        curr_segment_value = torch.where(intersected, zero, surf_dist)
        segment_length = 0.5 * (curr_segment_value + prev_surf_dist)
        weight_increment = segment_length * weight
        if use_extra:
            weight_increment = weight_increment * ew_sum
        weight_sum = s["weight_sum"] + torch.where(act, weight_increment, zero)
        warp_t = s["warp_t"] + torch.where(act, weight_increment * t, zero)

        t_d = s["t_d"]
        weight_d = convert_deriv(weight_d, t, t_d, d)
        sdf_grad_c = convert_deriv(g, t, t_d, d)
        segment_d = 0.5 * (sdf_grad_c + s["prev_sdf_grad_c"])

        if use_extra:
            surf_dist_d = torch.sign(f)[..., None] * sdf_grad_c
            extra_w_d = (s["prev_sdf_grad_c"] - surf_dist_d) * inv_ew_den[..., None]
            extra_w_d = extra_w_d - (dist_difference * inv_ew_den * inv_ew_den)[
                ..., None
            ] * _where3(f < params.extra_thresh, surf_dist_d, zero3)
            ew_sum_d = s["extra_weight_sum_d"] + _where3(dist_difference > 0.0, extra_w_d, zero3)
            ew_sum_d = _where3((ew_sum >= 1.0) | (ew_sum <= 0.0), zero3, ew_sum_d)
            weight_d = weight[..., None] * ew_sum_d + weight_d * ew_sum[..., None]
            weight = weight * ew_sum
        else:
            ew_sum_d = zero3

        weight_increment_d = weight[..., None] * segment_d + weight_d * segment_length[..., None]
        mixed_sum_d = s["mixed_sum_d"] + _where3(
            act,
            weight_increment_d * t[..., None] + (weight * segment_length)[..., None] * t_d,
            zero3,
        )
        t_d_new = _where3(act, t_d + sdf_grad_c, t_d)
        weight_d_sum = s["weight_d_sum"] + _where3(act, weight_increment_d, zero3)
        t_new = torch.where(act, t + curr_segment_value, t)
        i_new = s["i"] + act.to(torch.int32)
        act_new = act & (t_new <= maxt) & ~intersected & (i_new < params.max_steps)

        return {
            "active": act_new,
            "t": t_new,
            "its_t": its_t,
            "prev_surf_dist": torch.where(act, surf_dist, prev_surf_dist),
            "prev_sdf_grad_c": _where3(act, sdf_grad_c, s["prev_sdf_grad_c"]),
            "t_d": t_d_new,
            "weight_sum": weight_sum,
            "weight_d_sum": weight_d_sum,
            "mixed_sum_d": mixed_sum_d,
            "warp_t": warp_t,
            "i": i_new,
            "extra_weight_sum": torch.where(act, ew_sum, s["extra_weight_sum"]),
            "extra_weight_sum_d": _where3(act, ew_sum_d, s["extra_weight_sum_d"]),
        }

    zero = torch.zeros_like(t0)
    state = {
        "active": active0,
        "t": t0,
        "its_t": torch.full_like(t0, _INF),
        "prev_surf_dist": zero,
        "prev_sdf_grad_c": zero3,
        "t_d": t_d0,
        "weight_sum": zero,
        "weight_d_sum": zero3,
        "mixed_sum_d": zero3,
        "warp_t": zero,
        "i": torch.zeros_like(t0, dtype=torch.int32),
        "extra_weight_sum": zero,
        "extra_weight_sum_d": zero3,
    }
    consts = {"o": o, "d": d, "maxt": maxt, "trace_eps": trace_eps}
    s = _masked_loop(body, state, consts)

    its_t = s["its_t"]
    if params.refine_intersection:
        its_t = _refine(sdf, o, d, its_t, trace_eps, params, refine_active)

    # Normalize the trapezoid accumulators
    weight_sum = s["weight_sum"]
    inv_ws = 1.0 / torch.clamp_min(weight_sum, 1e-20)
    warp_t = s["warp_t"] * inv_ws
    warp_t_d = (-warp_t[..., None] * s["weight_d_sum"] + s["mixed_sum_d"]) * inv_ws[..., None]

    if params.use_weight_sum_weight:
        warp_weight = torch.clamp(weight_sum, 0.0, 1.0)
        warp_weight_d = _where3((weight_sum > 0.0) & (weight_sum < 1.0), s["weight_d_sum"], zero3)
    else:
        warp_weight = torch.ones_like(weight_sum)
        warp_weight_d = zero3

    # Disable the warp field below a weight threshold / outside the bbox
    invalid = (weight_sum < 1e-7) | ~hit
    warp_t = torch.where(invalid, torch.full_like(warp_t, _INF), warp_t)
    warp_t_d = _where3(invalid, zero3, warp_t_d)
    warp_weight = torch.where(invalid, zero, warp_weight)
    warp_weight_d = _where3(invalid, zero3, warp_weight_d)

    return TraceResult(
        its_t=its_t,
        warp_t=warp_t,
        warp_t_d=warp_t_d,
        warp_weight=warp_weight,
        warp_weight_d=warp_weight_d,
        num_steps=s["i"],
        weight_sum=weight_sum,
    )
