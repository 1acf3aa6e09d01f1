"""The reparameterized direct-illumination integrator and the wavefront
render pipeline.

Counterpart of the JAX package's ``models/integrator.py``: one wavefront of
``(W+2b)·(H+2b)·spp`` ray lanes per (view, mode), with

  * primal mode — fast non-diff sphere trace, detached splat positions,
  * grad mode   — warp-field reparameterized directions, attached
    determinants, attached film-position/filter-weight reweighting.

Implemented here: ``sdf_direct_reparam`` (direct illumination with detached
emitter sampling and a reparameterized shadow ray at depth 1) on pure-SDF
scenes under an environment emitter, ``warp_kind`` in {'warp', 'dummy'}.
MIS, antithetic sampling, the convolution-warp baseline, meshes, area lights
and the silhouette / simple-shading / PRB integrators are not, and asking
for one raises.

The training loop renders primal at high spp, takes dLoss/dimage, and pulls
it back through a (lower-spp) grad-mode render with autograd.

Memory: the 64-tap gather of one attached evaluation keeps ~1 KB per lane
for the backward pass, so a wavefront is rendered in spp-strided lane chunks
under a lane cap (:func:`lane_chunks`); chunk blocks sum before ``develop``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import resolve_device
from ..ops.film import BORDER, develop, splat
from ..ops.interaction import compute_surface_interaction
from ..ops.sampling import lane_uniforms
from ..ops.sdf import TraceParams
from ..ops.trace import sphere_trace
from ..ops.vecmath import replace_grad
from ..ops.warp import WarpConfig, reparameterize

__all__ = [
    "RenderConfig", "MAX_LANES", "lane_chunks", "render_lane_block", "render", "render_chunked",
]

# Lane cap of one chunk: bounds the live tap tensors (and, in grad mode, what
# autograd keeps of them).
MAX_LANES = 1 << 21


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render settings (the JAX package's fields and defaults, minus
    ``dense_splat``: the film is always accumulated by :func:`splat`)."""

    integrator: str = "sdf_direct_reparam"
    spp: int = 64
    use_mis: bool = False
    hide_emitters: bool = False
    sample_border: bool = True
    detach_indirect_si: bool = False
    decouple_reparam: bool = False
    # debug ablations (gradient-decomposition tooling; all off by default)
    debug_detach_nee_throughput: bool = False
    debug_detach_normals: bool = False
    debug_nondiff_si: bool = False
    debug_detach_splat: bool = False
    shadow_eps: float = 1e-3
    warp: WarpConfig = WarpConfig()
    trace: TraceParams = TraceParams()
    max_depth: int = 4
    # False ⇒ no reparameterization, det ≡ 1, shading gradients only
    use_warp: bool = True
    # 'warp' | 'dummy'  ('conv', the convolution baseline, is not ported)
    warp_kind: str = "warp"
    antithetic_sampling: bool = False


def _check_supported(cfg: RenderConfig):
    if cfg.integrator != "sdf_direct_reparam":
        raise NotImplementedError(f"integrator '{cfg.integrator}' is not ported")
    if cfg.warp_kind not in ("warp", "dummy"):
        raise NotImplementedError(f"warp_kind '{cfg.warp_kind}' is not ported")
    if cfg.use_mis:
        raise NotImplementedError("MIS BSDF sampling (use_mis) is not ported")
    if cfg.antithetic_sampling:
        raise NotImplementedError("antithetic sampling is not ported")


def _ray_intersect(scene, o, d, depth, cfg: RenderConfig, mode, maxt=math.inf, occlusion=False):
    """SDF intersect.  Returns ``(its_t, d_reparam, det)``.

    ``occlusion=True`` marks a binary visibility query: the intersection
    refinement is skipped (it moves ``its_t`` by O(ε) but never flips
    finite↔inf, and ``isfinite(its_t)`` is the only consumed bit)."""
    trace = cfg.trace
    if occlusion and trace.refine_intersection:
        trace = dataclasses.replace(trace, refine_intersection=False)
    reparam = mode != "primal" and cfg.use_warp and cfg.warp_kind != "dummy"
    if reparam and cfg.warp.max_reparam_depth >= 0 and depth > cfg.warp.max_reparam_depth:
        reparam = False
    if not reparam:
        its_t = sphere_trace(scene.sdf, o, d, trace, maxt=maxt)
        return its_t, d, torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
    return reparameterize(scene.sdf, o, d, cfg.warp, trace, maxt=maxt)


def _emitted_along(scene, p, d):
    """Emitted radiance arriving at ``p`` from direction ``d`` and the
    occlusion distance of emitter geometry (none here: always inf)."""
    env = scene.emitter.eval(d)
    return env, torch.full(d.shape[:-1], math.inf, dtype=d.dtype, device=d.device)


def _nee_sample(scene, p, u2):
    """Sample an emitter direction from ``p``: ``(d, pdf, radiance, maxt)``
    with ``maxt`` the distance bounding the shadow ray (inf for environment
    directions)."""
    d, pdf, rad = scene.emitter.sample_direction(u2)
    return d, pdf, rad, torch.full(pdf.shape, math.inf, dtype=pdf.dtype, device=pdf.device)


def _sample_direct(scene, o, d, uni, cfg: RenderConfig, mode):
    """Direct illumination with emitter sampling.
    Returns ``(rgb, valid_ray, det, d1)``."""
    reparametrize = mode != "primal"
    its_t, d1, det = _ray_intersect(scene, o, d, 0, cfg, mode)
    si = compute_surface_interaction(
        scene.sdf, o, d1, its_t, differentiable=reparametrize and not cfg.debug_nondiff_si
    )
    if cfg.debug_detach_normals:
        si = si.replace(n=si.n.detach(), wi=si.wi.detach())

    throughput = det[..., None] * torch.ones(o.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
    # Emitted radiance seen by the ray: the environment on escaped lanes
    # (attached direction → silhouette gradients of the background)
    emitted, t_light = _emitted_along(scene, o, d1)
    light_first = torch.isfinite(t_light) & (t_light < its_t)
    shade = si.valid & ~light_first
    see_emitted = light_first | ~si.valid
    if cfg.hide_emitters:
        see_emitted = torch.zeros_like(see_emitted)
    result = torch.where(see_emitted[..., None], emitted, torch.zeros_like(emitted)) * throughput
    valid_ray = si.valid | light_first
    if not cfg.hide_emitters:
        valid_ray = torch.ones_like(valid_ray)

    # ---------------- Emitter sampling (detached) ----------------
    active_e = shade
    si_p_det = si.p.detach()
    ds_d, ds_pdf, ds_rad, ds_dist = _nee_sample(scene, si_p_det, uni[:, 2:4].detach())
    ds_d = ds_d.detach()
    ds_pdf = ds_pdf.detach()
    ds_dist = ds_dist.detach()
    active_e = active_e & (ds_pdf > 0)
    if cfg.detach_indirect_si:
        shadow_o = si_p_det
    elif cfg.decouple_reparam:
        # spawn from the interaction of the *unreparameterized* ray: p
        # attached through the implicit depth but not the warped direction
        si_d0 = compute_surface_interaction(scene.sdf, o, d, its_t, differentiable=reparametrize)
        shadow_o = si_d0.p
    else:
        shadow_o = si.p  # attached: nested reparameterization
    shadow_o = shadow_o + ds_d * cfg.shadow_eps
    # Finite-distance shadow ray: stop just short of the emitter sample;
    # inf for environment directions.
    shadow_maxt = torch.where(
        torch.isfinite(ds_dist), ds_dist * (1.0 - 1e-3) - cfg.shadow_eps,
        torch.full_like(ds_dist, math.inf),
    )
    occluded_t, _, det_e = _ray_intersect(
        scene, shadow_o, ds_d, 1, cfg, mode, maxt=shadow_maxt, occlusion=True
    )
    visibility = (~torch.isfinite(occluded_t)).to(o.dtype)

    wo = si.to_local(ds_d)
    emitter_val = torch.where(
        (active_e & (ds_pdf > 0))[..., None],
        ds_rad / torch.clamp_min(ds_pdf, 1e-12)[..., None],
        torch.zeros_like(ds_rad),
    )
    bsdf_val = scene.bsdf.eval(si, wo)
    nee = visibility[..., None] * bsdf_val * emitter_val
    nee_throughput = throughput.detach() if cfg.debug_detach_nee_throughput else throughput
    contrib = nee_throughput * nee * det_e[..., None]
    result = result + torch.where(active_e[..., None], contrib, torch.zeros_like(contrib))

    result = torch.where(valid_ray[..., None], result, torch.zeros_like(result))
    return result, valid_ray, det, d1


def render_lane_block(scene, camera, lane, seed, cfg: RenderConfig, mode="primal"):
    """Render a set of wavefront lanes and splat them into a film block.

    ``lane``: (M,) int64 *global* lane indices in [0, (W+2b)(H+2b)·spp) —
    the RNG is keyed by global lane id, so any partition of the lane axis
    reproduces the same samples.  Returns the un-normalized (H+2b, W+2b, 5)
    block; blocks of lane chunks sum before :func:`develop`.
    """
    _check_supported(cfg)
    W, H = camera.resx, camera.resy
    b = BORDER if cfg.sample_border else 0
    pw = W + 2 * b
    spp = cfg.spp

    pix = torch.div(lane, spp, rounding_mode="floor")
    py = torch.div(pix, pw, rounding_mode="floor").to(torch.float32) - b
    px = (pix % pw).to(torch.float32) - b
    uni = lane_uniforms(seed, lane, 6)

    pos = torch.stack([px + uni[:, 0], py + uni[:, 1]], dim=-1)  # unpadded px coords
    o, d = camera.sample_ray(pos)

    rgb, valid, det, d1 = _sample_direct(scene, o, d, uni, cfg, mode)

    if mode == "primal" or cfg.debug_detach_splat:
        splat_pos = pos
        rw = torch.ones_like(det)
    else:
        # Re-evaluate the film position/importance with the attached
        # (reparameterized) direction
        it_p = o + d1
        splat_pos, imp = camera.project(it_p)
        rw = replace_grad(torch.ones_like(imp), imp / imp.detach())

    alpha = valid.to(rgb.dtype)
    weight_ch = replace_grad(torch.ones_like(det), det * rw)
    values = torch.cat([rgb * rw[..., None], alpha[..., None], weight_ch[..., None]], dim=-1)
    return splat(splat_pos, values, H, W, border=b)


def _padded_pixels(camera, cfg: RenderConfig):
    b = BORDER if cfg.sample_border else 0
    return (camera.resx + 2 * b) * (camera.resy + 2 * b), b


def lane_chunks(camera, cfg: RenderConfig, device, n_chunks: int | None = None,
                max_lanes: int = MAX_LANES):
    """The wavefront's global lane ids, cut into chunks: a list of (M,) int64
    tensors whose union is ``arange((W+2b)(H+2b)·spp)``.

    ``n_chunks=None`` picks the smallest divisor of ``spp`` that brings a
    chunk under ``max_lanes`` (one-sample chunks if none does); a given
    ``n_chunks`` must divide ``spp``.  The chunks are SPP-STRIDED — chunk c
    holds ALL pixels × sample slots ``[c·k, (c+1)·k)`` — so straggler pixels
    are mixed into every chunk.
    """
    npix, _ = _padded_pixels(camera, cfg)
    n = npix * cfg.spp
    if n_chunks is None:
        n_chunks = next(
            (c for c in range(1, cfg.spp + 1) if cfg.spp % c == 0 and n // c <= max_lanes),
            cfg.spp,
        )
    if cfg.spp % n_chunks != 0:
        raise ValueError(f"n_chunks={n_chunks} does not divide spp={cfg.spp}")
    if n_chunks == 1:
        return [torch.arange(n, dtype=torch.int64, device=device)]
    k = cfg.spp // n_chunks
    i = torch.arange(npix * k, dtype=torch.int64, device=device)
    base = torch.div(i, k, rounding_mode="floor") * cfg.spp + (i % k)
    return [base + c * k for c in range(n_chunks)]


def _view_camera(scene, view_idx, camera):
    if camera is not None:
        return camera
    return scene.cameras.view(view_idx if view_idx is not None else 0)


def render(scene, view_idx: int | None = None, seed=0, cfg: RenderConfig = RenderConfig(),
           mode="primal", camera=None, device=None):
    """Render one view as ONE wavefront → (H, W, 4) rgb+alpha image.

    ``mode='primal'`` gives the detached estimate; ``mode='grad'`` builds the
    differentiable estimator (reparameterized directions, attached film
    weights) whose backward pass carries the shape gradients.
    """
    return render_chunked(scene, view_idx, seed, cfg, mode, camera, n_chunks=1, device=device)


def render_chunked(scene, view_idx=0, seed=0, cfg: RenderConfig = RenderConfig(), mode="primal",
                   camera=None, n_chunks: int | None = None, max_lanes: int = MAX_LANES,
                   device=None):
    """Render with the wavefront split into lane chunks (:func:`lane_chunks`)
    to bound peak memory.  Matches :func:`render` up to float32 accumulation
    order (the same samples are splatted, grouped per chunk).

    In grad mode the graphs of all chunks stay alive until the caller's
    backward pass; the training loop instead back-propagates chunk by chunk
    (``opt/shape_opt._view_batch_loss_grads``).
    """
    device = resolve_device(device)
    scene.require_device(device)
    camera = _view_camera(scene, view_idx, camera)
    _, b = _padded_pixels(camera, cfg)
    block = None
    with torch.set_grad_enabled(mode != "primal" and torch.is_grad_enabled()):
        for lane in lane_chunks(camera, cfg, device, n_chunks, max_lanes):
            blk = render_lane_block(scene, camera, lane, seed, cfg, mode)
            block = blk if block is None else block + blk
        return develop(block, border=b)

