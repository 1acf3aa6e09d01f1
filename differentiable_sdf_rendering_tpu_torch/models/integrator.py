"""The reparameterized integrators and the wavefront render pipeline.

Counterpart of the JAX package's ``models/integrator.py``: one wavefront of
``(W+2b)·(H+2b)·spp`` ray lanes per (view, mode), with

  * primal mode — fast non-diff sphere trace, detached splat positions,
  * grad mode   — warp-field reparameterized directions, attached
    determinants, attached film-position/filter-weight reweighting.

Integrators, by name:
  * ``sdf_silhouette_reparam``     — binary coverage × det
  * ``sdf_simple_shading_reparam`` — n·l debug shading × det
  * ``sdf_direct_reparam``         — direct illumination with detached NEE,
    reparameterized shadow rays at depth 1, optional MIS BSDF sampling;
  * ``sdf_prb_reparam``            — path-replay backpropagation over
    ``max_depth`` bounces (``models/prb.py``).
Scenes may add a triangle mesh (merged with the SDF by nearest t; mirror
triangles get one specular bounce) and an area emitter at a finite position.
``warp_kind`` is 'warp' (the warp field), 'conv' (the convolution-warp
baseline, ``ops/warp_conv.py``: each reparameterized ray draws its own block
of auxiliary-ray uniforms) or 'dummy'.

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
from ..ops.interaction import compute_surface_interaction, coordinate_frame
from ..ops.mesh_intersect import mesh_intersect_full
from ..ops.sampling import lane_uniforms, mis_weight
from ..ops.sdf import TraceParams
from ..ops.trace import sphere_trace, sphere_trace_warp
from ..ops.vecmath import normalize, replace_grad
from ..ops.warp import WarpConfig, reparameterize, warp_eval
from ..ops.warp_conv import ConvWarpConfig, conv_reparameterize

__all__ = [
    "RenderConfig", "MAX_LANES", "lane_chunks", "render_lane_block", "render", "render_chunked", "render_aovs",
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
    # 'warp' (ours) | 'conv' (Bangaru et al. baseline) | 'dummy'
    warp_kind: str = "warp"
    conv: ConvWarpConfig = ConvWarpConfig()
    # mirrored pixel-jitter pairs within a pixel
    antithetic_sampling: bool = False


def _check_supported(cfg: RenderConfig):
    if cfg.integrator not in _INTEGRATORS:
        raise NotImplementedError(f"integrator '{cfg.integrator}' is not ported")
    if cfg.integrator == "sdf_prb_reparam" and cfg.warp_kind == "conv":
        # the JAX package refuses this pair too: the conv baseline goes with
        # the direct integrator only
        raise NotImplementedError("warp_kind='conv' is not supported by sdf_prb_reparam")
    if cfg.warp_kind not in ("warp", "conv", "dummy"):
        raise NotImplementedError(f"warp_kind '{cfg.warp_kind}' is not ported")


def _ray_intersect(scene, o, d, depth, cfg: RenderConfig, mode, maxt=math.inf, occlusion=False, uni_conv=None):
    """Hybrid intersect: the SDF trace merged with the scene's optional
    :class:`TriangleMesh` by nearest t.  Returns ``(its_t, d_reparam, det,
    mesh_aux)``, where ``mesh_aux`` is None for a pure-SDF scene and
    ``(mesh_t, mesh_n, mesh_albedo, mesh_mirror)`` otherwise.  ``maxt``
    bounds the ray (finite-distance shadow rays to an area emitter).

    ``occlusion=True`` marks a binary visibility query: the intersection
    refinement is skipped (it moves ``its_t`` by O(ε) but never flips
    finite↔inf, and ``isfinite(its_t)`` is the only consumed bit).  A
    per-lane bool tensor masks the refinement per lane instead, so that one
    trace carries shadow and scattering rays together.

    Under ``warp_kind='conv'`` a reparameterized ray is traced plainly and
    its direction reparameterized by :func:`conv_reparameterize` with the
    auxiliary uniforms ``uni_conv`` (N, 2·n_aux_rays)."""
    trace = cfg.trace
    refine_active = True
    if isinstance(occlusion, torch.Tensor):
        refine_active = ~occlusion
    elif occlusion and trace.refine_intersection:
        trace = dataclasses.replace(trace, refine_intersection=False)
    reparam = mode != "primal" and cfg.use_warp and cfg.warp_kind != "dummy"
    if reparam and cfg.warp.max_reparam_depth >= 0 and depth > cfg.warp.max_reparam_depth:
        reparam = False
    if not reparam:
        its_t = sphere_trace(scene.sdf, o, d, trace, maxt=maxt, refine_active=refine_active)
        d1, det = d, torch.ones(its_t.shape, dtype=o.dtype, device=o.device)
    elif cfg.warp_kind == "conv":
        its_t = sphere_trace(scene.sdf, o, d, trace, maxt=maxt)
        u = uni_conv.reshape(uni_conv.shape[:-1] + (cfg.conv.n_aux_rays, 2))
        d1, det = conv_reparameterize(scene.sdf, o, d, u, cfg.conv, trace)
    else:
        its_t, d1, det = reparameterize(scene.sdf, o, d, cfg.warp, trace, maxt=maxt, refine_active=refine_active)
    if scene.mesh is None:
        return its_t, d1, det, None
    # Intersect the *reparameterized* ray: mesh radiance seen past a moving
    # SDF silhouette then carries the boundary gradient through d1.
    maux = mesh_intersect_full(scene.mesh, o, d1)
    return torch.minimum(its_t, maux[0]), d1, det, maux


def _compute_si(scene, o, d1, its_t, maux, differentiable):
    """Surface interaction of the merged hit: the SDF's, overridden on the
    lanes whose nearest hit is the mesh (geometric mesh normal, hit point
    attached through d1 and the Möller–Trumbore t).  Returns
    ``(si, is_mesh)``, ``is_mesh`` None without a mesh."""
    si = compute_surface_interaction(scene.sdf, o, d1, its_t, differentiable=differentiable)
    if maux is None:
        return si, None
    mt, mn = maux[0], maux[1]
    is_mesh = torch.isfinite(mt) & (mt <= its_t)
    t_m = torch.where(is_mesh, mt, torch.zeros_like(mt))
    p_m = o + t_m[..., None] * d1
    s_m, b_m = coordinate_frame(mn.detach())
    m3 = is_mesh[..., None]
    si = si.replace(
        valid=si.valid | is_mesh,
        t=torch.where(is_mesh, t_m, si.t),
        p=torch.where(m3, p_m, si.p),
        n=torch.where(m3, mn, si.n),
        s=torch.where(m3, s_m, si.s),
        b=torch.where(m3, b_m, si.b),
    )
    # wi lives in the local frame: recompute it in the overridden one
    return si.replace(wi=torch.where(m3, si.to_local(-d1), si.wi)), is_mesh


def _mesh_diffuse(albedo, wo_local):
    """Lambertian eval and pdf of an auxiliary-mesh surface; ``albedo`` is
    the per-lane (N, 3) reflectance of the hit triangle."""
    cos = torch.clamp_min(wo_local[..., 2], 0.0)
    return albedo * (cos / math.pi)[..., None], cos / math.pi


def _conv_uni(uni, cfg: RenderConfig, depth: int):
    """The auxiliary-ray uniforms of the conv reparameterization at ``depth``
    (0 primary, 1 NEE shadow, 2 MIS BSDF ray): 2·n_aux_rays columns after
    the first 6; None for the other warp kinds."""
    if cfg.warp_kind != "conv":
        return None
    n = 2 * cfg.conv.n_aux_rays
    return uni[:, 6 + depth * n: 6 + (depth + 1) * n]


def _sample_silhouette(scene, o, d, uni, cfg, mode):
    """Binary coverage × det."""
    its_t, d1, det, _ = _ray_intersect(scene, o, d, 0, cfg, mode, uni_conv=_conv_uni(uni, cfg, 0))
    hit = torch.isfinite(its_t).to(o.dtype)
    rgb = (hit * det)[..., None].expand(hit.shape + (3,))
    return rgb, torch.ones_like(hit, dtype=torch.bool), det, d1


def _sample_simple_shading(scene, o, d, uni, cfg, mode):
    """Headlight-free debug shading: max(n · normalize(1, 1, 1), 0) × det."""
    its_t, d1, det, maux = _ray_intersect(scene, o, d, 0, cfg, mode, uni_conv=_conv_uni(uni, cfg, 0))
    si, _ = _compute_si(scene, o, d1, its_t, maux, differentiable=mode != "primal")
    l_dir = normalize(torch.ones(3, dtype=o.dtype, device=o.device))
    shade = torch.clamp_min(torch.sum(si.n * l_dir, -1), 0.0)
    shade = torch.where(si.valid, shade, torch.zeros_like(shade))
    rgb = (shade * det)[..., None].expand(shade.shape + (3,))
    return rgb, torch.ones_like(shade, dtype=torch.bool), det, d1


def _emitted_along(scene, p, d):
    """Emitted radiance arriving at ``p`` from direction ``d`` and the
    distance of the nearest emitter-geometry hit (inf = none).  The area
    emitter's rect is opaque geometry whose front face emits; past it, or
    with no rect, the environment is seen."""
    env = scene.emitter.eval(d)
    if scene.area_emitter is None:
        return env, torch.full(d.shape[:-1], math.inf, dtype=d.dtype, device=d.device)
    area = scene.area_emitter
    t_geo = area.occlude_t(p, d)
    t_front = area.ray_hit(p, d)
    rad = torch.where(
        torch.isfinite(t_front)[..., None], area.radiance.expand(env.shape),
        torch.where(torch.isfinite(t_geo)[..., None], torch.zeros_like(env), env),
    )
    return rad, t_geo


def _area_select_prob(scene):
    """Probability of picking the area emitter in the NEE mixture: in
    proportion to the emitters' approximate power, clipped to [0.02, 0.98]
    so that both components keep a density wherever they carry radiance
    (unbiased MIS weights); detached."""
    pa = scene.area_emitter.power_proxy()
    pe = scene.emitter.power_proxy()
    p = pa / torch.clamp_min(pa + pe, 1e-12)
    return torch.clamp(p, 0.02, 0.98).detach()


def _emitter_pdf(scene, p, d):
    """Solid-angle density of :func:`_nee_sample` at ``p`` producing ``d``."""
    pdf = scene.emitter.pdf_direction(d)
    if scene.area_emitter is None:
        return pdf
    p_area = _area_select_prob(scene)
    return (1.0 - p_area) * pdf + p_area * scene.area_emitter.pdf_direction_from(p, d)


def _nee_sample(scene, p, u2):
    """Sample an emitter direction from ``p``: ``(d, pdf, radiance, maxt)``
    with ``maxt`` the distance to the emitter surface that bounds the shadow
    ray (inf for environment directions).  With an environment and an area
    emitter, a power-proportional mixture (:func:`_area_select_prob`)
    whose selector uniform is re-stretched for reuse."""
    if scene.area_emitter is None:
        d, pdf, rad = scene.emitter.sample_direction(u2)
        return d, pdf, rad, torch.full(pdf.shape, math.inf, dtype=pdf.dtype, device=pdf.device)
    p_area = _area_select_prob(scene)
    pick_area = u2[..., 0] < p_area
    u0 = torch.where(pick_area, u2[..., 0] / p_area, (u2[..., 0] - p_area) / (1.0 - p_area))
    u = torch.stack([torch.clamp(u0, 0.0, 1.0), u2[..., 1]], -1)
    d_env, _, _ = scene.emitter.sample_direction(u)
    d_area, _, _, _ = scene.area_emitter.sample_from(p, u)
    d = torch.where(pick_area[..., None], d_area, d_env)
    pdf = _emitter_pdf(scene, p, d)
    rad, t_geo = _emitted_along(scene, p, d)
    return d, pdf, rad, t_geo


def _mirror_rays(si, o, d1, is_mirror, cfg: RenderConfig):
    """The rays that leave the ``is_mirror`` lanes, ``(o_r, d_r)``: ``d1``
    reflected about the hit's normal (on a mirror lane, the fixed facet
    normal), starting ``shadow_eps`` off the hit; other lanes keep
    ``(o, d1)``."""
    mirror3 = is_mirror[..., None]
    d_r = d1 - 2.0 * torch.sum(d1 * si.n, -1, keepdim=True) * si.n
    return torch.where(mirror3, si.p + d_r * cfg.shadow_eps, o), torch.where(mirror3, d_r, d1)


def _mirror_bounce(scene, o, d1, its_t, det, si, is_mesh, maux, cfg, mode):
    """One specular bounce: lanes whose nearest hit is a mirror triangle
    continue along the reflected ray.  The depth-1 re-intersect is itself
    reparameterized, so silhouette gradients of the SDF seen in the mirror
    flow through the reflected direction.  Returns the merged ``(si, its_t,
    o, dl, det, tint, is_mesh)``, ``dl`` the direction of the emitted-
    radiance lookup; a second mesh hit seen in the mirror absorbs."""
    if cfg.decouple_reparam:
        raise NotImplementedError("mirror scenes with decouple_reparam are not supported")
    if cfg.warp_kind == "conv":
        # the JAX package refuses this pair too
        raise NotImplementedError("mirror scenes are not supported with warp_kind='conv'")
    is_mirror = is_mesh & maux[3]
    mirror3 = is_mirror[..., None]
    o_r, d_r = _mirror_rays(si, o, d1, is_mirror, cfg)
    t2, d2, det2, maux2 = _ray_intersect(scene, o_r, d_r, 1, cfg, mode)
    si2, is_mesh2 = _compute_si(scene, o_r, d2, t2, maux2,
                                differentiable=mode != "primal" and not cfg.debug_nondiff_si)
    return (
        si2.replace(valid=si2.valid & ~is_mesh2).where(is_mirror, si),
        torch.where(is_mirror, t2, its_t),
        torch.where(mirror3, o_r, o),
        torch.where(mirror3, d2, d1),
        det * torch.where(is_mirror, det2, torch.ones_like(det2)),
        torch.where(mirror3, maux[2], torch.ones_like(maux[2])),
        is_mesh & ~is_mirror,
    )


def _sample_direct(scene, o, d, uni, cfg: RenderConfig, mode):
    """Direct illumination with NEE, a reparameterized shadow ray at depth 1,
    optional MIS BSDF sampling and, on a scene with mirror triangles, one
    specular bounce.  Returns ``(rgb, valid_ray, det, d1)``."""
    reparametrize = mode != "primal"
    its_t, d1, det, maux = _ray_intersect(scene, o, d, 0, cfg, mode, uni_conv=_conv_uni(uni, cfg, 0))
    si, is_mesh = _compute_si(scene, o, d1, its_t, maux,
                              differentiable=reparametrize and not cfg.debug_nondiff_si)
    if cfg.debug_detach_normals:
        si = si.replace(n=si.n.detach(), wi=si.wi.detach())

    tint = torch.ones(o.shape[:-1] + (3,), dtype=o.dtype, device=o.device)
    m_alb = maux[2] if maux is not None else None
    dl = d1  # direction of the emitted-radiance lookup
    if scene.mesh is not None and scene.mesh.material != "diffuse":
        si, its_t, o, dl, det, tint, is_mesh = _mirror_bounce(scene, o, d1, its_t, det, si, is_mesh, maux, cfg,
                                                              mode)
        if scene.mesh.material == "mirror":
            maux = m_alb = None  # no Lambertian mesh lane is left

    throughput = det[..., None] * tint  # reparam det × mirror tint
    # Emitted radiance seen by the (possibly mirror-reflected) ray: the
    # environment on escaped lanes, the area emitter's front face where its
    # rect is the nearest hit (attached direction → silhouette gradients of
    # the background)
    emitted, t_light = _emitted_along(scene, o, dl)
    light_first = torch.isfinite(t_light) & (t_light < its_t)
    shade = si.valid & ~light_first  # surface shading where the SDF/mesh hit is nearest
    see_emitted = light_first | ~si.valid
    valid_ray = si.valid | light_first
    if cfg.hide_emitters:
        see_emitted = torch.zeros_like(see_emitted)
    else:
        valid_ray = torch.ones_like(valid_ray)
    result = torch.where(see_emitted[..., None], emitted, torch.zeros_like(emitted)) * throughput

    # ---------------- Emitter sampling (detached) ----------------
    si_p_det = si.p.detach()
    ds_d, ds_pdf, ds_rad, ds_dist = (x.detach() for x in _nee_sample(scene, si_p_det, uni[:, 2:4].detach()))
    active_e = shade & (ds_pdf > 0)
    if cfg.detach_indirect_si:
        shadow_o = si_p_det
    elif cfg.decouple_reparam:
        # spawn from the interaction of the *unreparameterized* ray: p
        # attached through the implicit depth but not the warped direction
        shadow_o = compute_surface_interaction(scene.sdf, o, d, its_t, differentiable=reparametrize).p
    else:
        shadow_o = si.p  # attached: nested reparameterization
    shadow_o = shadow_o + ds_d * cfg.shadow_eps
    # Finite-distance shadow ray: stop just short of the emitter sample;
    # inf for environment directions.
    shadow_maxt = torch.where(torch.isfinite(ds_dist), ds_dist * (1.0 - 1e-3) - cfg.shadow_eps,
                              torch.full_like(ds_dist, math.inf))

    if cfg.use_mis:
        si_det = si.detach()
        bs_wo, bs_pdf, bs_weight = scene.bsdf.sample(si_det, uni[:, 4:6].detach())
        bsdf_d = si_det.to_world(bs_wo).detach()
        bsdf_o = si.p + bsdf_d * cfg.shadow_eps
    if cfg.use_mis and cfg.warp_kind != "conv":
        # The shadow rays and the BSDF-sampled rays go through one depth-1
        # trace of 2N lanes, as in the JAX package: a lane's result does not
        # depend on the lanes beside it, and the occlusion mask keeps the
        # refinement off the shadow half.
        n_l = shadow_o.shape[0]
        t_m, d_m, det_m, _ = _ray_intersect(
            scene, torch.cat([shadow_o, bsdf_o]), torch.cat([ds_d, bsdf_d]), 1, cfg, mode,
            maxt=torch.cat([shadow_maxt, torch.full_like(shadow_maxt, math.inf)]),
            occlusion=torch.cat([torch.ones(n_l, dtype=torch.bool, device=o.device),
                                 torch.zeros(n_l, dtype=torch.bool, device=o.device)]),
        )
        occluded_t, det_e = t_m[:n_l], det_m[:n_l]
        t_b, d_b, det_b = t_m[n_l:], d_m[n_l:], det_m[n_l:]
    else:
        # conv keeps two calls: each reparameterization has its own block of
        # auxiliary uniforms
        occluded_t, _, det_e, _ = _ray_intersect(scene, shadow_o, ds_d, 1, cfg, mode, maxt=shadow_maxt,
                                                 occlusion=True, uni_conv=_conv_uni(uni, cfg, 1))
        if cfg.use_mis:
            t_b, d_b, det_b, _ = _ray_intersect(scene, bsdf_o, bsdf_d, 1, cfg, mode, uni_conv=_conv_uni(uni, cfg, 2))
    visibility = (~torch.isfinite(occluded_t)).to(o.dtype)

    wo = si.to_local(ds_d)
    emitter_val = torch.where(active_e[..., None], ds_rad / torch.clamp_min(ds_pdf, 1e-12)[..., None],
                              torch.zeros_like(ds_rad))
    if cfg.use_mis:
        bsdf_val, bsdf_pdf = scene.bsdf.eval_pdf(si, wo)
        if maux is not None:
            mesh_val, mesh_pdf = _mesh_diffuse(m_alb, wo)
            bsdf_val = torch.where(is_mesh[..., None], mesh_val, bsdf_val)
            bsdf_pdf = torch.where(is_mesh, mesh_pdf, bsdf_pdf)
        nee = visibility[..., None] * bsdf_val * emitter_val * mis_weight(ds_pdf, bsdf_pdf.detach())[..., None]
    else:
        bsdf_val = scene.bsdf.eval(si, wo)
        if maux is not None:
            bsdf_val = torch.where(is_mesh[..., None], _mesh_diffuse(m_alb, wo)[0], bsdf_val)
        nee = visibility[..., None] * bsdf_val * emitter_val
    nee_throughput = throughput.detach() if cfg.debug_detach_nee_throughput else throughput
    contrib = nee_throughput * nee * det_e[..., None]
    result = result + torch.where(active_e[..., None], contrib, torch.zeros_like(contrib))

    # ---------------- BSDF sampling (MIS) ----------------
    if cfg.use_mis:
        active_b = shade & (bs_pdf > 0)
        bsdf_val = scene.bsdf.eval(si, bs_wo)
        if maux is not None:
            # mesh lanes: the Lambertian f of the mesh albedo; bs_pdf stays
            # the sampler's own pdf, so the estimator remains unbiased
            bsdf_val = torch.where(is_mesh[..., None], _mesh_diffuse(m_alb, bs_wo)[0], bsdf_val)
        # emitted radiance the BSDF ray reaches: the environment if it
        # escapes the SDF and mesh, the area emitter if its rect is nearest
        L_b, t_light_b = _emitted_along(scene, bsdf_o.detach(), d_b)
        reach_emitter = torch.where(torch.isfinite(t_light_b), t_light_b < t_b, ~torch.isfinite(t_b))
        if scene.bsdf.delta:
            # a delta lobe: eval ≡ 0, the value is in the sample weight, and
            # emitter sampling cannot produce its direction → MIS weight 1
            contrib = bs_weight * L_b
        else:
            w_mis_b = mis_weight(bs_pdf, _emitter_pdf(scene, bsdf_o.detach(), bsdf_d))
            contrib = bsdf_val / torch.clamp_min(bs_pdf, 1e-12)[..., None] * L_b * w_mis_b[..., None]
        contrib = throughput * contrib * det_b[..., None]
        result = result + torch.where((active_b & reach_emitter)[..., None], contrib, torch.zeros_like(contrib))

    result = torch.where(valid_ray[..., None], result, torch.zeros_like(result))
    return result, valid_ray, det, d1


def _sample_prb(scene, o, d, uni, cfg, mode):
    from .prb import sample_prb

    return sample_prb(scene, o, d, uni, cfg, mode)


_INTEGRATORS = {
    "sdf_silhouette_reparam": _sample_silhouette,
    "sdf_simple_shading_reparam": _sample_simple_shading,
    "sdf_direct_reparam": _sample_direct,
    "sdf_prb_reparam": _sample_prb,
}


def n_uniforms(cfg: RenderConfig, mode="grad") -> int:
    """Uniforms a lane draws: 6 (pixel jitter, NEE, BSDF), 8 more a bounce
    for PRB, and under the conv warp in grad mode 2·n_aux_rays for each
    reparameterized ray (the primary and the NEE shadow ray, and the MIS
    BSDF ray).  Each column is keyed by its own counter, so the first 6 are
    the same for every integrator, warp kind and mode; a primal render,
    which reparameterizes nothing, does not draw the auxiliary rays'
    columns."""
    n = 6 + (8 * cfg.max_depth if cfg.integrator == "sdf_prb_reparam" else 0)
    if cfg.warp_kind == "conv" and mode != "primal":
        n += (6 if cfg.use_mis else 4) * cfg.conv.n_aux_rays
    return n


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
    uni = lane_uniforms(seed, lane, n_uniforms(cfg, mode))

    jx, jy = uni[:, 0], uni[:, 1]
    if cfg.antithetic_sampling:
        # Mirrored jitter pairs within a pixel: sample s pairs with s^1 and
        # the odd one takes 1 - its partner's jitter; with an odd spp the
        # last sample of a pixel has no partner and stays as drawn.
        s_idx = lane % spp
        partner_s = torch.where((s_idx ^ 1) < spp, s_idx ^ 1, s_idx)
        partner = lane_uniforms(seed, lane - s_idx + partner_s, 2)
        odd = (s_idx & 1) == 1
        jx = torch.where(odd, 1.0 - partner[:, 0], jx)
        jy = torch.where(odd, 1.0 - partner[:, 1], jy)
    pos = torch.stack([px + jx, py + jy], dim=-1)  # unpadded px coords
    o, d = camera.sample_ray(pos)

    rgb, valid, det, d1 = _INTEGRATORS[cfg.integrator](scene, o, d, uni, cfg, mode)

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


@torch.no_grad()
def render_aovs(scene, view_idx=0, seed=0, cfg: RenderConfig = RenderConfig(), camera=None, device=None):
    """Diagnostic AOV images of one view, a dict of (H, W) tensors (mean
    over ``cfg.spp`` samples a pixel, no border): depth, warp_t, weight_sum,
    trace iteration count, warp divergence, the SDF value at the warp point,
    the normal and ∂warp_t/∂d."""
    device = resolve_device(device)
    scene.require_device(device)
    camera = _view_camera(scene, view_idx, camera)
    W, H = camera.resx, camera.resy
    lane = torch.arange(W * H * cfg.spp, dtype=torch.int64, device=device)
    pix = torch.div(lane, cfg.spp, rounding_mode="floor")
    py = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    px = (pix % W).to(torch.float32)
    uni = lane_uniforms(seed, lane, 2)
    o, d = camera.sample_ray(torch.stack([px + uni[:, 0], py + uni[:, 1]], dim=-1))

    res = sphere_trace_warp(scene.sdf, o, d, cfg.trace)
    warp_ok = torch.isfinite(res.warp_t)
    x = o + torch.where(warp_ok, res.warp_t, torch.zeros_like(res.warp_t))[..., None] * d
    _, div = warp_eval(scene.sdf, x, d, res.warp_t, res.warp_t_d, cfg.warp,
                       warp_weight_mult=res.warp_weight, warp_weight_mult_d=res.warp_weight_d)
    si = compute_surface_interaction(scene.sdf, o, d, res.its_t, differentiable=False)
    f_warp = scene.sdf.eval(torch.where(warp_ok[..., None], x, torch.full_like(x, 0.5)))

    def img(v):
        v = torch.where(torch.isfinite(v), v, torch.zeros_like(v))
        return v.reshape(H, W, cfg.spp).mean(-1)

    return {
        "depth": img(res.its_t),
        "warp_t": img(res.warp_t),
        "weight_sum": img(res.weight_sum),
        "i": img(res.num_steps.to(torch.float32)),
        "div": img(div),
        "sdf_value": img(f_warp),
        "nx": img(si.n[..., 0]),
        "ny": img(si.n[..., 1]),
        "nz": img(si.n[..., 2]),
        "warp_t_dx": img(res.warp_t_d[..., 0]),
        "warp_t_dy": img(res.warp_t_d[..., 1]),
        "warp_t_dz": img(res.warp_t_d[..., 2]),
    }
