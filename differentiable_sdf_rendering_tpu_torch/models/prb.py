"""Path-replay backpropagation (PRB) integrator over SDFs.

Counterpart of the JAX package's ``models/prb.py`` (``sdf_prb_reparam``).
The estimator is built in two phases:

  1. a **detached path trace** (unrolled over ``max_depth``, under
     ``torch.no_grad``) that records per-bounce state: rays, hits, sampled
     NEE and BSDF directions, throughput β, MIS weights, Russian-roulette
     factors and the per-bounce radiance (Le + Lr_dir).  Its sphere traces
     are K1 and its detached normals K2 on the card;
  2. a **differential phase** that, per bounce k, rebuilds only the local
     attached terms

        Lo_k = (Le_k + Lr_dir_k + Lr_ind_k) · det_k + extra_k

     with the replayed suffix radiance L_{k+1} detached, the current ray's
     reparameterization det_k, the BSDF-ratio indirect term
     ``L · replace_grad(1, f / detach(f))`` and the adjacent-vertex
     ``extra`` boundary terms.

The image is ``replace_grad(L_primal, Σ Lo_k)``: the primal radiance, with
the summed per-vertex gradients.  Russian roulette starts at depth 5; every
depth is reparameterized unless ``warp.max_reparam_depth`` limits it.
"""

from __future__ import annotations

import math

import torch

from ..ops.interaction import compute_surface_interaction
from ..ops.mesh_intersect import mesh_intersect, mesh_intersect_full
from ..ops.sampling import cosine_hemisphere_pdf, mis_weight, square_to_cosine_hemisphere
from ..ops.trace import sphere_trace
from ..ops.vecmath import normalize, replace_grad
from ..ops.warp import reparameterize
from .integrator import _compute_si, _emitted_along, _emitter_pdf, _mesh_diffuse, _nee_sample

__all__ = ["sample_prb"]

_RR_DEPTH = 5


def _merged_intersect(scene, o, d, trace, active, maxt=math.inf):
    """Detached SDF trace merged with the scene's optional mesh by nearest t:
    ``(its_t, maux)``, ``maux`` None without a mesh.  ``maxt`` bounds the ray
    (distance-bounded shadow rays toward an area emitter).  Lanes off
    ``active`` are not traced (inf): every use of theirs is masked."""
    its_t = sphere_trace(scene.sdf, o, d, trace, maxt=maxt, active=active)
    if scene.mesh is None:
        return its_t, None
    mt, mn, malb, mmir = mesh_intersect_full(scene.mesh, o, d)
    mt = torch.where(mt <= maxt, mt, math.inf)
    return torch.minimum(its_t, mt), (mt, mn, malb, mmir)


def _mesh_masks(scene, is_mesh, maux):
    """``(is_diffuse_mesh, is_mirror)`` lanes: a single-material mesh puts all
    its lanes on one side; a ``"mixed"`` mesh splits them on the hit
    triangle's mirror bit."""
    if scene.mesh is None or scene.mesh.material == "diffuse":
        return is_mesh, torch.zeros_like(is_mesh)
    if scene.mesh.material == "mirror":
        return torch.zeros_like(is_mesh), is_mesh
    mir = is_mesh & maux[3]
    return is_mesh & ~mir, mir


def _bsdf_eval_pdf(scene, si, wo, is_dmesh, is_mirror, m_alb):
    """Material-blended BSDF eval and pdf: the SDF's BSDF, Lambertian with
    the hit triangle's albedo on diffuse-mesh lanes, zero on mirror lanes (a
    delta lobe has no density)."""
    val, pdf = scene.bsdf.eval_pdf(si, wo)
    if scene.mesh is not None:
        mval, mpdf = _mesh_diffuse(m_alb, wo)
        val = torch.where(is_dmesh[..., None], mval, val)
        pdf = torch.where(is_dmesh, mpdf, pdf)
        val = torch.where(is_mirror[..., None], 0.0, val)
        pdf = torch.where(is_mirror, 0.0, pdf)
    return val, pdf


def _bsdf_sample(scene, si, u2, is_dmesh, is_mirror, m_alb):
    """Material-blended BSDF sample → ``(wo_local, pdf, weight, delta)``.
    Mirror lanes continue in the local mirror direction with pdf 1 and the
    triangle's reflectance as weight, and are delta lanes; diffuse-mesh lanes
    are cosine-sampled with the albedo as weight."""
    wo, pdf, weight = scene.bsdf.sample(si, u2)
    delta = torch.full(pdf.shape, bool(scene.bsdf.delta), dtype=torch.bool, device=pdf.device)
    if scene.mesh is not None:
        wo_c = square_to_cosine_hemisphere(u2)
        pdf_c = cosine_hemisphere_pdf(wo_c)
        ok_d = is_dmesh & (si.wi[..., 2] > 0) & (pdf_c > 0)
        wo = torch.where(is_dmesh[..., None], wo_c, wo)
        pdf = torch.where(is_dmesh, torch.where(ok_d, pdf_c, 0.0), pdf)
        weight = torch.where(is_dmesh[..., None], torch.where(ok_d[..., None], m_alb, 0.0), weight)
        if scene.mesh.material != "diffuse":
            wi = si.wi
            wo_m = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], dim=-1)
            ok_m = is_mirror & (wi[..., 2] > 0)
            wo = torch.where(is_mirror[..., None], wo_m, wo)
            pdf = torch.where(is_mirror, torch.where(ok_m, 1.0, 0.0), pdf)
            weight = torch.where(is_mirror[..., None], torch.where(ok_m[..., None], m_alb, 0.0), weight)
            delta = delta | is_mirror
    return wo, pdf, weight, delta


@torch.no_grad()
def _trace_primal(scene, o, d, uni, cfg):
    """Detached path trace → ``(records, L)``: a list of per-bounce dicts and
    the primal radiance."""
    n = o.shape[:-1]
    kw = dict(dtype=o.dtype, device=o.device)
    recs = []
    beta = torch.ones(n + (3,), **kw)
    mis_em = torch.ones(n, **kw)
    active = torch.ones(n, dtype=torch.bool, device=o.device)
    ray_o, ray_d = o, d
    L = torch.zeros(n + (3,), **kw)

    for k in range(cfg.max_depth):
        u = uni[:, 6 + 8 * k: 6 + 8 * (k + 1)]
        its_t, maux = _merged_intersect(scene, ray_o, ray_d, cfg.trace, active)
        # Emitted radiance along the ray: the environment on escaped lanes,
        # the area emitter's front face where its (opaque) rect is nearest
        emitted, t_light = _emitted_along(scene, ray_o, ray_d)
        light_first = torch.isfinite(t_light) & (t_light < its_t)
        valid = torch.isfinite(its_t) & active & ~light_first
        si, is_mesh = _compute_si(scene, ray_o, ray_d, its_t, maux, differentiable=False)
        if is_mesh is None:
            is_mesh = torch.zeros_like(valid)
        is_dmesh, is_mirror = _mesh_masks(scene, is_mesh, maux)
        m_alb = maux[2] if maux is not None else torch.zeros(n + (3,), **kw)

        # Le: the emitter seen directly; the rect is opaque, so its lanes end
        see_emitted = active & (light_first | ~torch.isfinite(its_t))
        Le = torch.where(see_emitted[..., None], beta * mis_em[..., None] * emitted, 0.0)

        # NEE (none on mirror vertices: their eval is 0) through the env/area
        # mixture, with distance-bounded shadow rays
        active_em = valid & (k + 1 < cfg.max_depth) & ~is_mirror
        ds_d, ds_pdf, ds_rad, ds_dist = _nee_sample(scene, si.p, u[:, 0:2])
        shadow_maxt = torch.where(torch.isfinite(ds_dist), ds_dist * (1.0 - 1e-3) - cfg.shadow_eps, math.inf)
        em_o = si.p + ds_d * cfg.shadow_eps
        em_t, _ = _merged_intersect(scene, em_o, ds_d, cfg.trace, active_em, maxt=shadow_maxt)
        occluded = torch.isfinite(em_t)
        em_weight = torch.where((ds_pdf > 0)[..., None], ds_rad / torch.clamp_min(ds_pdf, 1e-12)[..., None], 0.0)
        bsdf_val_em, bsdf_pdf_em = _bsdf_eval_pdf(scene, si, si.to_local(ds_d), is_dmesh, is_mirror, m_alb)
        mis_direct = mis_weight(ds_pdf, bsdf_pdf_em)
        Lr_dir = torch.where((active_em & ~occluded)[..., None],
                             beta * mis_direct[..., None] * bsdf_val_em * em_weight, 0.0)

        # BSDF sampling (the mirror direction on mirror lanes)
        bs_wo, bs_pdf, bs_weight, bs_delta = _bsdf_sample(scene, si, u[:, 2:4], is_dmesh, is_mirror, m_alb)
        ray_next_d = si.to_world(bs_wo)
        ray_next_o = si.p + ray_next_d * cfg.shadow_eps

        L = L + Le + Lr_dir

        beta_next = beta * bs_weight
        beta_max = torch.amax(beta_next, dim=-1)
        active_next = valid & (k + 1 < cfg.max_depth) & (bs_pdf > 0) & (beta_max > 0)
        if k >= _RR_DEPTH:  # Russian roulette
            rr_prob = torch.clamp_max(beta_max, 0.95)
            beta_next = beta_next / torch.clamp_min(rr_prob, 1e-8)[..., None]
            active_next = active_next & (u[:, 4] < rr_prob)

        # MIS weight of the next vertex's emitted radiance (the emitter
        # mixture's pdf of the BSDF direction); 1 after a delta lobe
        pdf_em_next = _emitter_pdf(scene, ray_next_o, ray_next_d)
        mis_em_next = torch.where(bs_delta, 1.0, mis_weight(bs_pdf, pdf_em_next))

        recs.append(dict(
            ray_o=ray_o, ray_d=ray_d, its_t=its_t, valid=valid, active=active, see_emitted=see_emitted,
            beta=beta, mis_em=mis_em, Le=Le, Lr_dir=Lr_dir, ds_d=ds_d, em_weight=em_weight, occluded=occluded,
            shadow_maxt=shadow_maxt, active_em=active_em, bs_wo=bs_wo, bs_pdf=bs_pdf, bs_weight=bs_weight,
            mis_direct=mis_direct, is_dmesh=is_dmesh, is_mirror=is_mirror, m_alb=m_alb, si=si,
        ))
        ray_o, ray_d = ray_next_o, ray_next_d
        beta, mis_em, active = beta_next, mis_em_next, active_next

    return recs, L


def _suffix_radiance(recs):
    """``L_k = Σ_{j≥k} (Le_j + Lr_dir_j)``, detached (the replayed value)."""
    out = [None] * len(recs)
    acc = torch.zeros_like(recs[0]["Le"])
    for k in reversed(range(len(recs))):
        acc = acc + recs[k]["Le"] + recs[k]["Lr_dir"]
        out[k] = acc
    return out


def _attached_si(scene, ray_o, d_rep, r):
    """Attached merged surface interaction of the differential phase: the SDF
    interaction re-attaches t through the implicit-function theorem; lanes
    whose primal hit was the mesh take the Möller–Trumbore hit of the
    reparameterized ray (attached through the ray, the geometry fixed) in
    the recorded normal frame."""
    si = compute_surface_interaction(scene.sdf, ray_o, d_rep, r["its_t"])
    if scene.mesh is None:
        return si
    is_m = r["is_dmesh"] | r["is_mirror"]
    mt, _ = mesh_intersect(scene.mesh, ray_o, d_rep)
    # the recorded t where the attached ray (numerically) misses the
    # triangle it hit; 1.0 on other lanes, whose fields the select drops
    # (it keeps inf·0 out of the position)
    t_m = torch.where(torch.isfinite(mt), mt, r["its_t"])
    t_m = torch.where(is_m & torch.isfinite(t_m), t_m, 1.0)
    si_rec = r["si"]
    si_m = si_rec.replace(t=t_m, p=ray_o + t_m[..., None] * d_rep, wi=si_rec.to_local(-d_rep))
    return si_m.where(is_m, si)


def _ratio(val):
    """``replace_grad(1, val / max(detach(val), 1e-12))``: the replay's
    BSDF-ratio factor, 1 in value."""
    return replace_grad(torch.ones_like(val), val / torch.clamp_min(val.detach(), 1e-12))


def sample_prb(scene, o, d, uni, cfg, mode):
    """PRB sample function of the integrator registry → ``(rgb, valid,
    det_primary, d_primary)``.  In grad mode the rgb carries the per-vertex
    attached terms.  Hybrid scenes take diffuse, mirror or mixed meshes."""
    recs, L_primal = _trace_primal(scene, o, d, uni, cfg)
    valid_ray = recs[0]["valid"] | recs[0]["see_emitted"] | (not cfg.hide_emitters)
    if mode == "primal":
        return L_primal, valid_ray, torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device), d

    Lsuf = _suffix_radiance(recs)
    n_b = len(recs)
    use_warp = cfg.use_warp and cfg.warp_kind != "dummy"
    max_rd = cfg.warp.max_reparam_depth
    # shadow rays are reparameterized at the static depth 1
    reparam_shadow = use_warp and (max_rd < 0 or 1 <= max_rd)
    result = torch.zeros_like(L_primal)
    det0 = d1_primary = si_prev = None

    for k in range(n_b):
        r = recs[k]
        first = k == 0

        # reparameterize the current ray, from the attached previous vertex
        if use_warp and (max_rd < 0 or k <= max_rd):
            if first:
                ray_o_att = r["ray_o"]
            else:
                ray_o_att = si_prev.p + r["ray_d"] * cfg.shadow_eps
                ray_o_att = torch.where(torch.isfinite(ray_o_att), ray_o_att, r["ray_o"])
            _, d_rep, det_k = reparameterize(scene.sdf, ray_o_att, r["ray_d"], cfg.warp, cfg.trace,
                                             active=r["active"])
        else:
            d_rep = r["ray_d"]
            det_k = torch.ones(o.shape[:-1], dtype=o.dtype, device=o.device)
        if first:
            det0, d1_primary = det_k, d_rep

        si_cur = _attached_si(scene, r["ray_o"], d_rep, r)

        # Le along the attached direction: its silhouette gradient rides det_k
        emitted_att, _ = _emitted_along(scene, r["ray_o"] if first else si_prev.p.detach(), d_rep)
        Le = torch.where(r["see_emitted"][..., None], r["beta"] * r["mis_em"][..., None] * emitted_att, 0.0)

        # NEE with the reparameterized, distance-bounded shadow ray
        em_o = si_cur.p + r["ds_d"] * cfg.shadow_eps
        if reparam_shadow:
            _, _, em_det = reparameterize(scene.sdf, em_o, r["ds_d"], cfg.warp, cfg.trace, maxt=r["shadow_maxt"],
                                          active=r["active_em"] & ~r["occluded"])
        else:
            em_det = torch.ones_like(det_k)
        bsdf_value_em, _ = _bsdf_eval_pdf(scene, si_cur, si_cur.to_local(r["ds_d"]), r["is_dmesh"], r["is_mirror"],
                                          r["m_alb"])
        Lr_dir = torch.where((r["active_em"] & ~r["occluded"])[..., None],
                             r["beta"] * r["mis_direct"][..., None] * bsdf_value_em * r["em_weight"]
                             * em_det[..., None], 0.0)

        # indirect: the BSDF-ratio replay term; on mirror lanes eval ≡ 0, so
        # the ratio is 1 with no derivative and L_next rides det_k alone
        if k + 1 < n_b:
            ray_next_d = si_cur.to_world(r["bs_wo"]).detach()
            bsdf_val, _ = _bsdf_eval_pdf(scene, si_cur, si_cur.to_local(ray_next_d), r["is_dmesh"], r["is_mirror"],
                                         r["m_alb"])
            bsdf_val_det = r["bs_weight"] * r["bs_pdf"][..., None]
            inv_det = torch.where(bsdf_val_det != 0, 1.0 / torch.clamp_min(bsdf_val_det, 1e-12), 0.0)
            Lr_ind = Lsuf[k + 1] * replace_grad(torch.ones_like(bsdf_val), inv_det * bsdf_val)
        else:
            Lr_ind = torch.zeros_like(Le)

        # adjacent-vertex 'extra' boundary terms.  The next vertex's emitted
        # radiance re-attached through the incident direction is 0 in
        # derivative for both emitter kinds (the environment depends on the
        # detached escaped direction only, the area light's radiance is a
        # constant), so only the two BSDF ratios remain.
        extra = torch.zeros_like(Le)
        if k + 1 < n_b:
            # the next vertex's BSDF with wi toward the attached si_cur.p, at
            # a fresh detached sample (u[6:8] of the row)
            r_next = recs[k + 1]
            si_next = r_next["si"]
            u_fresh = uni[:, 6 + 8 * k + 6: 6 + 8 * k + 8].detach()
            bs_wo_next, bs_pdf_next, _, _ = _bsdf_sample(scene, si_next, u_fresh, r_next["is_dmesh"],
                                                         r_next["is_mirror"], r_next["m_alb"])
            si_next_att = si_next.replace(wi=si_next.to_local(normalize(si_cur.p - si_next.p)))
            bsdf_val_next, _ = _bsdf_eval_pdf(scene, si_next_att, bs_wo_next, r_next["is_dmesh"],
                                              r_next["is_mirror"], r_next["m_alb"])
            L_nn = Lsuf[k + 2] if k + 2 < n_b else torch.zeros_like(Le)
            extra = extra + torch.where((r_next["valid"] & (bs_pdf_next > 0))[..., None],
                                        L_nn * _ratio(bsdf_val_next), 0.0)
        if not first:
            # the previous vertex's BSDF with wo toward the attached si_cur.p
            r_prev = recs[k - 1]
            si_prev_det = si_prev.detach()
            wo_prev_w = normalize(si_cur.p - si_prev_det.p)
            bsdf_val_prev, _ = _bsdf_eval_pdf(scene, si_prev_det, si_prev_det.to_local(wo_prev_w),
                                              r_prev["is_dmesh"], r_prev["is_mirror"], r_prev["m_alb"])
            extra = extra + torch.where(r["valid"][..., None], Lsuf[k] * _ratio(bsdf_val_prev), 0.0)

        Lo = (Le + Lr_dir + Lr_ind) * det_k[..., None] + extra
        result = result + torch.where(r["active"][..., None], Lo, 0.0)
        # si_cur stays attached: the next bounce reparameterizes from it
        si_prev = si_cur

    # the per-vertex terms carry ratio factors of value 1, so their sum
    # over-counts radiance; the film sees the primal L with their gradients
    result = replace_grad(L_primal, result)
    return torch.where(valid_ray[..., None], result, 0.0), valid_ray, det0, d1_primary
