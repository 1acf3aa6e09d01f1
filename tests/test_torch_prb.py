"""Path-replay backpropagation (``sdf_prb_reparam``) of the port vs the JAX
package: images and grid VJPs on the pure-SDF ``bunny`` rig (the main path's
scene) and on the hybrid rigs, the uniforms PRB draws, the port's own
estimator checks (depth 2 ≡ direct with MIS, more bounces add light, the
grad-mode image's value), and the ``warpprb`` / ``warpprbprimary`` methods
through ``optimize_shape`` and ``optimize_torch.py``.

Sizes: 16³ grids, 8² or 16² films, 2 spp.  The JAX side runs under
``jax.jit``, one program per case (the primal render, the grad image and the
grid VJP); at depth 3 that program takes ~30 s to trace and compile on one
CPU thread at 8² (~40 s at 16²), so one case is tier-1 and the rest are
``slow``."""

import dataclasses
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optimize_torch
from differentiable_sdf_rendering_tpu.models import emitter as jemitter, scenes_zoo as jzoo
from differentiable_sdf_rendering_tpu.models.camera import regular_cameras as jregular_cameras
from differentiable_sdf_rendering_tpu.models import integrator as jinteg, prb as jprb
from differentiable_sdf_rendering_tpu.models.integrator import RenderConfig as JRenderConfig, render as jrender
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.ops.sampling import lane_uniforms as jlane_uniforms
from differentiable_sdf_rendering_tpu.ops import film as jfilm, trace as jtrace
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF, TraceParams as JTraceParams
from differentiable_sdf_rendering_tpu.ops.warp import WarpConfig as JWarpConfig
from differentiable_sdf_rendering_tpu.opt import configs as jconfigs, opt_configs as jopt_configs
from differentiable_sdf_rendering_tpu.opt.shape_opt import optimize_shape as joptimize_shape
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg, prb as tprb
from differentiable_sdf_rendering_tpu_torch.models import scenes_zoo as tzoo
from differentiable_sdf_rendering_tpu_torch.models.bsdf import DiffuseBSDF
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.emitter import GridEnvmap
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf
from differentiable_sdf_rendering_tpu_torch.ops import film as tfilm, trace as ttrace, warp as twarp
from differentiable_sdf_rendering_tpu_torch.ops.sampling import lane_uniforms
from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
from differentiable_sdf_rendering_tpu_torch.ops.warp import WarpConfig
from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs
from differentiable_sdf_rendering_tpu_torch.opt import shape_opt
from test_torch_hybrid import _scenes as _hybrid_scenes
from torch_port_helpers import JIT_LEVEL0, t, to_np

RES = 16
PRB = "sdf_prb_reparam"

# (scene, film, RenderConfig fields).  "cup" is a bowl open toward the
# camera, under the constant emitter: of its 288 lanes at 8² 34, 13 and 7 are
# still on the surface after 1-3 bounces (the bunny at 16³ has none after
# the first), so the replay's vertex terms and the reparameterization gated
# to the primary ray see paths; Russian roulette acts from the bounce after
# depth 5, so it needs max_depth 7, and at 16², 8 spp 49 lanes meet it and 5
# go on.  The main
# path's bunny rig under its gradient sky, and the hybrid rigs (diffuse mesh
# under the vMF sun, mirror lanes, the area light), follow.
CASES = {
    "cup": ("cup", 8, {"max_depth": 3}),
    "cup-roulette": ("cup", 16, {"max_depth": 7, "spp": 8}),
    "cup-reparam0": ("cup", 16, {"max_depth": 3, "warp": "reparam0"}),
    "bunny": ("bunny", 16, {"max_depth": 3}),
    "torus-shadow": ("torus-shadow", 16, {"max_depth": 3}),
    "mirror-opt": ("mirror-opt", 16, {"max_depth": 3}),
    "plane_area": ("plane_area", 16, {"max_depth": 3}),
}


# The grid VJP's atol, in units of max|g|, where the issue's 1e-3 does not
# hold (ROADMAP §C gap 7), each set from its measured gap with its cause
# pinned by a test: on the cup at 8², 1 voxel of 4096 is 1.07e-3 off, the
# tracers' accumulators (test_prb_vjp_gap_is_the_tracer); at 16², 8 spp
# 12 voxels are up to 9.98e-3 off, NEE shadow rays that leave the surface
# at grazing angles (test_prb_vjp_gap_is_a_grazing_shadow_ray).
VJP_ATOL = {"cup": 1.5e-3, "cup-roulette": 1.5e-2}


def _cup_sdf():
    """A 16³ hollow sphere (radii 0.38 and 0.26) cut open by a plane facing
    view 0's camera (numpy, float32).  Its surfaces are curved or tilted: on
    a face whose normal has z = 0, the shading frame's sign test n_z ≥ 0
    would flip on rounding and send the two packages' bounce rays apart."""
    z, y, x = np.meshgrid(*((np.arange(RES) + 0.5) / RES,) * 3, indexing="ij")
    p = np.stack([x, y, z], axis=-1) - 0.5
    r = np.linalg.norm(p, axis=-1)
    cut = p @ (np.array([1.0, 0.3, 0.4]) / np.linalg.norm([1.0, 0.3, 0.4])) - 0.12
    return np.maximum(np.maximum(r - 0.38, 0.26 - r), cut).astype(np.float32)


def _scenes(name, film=16):
    """Both packages' scenes of ``name`` on one 16³ grid and one camera of
    ``film``² pixels (the hybrid rigs at 16² only):
    the cup under each package's default BSDF and constant emitter, the
    bunny's 16³ target under its rig, the hybrid rigs as in
    test_torch_hybrid.py.  The bunny's gradient sky goes to the JAX package
    with the port's tables: each package computes the sky with its own
    float32 sin/cos/pow (equal to rtol 1e-5, ROADMAP §C gap 3), and where the
    alias sampler's comparison u < p flips on that rounding, a PRB shadow
    sample lands in another texel (measured: 1 lane of 800 at seed 3, its
    direction 0.033 away, its pixel 1.1e-3)."""
    if name in ("torus-shadow", "mirror-opt", "plane_area"):
        return _hybrid_scenes(name)
    jcams, tcams = jregular_cameras(1, resx=film, resy=film), regular_cameras(1, resx=film, resy=film, device="cpu")
    if name == "cup":
        data = _cup_sdf()
        return JScene.create(jnp.asarray(data), cameras=jcams), Scene.create(t(data), cameras=tcams, device="cpu")
    data = to_np(tzoo.target_sdf(name, RES, device="cpu"))
    rj, rt = jzoo.scene_rig_full(name), tzoo.scene_rig_full(name, device="cpu")
    e = rt["emitter"]
    sky = jemitter.GridEnvmap(
        image=jnp.asarray(to_np(e.image)), image_rows=jnp.asarray(to_np(e.image_rows)),
        pdf_table=jnp.asarray(to_np(e.pdf_table)), alias_prob=jnp.asarray(to_np(e.alias_prob)),
        alias_idx=jnp.asarray(to_np(e.alias_idx), jnp.int32))
    sj = JScene(sdf=JGridSDF.create(jnp.asarray(data)), bsdf=rj["bsdf"], emitter=sky, cameras=jcams)
    st = Scene(sdf=GridSDF.create(t(data)), bsdf=rt["bsdf"], emitter=rt["emitter"], cameras=tcams)
    return sj, st


def _configs(fields):
    fields = {"spp": 2, **fields, "integrator": PRB}
    if fields.pop("warp", None) == "reparam0":
        return (JRenderConfig(warp=JWarpConfig(max_reparam_depth=0), **fields),
                tinteg.RenderConfig(warp=WarpConfig(max_reparam_depth=0), **fields))
    return JRenderConfig(**fields), tinteg.RenderConfig(**fields)


def _port_render(st, cfg, data, cot):
    """The port's primal image, grad-mode image and grid VJP at ``data``."""
    primal = tinteg.render(st.replace(sdf=GridSDF.create(t(data))), 0, seed=5, cfg=cfg, mode="primal", device="cpu")
    leaf = t(data).requires_grad_(True)
    img = tinteg.render(st.replace(sdf=st.sdf.with_data(leaf)), 0, seed=5, cfg=cfg, mode="grad", device="cpu")
    img.backward(t(cot))
    return to_np(primal), to_np(img), to_np(leaf.grad)


@pytest.mark.parametrize("case", [c if c == "cup" else pytest.param(c, marks=pytest.mark.slow) for c in CASES])
def test_prb_render_matches_jax(case):
    """Primal image, grad-mode image and grid VJP against the JAX package,
    one seed for both modes; and the grad-mode image's value is the primal
    image (the per-vertex ratio terms carry the gradient only)."""
    name, film, fields = CASES[case]
    sj, st = _scenes(name, film)
    cfg_j, cfg_t = _configs(fields)
    cot = np.random.default_rng(0).normal(size=(film, film, 4)).astype(np.float32)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(data, cotangent):
        primal = jrender(sj.replace(sdf=JGridSDF.create(data)), 0, seed=5, cfg=cfg_j, mode="primal")
        img, vjp = jax.vjp(lambda x: jrender(sj.replace(sdf=JGridSDF.create(x)), 0, seed=5, cfg=cfg_j, mode="grad"),
                           data)
        return primal, img, vjp(cotangent)[0]

    data = to_np(st.sdf.data)
    primal_j, img_j, g_j = [np.asarray(x) for x in jax_side(jnp.asarray(data), jnp.asarray(cot))]
    primal_t, img_t, g_t = _port_render(st, cfg_t, data, cot)
    # the same samples (bit-equal random numbers, all 6 + 8·max_depth
    # columns); float32 shading chains and the splat's summation order
    # differ
    assert primal_j[..., :3].max() > 0.05
    np.testing.assert_allclose(primal_t, primal_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(img_t, img_j, rtol=0, atol=2e-5)
    # the grad-mode splat positions are projected back from the attached
    # direction, so equal to the primal ones up to rounding
    np.testing.assert_allclose(img_t, primal_t, rtol=0, atol=2e-5)
    # the tracer's derivative accumulators differ by ~1e-3 of a ray's scale
    # (ROADMAP §C gap 1), as in test_torch_hybrid.py; two cases hold a limit
    # set from their measured gap (VJP_ATOL, gap 7)
    assert np.abs(g_j).max() > 1.0 and np.all(np.isfinite(g_t))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=VJP_ATOL.get(case, 1e-3) * np.abs(g_j).max())


@pytest.mark.slow
def test_prb_vjp_gap_is_the_tracer(monkeypatch):
    """§C gap 7: on the cup at 8² the port's grid VJP is 1.07e-3 of its scale
    off the JAX package's on one voxel.  Fed the JAX package's detached warp
    traces (its ``sphere_trace_warp`` on the same rays), the port holds the
    limit of the other cases, rtol 1e-3 and atol 1e-3 of the scale: the rest
    of the gap is the tracers' float32 accumulators (gap 1), summed over
    PRB's reparameterized traces."""
    name, film, fields = CASES["cup"]
    sj, st = _scenes(name, film)
    cfg_j, cfg_t = _configs(fields)
    cot = np.random.default_rng(0).normal(size=(film, film, 4)).astype(np.float32)
    g_j = np.asarray(jax.jit(lambda x, c: jax.vjp(
        lambda y: jrender(sj.replace(sdf=JGridSDF.create(y)), 0, seed=5, cfg=cfg_j, mode="grad"), x)[1](c)[0])(
        sj.sdf.data, jnp.asarray(cot)))

    def port_vjp():
        leaf = st.sdf.data.clone().requires_grad_(True)
        img = tinteg.render(st.replace(sdf=st.sdf.with_data(leaf)), 0, seed=5, cfg=cfg_t, mode="grad", device="cpu")
        img.backward(t(cot))
        return to_np(leaf.grad)

    jsdf = JGridSDF.create(jnp.asarray(to_np(st.sdf.data)))

    def jax_tracer(sdf, o, d, params, maxt=math.inf, active=True, refine_active=True):
        def arr(v):
            return jnp.asarray(to_np(v)) if isinstance(v, torch.Tensor) else v

        r = jtrace.sphere_trace_warp(jsdf, arr(o.detach()), arr(d.detach()), JTraceParams(), maxt=arr(maxt),
                                     active=arr(active), refine_active=arr(refine_active))
        return ttrace.TraceResult(**{f.name: torch.tensor(np.asarray(getattr(r, f.name)))
                                     for f in dataclasses.fields(ttrace.TraceResult)})

    scale = np.abs(g_j).max()
    own = np.abs(port_vjp() - g_j).max() / scale
    monkeypatch.setattr(twarp, "sphere_trace_warp", jax_tracer)
    g_s = port_vjp()
    assert own > 1e-3
    np.testing.assert_allclose(g_s, g_j, rtol=1e-3, atol=1e-3 * scale)


def _unit_shadow_det(reparameterize, ones):
    """``reparameterize`` with the shadow rays' (the calls given ``maxt``)
    determinant held at 1 and their direction unwarped."""
    def patched(sdf, o, d, warp, trace, maxt=None, **kw):
        if maxt is None:
            return reparameterize(sdf, o, d, warp, trace, **kw)
        return None, d, ones(o.shape[:-1])
    return patched


@pytest.mark.slow
def test_prb_vjp_gap_is_a_grazing_shadow_ray(monkeypatch):
    """§C gap 7: on the cup at 16², 8 spp, depth 7 the port's grid VJP is
    up to 9.98e-3 of its scale off the JAX package's on 12 voxels, and so it
    is at depth 2, where this test looks (the first vertex's NEE rays, traced
    at every depth ≥ 2 on the same uniforms).  The cause is the
    reparameterization of NEE shadow rays that leave the surface at a
    grazing angle: along the surface they start from it is ill-conditioned
    in float32.  Without
    the 5 lanes (of 3,200) whose unoccluded shadow ray leaves at cos θ < 0.02,
    or with the shadow rays' reparameterization held at 1 in both packages,
    the two agree at the issue's limit; on those lanes the port's own VJP
    moves by more than 1e-2 of its scale under a 1-ulp change of the grid,
    and with that reparameterization held at 1 by less than 1e-4."""
    name, film, fields = CASES["cup-roulette"]
    sj, st = _scenes(name, film)
    cfg_j, cfg_t = _configs({**fields, "max_depth": 2})
    n = (film + 4) ** 2 * cfg_t.spp
    seen = {}
    trace_primal = tprb._trace_primal

    def record(*a):
        seen["out"] = trace_primal(*a)
        return seen["out"]

    monkeypatch.setattr(tprb, "_trace_primal", record)
    tinteg.render(st, 0, seed=5, cfg=cfg_t, device="cpu")
    monkeypatch.undo()
    r = seen["out"][0][0]
    grazing = r["active_em"] & ~r["occluded"] & (r["si"].to_local(r["ds_d"])[..., 2].abs() < 0.02)
    bad = to_np(torch.nonzero(grazing)[:, 0])
    assert 1 <= len(bad) <= 8
    cot = np.random.default_rng(0).normal(size=(film, film, 4)).astype(np.float32)
    jcam, tcam = sj.cameras.view(0), st.cameras.view(0)

    def jax_vjp(data, lane):
        def img(x):
            return jfilm.develop(jinteg.render_lane_block(sj.replace(sdf=JGridSDF.create(x)), jcam,
                                                          jnp.asarray(lane, jnp.uint32), 5, cfg_j, "grad"), border=2)
        return np.asarray(jax.jit(lambda x, c: jax.vjp(img, x)[1](c)[0])(jnp.asarray(data), jnp.asarray(cot)))

    def port_grad(data, lane, cotangent=None):
        """The port's VJP of the developed image, or without ``cotangent``
        the gradient of the lanes' summed splatted radiance."""
        leaf = t(data).requires_grad_(True)
        blk = tinteg.render_lane_block(st.replace(sdf=st.sdf.with_data(leaf)), tcam, torch.tensor(lane), 5, cfg_t,
                                       "grad")
        if cotangent is None:
            blk[..., :3].sum().backward()
        else:
            tfilm.develop(blk, border=2).backward(t(cotangent))
        return to_np(leaf.grad)

    data = to_np(st.sdf.data)
    up = np.nextafter(data, np.float32(np.inf))
    keep = np.setdiff1d(np.arange(n), bad)
    g_j = jax_vjp(data, keep)
    np.testing.assert_allclose(port_grad(data, keep, cot), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())
    b, b_up = port_grad(data, bad), port_grad(up, bad)
    assert np.abs(b_up - b).max() > 1e-2 * np.abs(b).max()

    monkeypatch.setattr(tprb, "reparameterize", _unit_shadow_det(tprb.reparameterize, torch.ones))
    monkeypatch.setattr(jprb, "reparameterize", _unit_shadow_det(jprb.reparameterize, jnp.ones))
    lanes = np.arange(n)
    g_j = jax_vjp(data, lanes)
    np.testing.assert_allclose(port_grad(data, lanes, cot), g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())
    h, h_up = port_grad(data, bad), port_grad(up, bad)
    assert np.abs(h_up - h).max() < 1e-4 * np.abs(h).max()  # measured 3.6e-5


def test_prb_uniforms_extend_the_draw():
    """PRB draws 6 + 8·max_depth uniforms a lane; the first 6 are bit-equal
    to the draw of the other integrators, and all of them to the JAX
    package's."""
    lane = torch.arange(0, 5000, 7, dtype=torch.int64)
    cfg = tinteg.RenderConfig(integrator=PRB, max_depth=4)
    n = tinteg.n_uniforms(cfg)
    assert n == 38 and tinteg.n_uniforms(tinteg.RenderConfig()) == 6
    wide = lane_uniforms(11, lane, n)
    assert torch.equal(wide[:, :6], lane_uniforms(11, lane, 6))
    want = jlane_uniforms(11, jnp.asarray(to_np(lane), jnp.uint32), n)
    np.testing.assert_array_equal(to_np(wide), np.asarray(want))


def _mean(scene, seed, **fields):
    img = tinteg.render(scene, 0, seed=seed, cfg=tinteg.RenderConfig(**fields), device="cpu")
    return float(img[..., :3].mean())


@pytest.mark.parametrize("rig", ["sphere", "plane_area"])
def test_prb_depth2_matches_direct_mis(rig):
    """At depth 2 PRB estimates direct illumination with MIS (NEE at the first
    hit, the BSDF-sampled continuation reaching an emitter): the means agree
    over independent seeds (the streams differ: PRB draws its NEE and BSDF
    uniforms from columns 6 + 8k, the direct integrator from 2-5).  The
    scenes, sizes and seeds of tests/test_prb.py: a 32³ sphere under the
    constant emitter, one seed each (measured rel 6.6e-4); the area light
    over its dim ambient, three seeds each (single seeds scatter by ±4 %)."""
    if rig == "sphere":
        scene = Scene.create(create_sphere_sdf(32, radius=0.3, device="cpu"),
                             cameras=regular_cameras(4, resx=24, resy=24, device="cpu"), device="cpu")
        spp, n_seeds = 32, 1
    else:
        area = tzoo.scene_rig_full("plane_area", device="cpu")
        scene = Scene.create(create_sphere_sdf(24, radius=0.22, device="cpu"),
                             bsdf=DiffuseBSDF.create(albedo=(0.8,) * 3, device="cpu"), emitter=area["emitter"],
                             area_emitter=area["area_emitter"],
                             cameras=regular_cameras(2, resx=20, resy=20, device="cpu"), device="cpu")
        spp, n_seeds = 48, 3
    mp = np.mean([_mean(scene, 2 * s, integrator=PRB, spp=spp, max_depth=2) for s in range(n_seeds)])
    md = np.mean([_mean(scene, 2 * s + 1, spp=spp, use_mis=True) for s in range(n_seeds)])
    assert np.isfinite(mp) and md > 0.01
    assert abs(mp - md) / md < 0.025, (mp, md)


def test_prb_more_bounces_add_light():
    """Interreflection is non-negative: inside the cup, depth 4 is brighter
    than depth 2 on the same samples."""
    scene = _scenes("cup", 8)[1]
    m2 = _mean(scene, 0, integrator=PRB, spp=4, max_depth=2)
    m4 = _mean(scene, 0, integrator=PRB, spp=4, max_depth=4)
    assert m4 > m2 + 1e-3, (m2, m4)


def test_prb_methods_through_the_cli(tmp_path, monkeypatch):
    """``optimize_torch.py --configs warpprbprimary`` (1 iteration, tiny
    widths): the reference images come from the direct integrator, the
    gradient renders from PRB at depth 4 with only the primary ray
    reparameterized, and the run writes its checkpoints."""
    seen = {}
    refs = shape_opt.render_reference_images
    grads = shape_opt._view_batch_loss_grads

    def record_refs(scene, opt_cfg, ref_spp, cfg, *a):
        seen["ref"] = cfg
        return refs(scene, opt_cfg, ref_spp, cfg, *a)

    def record_grads(*a, cfg_primal, cfg_grad, **kw):
        seen["primal"], seen["grad"] = cfg_primal, cfg_grad
        return grads(*a, cfg_primal=cfg_primal, cfg_grad=cfg_grad, **kw)

    monkeypatch.setattr(shape_opt, "render_reference_images", record_refs)
    monkeypatch.setattr(shape_opt, "_view_batch_loss_grads", record_grads)
    monkeypatch.setattr(optimize_torch, "optimize_shape", functools.partial(optimize_torch.optimize_shape,
                                                                            target_res=16))
    optimize_torch.main(["cubes", "--cpu", "--optconfig", "no-tex-12", "--configs", "warpprbprimary", "--n_iter", "1",
                         "--refspp", "2", "--outputdir", str(tmp_path), "--sdf_res=16", "--n_sensors=1",
                         "--batch_size=1", "--resx=8", "--resy=8", "--upsample_iter=()", "--spp=2",
                         "--primal_spp_mult=1"])
    assert seen["ref"].integrator == "sdf_direct_reparam"
    for cfg in (seen["primal"], seen["grad"]):
        assert (cfg.integrator, cfg.max_depth, cfg.warp.max_reparam_depth) == (PRB, 4, 0)
    run_dir = os.path.join(str(tmp_path), "cubes", "no-tex-12", "warpprbprimary")
    assert sorted(os.listdir(os.path.join(run_dir, "params"))) == ["sdf-data-0000.vol", "sdf-final.vol"]


def test_unported_methods_raise():
    """No method of the registry is refused any more: ``fd`` trains as the
    JAX package trains it, with shading gradients only (bit-equal to
    ``onlyshadinggrad``: tests/test_torch_opt_tools.py).  PRB with the conv
    warp stays refused (test_torch_render.py::test_unported_paths_raise).
    Every method's training render configs build."""
    for name in tconfigs.CONFIG_NAMES:
        cfg_primal, cfg_grad = shape_opt.render_configs(tconfigs.get_config(name))
        assert cfg_primal.spp >= cfg_grad.spp >= 1, name
    fd, ref = (shape_opt.render_configs(tconfigs.get_config(n)) for n in ("fd", "onlyshadinggrad"))
    assert fd == ref


@pytest.mark.slow
def test_warpprb_optimize_matches_jax(monkeypatch):
    """Two iterations of ``warpprb`` on ``cubes`` (2 views, 16³, 16², 2 + 4
    spp, depth 4) in both packages, the port given the JAX package's sky
    tables (ROADMAP §C gap 3: with its own, the first step's gradients are
    7.0e-3 of their scale apart, with the JAX tables 7.0e-5).  Losses to
    1e-4; grids to 5e-4, the hybrid slice's limit (gap 6): the second step's
    gradients are 2.6e-3 of their scale apart (gaps 1 and 7), and Adam turns
    that into 4.4e-4 on 3 voxels (2.4e-4 with the JAX package's warp traces
    too; fed the JAX package's gradients, the port's grid is 1.2e-6 off)."""
    def run(optimize, configs, opt_configs, **kw):
        method = configs.get_config("warpprb")
        method.spp, method.primal_spp_mult = 2, 2
        opt_cfg = opt_configs.SdfConfig(upsample_iter=(), n_sensors=2, resx=16, resy=16, sdf_res=16,
                                        scene_name="cubes")
        return optimize("cubes", opt_cfg, method, n_iter=2, ref_spp=4, target_res=16, verbose=False, **kw)

    e = jzoo.scene_rig_full("cubes")["emitter"]
    sky = GridEnvmap(**{f: t(np.asarray(getattr(e, f))) for f in ("image", "image_rows", "pdf_table", "alias_prob")},
                     alias_idx=t(np.asarray(e.alias_idx), torch.int64))
    rig = shape_opt.scene_rig_full
    monkeypatch.setattr(shape_opt, "scene_rig_full", lambda *a, **kw: {**rig(*a, **kw), "emitter": sky})
    rt = run(shape_opt.optimize_shape, tconfigs, topt_configs, device="cpu")
    rj = run(joptimize_shape, jconfigs, jopt_configs)
    assert len(rt.loss_values) == 2 and all(np.isfinite(rt.loss_values))
    np.testing.assert_allclose(rt.loss_values, rj.loss_values, rtol=0, atol=1e-4)
    for got, want in ((rt.params["sdf"], rj.params["sdf"]), (rt.ema["sdf"], rj.ema["sdf"])):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=5e-4)
