"""Textured materials of the port vs the JAX package: the volume-texture
variables, the textured diffuse and the principled BSDF, the scene and
parameter round trip through the JAX package's objects, one view's grad-mode
VJP to the SDF and both textures, and the textured whole slice.  The same
seeded numpy inputs go through both packages; the JAX side runs under
``jax.jit`` (one compilation each), except where a value must be compared
op by op (see ``jax_bsdf_results``)."""

import dataclasses

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import bsdf as jbsdf
from differentiable_sdf_rendering_tpu.models.camera import PerspectiveCamera as JCamera
from differentiable_sdf_rendering_tpu.models.emitter import GridEnvmap as JGridEnvmap
from differentiable_sdf_rendering_tpu.models.integrator import RenderConfig as JRenderConfig, render as jrender
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.ops.interaction import SurfaceInteraction as JSI
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF
from differentiable_sdf_rendering_tpu.opt import variables as jvars
from differentiable_sdf_rendering_tpu_torch.models import bsdf as tbsdf
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.emitter import make_gradient_envmap
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import target_sdf
from differentiable_sdf_rendering_tpu_torch.ops.interaction import SurfaceInteraction
from differentiable_sdf_rendering_tpu_torch.opt import variables as tvars
from differentiable_sdf_rendering_tpu_torch.utils import convert
from torch_port_helpers import JIT_LEVEL0, jax_scene_to_numpy, t, to_np

N = 256  # shading points of the BSDF cases
BSDF_KINDS = ("diffuse_tex", "principled", "principled_tex")


def _bsdf_inputs():
    """Seeded shading points: directions on the whole sphere (so some lie
    below the horizon), unit-cube points, uniforms, and 4³ textures whose
    roughness crosses both clip bounds."""
    rng = np.random.default_rng(11)
    v = rng.normal(size=(4, N, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    wi = v[0].copy()
    wi[: N // 2, 2] = np.abs(wi[: N // 2, 2])  # half the incident directions above the horizon
    return {
        "wi": wi, "wo": v[1], "n": v[2], "s": v[3],
        "p": rng.random((N, 3)).astype(np.float32),
        "u": rng.random((N, 2)).astype(np.float32),
        "albedo_tex": rng.uniform(0.1, 0.9, (4, 4, 4, 3)).astype(np.float32),
        "rough_tex": rng.uniform(0.0, 1.0, (4, 4, 4, 1)).astype(np.float32),
        "cot": rng.normal(size=(N, 3)).astype(np.float32),
    }


def _jax_bsdf(kind, x):
    if kind == "diffuse_tex":
        return jbsdf.DiffuseBSDF.create((0.7, 0.5, 0.3), albedo_tex=x["albedo_tex"])
    if kind == "principled":
        return jbsdf.PrincipledBSDF.create((0.8, 0.6, 0.4), roughness=0.3)
    return jbsdf.PrincipledBSDF.create(base_color_tex=x["albedo_tex"], roughness_tex=x["rough_tex"])


def _port_bsdf(kind, x):
    if kind == "diffuse_tex":
        return tbsdf.DiffuseBSDF.create((0.7, 0.5, 0.3), albedo_tex=x["albedo_tex"], device="cpu")
    if kind == "principled":
        return tbsdf.PrincipledBSDF.create((0.8, 0.6, 0.4), roughness=0.3, device="cpu")
    return tbsdf.PrincipledBSDF.create(base_color_tex=x["albedo_tex"], roughness_tex=x["rough_tex"], device="cpu")


def _si(cls, f, x):
    ones = np.ones(N, np.float32)
    return cls(valid=f(ones > 0), t=f(ones), p=f(x["p"]), n=f(x["n"]), s=f(x["s"]), b=f(x["s"]), wi=f(x["wi"]))


@pytest.fixture(scope="module")
def jax_bsdf_results():
    """The inputs and, per BSDF kind, the JAX package's ``eval``,
    ``eval_pdf`` and ``sample``, run op by op, and the VJP of ``eval`` to
    the shading points and the textures, under ``jax.jit``.  The values are
    not taken from the compiled program: it rounds its multiply-adds apart
    from the port (even at backend optimisation level 0), and GGX's peak at
    roughness 0.3 (α² = 0.0081) turns that rounding into 1.2e-5 of a sample
    weight (the float64 value lies between the two), while op by op the JAX
    package and the port round alike."""
    x = _bsdf_inputs()
    arrs = {k: jnp.asarray(v) for k, v in x.items()}

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def vjps(arrs):
        out = {}
        for kind in BSDF_KINDS:
            def ev(p, albedo_tex, rough_tex):
                a = {**arrs, "p": p, "albedo_tex": albedo_tex, "rough_tex": rough_tex}
                return _jax_bsdf(kind, a).eval(_si(JSI, lambda v: v, a), a["wo"])

            out[kind] = jax.vjp(ev, arrs["p"], arrs["albedo_tex"], arrs["rough_tex"])[1](arrs["cot"])
        return out

    res = {}
    si = _si(JSI, lambda v: v, arrs)
    for kind, vjp in vjps(arrs).items():
        b = _jax_bsdf(kind, arrs)
        res[kind] = jax.tree_util.tree_map(np.asarray, {
            "eval": b.eval(si, arrs["wo"]), "eval_pdf": b.eval_pdf(si, arrs["wo"]),
            "sample": b.sample(si, arrs["u"]), "vjp": vjp})
    return x, res


@pytest.mark.parametrize("kind", BSDF_KINDS)
def test_bsdf_matches_jax(jax_bsdf_results, kind):
    x, res = jax_bsdf_results
    want = res[kind]
    leaves = {k: t(x[k]).requires_grad_(True) for k in ("p", "albedo_tex", "rough_tex")}
    b = _port_bsdf(kind, {**x, **leaves})
    si = _si(SurfaceInteraction, lambda a: a if isinstance(a, torch.Tensor) else torch.tensor(a), {**x, **leaves})
    val = b.eval(si, t(x["wo"]))
    assert val.shape == (N, 3) and bool((val > 0).any()) and bool((val == 0).any())
    np.testing.assert_allclose(to_np(val), want["eval"], rtol=1e-5, atol=1e-6)
    for got, w in zip(b.eval_pdf(si, t(x["wo"])), want["eval_pdf"]):
        np.testing.assert_allclose(to_np(got), w, rtol=1e-5, atol=1e-6)
    for got, w in zip(b.sample(si, t(x["u"])), want["sample"]):
        np.testing.assert_allclose(to_np(got), w, rtol=1e-5, atol=1e-6)
    # autograd reaches the textures through their data and through p
    grads = torch.autograd.grad(val, list(leaves.values()), t(x["cot"]), allow_unused=True) if val.requires_grad \
        else (None,) * 3
    for name, g, w in zip(leaves, grads, want["vjp"]):
        g = np.zeros_like(w) if g is None else to_np(g)
        # against the fused program (see the fixture): relative to the
        # largest entry, whose GGX peak carries the rounding
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max(), err_msg=name)
    if kind == "principled_tex":
        assert all(np.abs(w).max() > 0 for w in want["vjp"])


def _furnace_si(n):
    """The shading points of the JAX package's own BSDF checks: p at the
    cube's centre, the normal +z, wi = (0.3, 0.1, 0.94)."""
    def rows(v):
        return torch.tensor(v, dtype=torch.float32).expand(n, 3)

    return SurfaceInteraction(valid=torch.ones(n, dtype=torch.bool), t=torch.ones(n), p=rows([0.5] * 3),
                              n=rows([0.0, 0.0, 1.0]), s=rows([1.0, 0.0, 0.0]), b=rows([0.0, 1.0, 0.0]),
                              wi=rows([0.3, 0.1, 0.94]))


def test_diffuse_white_furnace():
    """E[f·cos/pdf] over the cosine sampler = albedo, constant or from a
    constant texture."""
    u = t(np.random.default_rng(0).random((4096, 2)))
    tex = np.broadcast_to(np.float32([0.7, 0.5, 0.3]), (2, 2, 2, 3))
    for b in (tbsdf.DiffuseBSDF.create((0.7, 0.5, 0.3), device="cpu"),
              tbsdf.DiffuseBSDF.create((0.1, 0.1, 0.1), albedo_tex=t(tex), device="cpu")):
        _, _, weight = b.sample(_furnace_si(4096), u)
        np.testing.assert_allclose(to_np(weight).mean(0), [0.7, 0.5, 0.3], atol=0.02)


def test_eval_pdf_consistent_with_sample():
    si = _furnace_si(512)
    u = t(np.random.default_rng(1).random((512, 2)))
    for b in (tbsdf.DiffuseBSDF.create((0.6, 0.6, 0.6), device="cpu"),
              tbsdf.PrincipledBSDF.create((0.6, 0.6, 0.6), roughness=0.3, device="cpu")):
        wo, pdf, weight = b.sample(si, u)
        val, pdf2 = b.eval_pdf(si, wo)
        np.testing.assert_allclose(to_np(pdf), to_np(pdf2), atol=1e-6)
        np.testing.assert_allclose(to_np(val) / np.maximum(to_np(pdf)[..., None], 1e-8), to_np(weight), atol=1e-4)


def test_principled_energy_bounded():
    u = t(np.random.default_rng(2).random((2048, 2)))
    _, _, weight = tbsdf.PrincipledBSDF.create((0.8, 0.8, 0.8), roughness=0.4, device="cpu").sample(_furnace_si(2048), u)
    est = to_np(weight).mean(0)
    assert np.all(est < 1.15) and np.all(est > 0.5), est  # energy ≤ 1 + MC tolerance


def test_volume_variable_spec():
    kw = dict(key="albedo", resolution=8, channels=3, init_value=0.5, upsample_iter=(2, 5), beta=0.9, lr=None,
              clamp=(1e-5, 1.0))
    st, sj = tvars.VolumeVariableSpec(**kw), jvars.VolumeVariableSpec(**kw)
    assert dataclasses.asdict(st) == dataclasses.asdict(sj) and st.initial_resolution == sj.initial_resolution == 2
    init = st.initialize(device="cpu")
    assert init.dtype == torch.float32
    np.testing.assert_array_equal(to_np(init), np.asarray(sj.initialize()))
    tiny = tvars.VolumeVariableSpec(key="roughness", resolution=4, channels=1, upsample_iter=(1, 2, 3))
    assert tuple(tiny.initialize(device="cpu").shape) == (2, 2, 2, 1)  # at least 2 a side
    vol = np.random.default_rng(3).uniform(-0.5, 1.5, (4, 4, 4, 3)).astype(np.float32)
    validate_j = jax.jit(sj.validate, static_argnums=1)
    for i in (-1, 2):  # plain clamp; scheduled trilinear upsample, then clamp
        got, want = to_np(st.validate(t(vol), i)), np.asarray(validate_j(jnp.asarray(vol), i))
        assert got.shape == want.shape == ((8, 8, 8, 3) if i == 2 else (4, 4, 4, 3))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    rough = tvars.VolumeVariableSpec(key="roughness", resolution=4, channels=1, clamp=(0.1, 0.8), upsample_iter=(7,))
    one = vol[..., :1]
    rough_j = jax.jit(jvars.VolumeVariableSpec(**dataclasses.asdict(rough)).validate, static_argnums=1)
    np.testing.assert_allclose(to_np(rough.validate(t(one), 7)), np.asarray(rough_j(jnp.asarray(one), 7)),
                               rtol=1e-5, atol=1e-6)
    g = np.array([np.nan, -3.0, 0.05, 2.0], np.float32)  # NaN → 0, no clamp
    np.testing.assert_array_equal(to_np(st.validate_gradient(t(g))), np.asarray(sj.validate_gradient(jnp.asarray(g))))
    for spec in (st, dataclasses.replace(st, lr=0.2)):
        want = float(jvars.VolumeVariableSpec(**dataclasses.asdict(spec)).lr_for(0.04, 300))
        assert spec.lr_for(0.04, 300) == pytest.approx(want, rel=1e-7)  # no decay, no adaptive scaling


# ---- one view of a tiny principled scene: 16³ cubes, 4³ textures, 16², 2 spp
@pytest.fixture(scope="module")
def principled_scenes():
    """The scene, built by the port (its 16³ ``cubes`` target, gradient sky
    and rig) and carried to the JAX package through the ``utils/convert.py``
    dict: ``(jax_scene, port_scene)``."""
    rng = np.random.default_rng(21)
    st = Scene.create(
        target_sdf("cubes", 16, device="cpu"),
        bsdf=tbsdf.PrincipledBSDF.create(base_color_tex=t(rng.uniform(0.2, 0.9, (4, 4, 4, 3))),
                                         roughness_tex=t(rng.uniform(0.2, 0.7, (4, 4, 4, 1))), device="cpu"),
        emitter=make_gradient_envmap(device="cpu"), cameras=regular_cameras(2, resx=16, resy=16, device="cpu"),
        device="cpu",
    )
    return _jax_scene_from_numpy(convert.scene_to_numpy(st)), st


def _jax_scene_from_numpy(d):
    """A JAX ``Scene`` built from the ``utils/convert.py`` scene dict."""
    if d["bsdf"] == "principled":
        bsdf = jbsdf.PrincipledBSDF(base_color=jnp.asarray(d["base_color"]), roughness=jnp.asarray(d["roughness"]),
                                    base_color_tex=jnp.asarray(d["base_color_tex"]),
                                    roughness_tex=jnp.asarray(d["roughness_tex"]), specular=d["specular"])
    else:
        bsdf = jbsdf.DiffuseBSDF(albedo=jnp.asarray(d["albedo"]), albedo_tex=jnp.asarray(d["albedo_tex"]))
    emitter = JGridEnvmap(image=jnp.asarray(d["envmap_image"]), image_rows=jnp.asarray(d["envmap_image"].reshape(-1, 3)),
                          pdf_table=jnp.asarray(d["envmap_pdf_table"]), alias_prob=jnp.asarray(d["envmap_alias_prob"]),
                          alias_idx=jnp.asarray(d["envmap_alias_idx"]))
    cams = JCamera(origin=jnp.asarray(d["cam_origin"]), rot=jnp.asarray(d["cam_rot"]),
                   tan_half_fov=jnp.asarray(d["cam_tan_half_fov"]), resx=d["cam_resx"], resy=d["cam_resy"])
    return JScene(sdf=JGridSDF.create(jnp.asarray(d["sdf"]), p=jnp.asarray(d["sdf_p"])), bsdf=bsdf, emitter=emitter,
                  cameras=cams)


def test_convert_round_trip_through_jax(principled_scenes):
    sj, st = principled_scenes
    d = convert.scene_to_numpy(st)
    back = convert.scene_from_numpy(jax_scene_to_numpy(sj), "cpu")  # port → dict → JAX → dict → port
    assert isinstance(back.bsdf, tbsdf.PrincipledBSDF) and tuple(back.bsdf.roughness_tex.shape) == (4, 4, 4, 1)
    again = convert.scene_to_numpy(back)
    assert d.keys() == again.keys() and d["bsdf"] == "principled"
    for k in d:
        np.testing.assert_array_equal(np.asarray(d[k]), np.asarray(again[k]), err_msg=k)
    diffuse = st.replace(bsdf=tbsdf.DiffuseBSDF.create(albedo_tex=st.bsdf.base_color_tex, device="cpu"))
    dd = convert.scene_to_numpy(diffuse)
    assert dd["bsdf"] == "diffuse" and "base_color" not in dd
    for k, v in jax_scene_to_numpy(_jax_scene_from_numpy(dd)).items():
        np.testing.assert_array_equal(np.asarray(dd[k]), np.asarray(v), err_msg=k)
    params = {"sdf": st.sdf.data, "albedo": st.bsdf.base_color_tex, "roughness": st.bsdf.roughness_tex}
    as_jax = {k: jnp.asarray(v) for k, v in convert.params_to_numpy(params).items()}
    back = convert.params_from_numpy({k: np.asarray(v) for k, v in as_jax.items()}, "cpu")
    assert all(torch.equal(back[k], params[k]) for k in params) and tuple(back["roughness"].shape) == (4, 4, 4, 1)


def test_grad_mode_vjp_to_sdf_and_textures(principled_scenes):
    sj, st = principled_scenes
    cot = np.random.default_rng(22).normal(size=(16, 16, 4)).astype(np.float32)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def image_and_vjp(sdf, albedo, rough, cotangent):
        def fj(s, a, r):
            scene = sj.replace(sdf=JGridSDF.create(s), bsdf=sj.bsdf.replace(base_color_tex=a, roughness_tex=r))
            return jrender(scene, 0, seed=5, cfg=JRenderConfig(spp=2), mode="grad")

        img, vjp = jax.vjp(fj, sdf, albedo, rough)
        return img, vjp(cotangent)

    img_j, grads_j = image_and_vjp(sj.sdf.data, sj.bsdf.base_color_tex, sj.bsdf.roughness_tex, jnp.asarray(cot))

    leaves = [x.clone().requires_grad_(True) for x in (st.sdf.data, st.bsdf.base_color_tex, st.bsdf.roughness_tex)]
    scene = st.replace(sdf=st.sdf.with_data(leaves[0]),
                       bsdf=st.bsdf.replace(base_color_tex=leaves[1], roughness_tex=leaves[2]))
    img = tinteg.render(scene, 0, seed=5, cfg=tinteg.RenderConfig(spp=2), mode="grad", device="cpu")
    np.testing.assert_allclose(to_np(img), np.asarray(img_j), rtol=0, atol=2e-5)
    img.backward(t(cot))
    for name, leaf, gj in zip(("sdf", "albedo", "roughness"), leaves, grads_j):
        gj, gt = np.asarray(gj), to_np(leaf.grad)
        assert np.abs(gj).max() > 0 and np.all(np.isfinite(gt)), name
        # as the grid-gradient test of test_torch_render.py: the tracer's
        # derivative accumulators carry ~1e-3 relative differences per ray,
        # and a voxel or texel sums the terms of many rays
        np.testing.assert_allclose(gt, gj, rtol=1e-3, atol=1e-3 * np.abs(gj).max(), err_msg=name)


@pytest.mark.slow  # the JAX package compiles its training step twice (the albedo volume doubles in the run): ~60 s
def test_textured_slice_matches_jax():
    """``optimize_shape`` of both packages on ``cubes`` with the SDF, an
    albedo and a roughness volume under the principled BSDF: two views,
    16³, 16², 2 + 4 spp, two iterations, the albedo doubling (8³ → 16³)
    before the second."""
    from differentiable_sdf_rendering_tpu.opt import configs as jconfigs, opt_configs as jopt_configs
    from differentiable_sdf_rendering_tpu.opt.shape_opt import optimize_shape as joptimize_shape
    from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape

    cfg = dict(n_sensors=2, resx=16, resy=16, sdf_res=16, scene_name="cubes", upsample_iter=(),
               param_keys=("sdf", "albedo", "roughness"), tex_upsample_iter=(1,))

    def run(optimize, configs, opt_configs, **kw):
        method = configs.get_config("warp")
        method.spp, method.primal_spp_mult = 2, 2
        return optimize("cubes", opt_configs.SdfConfig(**cfg), method, n_iter=2, ref_spp=4, target_res=16,
                        verbose=False, **kw)

    rt = run(optimize_shape, tconfigs, topt_configs, device="cpu")
    rj = run(joptimize_shape, jconfigs, jopt_configs)
    assert isinstance(rt.scene.bsdf, tbsdf.PrincipledBSDF)
    # measured 6.1e-5 at iteration 1
    np.testing.assert_allclose(rt.loss_values, rj.loss_values, rtol=0, atol=1e-4)
    shapes = {"sdf": (16, 16, 16), "albedo": (16, 16, 16, 3), "roughness": (2, 2, 2, 1)}
    for k, shape in shapes.items():
        assert tuple(rt.params[k].shape) == tuple(np.shape(rj.params[k])) == shape
    # The textures: Adam's first step is ±lr wherever the gradient is not
    # zero, so a sign flipped by rounding on a tiny gradient would show as
    # 2·lr = 0.08; none does.  Measured: albedo 2.0e-5 (EMA 5.4e-6),
    # roughness 1.1e-6 — a texel's step is lr·g/(|g| + 1e-8), and on texels
    # that few rays reach |g| is within a few orders of 1e-8.
    for k in ("albedo", "roughness"):
        for got, want in ((rt.params[k], rj.params[k]), (rt.ema[k], rj.ema[k])):
            np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=1e-4, err_msg=k)
    assert float((rt.params["albedo"] - 0.5).abs().max()) > 0.07  # the texture gradient reached it
    # The SDF: the EMA at 3e-4 as in test_torch_shape_opt.py (measured
    # 1.2e-4); the grid after the second step agrees to 3e-4 on 98 % of its
    # voxels and differs by up to 2.4e-3 on the rest.  The cause, measured:
    # the two packages' gradients of one view agree to 3e-4 of their largest
    # entry (the tracer's float32 cancellation), which on voxel (7, 4, 7)
    # (gradient -3.1e-5 in the port, -4.0e-5 in the JAX package, against a
    # largest entry of 0.085) is a quarter of the voxel's own gradient.
    # Adam normalises every voxel's step, m̂/√v̂ = 0.977 against 0.952 with
    # the first gradient -1.8e-5, so at lr 0.078 the steps differ by 2.0e-3;
    # redistancing carries that to the voxel's neighbours.  Without textures
    # no such voxel occurs in the first two iterations of this scene.
    np.testing.assert_allclose(to_np(rt.ema["sdf"]), np.asarray(rj.ema["sdf"]), rtol=0, atol=3e-4)
    diff = np.abs(to_np(rt.params["sdf"]) - np.asarray(rj.params["sdf"]))
    assert (diff <= 3e-4).mean() > 0.98 and diff.max() < 5e-3, (float((diff <= 3e-4).mean()), float(diff.max()))
