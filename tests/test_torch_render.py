"""Rendering of the port vs the JAX package: the primal image and the
grad-mode VJP w.r.t. the grid on the repo's entry scene cut to 16³ / 16² /
2 spp, the grid envmap, and the small pieces of the optimization layer."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import emitter as jemitter
from differentiable_sdf_rendering_tpu.models.camera import regular_cameras as jregular_cameras
from differentiable_sdf_rendering_tpu.models.integrator import RenderConfig as JRenderConfig, render as jrender
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.ops import initializers as jinit
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF
from differentiable_sdf_rendering_tpu.opt import adam as jadam, losses as jlosses, regularizations as jreg, variables as jvars
from differentiable_sdf_rendering_tpu_torch.models import emitter as temitter
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg
from differentiable_sdf_rendering_tpu_torch.ops import initializers as tinit
from differentiable_sdf_rendering_tpu_torch.opt import adam as tadam, losses as tlosses, regularizations as treg, variables as tvars
from differentiable_sdf_rendering_tpu_torch.utils import convert
from torch_port_helpers import jax_scene_to_numpy, perturbed_sphere, t, to_np


@pytest.fixture(scope="module")
def scenes():
    """The ``__graft_entry__.entry`` scene (sphere SDF, two regular cameras,
    diffuse BSDF) cut to 16³ / 16², under the default rig's gradient sky; the
    port's copy is carried across as numpy by ``utils/convert``.  The JAX
    functions of this file run under ``jax.jit``: one XLA program each
    instead of one compilation per primitive (the same values up to XLA's
    fusion, far inside every tolerance below)."""
    sj = JScene.create(
        jax.jit(lambda: jinit.create_sphere_sdf(16, radius=0.3))(),
        cameras=jregular_cameras(2, resx=16, resy=16),
        emitter=jemitter.make_gradient_envmap(),
    )
    return sj, convert.scene_from_numpy(jax_scene_to_numpy(sj), "cpu")


# view and seed are traced: the two primal cases share one compilation
_jrender_primal = jax.jit(lambda scene, view, seed: jrender(scene, view, seed=seed, cfg=JRenderConfig(spp=2),
                                                             mode="primal"))


def test_render_config_defaults_equal():
    import dataclasses

    jd, td = dataclasses.asdict(JRenderConfig()), dataclasses.asdict(tinteg.RenderConfig())
    for dropped in ("dense_splat", "conv"):  # TPU splat switch; unported baseline's settings
        jd.pop(dropped)
    jd["trace"], td["trace"] = dict(jd["trace"]), dict(td["trace"])
    assert jd == td


@pytest.mark.parametrize("view,seed", [(0, 0), (1, 5)])
def test_primal_image(scenes, view, seed):
    sj, st = scenes
    want = np.asarray(_jrender_primal(sj, view, seed))
    got = tinteg.render(st, view, seed=seed, cfg=tinteg.RenderConfig(spp=2), mode="primal", device="cpu")
    assert tuple(got.shape) == (16, 16, 4) and not got.requires_grad
    # same samples (bit-equal random numbers); float32 shading chains and the
    # splat's summation order differ
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=2e-5)
    chunked = tinteg.render_chunked(
        st, view, seed=seed, cfg=tinteg.RenderConfig(spp=2), mode="primal", n_chunks=2, device="cpu"
    )
    np.testing.assert_allclose(to_np(chunked), to_np(got), rtol=0, atol=2e-5)
    with pytest.raises(ValueError):
        tinteg.lane_chunks(st.cameras.view(0), tinteg.RenderConfig(spp=4), "cpu", n_chunks=3)
    capped = tinteg.render_chunked(
        st, view, seed=seed, cfg=tinteg.RenderConfig(spp=2), mode="primal", max_lanes=300, device="cpu"
    )
    np.testing.assert_allclose(to_np(capped), to_np(got), rtol=0, atol=2e-5)


def test_grad_mode_vjp_to_grid(scenes):
    sj, st = scenes
    cot = np.random.default_rng(0).normal(size=(16, 16, 4)).astype(np.float32)

    @jax.jit
    def image_and_vjp(data, cotangent):
        def fj(d):
            return jrender(sj.replace(sdf=JGridSDF.create(d)), 0, seed=5, cfg=JRenderConfig(spp=2), mode="grad")

        img, vjp = jax.vjp(fj, data)
        return img, vjp(cotangent)[0]

    img_j, g_j = image_and_vjp(sj.sdf.data, jnp.asarray(cot))
    g_j = np.asarray(g_j)

    leaf = st.sdf.data.clone().requires_grad_(True)
    scene = st.replace(sdf=st.sdf.with_data(leaf))
    img = tinteg.render(scene, 0, seed=5, cfg=tinteg.RenderConfig(spp=2), mode="grad", device="cpu")
    np.testing.assert_allclose(to_np(img), np.asarray(img_j), rtol=0, atol=2e-5)
    img.backward(t(cot))
    g_t = to_np(leaf.grad)
    assert np.abs(g_j).max() > 1.0 and np.all(np.isfinite(g_t))
    # the tracer's derivative accumulators carry ~1e-3 relative differences
    # per ray (cancellation); a voxel sums the terms of many rays, so the
    # absolute floor is 1e-3 of the largest entry rather than 1e-6
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())
    # the chunked backward of the training loop gives the same gradient
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt

    params = {"sdf": st.sdf.data}
    ref = torch.zeros(16, 16, 3)
    cfgs = dict(loss_name="l2", cfg_primal=tinteg.RenderConfig(spp=2), cfg_grad=tinteg.RenderConfig(spp=2), batch=1)
    l1, g1 = shape_opt._view_batch_loss_grads(params, st, [0], [3], [5], ref[None], **cfgs)
    l2, g2 = shape_opt._view_batch_loss_grads(params, st, [0], [3], [5], ref[None], max_lanes=300, **cfgs)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    np.testing.assert_allclose(to_np(g2["sdf"]), to_np(g1["sdf"]), rtol=1e-4, atol=1e-5 * float(g1["sdf"].abs().max()))


def test_grid_envmap(scenes):
    sj, st = scenes
    ej, et = sj.emitter, st.emitter
    # the port's own table build, from the same image
    built = temitter.GridEnvmap.create(np.asarray(ej.image), device="cpu")
    np.testing.assert_array_equal(to_np(built.alias_idx), np.asarray(ej.alias_idx))
    np.testing.assert_allclose(to_np(built.alias_prob), np.asarray(ej.alias_prob), rtol=1e-6)
    np.testing.assert_allclose(to_np(built.pdf_table), np.asarray(ej.pdf_table), rtol=1e-6)
    own = temitter.make_gradient_envmap(device="cpu")
    np.testing.assert_allclose(to_np(own.image), np.asarray(ej.image), rtol=1e-5, atol=1e-6)

    rng = np.random.default_rng(1)
    u = rng.random((500, 2)).astype(np.float32)
    dj, pj, rj = ej.sample_direction(jnp.asarray(u))
    dt, pt, rt = et.sample_direction(t(u))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=1e-6)
    d = rng.normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    np.testing.assert_allclose(to_np(et.eval(t(d))), np.asarray(ej.eval(jnp.asarray(d))), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(et.pdf_direction(t(d))), np.asarray(ej.pdf_direction(jnp.asarray(d))), rtol=1e-5)
    # pdf and radiance of the samples: the cell is re-derived from the
    # direction, which on a rounding-width sliver picks the neighbouring
    # texel (on either side) — allow a few such samples
    ok = np.isclose(to_np(pt), np.asarray(pj), rtol=1e-4)
    assert ok.mean() > 0.98
    np.testing.assert_allclose(to_np(rt)[ok], np.asarray(rj)[ok], rtol=1e-3, atol=1e-4)


def test_diffuse_bsdf_and_constant_emitter():
    from differentiable_sdf_rendering_tpu.models.bsdf import DiffuseBSDF as JDiffuse
    from differentiable_sdf_rendering_tpu.ops.interaction import SurfaceInteraction as JSI
    from differentiable_sdf_rendering_tpu.ops.sdf import SphereSDF as JSphere
    from differentiable_sdf_rendering_tpu_torch.models.bsdf import DiffuseBSDF
    from differentiable_sdf_rendering_tpu_torch.ops.interaction import SurfaceInteraction
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import SphereSDF

    rng = np.random.default_rng(6)
    n = 64
    v = rng.normal(size=(4, n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    wi, wo, p = v[0], v[1], rng.random((n, 3)).astype(np.float32)
    u = rng.random((n, 2)).astype(np.float32)
    mk = lambda cls, f: cls(valid=f(np.ones(n, bool)), t=f(np.ones(n, np.float32)), p=f(p), n=f(v[2]), s=f(v[3]), b=f(v[3]), wi=f(wi))
    si_j = mk(JSI, jnp.asarray)
    si_t = mk(SurfaceInteraction, lambda a: torch.tensor(a))
    bj, bt = JDiffuse.create((0.7, 0.5, 0.3)), DiffuseBSDF.create((0.7, 0.5, 0.3), device="cpu")
    np.testing.assert_allclose(to_np(bt.eval(si_t, t(wo))), np.asarray(bj.eval(si_j, jnp.asarray(wo))), rtol=1e-6, atol=1e-7)
    for got, want in zip(bt.eval_pdf(si_t, t(wo)), bj.eval_pdf(si_j, jnp.asarray(wo))):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(bt.pdf(si_t, t(wo))), np.asarray(bj.eval_pdf(si_j, jnp.asarray(wo))[1]), rtol=1e-6, atol=1e-7)
    for got, want in zip(bt.sample(si_t, t(u)), bj.sample(si_j, jnp.asarray(u))):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-6)

    ej, et = jemitter.ConstantEmitter.create((1.0, 0.5, 0.25)), temitter.ConstantEmitter.create((1.0, 0.5, 0.25), device="cpu")
    for got, want in zip(et.sample_direction(t(u)), ej.sample_direction(jnp.asarray(u))):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(to_np(et.pdf_direction(t(wo))), np.asarray(ej.pdf_direction(jnp.asarray(wo))), rtol=1e-6)

    x = (p * 1.2 - 0.1).astype(np.float32)
    for got, want in zip(SphereSDF.create(device="cpu").eval_all(t(x)), JSphere.create().eval_all(jnp.asarray(x))):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(to_np(SphereSDF.create(device="cpu").eval_and_grad(t(x))[1]), np.asarray(JSphere.create().eval_grad(jnp.asarray(x))), atol=1e-6)


def test_losses_regulariser_adam():
    rng = np.random.default_rng(2)
    img, ref = rng.random((2, 16, 16, 3)).astype(np.float32)
    for name in ("l1", "l2", "mape", "multiscale_l1"):
        want = float(getattr(jlosses, name)(jnp.asarray(img), jnp.asarray(ref)))
        assert float(getattr(tlosses, name)(t(img), t(ref))) == pytest.approx(want, rel=1e-5)
    np.testing.assert_allclose(
        to_np(tlosses.downsample_half(t(img))), np.asarray(jlosses.downsample_half(jnp.asarray(img))), atol=1e-6
    )
    x = t(img).requires_grad_(True)
    tlosses.multiscale_l1(x, t(ref)).backward()
    gj = jax.grad(lambda a: jlosses.multiscale_l1(a, jnp.asarray(ref)))(jnp.asarray(img))
    np.testing.assert_allclose(to_np(x.grad), np.asarray(gj), rtol=1e-5, atol=1e-8)

    grid = perturbed_sphere(8, seed=3)
    assert float(treg.discrete_laplacian_reg(t(grid))) == pytest.approx(
        float(jreg.discrete_laplacian_reg(jnp.asarray(grid))), rel=1e-5)

    p, g = rng.normal(size=(2, 6, 6, 6)).astype(np.float32)
    g[0, 0, :3] = 0.0
    for mask in (False, True):
        sj = jadam.adam_init({"sdf": jnp.asarray(p)})
        s_t = convert.adam_state_from_numpy(
            {"m": {"sdf": np.asarray(sj["m"]["sdf"])}, "v": {"sdf": np.asarray(sj["v"]["sdf"])}, "t": {"sdf": 0}}, "cpu")
        pj, pt = {"sdf": jnp.asarray(p)}, {"sdf": t(p)}
        for step in range(3):
            gg = g * (1.0 + step)
            pj, sj = jadam.adam_step(pj, {"sdf": jnp.asarray(gg)}, sj, {"sdf": 0.05}, mask_updates=mask)
            pt, s_t = tadam.adam_step(pt, {"sdf": t(gg)}, s_t, {"sdf": 0.05}, mask_updates=mask)
        np.testing.assert_allclose(to_np(pt["sdf"]), np.asarray(pj["sdf"]), rtol=1e-5, atol=1e-6)
        back = convert.adam_state_to_numpy(s_t)
        assert back["t"]["sdf"] == int(sj["t"]["sdf"]) == 3
        np.testing.assert_allclose(back["v"]["sdf"], np.asarray(sj["v"]["sdf"]), rtol=1e-5, atol=1e-9)
    assert tadam.simple_lr_decay(0.04, 0.02, 490) == pytest.approx(float(jadam.simple_lr_decay(0.04, 0.02, 490)))


def test_variables_and_initializers():
    for res in (8, (6, 8, 10)):
        np.testing.assert_allclose(
            to_np(tvars.box_sdf_grid(res, device="cpu")), np.asarray(jvars.box_sdf_grid(res)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        to_np(tinit.voxel_centers((4, 6, 8), device="cpu")), np.asarray(jinit.voxel_centers((4, 6, 8))), atol=1e-7)
    np.testing.assert_allclose(
        to_np(tinit.create_sphere_sdf(16, device="cpu")), np.asarray(jinit.create_sphere_sdf(16)), rtol=0, atol=5e-6)
    grid = perturbed_sphere(8, seed=4)
    np.testing.assert_allclose(
        to_np(tinit.upsample_sdf(t(grid))), np.asarray(jinit.upsample_sdf(jnp.asarray(grid))), rtol=1e-5, atol=1e-6)
    vol = np.random.default_rng(5).random((4, 4, 4, 3)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tinit.upsample_volume(t(vol))), np.asarray(jinit.upsample_volume(jnp.asarray(vol))), rtol=1e-5, atol=1e-6)

    spec_t, spec_j = tvars.SdfVariableSpec(resolution=16, upsample_iter=(3,)), jvars.SdfVariableSpec(resolution=16, upsample_iter=(3,))
    assert spec_t == tvars.SdfVariableSpec(**{f: getattr(spec_j, f) for f in spec_j.__dataclass_fields__})
    assert spec_t.initial_resolution == 8
    assert spec_t.lr_for(0.04, 7, 16) == pytest.approx(float(spec_j.lr_for(0.04, 7, 16)))
    moved = (grid * 1.5 + 0.05).astype(np.float32)
    np.testing.assert_allclose(  # bbox clamp + redistance
        to_np(spec_t.validate(t(moved), -1)), np.asarray(spec_j.validate(jnp.asarray(moved), -1)), rtol=0, atol=5e-6)
    assert tuple(spec_t.validate(t(moved), 3).shape) == (16, 16, 16)  # the scheduled upsample
    g = np.array([np.nan, -3.0, 0.05, 2.0], np.float32)
    np.testing.assert_array_equal(to_np(spec_t.validate_gradient(t(g))), np.asarray(spec_j.validate_gradient(jnp.asarray(g))))
    a, b = t(grid), t(moved)
    np.testing.assert_allclose(to_np(tvars.ema_update(a, b, 0.95)), np.asarray(jvars.ema_update(jnp.asarray(grid), jnp.asarray(moved), 0.95)), rtol=1e-6)
    assert tvars.ema_update(None, b, 0.95) is b and tvars.ema_update(torch.zeros(2), b, 0.95) is b


def test_convert_round_trip(scenes):
    _, st = scenes
    d = convert.scene_to_numpy(st)
    again = convert.scene_to_numpy(convert.scene_from_numpy(d, "cpu"))
    assert d.keys() == again.keys()
    for k in d:
        np.testing.assert_array_equal(np.asarray(d[k]), np.asarray(again[k]), err_msg=k)
    params = {"sdf": st.sdf.data}
    back = convert.params_from_numpy(convert.params_to_numpy(params), "cpu")
    assert torch.equal(back["sdf"], params["sdf"])


def test_unported_paths_raise(scenes):
    _, st = scenes
    for bad in (dict(warp_kind="conv"), dict(integrator="sdf_prb_reparam", warp_kind="conv")):
        with pytest.raises(NotImplementedError):
            tinteg.render(st, 0, cfg=tinteg.RenderConfig(spp=1, **bad), device="cpu")
    with pytest.raises(ValueError):
        tinteg.render(st, 0, cfg=tinteg.RenderConfig(spp=1), device="meta")
