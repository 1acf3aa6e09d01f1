"""Rendering of the port vs the JAX package: the primal image and the
grad-mode VJP w.r.t. the grid on the repo's entry scene cut to 16³ / 16² /
2 spp, the grid envmap, and the small pieces of the optimization layer."""

import functools

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
from torch_port_helpers import JIT_LEVEL0, jax_scene_to_numpy, perturbed_sphere, t, to_np


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
                                                             mode="primal"), **JIT_LEVEL0)


def test_render_config_defaults_equal():
    import dataclasses

    jd, td = dataclasses.asdict(JRenderConfig()), dataclasses.asdict(tinteg.RenderConfig())
    jd.pop("dense_splat")  # TPU splat switch
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


@pytest.mark.slow
def test_grad_mode_vjp_to_grid(scenes):
    """The grad-mode image and its VJP to the grid against the JAX package.
    Slow: the tier-1 cases of tests/test_torch_textures.py
    (``test_grad_mode_vjp_to_sdf_and_textures``), tests/test_torch_hybrid.py
    (``torus-shadow``) and tests/test_torch_shape_opt.py run the same warp
    render and its backward pass against the JAX package."""
    sj, st = scenes
    cot = np.random.default_rng(0).normal(size=(16, 16, 4)).astype(np.float32)

    @functools.partial(jax.jit, **JIT_LEVEL0)
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


def test_grad_mode_chunked_backward(scenes):
    """The training loop's chunked backward (a first pass without a graph,
    then one chunk's graph at a time) gives the gradient of the unchunked
    one."""
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt

    _, st = scenes
    params = {"sdf": st.sdf.data}
    ref = torch.zeros(16, 16, 3)
    cfgs = dict(loss_name="l2", cfg_primal=tinteg.RenderConfig(spp=2), cfg_grad=tinteg.RenderConfig(spp=2), batch=1)
    l1, g1 = shape_opt._view_batch_loss_grads(params, st, [0], [3], [5], ref[None], **cfgs)
    l2, g2 = shape_opt._view_batch_loss_grads(params, st, [0], [3], [5], ref[None], max_lanes=300, **cfgs)
    assert float(g1["sdf"].abs().max()) > 0
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
    d = rng.normal(size=(500, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    (dj, pj, rj), eval_j, pdf_j = jax.jit(lambda u, d: (ej.sample_direction(u), ej.eval(d), ej.pdf_direction(d)),
                                          **JIT_LEVEL0)(u, d)
    dt, pt, rt = et.sample_direction(t(u))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(et.eval(t(d))), np.asarray(eval_j), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(et.pdf_direction(t(d))), np.asarray(pdf_j), rtol=1e-5)
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
    grid = perturbed_sphere(8, seed=3)
    p, g = rng.normal(size=(2, 6, 6, 6)).astype(np.float32)
    g[0, 0, :3] = 0.0
    names = ("l1", "l2", "mape", "multiscale_l1")

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(img, ref, grid, p, g):
        out = {name: getattr(jlosses, name)(img, ref) for name in names}
        out["downsample"] = jlosses.downsample_half(img)
        out["grad"] = jax.grad(lambda a: jlosses.multiscale_l1(a, ref))(img)
        out["laplacian"] = jreg.discrete_laplacian_reg(grid)
        for mask in (False, True):
            sj = jadam.adam_init({"sdf": p})
            pj = {"sdf": p}
            for step in range(3):
                pj, sj = jadam.adam_step(pj, {"sdf": g * (1.0 + step)}, sj, {"sdf": 0.05}, mask_updates=mask)
            out[f"adam_{mask}"] = (pj["sdf"], sj["v"]["sdf"], sj["t"]["sdf"], jadam.adam_init({"sdf": p})["v"]["sdf"])
        return out

    want = jax_side(img, ref, grid, p, g)
    for name in names:
        assert float(getattr(tlosses, name)(t(img), t(ref))) == pytest.approx(float(want[name]), rel=1e-5)
    np.testing.assert_allclose(to_np(tlosses.downsample_half(t(img))), np.asarray(want["downsample"]), atol=1e-6)
    x = t(img).requires_grad_(True)
    tlosses.multiscale_l1(x, t(ref)).backward()
    np.testing.assert_allclose(to_np(x.grad), np.asarray(want["grad"]), rtol=1e-5, atol=1e-8)
    assert float(treg.discrete_laplacian_reg(t(grid))) == pytest.approx(float(want["laplacian"]), rel=1e-5)

    for mask in (False, True):
        p_j, v_j, t_j, v0 = want[f"adam_{mask}"]
        s_t = convert.adam_state_from_numpy(
            {"m": {"sdf": np.zeros_like(p)}, "v": {"sdf": np.asarray(v0)}, "t": {"sdf": 0}}, "cpu")
        pt = {"sdf": t(p)}
        for step in range(3):
            pt, s_t = tadam.adam_step(pt, {"sdf": t(g * (1.0 + step))}, s_t, {"sdf": 0.05}, mask_updates=mask)
        np.testing.assert_allclose(to_np(pt["sdf"]), np.asarray(p_j), rtol=1e-5, atol=1e-6)
        back = convert.adam_state_to_numpy(s_t)
        assert back["t"]["sdf"] == int(t_j) == 3
        np.testing.assert_allclose(back["v"]["sdf"], np.asarray(v_j), rtol=1e-5, atol=1e-9)
    assert tadam.simple_lr_decay(0.04, 0.02, 490) == pytest.approx(float(jadam.simple_lr_decay(0.04, 0.02, 490)))


def test_variables_and_initializers():
    grid = perturbed_sphere(8, seed=4)
    moved = (grid * 1.5 + 0.05).astype(np.float32)
    vol = np.random.default_rng(5).random((4, 4, 4, 3)).astype(np.float32)
    g = np.array([np.nan, -3.0, 0.05, 2.0], np.float32)
    spec_t, spec_j = tvars.SdfVariableSpec(resolution=16, upsample_iter=(3,)), jvars.SdfVariableSpec(resolution=16, upsample_iter=(3,))

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(grid, moved, vol, g):
        return {
            "box8": jvars.box_sdf_grid(8), "box_non_cubic": jvars.box_sdf_grid((6, 8, 10)),
            "centers": jinit.voxel_centers((4, 6, 8)), "sphere": jinit.create_sphere_sdf(16),
            "upsample": jinit.upsample_sdf(grid), "upsample_volume": jinit.upsample_volume(vol),
            "validate": spec_j.validate(moved, -1), "validate_gradient": spec_j.validate_gradient(g),
            "ema": jvars.ema_update(grid, moved, 0.95),
        }

    want = {k: np.asarray(v) for k, v in jax_side(grid, moved, vol, g).items()}
    for res, key in ((8, "box8"), ((6, 8, 10), "box_non_cubic")):
        np.testing.assert_allclose(to_np(tvars.box_sdf_grid(res, device="cpu")), want[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(tinit.voxel_centers((4, 6, 8), device="cpu")), want["centers"], atol=1e-7)
    np.testing.assert_allclose(to_np(tinit.create_sphere_sdf(16, device="cpu")), want["sphere"], rtol=0, atol=5e-6)
    np.testing.assert_allclose(to_np(tinit.upsample_sdf(t(grid))), want["upsample"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(tinit.upsample_volume(t(vol))), want["upsample_volume"], rtol=1e-5, atol=1e-6)

    assert spec_t == tvars.SdfVariableSpec(**{f: getattr(spec_j, f) for f in spec_j.__dataclass_fields__})
    assert spec_t.initial_resolution == 8
    assert spec_t.lr_for(0.04, 7, 16) == pytest.approx(float(spec_j.lr_for(0.04, 7, 16)))
    # bbox clamp + redistance
    np.testing.assert_allclose(to_np(spec_t.validate(t(moved), -1)), want["validate"], rtol=0, atol=5e-6)
    assert tuple(spec_t.validate(t(moved), 3).shape) == (16, 16, 16)  # the scheduled upsample
    np.testing.assert_array_equal(to_np(spec_t.validate_gradient(t(g))), want["validate_gradient"])
    a, b = t(grid), t(moved)
    np.testing.assert_allclose(to_np(tvars.ema_update(a, b, 0.95)), want["ema"], rtol=1e-6)
    assert tvars.ema_update(None, b, 0.95) is b and tvars.ema_update(torch.zeros(2), b, 0.95) is b


def test_block_and_noisy_sphere_initializers():
    """``create_block_sdf`` and ``create_sphere_sdf`` with ``noise_sigma``
    against the JAX package (one jitted program).  The noise is the JAX
    package's ``jax.random.normal(PRNGKey(seed))`` draw: its uniform bits
    bit-equal, its inverse error function Giles' polynomial as XLA
    evaluates it, so the draws agree within a few ulps (measured 3 at most);
    the grids then differ by redistancing's rounding (ROADMAP §C gap 1)."""
    from jax import random as jrandom

    res = (16, 12, 14)
    want = jax.jit(lambda: (jinit.create_block_sdf(16), jinit.create_sphere_sdf(res, noise_sigma=0.05, seed=3),
                            jrandom.normal(jrandom.PRNGKey(3), res)))()
    block, noisy, noise = (np.asarray(x) for x in want)
    np.testing.assert_allclose(to_np(tinit.create_block_sdf(16, device="cpu")), block, rtol=0, atol=5e-6)
    got = to_np(tinit.normal_noise(3, res, device="cpu"))
    assert np.abs(noise).max() > 3.0
    np.testing.assert_allclose(got, noise, rtol=0, atol=4 * np.spacing(np.float32(np.abs(noise).max())))
    np.testing.assert_allclose(to_np(tinit.create_sphere_sdf(res, noise_sigma=0.05, seed=3, device="cpu")), noisy,
                               rtol=0, atol=5e-6)
    assert block.min() < 0 < block.max()


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
    """What the JAX package refuses too: PRB with the conv warp, and a
    mirror scene with it."""
    from differentiable_sdf_rendering_tpu_torch.ops.mesh_intersect import TriangleMesh
    from differentiable_sdf_rendering_tpu_torch.ops.warp_conv import ConvWarpConfig

    _, st = scenes
    with pytest.raises(NotImplementedError):
        tinteg.render(st, 0, cfg=tinteg.RenderConfig(spp=1, integrator="sdf_prb_reparam", warp_kind="conv"),
                      device="cpu")
    rect = TriangleMesh.create([[-1, -1, -0.2], [2, -1, -0.2], [2, 2, -0.2], [-1, 2, -0.2]], [[0, 1, 2], [0, 2, 3]],
                               material="mirror", device="cpu")
    mirror = st.replace(mesh=rect)
    conv = tinteg.RenderConfig(spp=1, warp_kind="conv", conv=ConvWarpConfig(n_aux_rays=1))
    for mode in ("primal", "grad"):
        with pytest.raises(NotImplementedError):
            tinteg.render(mirror, 0, cfg=conv, mode=mode, device="cpu")
    with pytest.raises(ValueError):
        tinteg.render(st, 0, cfg=tinteg.RenderConfig(spp=1), device="meta")
