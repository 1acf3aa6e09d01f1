"""Hybrid scenes of the port vs the JAX package: primal images and grid VJPs
of the mesh, mirror, mixed-mesh and area-light rigs and of the silhouette and
simple-shading integrators, an antithetic image, the AOV images, and the
``torus-shadow`` slice as a whole.  Sizes: 16³ targets, 16² films, 2 spp;
the JAX side runs under ``jax.jit``, one compilation per case (a case's
primal and grad renders in one program).

Cases other than ``torus-shadow`` (the slice's main path) are marked slow:
each JAX compilation takes 8–17 s on one CPU thread, beyond the tier-1
budget of the new cases."""

import dataclasses

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import scenes_zoo as jzoo
from differentiable_sdf_rendering_tpu.models.camera import regular_cameras as jregular_cameras
from differentiable_sdf_rendering_tpu.models.integrator import (
    RenderConfig as JRenderConfig, render as jrender, render_aovs as jrender_aovs,
)
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.ops import mesh_intersect as jmesh
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg
from differentiable_sdf_rendering_tpu_torch.models import scenes_zoo as tzoo
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.ops import mesh_intersect as tmesh
from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
from torch_port_helpers import JIT_LEVEL0, t, to_np

RES = FILM = 16

# (scene, RenderConfig fields): the rigs under the default integrator, MIS,
# the two debug integrators and antithetic sampling; "mirror-opt+floor" is
# the mirror-opt rig with the torus-shadow floor merged into its mesh
# (material "mixed")
CASES = {
    "torus-shadow": ("torus-shadow", {}),
    "mirror-opt": ("mirror-opt", {}),
    "mirror-opt+floor": ("mirror-opt", {}),
    "plane_area": ("plane_area", {}),
    "plane_area-mis": ("plane_area", {"use_mis": True}),
    "torus-shadow-mis": ("torus-shadow", {"use_mis": True}),
    "silhouette": ("torus-shadow", {"integrator": "sdf_silhouette_reparam"}),
    "simple_shading": ("torus-shadow", {"integrator": "sdf_simple_shading_reparam"}),
    "antithetic": ("torus-shadow", {"antithetic_sampling": True}),
}


def _scenes(name, floor=False):
    """The rig of ``name`` with the port's 16³ target in both packages (the
    target, and each package's own rig objects, equal to the JAX package's by
    test_torch_mesh.py::test_new_rigs_match_jax) and one 16² camera; with
    ``floor``, the rig's mesh merged with the torus-shadow floor."""
    data = to_np(tzoo.target_sdf(name, RES, device="cpu"))
    rj, rt = jzoo.scene_rig_full(name), tzoo.scene_rig_full(name, device="cpu")
    mj, mt = rj["mesh"], rt["mesh"]
    if floor:
        mj = jmesh.TriangleMesh.merge([mj, jzoo.scene_rig_full("torus-shadow")["mesh"]])
        mt = tmesh.TriangleMesh.merge([mt, tzoo.scene_rig_full("torus-shadow", device="cpu")["mesh"]])
        assert mj.material == mt.material == "mixed"
    sj = JScene(sdf=JGridSDF.create(jnp.asarray(data)), bsdf=rj["bsdf"], emitter=rj["emitter"],
                cameras=jregular_cameras(1, resx=FILM, resy=FILM), mesh=mj, area_emitter=rj["area_emitter"])
    st = Scene(sdf=GridSDF.create(t(data)), bsdf=rt["bsdf"], emitter=rt["emitter"],
               cameras=regular_cameras(1, resx=FILM, resy=FILM, device="cpu"), mesh=mt,
               area_emitter=rt["area_emitter"])
    return sj, st


@pytest.mark.parametrize("case", [c if c == "torus-shadow" else pytest.param(c, marks=pytest.mark.slow)
                                  for c in CASES])
def test_hybrid_render_matches_jax(case):
    name, fields = CASES[case]
    sj, st = _scenes(name, floor=case.endswith("+floor"))
    cot = np.random.default_rng(0).normal(size=(FILM, FILM, 4)).astype(np.float32)
    cfg_j = JRenderConfig(spp=2, **fields)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(data, cotangent):
        primal = jrender(sj, 0, seed=3, cfg=cfg_j, mode="primal")
        img, vjp = jax.vjp(lambda x: jrender(sj.replace(sdf=JGridSDF.create(x)), 0, seed=5, cfg=cfg_j, mode="grad"),
                           data)
        return primal, img, vjp(cotangent)[0]

    primal_j, img_j, g_j = (np.asarray(x) for x in jax_side(sj.sdf.data, jnp.asarray(cot)))

    cfg_t = tinteg.RenderConfig(spp=2, **fields)
    primal_t = tinteg.render(st, 0, seed=3, cfg=cfg_t, mode="primal", device="cpu")
    leaf = st.sdf.data.clone().requires_grad_(True)
    img_t = tinteg.render(st.replace(sdf=st.sdf.with_data(leaf)), 0, seed=5, cfg=cfg_t, mode="grad", device="cpu")
    img_t.backward(t(cot))
    g_t = to_np(leaf.grad)

    # the same samples (bit-equal random numbers); float32 shading chains and
    # the splat's summation order differ, as in test_torch_render.py
    assert primal_j[..., :3].max() > 0.05
    np.testing.assert_allclose(to_np(primal_t), primal_j, rtol=0, atol=2e-5)
    np.testing.assert_allclose(to_np(img_t), img_j, rtol=0, atol=2e-5)
    # the tracer's derivative accumulators differ by ~1e-3 of a ray's scale
    # (ROADMAP §C gap 1), as in test_torch_render.py's grid VJP
    assert np.abs(g_j).max() > 1.0 and np.all(np.isfinite(g_t))
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())


@pytest.mark.slow
def test_render_aovs_matches_jax():
    sj, st = _scenes("torus-shadow")
    cfg = dict(spp=2)
    want = jax.jit(lambda: jrender_aovs(sj, 0, seed=2, cfg=JRenderConfig(**cfg)))()
    got = tinteg.render_aovs(st, 0, seed=2, cfg=tinteg.RenderConfig(**cfg), device="cpu")
    assert got.keys() == want.keys() and len(got) == 12
    for key in got:
        w = np.asarray(want[key])
        assert tuple(got[key].shape) == (FILM, FILM)
        # trace outputs: atol 1e-5 on its_t and warp_t; the derivative
        # accumulators and the divergence carry gap 1's cancellation
        tol = {"depth": 1e-5, "warp_t": 1e-5, "nx": 1e-5, "ny": 1e-5, "nz": 1e-5, "sdf_value": 1e-6}.get(key)
        if tol is None:
            tol = 1e-3 * max(np.abs(w).max(), 1.0)
        np.testing.assert_allclose(to_np(got[key]), w, rtol=0, atol=tol, err_msg=key)


@pytest.mark.parametrize("name,opt_config", [("torus-shadow", "torus-shadow-1"), ("mirror-opt", "mirror-opt-1"),
                                             ("plane_area", "no-tex-1")])
def test_hybrid_scenes_optimize(name, opt_config, tmp_path):
    """The port's own runs of the three kinds of rig through
    ``optimize_shape`` (one iteration, 8³, 8², 2 spp): finite losses, the
    rig's mesh and area light in the final scene, checkpoints written."""
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape

    opt_cfg, _ = get_opt_config(opt_config)
    opt_cfg = dataclasses.replace(opt_cfg, sdf_res=8, resx=8, resy=8, upsample_iter=(), use_multiscale_rendering=False)
    method = get_config("warp")
    method.spp, method.primal_spp_mult = 2, 1
    result = optimize_shape(name, opt_cfg, method, output_dir=str(tmp_path), n_iter=1, ref_spp=2, target_res=8,
                            verbose=False, device="cpu")
    rig = tzoo.scene_rig_full(name, device="cpu")
    assert np.isfinite(result.loss_values).all() and result.loss_values[0] > 0
    assert (result.scene.mesh is None) == (rig["mesh"] is None)
    assert (result.scene.area_emitter is None) == (rig["area_emitter"] is None)
    assert torch.isfinite(result.params["sdf"]).all()
    assert sorted(p.name for p in (tmp_path / "params").iterdir()) == ["sdf-data-0000.vol", "sdf-final.vol"]


@pytest.mark.slow
def test_torus_shadow_slice_matches_jax():
    """``optimize_shape("torus-shadow", …)`` of both packages: 2 iterations,
    16³ grid and target, 16² film, one view, 2 + 4 spp, no upsampling; the
    floor mesh and the vMF sun of the rig."""
    from differentiable_sdf_rendering_tpu.opt import configs as jconfigs, opt_configs as jopt_configs
    from differentiable_sdf_rendering_tpu.opt.shape_opt import optimize_shape as joptimize_shape
    from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape

    def run(optimize, configs, opt_configs, **kw):
        opt_cfg, _ = opt_configs.get_opt_config("torus-shadow-1")
        opt_cfg = dataclasses.replace(opt_cfg, sdf_res=16, resx=16, resy=16, upsample_iter=(),
                                      use_multiscale_rendering=False)
        method = configs.get_config("warp")
        method.spp, method.primal_spp_mult = 2, 2
        return optimize("torus-shadow", opt_cfg, method, n_iter=2, ref_spp=4, target_res=16, verbose=False, **kw)

    rt = run(optimize_shape, tconfigs, topt_configs, device="cpu")
    rj = run(joptimize_shape, jconfigs, jopt_configs)
    assert rt.scene.mesh is not None and len(rt.loss_values) == 2 and all(np.isfinite(rt.loss_values))
    np.testing.assert_allclose(rt.loss_values, rj.loss_values, rtol=1e-4, atol=0)
    # grid 5e-4 (ROADMAP §C gap 6): measured 4.2e-4 on 1 voxel of 4096 (7
    # beyond 1e-4), the EMA 2.1e-5.  The second step's gradients agree to
    # 3.0e-3 of their largest entry (gap 1); fed the JAX package's gradient
    # of that step, the port's grid is 1.9e-4 off at most.
    for got, want in ((rt.params["sdf"], rj.params["sdf"]), (rt.ema["sdf"], rj.ema["sdf"])):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=5e-4)
