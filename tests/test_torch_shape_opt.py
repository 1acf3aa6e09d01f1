"""The slice as a whole: ``optimize_shape`` of the port vs the JAX package on
one tiny configuration, same seeds: loss per iteration, final grid, EMA; the
files each writes (checkpoints, progress images, ``metadata.json``, the loss
plot) and a resume from them."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.opt import configs as jconfigs, opt_configs as jopt_configs
from differentiable_sdf_rendering_tpu.opt.shape_opt import optimize_shape as joptimize_shape
from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs
from differentiable_sdf_rendering_tpu_torch.opt import shape_opt as tshape_opt
from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape
from differentiable_sdf_rendering_tpu.opt import shape_opt as jshape_opt
from differentiable_sdf_rendering_tpu_torch.ops.sdf import BoxSDF, SphereSDF
from differentiable_sdf_rendering_tpu_torch.utils.io import read_png
from torch_port_helpers import JIT_LEVEL0, to_np

# A two-view 16³ / 16² reconstruction of the 'cubes' scene, 2 grad + 4 primal
# spp.  Which scene: 'torus' (and 'bunny', 'chair') agree with the JAX package
# in loss to 1e-4 but not in the grid after iteration 1, for a reason that is
# float32 rounding and not a difference between the two programs — a few
# shadow rays creep along the surface for all 192 trace steps, their warp
# accumulators are differences of sums of order 1e10, and either framework's
# float32 result is off the float64 one by percents.  The learning rate of a
# 16³ grid is 0.078, so Adam turns that into grid differences of 1e-3.
# test_torus_gap_is_float32_rounding (slow) measures each link of that chain.
# 'cubes' has no such ray in its first two iterations on the CPU.
SCENE = "cubes"
TINY = dict(n_sensors=2, resx=16, resy=16, sdf_res=16, scene_name=SCENE)


def _method(configs):
    method = configs.get_config("warp")
    method.spp, method.primal_spp_mult = 2, 2
    return method


def _run(optimize, configs, opt_configs, n_iter, upsample_iter, scene=SCENE, **kw):
    opt_cfg = opt_configs.SdfConfig(upsample_iter=upsample_iter, **{**TINY, "scene_name": scene})
    return optimize(scene, opt_cfg, _method(configs), n_iter=n_iter, ref_spp=4, target_res=16, verbose=False, **kw)


def _compare(n_iter, upsample_iter, loss_atol, grid_atol, out_dirs=(None, None)):
    """Both packages' runs, held together; with ``out_dirs`` (JAX, port) each
    writes its files there, progress images included."""
    jdir, tdir = out_dirs
    images = {"write_images": True} if tdir else {}
    rt = _run(optimize_shape, tconfigs, topt_configs, n_iter, upsample_iter, device="cpu", output_dir=tdir, **images)
    rj = _run(joptimize_shape, jconfigs, jopt_configs, n_iter, upsample_iter, output_dir=jdir, **images)
    assert len(rt.loss_values) == n_iter and all(np.isfinite(rt.loss_values))
    np.testing.assert_allclose(rt.loss_values, rj.loss_values, rtol=0, atol=loss_atol)
    for got, want in ((rt.params["sdf"], rj.params["sdf"]), (rt.ema["sdf"], rj.ema["sdf"])):
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=grid_atol)
    return rt


def _files(root):
    return sorted(os.path.relpath(os.path.join(base, f), root) for base, _, fs in os.walk(root) for f in fs)


def _check_outputs_match(jdir, tdir):
    """The same files under both output directories (the progress images by
    name and size: their contents are held by the slow
    test_progress_images_match_jax), the losses of ``metadata.json`` within
    1e-4."""
    names = _files(tdir)
    assert names == _files(jdir)
    want = {"metadata.json", "loss.png", "loss.pdf", "params/sdf-data-0000.vol", "params/sdf-data-0001.vol",
            "params/sdf-final.vol", *(f"opt/opt-{i:04d}-{v:02d}.png" for i in range(2) for v in range(2))}
    assert set(names) == want, names
    for name in names:
        if name.startswith("opt/"):
            got, ref = (read_png(os.path.join(d, name)) for d in (tdir, jdir))
            assert got.shape == ref.shape == (16, 16, 3) and got.max() > 0, name
    (mt, mj) = (json.load(open(os.path.join(d, "metadata.json"))) for d in (tdir, jdir))
    np.testing.assert_allclose(mt["loss_values"], mj["loss_values"], rtol=0, atol=1e-4)


def _blank_render(scene, view_idx=None, seed=0, cfg=None, mode="primal", camera=None):
    """A stand-in for the JAX package's progress-image render: a black image
    of the film's size, for the file names alone (the JAX package renders
    op by op, ~20 s here)."""
    return jnp.zeros((camera.resy, camera.resx, 4), jnp.float32)


def _check_resume_matches(tmp_path, jdir, tdir, rt, monkeypatch):
    """``resume_from=1`` of the finished 2-iteration run, with the run's
    ``metadata.json``, without it and with a corrupt one: no iteration left,
    so each package returns the stitched history: the first 2 losses of the
    file, else NaNs; its wall time adds to the file's.  No iteration reads
    the target or its references, so neither package builds them here."""
    for mod, data in ((jshape_opt, jnp.zeros((16, 16, 16))), (tshape_opt, torch.zeros(16, 16, 16))):
        monkeypatch.setattr(mod, "render_reference_images", lambda *a, **k: {})
        monkeypatch.setattr(mod, "target_sdf", lambda *a, _data=data, **k: _data)
    for case in ("present", "absent", "corrupt"):
        dirs = [str(tmp_path / case / name) for name in ("jax", "port")]
        prior = []
        for src, dst in zip((jdir, tdir), dirs):
            shutil.copytree(src, dst)
            meta = os.path.join(dst, "metadata.json")
            prior.append(json.load(open(meta))["total_time"])
            if case == "absent":
                os.remove(meta)
            elif case == "corrupt":
                open(meta, "w").write("{ not json")
        results = [_run(optimize, configs, opt_configs, 2, (), output_dir=d, resume_from=1, **kw)
                   for (optimize, configs, opt_configs, kw), d in zip(
                       ((joptimize_shape, jconfigs, jopt_configs, {}),
                        (optimize_shape, tconfigs, topt_configs, {"device": "cpu"})), dirs)]
        (lj, lt) = (np.asarray(r.loss_values, np.float64) for r in results)
        assert lt.shape == lj.shape == (2,), case
        if case == "present":
            np.testing.assert_array_equal(lt, np.asarray(rt.loss_values))
            np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
        else:
            assert np.isnan(lt).all() and np.isnan(lj).all(), case
        for d, r, before in zip(dirs, results, prior):
            meta = json.load(open(os.path.join(d, "metadata.json")))
            assert meta["total_time"] == pytest.approx(r.total_time)
            assert (r.total_time > before) == (case == "present"), case
        assert torch.equal(results[1].params["sdf"], rt.params["sdf"])


def test_two_iterations_match_jax(tmp_path, monkeypatch):
    # loss 1e-4: a mean over 768 values that each agree to ~2e-5 (measured
    # 1e-5).  Grids 3e-4: the grid gradient carries ~1e-3 relative differences
    # (tracer cancellation), which Adam's normalised step g/(|g|+1e-8)·lr
    # turns into ~2e-5 per iteration on voxels whose gradient is of the order
    # of its epsilon; redistancing then carries an interface voxel's offset
    # outward (measured: 1.2e-4 on 1 voxel of 4096, 6e-5 elsewhere; EMA 6e-6)
    out_dirs = (str(tmp_path / "jax"), str(tmp_path / "port"))
    monkeypatch.setattr(jshape_opt, "render", _blank_render)
    rt = _compare(2, (), loss_atol=1e-4, grid_atol=3e-4, out_dirs=out_dirs)
    assert tuple(rt.params["sdf"].shape) == (16, 16, 16)
    assert rt.ema["sdf"] is not rt.params["sdf"] and len(rt.iter_seconds) == 2
    _check_outputs_match(*out_dirs)
    _check_resume_matches(tmp_path, *out_dirs, rt, monkeypatch)


@pytest.mark.slow
def test_progress_images_match_jax(tmp_path, monkeypatch):
    """The progress images of both packages' tiny run, within 1 of 255
    (images of grids 3e-4 apart, tonemapped); the JAX package's render
    compiled at backend level 0, which rounds as it runs op by op."""
    monkeypatch.setattr(jshape_opt, "render", jax.jit(jshape_opt.render, static_argnames=("view_idx", "cfg", "mode"),
                                                      **JIT_LEVEL0))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _compare(2, (), loss_atol=1e-4, grid_atol=3e-4, out_dirs=(jdir, tdir))
    names = [n for n in _files(tdir) if n.startswith("opt/")]
    assert len(names) == 4 and names == [n for n in _files(jdir) if n.startswith("opt/")]
    for name in names:
        got, ref = (read_png(os.path.join(d, name)).astype(int) for d in (tdir, jdir))
        assert np.abs(got - ref).max() <= 1, name


def test_configs_equal_jax():
    for name in jconfigs.CONFIG_NAMES:
        assert dataclasses.asdict(tconfigs.get_config(name)) == dataclasses.asdict(jconfigs.get_config(name))
    assert tconfigs.CONFIG_NAMES == jconfigs.CONFIG_NAMES
    for name in topt_configs.OPT_CONFIG_NAMES:
        ct, rest_t = topt_configs.get_opt_config(name, ["--n_sensors=4", "--spp=8"])
        cj, rest_j = jopt_configs.get_opt_config(name, ["--n_sensors=4", "--spp=8"])
        assert dataclasses.asdict(ct) == dataclasses.asdict(cj) and rest_t == rest_j == ["--spp=8"]
        assert [ct.sensor_indices(i) for i in range(5)] == [cj.sensor_indices(i) for i in range(5)]
        assert [ct.res_at(i) for i in (0, 100, 200)] == [cj.res_at(i) for i in (0, 100, 200)]
        vt, vj = ct.variables(), cj.variables()
        assert [type(v).__name__ for v in vt] == [type(v).__name__ for v in vj]
        assert [dataclasses.asdict(v) for v in vt] == [dataclasses.asdict(v) for v in vj]
    assert topt_configs.OPT_CONFIG_NAMES == jopt_configs.OPT_CONFIG_NAMES and len(topt_configs.OPT_CONFIG_NAMES) == 71
    principled_12, _ = topt_configs.get_opt_config("principled-12")
    assert [(v.key, v.resolution, v.initial_resolution) for v in principled_12.variables()] == [
        ("sdf", 64, 16), ("albedo", 64, 2), ("roughness", 16, 4)]
    no_tex_12, _ = topt_configs.get_opt_config("no-tex-12")
    assert (no_tex_12.n_sensors, no_tex_12.batch_size, no_tex_12.resx, no_tex_12.sdf_res) == (12, 6, 128, 64)
    m = tconfigs.get_config("warp")
    assert tconfigs.apply_cmdline_args(m, ["--spp=16", "--nope=1", "pos"]) == ["--nope=1", "pos"] and m.spp == 16


def test_unported_options_raise():
    # the method 'fd' no longer raises: it trains as the JAX package trains
    # it (tests/test_torch_opt_tools.py)
    method = tconfigs.get_config("warp")
    cfg = topt_configs.SdfConfig(upsample_iter=(), **TINY)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no card and no device="cpu": raises, no fallback
            optimize_shape(SCENE, cfg, method, n_iter=1)
        with pytest.raises(RuntimeError):
            SphereSDF.create()
        with pytest.raises(RuntimeError):
            BoxSDF.create()


@pytest.mark.slow
def test_with_upsample_matches_jax():
    # the grid doubles (8³ → 16³) before iteration 1: Adam state and EMA
    # reset, two redistancing calls in that iteration.  Three iterations: the
    # losses still agree; the grids agree except where a ray that creeps along
    # the surface gives the two packages float32 gradients a few percent
    # apart and Adam (lr 0.078) turns that into a step (measured: 55 voxels
    # of 4096 beyond 5e-3, max 0.04; test_torus_gap_is_float32_rounding
    # takes that mechanism apart)
    rt = _run(optimize_shape, tconfigs, topt_configs, 3, (1,), device="cpu")
    rj = _run(joptimize_shape, jconfigs, jopt_configs, 3, (1,))
    np.testing.assert_allclose(rt.loss_values, rj.loss_values, rtol=0, atol=2e-4)
    assert tuple(rt.params["sdf"].shape) == tuple(rj.params["sdf"].shape) == (16, 16, 16)
    diff = np.abs(to_np(rt.params["sdf"]) - np.asarray(rj.params["sdf"]))
    assert (diff < 5e-3).mean() > 0.97 and diff.max() < 0.1


@pytest.mark.slow
def test_loss_decreases():
    """Tiny sphere→block reconstruction on the port alone, the configuration
    and criteria of the JAX package's own convergence test (24 iterations)."""
    method = tconfigs.get_config("warp")
    method.spp, method.primal_spp_mult = 4, 2
    opt_cfg = topt_configs.SdfConfig(n_sensors=3, resx=24, resy=24, sdf_res=16, upsample_iter=())
    res = optimize_shape("block", opt_cfg, method, ref_spp=16, n_iter=24, target_res=32, verbose=False, device="cpu")
    losses = np.asarray(res.loss_values)
    assert np.isfinite(losses).all()
    # Adam steps every voxel by ±lr, so the loss may spike in the first few
    # iterations; it must come down over the run.
    tail = losses[-4:].mean()
    assert tail < losses[0] * 0.9, losses
    assert tail < losses.max() * 0.6, losses


@pytest.mark.slow
def test_torus_gap_is_float32_rounding():
    """Why 'torus' is not the tier-1 scene: after iteration 1 its grid differs
    from the JAX package's by ~3e-3 in ~100 voxels.  Each link of the cause is
    measured here on the grid that the JAX package has after iteration 0, for
    view 1 of iteration 1 (gradient seed 12); run with ``-s`` for the numbers.

    1. Two of the 800 gradient lanes have a shadow ray that creeps along the
       surface for all ``max_steps`` trace steps.  Its accumulators are
       differences of sums of order 1e10: in float64 the two packages agree
       to 1e-8, in float32 each is off that value by more than 1e-2.
    2. Those lanes carry the gap of the grid gradient: without them the two
       packages' gradients agree ten times better, to 2e-4 of the largest.
    3. Given the same gradients the two step tails (regulariser, clamp, Adam,
       redistancing, EMA) agree to 5e-6.  The port's tail alone, fed the
       port's and then the JAX package's gradient, gives grids more than 1e-4
       apart (Adam's step is lr·m/√v with lr = 0.078 at 16³), and less than
       1e-4 apart once the creeping lanes are left out of both gradients.
    """
    import jax
    import jax.numpy as jnp

    from differentiable_sdf_rendering_tpu.models import integrator as jint, scenes_zoo as jzoo
    from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
    from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF
    from differentiable_sdf_rendering_tpu.ops.trace import sphere_trace_warp as jtrace
    from differentiable_sdf_rendering_tpu.opt import shape_opt as jso
    from differentiable_sdf_rendering_tpu.opt.adam import adam_init as jadam_init
    from differentiable_sdf_rendering_tpu_torch.models import integrator as tint
    from differentiable_sdf_rendering_tpu_torch.ops.film import BORDER
    from differentiable_sdf_rendering_tpu_torch.ops.interaction import compute_surface_interaction
    from differentiable_sdf_rendering_tpu_torch.ops.sampling import lane_uniforms
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace_warp
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt as tso
    from differentiable_sdf_rendering_tpu_torch.opt.adam import adam_init
    from differentiable_sdf_rendering_tpu_torch.utils.convert import scene_from_numpy
    from torch_port_helpers import jax_scene_to_numpy

    grids = []
    _run(joptimize_shape, jconfigs, jopt_configs, 1, (), scene="torus",
         checkpoint_cb=lambda i, params, losses: grids.append(np.array(params["sdf"])))
    grid0 = grids[0]

    view, seed_g = 1, 12  # iteration 1, second view: seed 2·(1+2) + (1+2), gradient seed + (1+2)
    jopt = jopt_configs.SdfConfig(upsample_iter=(), **{**TINY, "scene_name": "torus"})
    rig = jzoo.scene_rig_full("torus", jopt.param_keys)
    jscene = JScene(sdf=JGridSDF.create(jnp.asarray(grid0)), bsdf=rig["bsdf"], emitter=rig["emitter"],
                    cameras=jso._make_cameras(jopt, 16, 16))
    tscene = scene_from_numpy(jax_scene_to_numpy(jscene), "cpu")
    jm, tm = _method(jconfigs), _method(tconfigs)
    jcfg = jint.RenderConfig(integrator=jm.integrator, spp=jm.spp, warp=jm.warp_config(), trace=jm.trace_params())
    tcfg = tint.RenderConfig(integrator=tm.integrator, spp=tm.spp, warp=tm.warp_config(), trace=tm.trace_params())
    jcam, tcam = jscene.cameras.view(view), tscene.cameras.view(view)

    # ---- 1. the creeping shadow rays, and their accumulators in 32 and 64 bits
    (lane,) = tint.lane_chunks(tcam, tcfg, "cpu")
    pw = 16 + 2 * BORDER
    pix = torch.div(lane, tcfg.spp, rounding_mode="floor")
    uni = lane_uniforms(seed_g, lane, 6)
    pos = torch.stack([(pix % pw).float() - BORDER + uni[:, 0],
                       torch.div(pix, pw, rounding_mode="floor").float() - BORDER + uni[:, 1]], dim=-1)
    o, d = tcam.sample_ray(pos)
    primary = sphere_trace_warp(tscene.sdf, o, d, tcfg.trace)
    si = compute_surface_interaction(tscene.sdf, o, d, primary.its_t, differentiable=False)
    shadow_d = tscene.emitter.sample_direction(uni[:, 2:4])[0]
    shadow_o = si.p + shadow_d * tcfg.shadow_eps
    occlusion = dataclasses.replace(tcfg.trace, refine_intersection=False)
    shadow = sphere_trace_warp(tscene.sdf, shadow_o, shadow_d, occlusion, active=si.valid)
    creeping = (shadow.num_steps >= tcfg.trace.max_steps).nonzero().squeeze(1)
    assert 0 < len(creeping) <= 8 and not bool((primary.num_steps >= tcfg.trace.max_steps).any())
    so, sd = shadow_o[creeping], shadow_d[creeping]
    jocc = dataclasses.replace(jcfg.trace, refine_intersection=False)

    def rel(a, ref):
        a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
        return float((np.abs(a - ref).max(-1) / np.abs(ref).max(-1)).max())

    port32 = shadow.warp_t_d[creeping].numpy()
    jax32 = jtrace(jscene.sdf, jnp.asarray(so.numpy()), jnp.asarray(sd.numpy()), jocc).warp_t_d
    with jax.disable_jit():
        jax32_eager = jtrace(jscene.sdf, jnp.asarray(so.numpy()), jnp.asarray(sd.numpy()), jocc).warp_t_d
    sdf64 = GridSDF(data=tscene.sdf.data.double(), p=tscene.sdf.p.double())
    port64 = sphere_trace_warp(sdf64, so.double(), sd.double(), occlusion).warp_t_d.numpy()
    with jax.enable_x64(True):
        jax64 = np.asarray(jtrace(JGridSDF.create(jnp.asarray(grid0, jnp.float64)), jnp.asarray(so.numpy(), jnp.float64),
                                  jnp.asarray(sd.numpy(), jnp.float64), jocc).warp_t_d)
    assert port64.dtype == jax64.dtype == np.float64
    print(f"\ncreeping shadow lanes {creeping.tolist()}, weight sums {shadow.weight_sum[creeping].tolist()}")
    print(f"warp_t_d: port64 vs jax64 {rel(port64, jax64):.2e}; port32 vs port64 {rel(port32, port64):.2e}; "
          f"jax32 vs port64 {rel(jax32, port64):.2e}; port32 vs jax32 {rel(port32, jax32):.2e}; "
          f"jax32 compiled vs op by op {rel(jax32, jax32_eager):.2e}; port32 vs jax32 op by op {rel(port32, jax32_eager):.2e}")
    assert rel(port64, jax64) < 1e-8
    assert rel(port32, port64) > 1e-2 and rel(jax32, port64) > 1e-2

    # ---- 2. the grid gradient of <dB, block> with and without those lanes
    d_block = np.random.default_rng(0).standard_normal((pw, pw, 5)).astype(np.float32)

    def grad_port(lanes):
        leaf = torch.tensor(grid0, requires_grad=True)
        scene = tscene.replace(sdf=tscene.sdf.with_data(leaf))
        block = tint.render_lane_block(scene, tcam, lanes, seed_g, tcfg, "grad")
        (block * torch.tensor(d_block)).sum().backward()
        return leaf.grad.numpy()

    def grad_jax(lanes):
        lanes = jnp.asarray(lanes.numpy(), jnp.uint32)

        def f(g):
            scene = jscene.replace(sdf=JGridSDF.create(g))
            return jnp.sum(jint.render_lane_block(scene, jcam, lanes, seed_g, jcfg, "grad") * d_block)
        return np.asarray(jax.jit(jax.grad(f))(jnp.asarray(grid0)))

    keep = torch.ones(len(lane), dtype=torch.bool)
    keep[creeping] = False
    gj_all, gt_all = grad_jax(lane), grad_port(lane)
    gj_rest, gt_rest = grad_jax(lane[keep]), grad_port(lane[keep])
    scale = np.abs(gj_all).max()
    gap_all, gap_rest = np.abs(gj_all - gt_all).max() / scale, np.abs(gj_rest - gt_rest).max() / scale
    print(f"grid gradient gap / max|g|: all lanes {gap_all:.2e}, without the creeping lanes {gap_rest:.2e}")
    assert gap_rest < 2e-4 and gap_rest < 0.1 * gap_all

    # ---- 3. two step tails on the same gradients; the port's sensitivity
    ga, gb = gj_all * (0.05 / scale), gj_rest * (0.05 / scale)
    jspecs, tspecs = tuple(jopt.variables()), tuple(topt_configs.SdfConfig(upsample_iter=(), **TINY).variables())
    lrs = [{"sdf": jspecs[0].lr_for(jm.learning_rate, i, 16)} for i in (0, 1)]

    def tail_port(g_second):
        params = {"sdf": torch.tensor(grid0)}
        state, ema = adam_init(params), dict(params)
        for g, lr in zip((ga, g_second), lrs):
            params, state, ema, _ = tso._finish_step(params, state, ema, {"sdf": torch.tensor(g)}, torch.zeros(()), lr,
                                                     specs=tspecs, mask_updates=tm.mask_optimizer)
        return params["sdf"].numpy()

    params = {"sdf": jnp.asarray(grid0)}
    state, ema = jadam_init(params), dict(params)
    for g, lr in zip((ga, gb), lrs):
        params, state, ema, _ = jso._finish_step(dict(params), state, ema, {"sdf": jnp.asarray(g)}, jnp.zeros(()), lr,
                                                 specs=jspecs, mask_updates=jm.mask_optimizer)
    same = tail_port(gb)
    tail_gap = np.abs(same - np.asarray(params["sdf"])).max()
    # the port's tail on each package's own second gradient, all lanes / without the creeping ones
    moved_all = np.abs(tail_port(gt_all * (0.05 / scale)) - tail_port(gj_all * (0.05 / scale)))
    moved_rest = np.abs(tail_port(gt_rest * (0.05 / scale)) - same)
    print(f"step tails on equal gradients: max grid diff {tail_gap:.2e} (lr {lrs[1]['sdf']:.4f}); the port's tail on the "
          f"port's vs the JAX package's gradient: max grid diff {moved_all.max():.2e} ({int((moved_all > 1e-4).sum())} voxels "
          f"beyond 1e-4), without the creeping lanes {moved_rest.max():.2e} ({int((moved_rest > 1e-4).sum())} voxels)")
    assert tail_gap < 5e-6
    assert moved_all.max() > 1e-4 > moved_rest.max()
