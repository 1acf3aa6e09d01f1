#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network.  Imports only the port
(``differentiable_sdf_rendering_tpu_torch``).  Phases, each printing one JSON
line; any failure raises and the script exits non-zero:

1. ``device``  — card, power limit, torch / CUDA versions.
2. ``build``   — compiles every kernel under ``csrc/`` with ``nvcc`` (one
   compiler per source, all started together).
3. ``kernels`` — each kernel against its plain PyTorch version on the card,
   at the shapes the training path gives it, with CUDA-event timings:
   redistancing at 16³, 32³, 64³ and the 128³ target (with the CUDA
   launches of one call as the kernel's C entry counts them); the sphere
   trace on one 2²¹-lane primal chunk of a ``bunny`` view (camera rays and
   the shadow rays from their hits) at a 64³ grid and at the 128³ target;
   the detached grid evaluation at 2²¹ points near the surface.
4. ``reference`` — a small primal render on the card against the same
   package's plain path on the host.
5. ``train``   — ``optimize_shape("bunny", no-tex-12, warp)`` at the
   published widths (12 views, batches of 6, 128² film, 64 + 256 spp, grid
   16³ → 32³ → 64³) for a few iterations, writing checkpoints and
   ``metadata.json``; depth (iterations, reference spp) is cut.  Kernel
   launch counts are zeroed just before and read just after; every kernel
   must have run, and the grid must pass through 16³, 32³ and 64³.
6. ``cli``     — the two command-line entry points in-process:
   ``optimize_torch.main`` (``bunny``, ``no-tex-12``, 1 iteration) and
   ``render_turntable_torch.main`` on its checkpoint at the CLI's published
   512², 256 spp, 4 of its 64 frames; counts zeroed before and read after.
7. the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and the
   final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import importlib.metadata
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

# Published peaks of one H100 SXM: HBM bytes/s and fp32 FLOP/s outside the
# tensor cores.  Used for the lower bound on a kernel's time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Arithmetic of one voxel in one Godunov pass (csrc/redistance.cu): 3
# neighbour mins, 4 for the sorting network, 4 for a2, 1 + 13 + 16 for the
# three candidate solutions, 4 for the selection, 2 for min and frozen select.
REDISTANCE_OPS_PER_VOXEL_PASS = 47
# Arithmetic of one value-only grid evaluation in csrc/sphere_trace.cu (see
# csrc/tricubic.cuh), counted for the separable contraction, the fewest
# operations the function needs (the kernel itself sums the 64 taps in the
# plain version's non-separable order, to match its rounding): ray point 9;
# per axis 4 for the fraction and 19 for the basis weights (69); contraction
# 16 rows x (4 products, 3 adds) over x, 4 x 7 over y, 7 over z (147); step
# and tests 5.  Integer index arithmetic is not counted.
TRACE_OPS_PER_EVAL = 230
# Per ray of the trace kernel: o, d (24 B), t0, maxt, trace_eps (12 B),
# active, refine_active (2 B) read; its_t, num_steps (8 B) written.
TRACE_BYTES_PER_RAY = 46
# Arithmetic of one value-and-gradient evaluation in csrc/grid_eval.cu, again
# for the separable contraction: point 3; per axis 4 for the fraction, 19 for
# the weights and 14 for their derivatives (111); contraction: per (z, y) row
# the sums over x with wx and with dwx (16 x 14 = 224), per z three sums over
# y (wy a, wy b, dwy a: 4 x 21 = 84), four sums over z (value, d/dx, d/dy
# with wz, d/dz with dwz: 28); gradient scaling 3.
GRID_EVAL_OPS_PER_POINT = 453
GRID_EVAL_BYTES_PER_POINT = 28


def emit(obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, repeats=10, warmup=2):
    """Median CUDA-event milliseconds of ``fn()`` over ``repeats`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def triton_version():
    """Version of the installed ``triton`` package, None where there is none
    (this slice has no Triton kernel; recorded for the environment only)."""
    try:
        return importlib.metadata.version("triton")
    except importlib.metadata.PackageNotFoundError:
        return None


def level_sets(res, rng):
    """Two test inputs per resolution (numpy, from the seeded ``rng``): a
    noise-perturbed sphere SDF and a level set that is not a distance."""
    import numpy as np

    c = (np.arange(res, dtype=np.float32) + 0.5) / res
    z, y, x = np.meshgrid(c, c, c, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    perturbed = (r - 0.3 + 0.02 * rng.standard_normal(r.shape)).astype(np.float32)
    non_sdf = ((r - 0.28) * 3.0 * (1.0 + 0.5 * np.sin(7.0 * x) * np.cos(5.0 * y))).astype(np.float32)
    return {"perturbed_sphere": perturbed, "non_sdf": non_sdf}, (r - 0.28).astype(np.float32)


def phase_kernels(device):
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import redistance as rd

    rng = np.random.default_rng(0)
    by_res = {}
    max_err = 0.0
    for res in (16, 32, 64, 128):
        inputs, true_dist = level_sets(res, rng)
        for name, phi_np in inputs.items():
            phi = torch.as_tensor(phi_np, device=device)
            sign = torch.where(phi >= 0.0, 1.0, -1.0).to(torch.float32)
            dist0, frozen = rd._interface_init(phi, rd._spacing(phi.shape))
            for iters in sorted({0, 5, res}):
                got = rd.redistance(phi, iterations=iters)
                want = rd.redistance_plain(dist0, frozen, sign, iters)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                # tolerance: none — the kernel is compiled without FMA
                # contraction and must equal the plain version bit for bit
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"redistance kernel != plain version at {res}^3 / {name} / "
                        f"{iters} passes: max abs diff {err}"
                    )
            if name == "non_sdf":
                # sanity: the zero level set is the r = 0.28 sphere, so the
                # result must be its distance up to the scheme's error: first
                # order in h, plus the float32 cancellation in the quadratic
                # solve, which at 128^3 reaches 0.04 (in the JAX package's
                # solver as well; in float64 the same passes stay below 0.003)
                h = 1.0 / res
                band = np.abs(true_dist) < 0.15
                dev = np.abs(got.cpu().numpy() - true_dist)[band].max()
                if not dev < max(2.0 * h, 0.05):
                    raise AssertionError(f"redistance off the sphere distance by {dev} at {res}^3")
        # timings on the perturbed sphere, full pass count
        phi = torch.as_tensor(inputs["perturbed_sphere"], device=device)
        sign = torch.where(phi >= 0.0, 1.0, -1.0).to(torch.float32)
        dist0, frozen = rd._interface_init(phi, rd._spacing(phi.shape))
        n = res ** 3
        ops = REDISTANCE_OPS_PER_VOXEL_PASS * n * res + 2 * n
        nbytes = n * (4 + 1 + 4 + 4)  # dist0, frozen, sign read once; out written once
        t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
        # CUDA launches of one call, counted by redistance_run itself
        before = rd.redistance.cuda_launches
        rd._redistance_kernel(dist0, frozen, sign, res)
        cuda_launches = rd.redistance.cuda_launches - before
        ms = cuda_ms(lambda: rd._redistance_kernel(dist0, frozen, sign, res))
        by_res[res] = {
            "ms": ms,
            "plain_ms": cuda_ms(lambda: rd.redistance_plain(dist0, frozen, sign, res), repeats=10 if res < 128 else 3, warmup=1),
            "wrapper_ms": cuda_ms(lambda: rd.redistance(phi)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "cuda_launches_per_call": cuda_launches,
            "us_per_cuda_launch": ms * 1e3 / cuda_launches,
        }
    # a non-cubic grid on the card has no kernel yet: it must raise, not
    # fall back to the plain version
    try:
        rd.redistance(torch.full((8, 12, 16), 0.1, device=device))
    except NotImplementedError:
        pass
    else:
        raise AssertionError("redistance accepted a non-cubic CUDA grid")
    emit({"phase": "kernels", "redistance": {"max_abs_diff": max_err, "by_res": by_res}})
    return max_err, by_res


def primal_chunk_rays(device):
    """Camera rays of the first lane chunk of a primal render of view 0 of
    the ``no-tex-12`` rig (128² film, 256 spp), as ``render_lane_block``
    makes them, and the uniforms of those lanes."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, lane_chunks
    from differentiable_sdf_rendering_tpu_torch.ops.film import BORDER
    from differentiable_sdf_rendering_tpu_torch.ops.sampling import lane_uniforms

    cfg = RenderConfig(spp=256)
    cam = regular_cameras(12, resx=128, resy=128, device=device).view(0)
    lane = lane_chunks(cam, cfg, device)[0]
    pw = cam.resx + 2 * BORDER
    pix = torch.div(lane, cfg.spp, rounding_mode="floor")
    py = torch.div(pix, pw, rounding_mode="floor").to(torch.float32) - BORDER
    px = (pix % pw).to(torch.float32) - BORDER
    uni = lane_uniforms(0, lane, 6)
    o, d = cam.sample_ray(torch.stack([px + uni[:, 0], py + uni[:, 1]], dim=-1))
    return o, d, uni, cfg.trace


def trace_case(sdf, o, d, params, lanes_kw):
    """K1 against its plain version on one set of rays: agreement, CUDA-event
    times of the bare launch and of the plain version, and the bound from
    the steps this run's rays took."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    its_k, evals_per_ray = tr._sphere_trace_kernel(sdf, o, d, params, **lanes_kw)
    its_p = tr.sphere_trace_plain(sdf, o, d, params, **lanes_kw)
    torch.cuda.synchronize()
    hit_k, hit_p = torch.isfinite(its_k), torch.isfinite(its_p)
    both = hit_k & hit_p
    hit_diff = float((hit_k != hit_p).float().mean())
    max_dt = float((its_k[both] - its_p[both]).abs().max()) if bool(both.any()) else 0.0
    # operands of the bare launch, prepared as the wrapper prepares them
    lanes, _ = tr._kernel_lanes(sdf, o, d, params, **lanes_kw)
    n = o.shape[0]
    evals = int(evals_per_ray.sum())
    t_ops = evals * TRACE_OPS_PER_EVAL / PEAK_FP32_FLOPS * 1e3
    t_bytes = (n * TRACE_BYTES_PER_RAY + sdf.data.numel() * 4 + 12) / PEAK_BYTES_PER_S * 1e3
    return {
        "rays": n, "grid_res": sdf.data.shape[0], "hit_share": float(hit_k.float().mean()),
        "hit_bits_differ_share": hit_diff, "max_abs_dits_t_both_hit": max_dt,
        "mean_num_steps": float(evals_per_ray.float().mean()), "max_num_steps": int(evals_per_ray.max()),
        "ms": cuda_ms(lambda: tr._launch_sphere_trace(sdf.data, sdf.p, lanes, params)),
        "wrapper_ms": cuda_ms(lambda: tr.sphere_trace(sdf, o, d, params, **lanes_kw)),
        "plain_ms": cuda_ms(lambda: tr.sphere_trace_plain(sdf, o, d, params, **lanes_kw), repeats=3, warmup=1),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "grid_evaluations": evals,
    }


def phase_trace_kernels(device):
    """K1 (csrc/sphere_trace.cu) and K2 (csrc/grid_eval.cu) against their
    plain versions at the path's shapes."""
    import dataclasses

    import torch

    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops import grid as gridops
    from differentiable_sdf_rendering_tpu_torch.ops.interaction import compute_surface_interaction
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF, SphereSDF
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace, sphere_trace_plain

    o, d, uni, params = primal_chunk_rays(device)
    emitter = scene_rig_full("bunny", device=device)["emitter"]
    occlusion = dataclasses.replace(params, refine_intersection=False)
    trace = {}
    with torch.no_grad():
        for res in (64, 128):
            sdf = GridSDF.create(target_sdf("bunny", res, device=device))
            trace[f"camera_{res}"] = trace_case(sdf, o, d, params, {})
            # the shadow rays of the same lanes: finite-hit origins, an
            # active mask, no refinement (the occlusion query of a primal render)
            si = compute_surface_interaction(sdf, o, d, sphere_trace_plain(sdf, o, d, params), differentiable=False)
            ds_d = emitter.sample_direction(uni[:, 2:4])[0]
            trace[f"shadow_{res}"] = trace_case(sdf, si.p + ds_d * 1e-3, ds_d, occlusion, {"active": si.valid})
            if res == 64:
                hits = si.p[si.valid]
                grid64 = sdf
        for name, case in trace.items():
            if not (case["hit_bits_differ_share"] <= 1e-3 and case["max_abs_dits_t_both_hit"] <= 1e-5):
                raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")
        # an analytic SDF on the card has no kernel: it must raise, not fall
        # back to the plain version
        try:
            sphere_trace(SphereSDF.create(device=device), o[:8], d[:8], params)
        except NotImplementedError:
            pass
        else:
            raise AssertionError("the CUDA sphere tracer accepted an analytic SDF")

        # K2 at 2^21 points near the surface: the hits above, resampled and
        # jittered by up to half a voxel
        gen = torch.Generator(device=device).manual_seed(0)
        n = 1 << 21
        idx = torch.randint(0, hits.shape[0], (n,), device=device, generator=gen)
        pts = hits[idx] + (torch.rand(n, 3, device=device, generator=gen) - 0.5) / 64
        data, origin = grid64.data, grid64.p
        vk, gk = gridops.grid_eval_grad_detached(data, pts, origin)
        vp, gp = gridops.grid_eval_grad_detached_plain(data, pts, origin)
        torch.cuda.synchronize()
        rel_v = float((vk - vp).abs().max() / vp.abs().max())
        rel_g = float((gk - gp).abs().max() / gp.abs().max())
        max_abs = max(float((vk - vp).abs().max()), float((gk - gp).abs().max()))
        # tolerance: the kernel sums the 64 taps in sequence, torch.sum as a
        # tree; the weights are bit-equal, so the difference is rounding
        # (relative to the output's scale)
        if not (rel_v <= 1e-5 and rel_g <= 1e-5):
            raise AssertionError(f"grid-evaluation kernel disagrees with its plain version: "
                                 f"relative {rel_v} (value), {rel_g} (gradient)")
        t_ops = n * GRID_EVAL_OPS_PER_POINT / PEAK_FP32_FLOPS * 1e3
        t_bytes = (n * GRID_EVAL_BYTES_PER_POINT + data.numel() * 4 + 12) / PEAK_BYTES_PER_S * 1e3
        grid_eval = {
            "points": n, "grid_res": data.shape[0], "max_rel_diff_value": rel_v, "max_rel_diff_grad": rel_g,
            "max_abs_diff": max_abs,
            "ms": cuda_ms(lambda: gridops._grid_eval_grad_kernel(data, pts, origin)),
            "plain_ms": cuda_ms(lambda: gridops.grid_eval_grad_detached_plain(data, pts, origin)),
            "bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        }
    emit({"phase": "kernels", "sphere_trace": trace, "grid_eval_grad": grid_eval})
    return trace, grid_eval


def phase_reference(device):
    """A 32³ sphere under two 32² cameras, 2 spp, primal: card vs host."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf

    cfg = RenderConfig(integrator="sdf_direct_reparam", spp=2)
    imgs = {}
    for dev in ("cpu", device):
        scene = Scene.create(
            create_sphere_sdf(32, radius=0.3, device=dev),
            cameras=regular_cameras(2, resx=32, resy=32, device=dev), device=dev,
        )
        imgs[str(dev)] = render(scene, 0, seed=0, cfg=cfg, mode="primal", device=dev).cpu()
    a, b = imgs["cpu"], imgs[str(device)]
    diff = (a - b).abs()
    mean_diff, max_diff = float(diff.mean()), float(diff.max())
    # tolerance: the two devices round sin/cos/atan2 and sum the splat in
    # different orders; on this fixed input that is 4e-8 in the mean and
    # 5e-6 at most (five runs on an H100), and no sample changes its hit
    if not (torch.isfinite(b).all() and b.shape == (32, 32, 4) and mean_diff < 1e-6 and max_diff < 1e-4):
        raise AssertionError(
            f"card render disagrees with the host render: abs diff mean {mean_diff}, max {max_diff}")
    emit({"phase": "reference", "mean_abs_diff": mean_diff, "max_abs_diff": max_diff})


def eikonal_median(grid):
    """Median |∇f| (central differences) over interior voxels within two
    voxels of the zero level set."""
    import torch

    h = 1.0 / grid.shape[0]
    gz = (grid[2:, 1:-1, 1:-1] - grid[:-2, 1:-1, 1:-1]) / (2 * h)
    gy = (grid[1:-1, 2:, 1:-1] - grid[1:-1, :-2, 1:-1]) / (2 * h)
    gx = (grid[1:-1, 1:-1, 2:] - grid[1:-1, 1:-1, :-2]) / (2 * h)
    norm = torch.sqrt(gx * gx + gy * gy + gz * gz)
    near = grid[1:-1, 1:-1, 1:-1].abs() < 2 * h
    return float(norm[near].median())


# depth cuts of the train phase: iterations (512 in a full run) and samples
# per pixel of the reference images (512 in a full run)
ITERS = 4
REF_SPP = 64


def reset_counts():
    from differentiable_sdf_rendering_tpu_torch.ops.grid import grid_eval_grad_detached
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace

    redistance.kernel_launches = redistance.cuda_launches = 0
    sphere_trace.kernel_launches = 0
    grid_eval_grad_detached.kernel_launches = 0


def read_counts():
    """Launches of each kernel since :func:`reset_counts`, by wrapper."""
    from differentiable_sdf_rendering_tpu_torch.ops.grid import grid_eval_grad_detached
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace

    return {
        "redistance": redistance.kernel_launches,
        "redistance_cuda_launches": redistance.cuda_launches,
        "sphere_trace": sphere_trace.kernel_launches,
        "grid_eval_grad": grid_eval_grad_detached.kernel_launches,
    }


def phase_train(device):
    import math

    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import load_checkpoint, optimize_shape

    opt_cfg, _ = get_opt_config("no-tex-12")
    method = get_config("warp")
    # depth cut: the grid is upsampled after 1 and 2 iterations instead of
    # 64 and 128, so 16³, 32³ and 64³ all run; widths are the published ones
    opt_cfg.upsample_iter = (1, 2)
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy, opt_cfg.sdf_res) == (12, 6, 128, 128, 64)
    assert (method.spp, method.primal_spp_mult) == (64, 4)

    seen = []
    out_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    result = optimize_shape(
        "bunny", opt_cfg, method, output_dir=out_dir.name, n_iter=ITERS, ref_spp=REF_SPP, target_res=128,
        verbose=False, checkpoint_cb=lambda i, params, losses: seen.append(tuple(params["sdf"].shape)),
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    launches, cuda_launches = counts["redistance"], counts["redistance_cuda_launches"]
    with out_dir:
        files = sorted(os.listdir(os.path.join(out_dir.name, "params")))
        want = ["sdf-data-0000.vol", f"sdf-data-{ITERS - 1:04d}.vol", "sdf-final.vol"]
        if files != want or not os.path.exists(os.path.join(out_dir.name, "metadata.json")):
            raise AssertionError(f"checkpoints written: {files}, expected {want} and metadata.json")
        ema_back = load_checkpoint(out_dir.name, "final", opt_cfg.variables(), device=device)["sdf"]
        last_back = load_checkpoint(out_dir.name, ITERS - 1, opt_cfg.variables(), device=device)["sdf"]
        if not (torch.equal(ema_back, result.ema["sdf"]) and torch.equal(last_back, result.params["sdf"])):
            raise AssertionError("the checkpoints do not read back as the run's final grid and EMA")
        with open(os.path.join(out_dir.name, "metadata.json")) as f:
            if not np.allclose(json.load(f)["loss_values"], result.loss_values):
                raise AssertionError("metadata.json does not hold the run's losses")

    final = result.params["sdf"]
    if not all(math.isfinite(v) for v in result.loss_values) or len(result.loss_values) != ITERS:
        raise AssertionError(f"losses not finite: {result.loss_values}")
    if tuple(final.shape) != (64, 64, 64) or not {(16,) * 3, (32,) * 3, (64,) * 3} <= set(seen):
        raise AssertionError(f"grid went through {seen}, expected 16^3, 32^3 and 64^3")
    if not torch.isfinite(final).all() or not torch.isfinite(result.ema["sdf"]).all():
        raise AssertionError("final grid has non-finite values")
    if launches < ITERS:
        raise AssertionError(f"redistance kernel launched {launches} times in {ITERS} iterations")
    if counts["sphere_trace"] == 0 or counts["grid_eval_grad"] == 0:
        raise AssertionError(f"a kernel of the training path was not launched: {counts}")
    eik = eikonal_median(final)
    if not 0.7 < eik < 1.3:
        raise AssertionError(f"final grid is not a distance field near its surface: median |grad f| = {eik}")
    emit({
        "phase": "train", "scene": "bunny", "opt_config": "no-tex-12", "method": "warp",
        "iterations": ITERS, "ref_spp": REF_SPP, "target_res": 128, "upsample_iter": [1, 2],
        "loss": result.loss_values, "iter_seconds": result.iter_seconds,
        "grid_res": [s[0] for s in seen], "seconds_total": seconds,
        "kernel_launches": counts, "eikonal_median": eik,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "checkpoints": files,
    })
    return counts


# depth cut of the turntable: frames (64 in the CLI's default)
TURNTABLE_FRAMES = 4


def phase_cli(device):
    """``optimize_torch.main`` then ``render_turntable_torch.main`` in-process,
    at the published widths: ``bunny`` / ``no-tex-12`` / ``warp`` for one
    iteration (reference spp cut to 64 as in the train phase), then the
    turntable at 512², 256 spp for 4 of its 64 frames."""
    import torch

    import optimize_torch
    import render_turntable_torch
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace_plain
    from differentiable_sdf_rendering_tpu_torch.utils import io, video

    frames = []
    render_chunked = video.render_chunked

    def recording_render(scene, **kw):
        # each frame's image before tonemapping (finite values, time) and its
        # coverage: the share of pixel-centre camera rays that hit the shape,
        # traced by the plain version so that no kernel launch is counted
        t_frame = time.perf_counter()
        img = render_chunked(scene, **kw)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t_frame
        cam = kw["camera"]
        ys, xs = torch.meshgrid(torch.arange(cam.resy, device=device) + 0.5,
                                torch.arange(cam.resx, device=device) + 0.5, indexing="ij")
        o, d = cam.sample_ray(torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1))
        hit = torch.isfinite(sphere_trace_plain(scene.sdf, o, d, kw["cfg"].trace))
        frames.append({"finite": bool(torch.isfinite(img).all()), "coverage": float(hit.float().mean()),
                       "shape": list(img.shape), "seconds": seconds})
        return img

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out_dir:
        reset_counts()
        t0 = time.perf_counter()
        optimize_torch.main(["bunny", "--optconfig", "no-tex-12", "--configs", "warp", "--n_iter", "1",
                             "--refspp", str(REF_SPP), "--outputdir", out_dir])
        torch.cuda.synchronize()
        optimize_seconds = time.perf_counter() - t0
        optimize_counts = read_counts()

        reset_counts()
        video.render_chunked = recording_render
        t0 = time.perf_counter()
        try:
            render_turntable_torch.main(["bunny", "--optconfig", "no-tex-12", "--config", "warp",
                                         "--outputdir", out_dir, "--n_frames", str(TURNTABLE_FRAMES)])
        finally:
            video.render_chunked = render_chunked
        turntable_seconds = time.perf_counter() - t0
        turntable_counts = read_counts()

        frame_dir = os.path.join(out_dir, "bunny", "no-tex-12", "warp", "turntable")
        pngs = sorted(os.listdir(frame_dir))
        shapes = [io.read_png(os.path.join(frame_dir, f)).shape for f in pngs]
    if len(pngs) != TURNTABLE_FRAMES or any(sh != (512, 512, 3) for sh in shapes):
        raise AssertionError(f"turntable frames written: {pngs} of shapes {shapes}")
    if not all(f["finite"] and 0.01 < f["coverage"] < 0.99 and f["shape"] == [512, 512, 4] for f in frames):
        raise AssertionError(f"turntable frames: {frames}")
    for counts in (optimize_counts, turntable_counts):
        if counts["sphere_trace"] == 0 or counts["grid_eval_grad"] == 0:
            raise AssertionError(f"a kernel of the CLI path was not launched: {counts}")
    emit({
        "phase": "cli", "optimize_seconds": optimize_seconds, "optimize_kernel_launches": optimize_counts,
        "turntable_seconds": turntable_seconds, "turntable_frames": len(pngs),
        "turntable_frame_seconds": [f["seconds"] for f in frames], "turntable_kernel_launches": turntable_counts,
        "coverage": [f["coverage"] for f in frames],
    })
    return optimize_counts, turntable_counts


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from differentiable_sdf_rendering_tpu_torch import kernels

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda, "triton": triton_version(),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32, "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    })

    built = kernels.build_all(verbose_ptxas=True)
    emit({"phase": "build", "seconds": built["seconds"], "built": built["built"],
          "ptxas": [ln for ln in built["log"].splitlines() if "registers" in ln or "spill" in ln]})

    max_err, by_res = phase_kernels(device)
    trace, grid_eval = phase_trace_kernels(device)
    phase_reference(device)
    train_counts = phase_train(device)
    optimize_counts, turntable_counts = phase_cli(device)

    # Each kernel's times at the main path's shapes; the other shapes are in
    # the ``kernels`` phase lines.  ``launches`` counts the wrapper's calls
    # into the kernel during the train phase, ``cli_launches`` during the two
    # CLI runs; ``cuda_launches`` the CUDA launches of the redistancing calls
    # (counted by the kernel's C entry).  No single PyTorch call computes any
    # of these functions, so ``library_ms`` is null.
    main_res = by_res[64]
    k1 = trace["camera_64"]
    emit({"kernels": [
        {
            "name": "redistance", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/redistance.cu",
            "replaces": "differentiable_sdf_rendering_tpu/ops/pallas_redistance.py:113",
            "launches": train_counts["redistance"], "cuda_launches": train_counts["redistance_cuda_launches"],
            "cli_launches": optimize_counts["redistance"] + turntable_counts["redistance"],
            "max_abs_err": max_err, "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
            "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"], "library_ms": None,
            "shape": "64x64x64 fp32, 64 passes",
        },
        {
            "name": "sphere_trace", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/sphere_trace.cu",
            "replaces": "scripts/trace_probe_r3.py:360",
            "launches": train_counts["sphere_trace"],
            "cli_launches": optimize_counts["sphere_trace"] + turntable_counts["sphere_trace"],
            "max_abs_err": max(c["max_abs_dits_t_both_hit"] for c in trace.values()),
            "hit_bits_differ_share": max(c["hit_bits_differ_share"] for c in trace.values()),
            "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": None,
            "shape": f"{k1['rays']} camera rays of a bunny view (128^2 film, 256 spp), 64^3 fp32 grid",
        },
        {
            "name": "grid_eval_grad", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/grid_eval.cu",
            "replaces": "scripts/trace_probe_r3.py:421",
            "also_replaces": ["scripts/trace_probe_r3.py:482", "scripts/gather_probe.py:206",
                              "scripts/gather_probe.py:262"],
            "launches": train_counts["grid_eval_grad"],
            "cli_launches": optimize_counts["grid_eval_grad"] + turntable_counts["grid_eval_grad"],
            "max_abs_err": grid_eval["max_abs_diff"],
            "ms": grid_eval["ms"], "plain_ms": grid_eval["plain_ms"], "bound_ms": grid_eval["bound_ms"],
            "bound_by": grid_eval["bound_by"], "library_ms": None,
            "shape": f"{grid_eval['points']} points near the surface, 64^3 fp32 grid",
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
