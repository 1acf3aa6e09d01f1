#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and no network.  Imports only the port
(``differentiable_sdf_rendering_tpu_torch``).  Phases, each printing one JSON
line; any failure raises and the script exits non-zero:

1. ``device``  — card, power limit, torch / CUDA versions.
2. ``build``   — compiles every kernel under ``csrc/`` with ``nvcc``.
3. ``kernels`` — each kernel against its plain PyTorch version on the card,
   at the shapes the training path gives it (redistancing at 16³, 32³, 64³
   and the 128³ target), with CUDA-event timings and the CUDA launches of
   one call as the kernel's C entry counts them.
4. ``reference`` — a small primal render on the card against the same
   package's plain path on the host.
5. ``train``   — ``optimize_shape("bunny", no-tex-12, warp)`` at the
   published widths (12 views, batches of 6, 128² film, 64 + 256 spp, grid
   16³ → 32³ → 64³) for a few iterations; depth (iterations, reference spp)
   is cut.  Kernel launch counts are zeroed just before and read just after;
   the grid must pass through 16³, 32³ and 64³.
6. the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and the
   final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import importlib.metadata
import json
import statistics
import subprocess
import sys
import time

# Published peaks of one H100 SXM: HBM bytes/s and fp32 FLOP/s outside the
# tensor cores.  Used for the lower bound on a kernel's time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Arithmetic of one voxel in one Godunov pass (csrc/redistance.cu): 3
# neighbour mins, 4 for the sorting network, 4 for a2, 1 + 13 + 16 for the
# three candidate solutions, 4 for the selection, 2 for min and frozen select.
REDISTANCE_OPS_PER_VOXEL_PASS = 47


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


def phase_train(device):
    import math

    import torch

    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance

    opt_cfg, _ = get_opt_config("no-tex-12")
    method = get_config("warp")
    # depth cut: the grid is upsampled after 1 and 2 iterations instead of
    # 64 and 128, so 16³, 32³ and 64³ all run; widths are the published ones
    opt_cfg.upsample_iter = (1, 2)
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy, opt_cfg.sdf_res) == (12, 6, 128, 128, 64)
    assert (method.spp, method.primal_spp_mult) == (64, 4)

    seen = []
    torch.cuda.reset_peak_memory_stats()
    redistance.kernel_launches = redistance.cuda_launches = 0
    t0 = time.perf_counter()
    result = optimize_shape(
        "bunny", opt_cfg, method, n_iter=ITERS, ref_spp=REF_SPP, target_res=128, verbose=False,
        checkpoint_cb=lambda i, params, losses: seen.append(tuple(params["sdf"].shape)),
    )
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, cuda_launches = redistance.kernel_launches, redistance.cuda_launches

    final = result.params["sdf"]
    if not all(math.isfinite(v) for v in result.loss_values) or len(result.loss_values) != ITERS:
        raise AssertionError(f"losses not finite: {result.loss_values}")
    if tuple(final.shape) != (64, 64, 64) or not {(16,) * 3, (32,) * 3, (64,) * 3} <= set(seen):
        raise AssertionError(f"grid went through {seen}, expected 16^3, 32^3 and 64^3")
    if not torch.isfinite(final).all() or not torch.isfinite(result.ema["sdf"]).all():
        raise AssertionError("final grid has non-finite values")
    if launches < ITERS:
        raise AssertionError(f"redistance kernel launched {launches} times in {ITERS} iterations")
    eik = eikonal_median(final)
    if not 0.7 < eik < 1.3:
        raise AssertionError(f"final grid is not a distance field near its surface: median |grad f| = {eik}")
    emit({
        "phase": "train", "scene": "bunny", "opt_config": "no-tex-12", "method": "warp",
        "iterations": ITERS, "ref_spp": REF_SPP, "target_res": 128, "upsample_iter": [1, 2],
        "loss": result.loss_values, "iter_seconds": result.iter_seconds,
        "grid_res": [s[0] for s in seen], "seconds_total": seconds,
        "redistance_kernel_launches": launches, "redistance_cuda_launches": cuda_launches,
        "eikonal_median": eik,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    })
    return launches, cuda_launches


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
    phase_reference(device)
    launches, cuda_launches = phase_train(device)

    # the kernel's times at the main path's 64^3; the other resolutions are
    # in the ``kernels`` phase line.  ``launches`` counts the wrapper's calls
    # into the kernel during the train phase, ``cuda_launches`` the CUDA
    # launches those calls made (counted by the kernel's C entry).
    main_res = by_res[64]
    emit({"kernels": [{
        "name": "redistance", "route": "cuda",
        "source": "differentiable_sdf_rendering_tpu_torch/csrc/redistance.cu",
        "replaces": "differentiable_sdf_rendering_tpu/ops/pallas_redistance.py:113",
        "launches": launches, "cuda_launches": cuda_launches, "max_abs_err": max_err,
        "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
        "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this function
        "shape": "64x64x64 fp32, 64 passes",
    }]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
