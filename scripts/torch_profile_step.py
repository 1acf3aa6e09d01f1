#!/usr/bin/env python3
"""Profile one view of one training step of the PyTorch/CUDA port on the card.

    python3 scripts/torch_profile_step.py [--scene bunny] [--optconfig no-tex-12] [--method warp] [--res 64]
                                          [--out report.json]
    python3 scripts/torch_profile_step.py --scene torus-shadow --optconfig torus-shadow-1 --res 128
    python3 scripts/torch_profile_step.py --method warpprb
    python3 scripts/torch_profile_step.py --method conv
    python3 scripts/torch_profile_step.py --scene torus-shadow --optconfig torus-shadow-1 --res 128 \
        --method warpprb --no-profile

Builds the ``--optconfig`` / ``--method`` training step of ``optimize_shape``
at the config's published widths (its final film: 128² for ``no-tex-12``,
256² for ``torus-shadow-1``; the method's primal and gradient spp, 256 + 64,
and its integrator and warp: ``warpprb`` is PRB at depth 4, ``conv`` the
convolution-warp baseline with 16 auxiliary rays) on a ``--res``³ sphere
grid against the procedural references of ``--scene`` under its rig (the
floor mesh and vMF sun of ``torus-shadow``; rendered with the direct
integrator, as ``optimize_shape`` renders them), runs the loss and gradient
of ONE view under ``torch.profiler``, and prints the wall time of the view,
its peak device memory, its device idle share, the number of CUDA kernel
launches (and of the hand-written kernels' wrapper calls), the device time
of those kernels and the kernels that take most of the device time; then the
same for the view's primal render alone, whose difference to the view is the
grad half.  Where the gradient wavefront takes several lane chunks, the wall
time of the pass that renders them without a graph (for the block's
cotangent) is measured apart.  ``--no-profile`` skips ``torch.profiler``
(wall times, peak memory and wrapper calls only).  Needs a CUDA card; fails
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="bunny")
    ap.add_argument("--optconfig", default="no-tex-12")
    ap.add_argument("--method", default="warp", help="gradient method config, e.g. warp, warpprb or conv")
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    ap.add_argument("--no-profile", action="store_true", help="skip torch.profiler")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from differentiable_sdf_rendering_tpu_torch.models.integrator import (
        RenderConfig, lane_chunks, render_chunked, render_lane_block,
    )
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.grid import grid_eval_grad_detached
    from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda")
    opt_cfg, _ = get_opt_config(args.optconfig)
    film = (opt_cfg.resx, opt_cfg.resy)
    rig = scene_rig_full(args.scene, device=device)
    extras = {"mesh": rig["mesh"], "area_emitter": rig["area_emitter"]}
    cams = shape_opt._make_cameras(opt_cfg, *film, device)
    target = Scene(sdf=GridSDF.create(target_sdf(args.scene, 128, device=device)), bsdf=rig["bsdf"],
                   emitter=rig["emitter"], cameras=cams, **extras)
    method = get_config(args.method)
    cfg_primal, cfg_grad = shape_opt.render_configs(method)
    one_view = get_opt_config(args.optconfig)[0]
    one_view.n_sensors = 1
    refs = shape_opt.render_reference_images(target, one_view, 64, RenderConfig())[film]
    params = {"sdf": create_sphere_sdf(args.res, device=device)}
    base = Scene(sdf=GridSDF.create(torch.zeros_like(params["sdf"])), bsdf=rig["bsdf"],
                 emitter=rig["emitter"], cameras=cams, **extras)
    scene_det = base.replace(sdf=GridSDF.create(params["sdf"]))

    def step():
        return shape_opt._view_batch_loss_grads(
            params, base, [0], [0], [13], refs, loss_name=opt_cfg.loss,
            cfg_primal=cfg_primal, cfg_grad=cfg_grad, batch=1,
        )

    def primal():
        return render_chunked(scene_det, seed=0, cfg=cfg_primal, mode="primal", camera=cams.view(0), device=device)

    chunks = lane_chunks(cams.view(0), cfg_grad, device)

    def grad_first_pass():
        # the no-graph pass of _view_batch_loss_grads over several chunks
        with torch.no_grad():
            return sum(render_lane_block(scene_det, cams.view(0), c, 13, cfg_grad, "grad") for c in chunks)

    wrappers = (sphere_trace, grid_eval_grad_detached, redistance)

    def measure(fn):
        """Wall seconds and peak memory of one call (after a warm-up call),
        the wrappers' kernel calls in it, and its CUDA kernels under the
        profiler."""
        fn()  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = [w.kernel_launches for w in wrappers]
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        wrapper_calls = {w.__name__: w.kernel_launches - b for w, b in zip(wrappers, before)}
        if args.no_profile:
            return {"wall_s": wall, "peak_memory_bytes": peak, "wrapper_calls": wrapper_calls}, []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        # kernel rows only: an operator row repeats the time of the kernels it launched
        rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                      key=lambda e: -e.self_device_time_total)
        device_total = sum(e.self_device_time_total for e in rows)
        return {
            "wall_s": wall, "peak_memory_bytes": peak, "device_busy_s": device_total / 1e6,
            "device_idle_share": 1.0 - device_total / 1e6 / wall,
            "cuda_kernel_launches": sum(e.count for e in rows), "wrapper_calls": wrapper_calls,
            "port_kernels_device_ms": {
                name: sum(e.self_device_time_total for e in rows if name in e.key) / 1e3
                for name in ("sphere_trace_kernel", "grid_eval_grad_kernel", "redistance_kernel")},
        }, [{"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3, "calls": e.count} for e in rows[:25]]

    view, top = measure(step)
    primal_only, _ = measure(primal)
    first_pass = measure(grad_first_pass)[0] if len(chunks) > 1 else None
    report = {
        "card": torch.cuda.get_device_name(0), "scene": args.scene, "optconfig": args.optconfig,
        "method": method.name, "integrator": cfg_grad.integrator, "film": list(film), "grid_res": args.res,
        "view_wall_s": view["wall_s"], "peak_memory_bytes": view["peak_memory_bytes"],
        **{k: v for k, v in view.items() if k not in ("wall_s", "peak_memory_bytes")},
        "primal_render": primal_only, "grad_chunks": len(chunks), "grad_first_pass": first_pass,
        "top_kernels": top,
    }
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if k != "top_kernels"}))
    for row in top:
        print(f"{row['device_ms']:10.2f} ms  {row['calls']:7d}  {row['name']}")


if __name__ == "__main__":
    main()
