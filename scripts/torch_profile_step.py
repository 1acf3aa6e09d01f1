#!/usr/bin/env python3
"""Profile one view of one training step of the PyTorch/CUDA port on the card.

    python3 scripts/torch_profile_step.py [--res 64] [--out report.json]

Builds the ``no-tex-12`` / ``warp`` training step of ``optimize_shape`` at its
published widths (128² film, 256 primal + 64 gradient spp) on a ``--res``³
sphere grid against the procedural ``bunny`` references, runs the loss and
gradient of ONE view under ``torch.profiler``, and prints the wall time of
the view, its device idle share, the number of CUDA kernel launches (and of
the hand-written kernels' wrapper calls) and the kernels that take most of
the device time.  Needs a CUDA card; fails without one.
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
    ap.add_argument("--res", type=int, default=64)
    ap.add_argument("--out", default=None, help="also write the report to this JSON file")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.grid import grid_eval_grad_detached
    from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda")
    opt_cfg, _ = get_opt_config("no-tex-12")
    rig = scene_rig_full("bunny", device=device)
    cams = shape_opt._make_cameras(opt_cfg, opt_cfg.resx, opt_cfg.resy, device)
    target = Scene(sdf=GridSDF.create(target_sdf("bunny", 128, device=device)), bsdf=rig["bsdf"],
                   emitter=rig["emitter"], cameras=cams)
    cfg_grad = RenderConfig(spp=64)
    cfg_primal = RenderConfig(spp=256)
    one_view = get_opt_config("no-tex-12")[0]
    one_view.n_sensors = 1
    refs = shape_opt.render_reference_images(target, one_view, 64, RenderConfig())[(128, 128)]
    params = {"sdf": create_sphere_sdf(args.res, device=device)}
    base = Scene(sdf=GridSDF.create(torch.zeros_like(params["sdf"])), bsdf=rig["bsdf"],
                 emitter=rig["emitter"], cameras=cams)

    def step():
        return shape_opt._view_batch_loss_grads(
            params, base, [0], [0], [13], refs, loss_name="multiscale_l1",
            cfg_primal=cfg_primal, cfg_grad=cfg_grad, batch=1,
        )

    step()  # warm-up
    torch.cuda.synchronize()
    wrappers = (sphere_trace, grid_eval_grad_detached, redistance)
    before = [w.kernel_launches for w in wrappers]
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wrapper_calls = {w.__name__: w.kernel_launches - b for w, b in zip(wrappers, before)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    # kernel rows only: an operator row repeats the time of the kernels it launched
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows = sorted(kernels, key=lambda e: -e.self_device_time_total)
    device_total = sum(e.self_device_time_total for e in rows)
    top = [
        {"name": e.key[:90], "device_ms": e.self_device_time_total / 1e3, "calls": e.count}
        for e in rows[:25]
    ]
    report = {
        "card": torch.cuda.get_device_name(0), "grid_res": args.res, "view_wall_s": wall,
        "device_busy_s": device_total / 1e6, "device_idle_share": 1.0 - device_total / 1e6 / wall,
        "cuda_kernel_launches": sum(e.count for e in rows), "wrapper_calls": wrapper_calls,
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
