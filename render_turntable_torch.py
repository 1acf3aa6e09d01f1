#!/usr/bin/env python3
"""Re-render a finished optimization's checkpoint as a turntable video, with
the PyTorch/CUDA port.

The same arguments and defaults as ``render_turntable.py`` (the JAX
package's), plus ``--cpu``:

    python render_turntable_torch.py <scene> --optconfig no-tex-12 --config warp
                                     [--outputdir output] [--resx 512] [--resy 512]
                                     [--spp 256] [--n_frames 64] [--iteration final] [--cpu]

Reads ``<outputdir>/<scene>/<optconfig>/<config>/params`` (as written by
``optimize_torch.py`` or ``optimize.py``) and writes PNG frames to its
``turntable/`` folder (and ``video/turntable.mp4`` where ffmpeg is
installed).  Runs on the CUDA card unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import sys

from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig
from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import load_checkpoint
from differentiable_sdf_rendering_tpu_torch.utils.video import render_turntable


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("scene")
    ap.add_argument("--optconfig", default="no-tex-12")
    ap.add_argument("--config", default="warp")
    ap.add_argument("--outputdir", default="output")
    ap.add_argument("--resx", type=int, default=512)
    ap.add_argument("--resy", type=int, default=512)
    ap.add_argument("--spp", type=int, default=256)
    ap.add_argument("--n_frames", type=int, default=64)
    ap.add_argument("--iteration", default="final")
    ap.add_argument("--cpu", action="store_true", help="run on the host instead of the CUDA card")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    opt_cfg, _ = get_opt_config(args.optconfig)
    run_dir = os.path.join(args.outputdir, args.scene, args.optconfig, args.config)
    it = args.iteration
    if it not in ("final",):
        it = int(it)
    params = load_checkpoint(run_dir, it, opt_cfg.variables(), device=device)
    bsdf, emitter = scene_rig(args.scene, opt_cfg.param_keys, device=device)
    scene = Scene.create(params["sdf"], bsdf=bsdf, emitter=emitter,
                         cameras=regular_cameras(1, device=device), device=device)
    render_turntable(
        scene, run_dir, resx=args.resx, resy=args.resy, spp=args.spp,
        n_frames=args.n_frames, n_chunks=max(1, (args.resx * args.resy * args.spp) // (1 << 21)),
    )
    print(f"[done] turntable → {os.path.join(run_dir, 'turntable')}")


if __name__ == "__main__":
    sys.exit(main())
