#!/usr/bin/env python3
"""Command-line entry point for SDF shape reconstruction with the PyTorch/CUDA port.

The same arguments as ``optimize.py`` (the JAX package's entry point):

    python optimize_torch.py <scene...> --optconfig <name...> [--configs warp ...]
                             [--n_iter N] [--refspp N] [--outputdir DIR] [--key=value ...]
                             [--cpu]

Runs ``differentiable_sdf_rendering_tpu_torch.opt.shape_opt.optimize_shape``
on the CUDA card, or on the host with ``--cpu``, and writes checkpoints and
``metadata.json`` to ``<outputdir>/<scene>/<optconfig>/<config>``.
``--key=value`` arguments override fields of the method config, then of the
optimization config.
"""

from __future__ import annotations

import argparse
import os
import sys

from differentiable_sdf_rendering_tpu_torch.opt.configs import apply_cmdline_args, get_config
from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import optimize_shape


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("scenes", nargs="+", help="scene name(s), e.g. dragon")
    parser.add_argument("--optconfig", nargs="+", default=["no-tex-12"], help="optimization config name(s)")
    parser.add_argument("--configs", nargs="+", default=["warp"], help="gradient method config name(s)")
    parser.add_argument("--outputdir", default="output")
    parser.add_argument("--refspp", type=int, default=512, help="reference image spp")
    parser.add_argument("--n_iter", type=int, default=None)
    parser.add_argument("--scenedir", default=None, help="optional directory with real scene assets")
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--print_params", action="store_true")
    parser.add_argument("--cpu", action="store_true", help="run on the host instead of the CUDA card")
    args, extra = parser.parse_known_args(argv)
    device = "cpu" if args.cpu else None

    for scene in args.scenes:
        for opt_name in args.optconfig:
            for cfg_name in args.configs:
                method_cfg = get_config(cfg_name)
                rest = apply_cmdline_args(method_cfg, list(extra))
                opt_cfg, rest = get_opt_config(opt_name, rest)
                if rest:
                    print(f"[warn] unconsumed arguments: {rest}")
                if args.print_params:
                    print("method config:", method_cfg)
                    print("opt config:", opt_cfg)
                    continue
                out = os.path.join(args.outputdir, scene, opt_name, method_cfg.name)
                if os.path.exists(os.path.join(out, "metadata.json")) and not args.force:
                    print(f"[skip] {out} exists (use --force)")
                    continue
                print(f"[run] scene={scene} optconfig={opt_name} config={cfg_name} → {out}")
                result = optimize_shape(
                    scene,
                    opt_cfg,
                    method_cfg,
                    output_dir=out,
                    ref_spp=args.refspp,
                    scene_dir=args.scenedir,
                    n_iter=args.n_iter,
                    device=device,
                )
                print(f"[done] final loss {result.loss_values[-1]:.5f} in {result.total_time:.1f}s")


if __name__ == "__main__":
    sys.exit(main())
