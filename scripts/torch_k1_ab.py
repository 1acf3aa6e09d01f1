"""K1 (``csrc/sphere_trace.cu``) on its default-option sets in several trees
of the port, in turns on one card, and the static SASS of each tree's grid
kernel.

Usage, on a machine with a CUDA card::

    python scripts/torch_k1_ab.py [--rounds 3] [--repeats 5] [--out DIR] NAME=TREE [NAME=TREE ...]

Each ``TREE`` is the root of a checkout of this repo (its ``chip_smoke.py``
and ``differentiable_sdf_rendering_tpu_torch/``), for example a ``git
archive`` of a parent commit unpacked beside the working tree.  A round runs
the trees in the given order and then in reverse (A B C C B A), each time in
a process of its own that builds that tree's kernels and times the bare K1
launch (``chip_smoke.k1_bare``) on the tree's ``chip_smoke.path_ray_sets``:
the camera rays of a bunny view's first lane chunk (128² film, 256 spp,
1.1 M lanes) and the shadow rays from their hits, at 64³ and 128³, all with
the default options (ω = 1, the fixed-rate refinement).  Each process takes
``--repeats`` CUDA-event medians of 10 launches a set.  Then, for each tree,
the static SASS of every kernel in its ``libsphere_trace.so`` (instructions
by class, from ``cuobjdump -sass``) and, for its grid kernels, the
instructions that differ from the first tree's grid kernel of the same
options.  Prints one JSON line a process, then one ``summary`` line; writes
each grid kernel's opcodes to ``--out``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import difflib
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def worker(tree, repeats):
    """In ``tree``: build its kernels, time K1 on its path sets; one JSON
    line on stdout."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from differentiable_sdf_rendering_tpu_torch import kernels

    built = kernels.build_all(verbose_ptxas=True)
    device = torch.device("cuda")
    sets = {}
    with torch.no_grad(), contextlib.redirect_stdout(sys.stderr):
        for name, sdf, o, d, params, lanes_kw, _ in chip_smoke.path_ray_sets(device):
            launch = chip_smoke.k1_bare(sdf, o, d, params, lanes_kw)
            sets[name] = [chip_smoke.cuda_ms(launch) for _ in range(repeats)]
    ptxas = [ln.strip() for ln in built["log"].splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"tree": tree, "ms": sets, "built": built["built"], "ptxas": ptxas}), flush=True)


def sass(tree):
    """``{kernel: (class counts, opcodes)}`` of the tree's sphere-trace
    library."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    lib = os.path.join(tree, "differentiable_sdf_rendering_tpu_torch", "build", "libsphere_trace.so")
    text = subprocess.run([tool, "-sass", lib], check=True, capture_output=True, text=True).stdout
    return {name: (chip_smoke.sass_class_counts(ins), [op for _, op, _ in ins])
            for name, ins in chip_smoke.sass_functions(text).items()}


def grid_kernels(funcs):
    """The grid kernels of one library, keyed by their options: ``default``
    for the kernel a default-option launch runs (the one grid kernel, or the
    one instantiated with ``false``), ``options`` for the other."""
    names = sorted(n for n in funcs if "GridSdf" in n)
    if len(names) == 1:
        return {"default": names[0]}
    return {("default" if "ILb0E" in n else "options"): n for n in names}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="*", help="NAME=TREE")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "k1_ab"))
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(os.path.abspath(args.worker), args.repeats)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_k1_ab: no CUDA device", file=sys.stderr)
        return 1
    trees = [(n, os.path.abspath(p)) for n, p in (a.split("=", 1) for a in args.trees)]
    if not trees:
        ap.error("name at least one NAME=TREE")
    os.makedirs(args.out, exist_ok=True)
    runs = {n: [] for n, _ in trees}
    ptxas = {}
    for r in range(args.rounds):
        for name, tree in trees + trees[::-1]:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree,
                                  "--repeats", str(args.repeats)], check=True, capture_output=True, text=True)
            line = json.loads(out.stdout.strip().splitlines()[-1])
            runs[name].append(line["ms"])
            if line["built"]:
                ptxas[name] = line["ptxas"]
            print(json.dumps({"round": r, "name": name, "ms": line["ms"]}), flush=True)

    summary = {"ms": {}, "ptxas": ptxas, "sass": {}}
    for name, _ in trees:
        per_set = {}
        for ms in runs[name]:
            for s, vals in ms.items():
                per_set.setdefault(s, []).extend(vals)
        summary["ms"][name] = {s: {"min": min(v), "median": sorted(v)[len(v) // 2], "max": max(v), "n": len(v)}
                               for s, v in per_set.items()}
    first = None
    for name, tree in trees:
        funcs = sass(tree)
        grids = grid_kernels(funcs)
        entry = {"functions": {n: counts for n, (counts, _) in funcs.items()}, "grid": grids}
        for key, fn in grids.items():
            with open(os.path.join(args.out, f"{name}_{key}.txt"), "w") as f:
                f.write("\n".join(funcs[fn][1]) + "\n")
        if first is None:
            first = {key: funcs[fn][1] for key, fn in grids.items()}
        else:
            diffs = {}
            for key, fn in grids.items():
                ops = funcs[fn][1]
                ref = first.get(key, first["default"])
                sm = difflib.SequenceMatcher(a=ref, b=ops, autojunk=False)
                changed = sum(max(i2 - i1, j2 - j1) for tag, i1, i2, j1, j2 in sm.get_opcodes() if tag != "equal")
                diffs[key] = {"instructions": len(ops), "first_tree_instructions": len(ref),
                              "differing_instructions": changed}
            entry["vs_" + trees[0][0]] = diffs
        summary["sass"][name] = entry
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
