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
   redistancing bit for bit at 16³, 32³, 64³, the 128³ target and 256³ (the
   ``-hqq`` grids) and on two non-cubic grids, on two level sets, at 0, 1, 5,
   max(shape) and 2 max(shape) passes (at 256³ the plain version runs
   max(shape) passes once), two launches bit-identical, the result near the
   distance to a sphere (with the plain version in float64 as the witness
   of the scheme's own error at every size); its times (kernel,
   whole call, plain), bound, launch shape, the cost of one grid-wide
   barrier at that launch and the SASS instructions of one voxel-pass; the
   sphere trace (K1) on one 2²¹-lane primal chunk of a ``bunny`` view
   (camera rays and the shadow rays from their hits) at a 64³ grid and at
   the 128³ target: bare launch, wrapper, two launches bit-identical, and
   the step statistics of the rays in lane order with the time without the
   rays of 128 steps or more; the detached grid evaluation (K2) on three
   point sets (the path's own points in lane order, 2²¹ points near the
   surface in random order, the same in Morton order); after these, K1 on
   the analytic sphere of the Pallas probe
   ``scripts/trace_probe_r3.py::probe_pallas`` (262,144 rays); then K1 on
   the hybrid scenes' ray sets at their 128³ targets: the shadow rays
   toward the vMF sun from the ``torus-shadow`` floor (256² film), the rays
   reflected off the ``mirror-opt`` mirror, and the ``plane_area`` shadow
   rays toward the area light with their finite ``maxt`` (hit bits over
   the active lanes); and K2 on the 128³ ``torus-shadow`` grid: the floor
   and torus hits of the 256² camera chunk in lane order, and resampled in
   random and in Morton order; then K1 on PRB's ray sets (the bounce rays of
   depths 1 and 2 and the NEE shadow rays of depth 1 of its detached path
   trace on a ``bunny`` view at 64³, 128², 64 spp) and K2 on their points;
   then K1 on the conv warp's auxiliary rays (index 0 about the camera rays
   and about the NEE shadow rays of that view's 64-spp grad chunk), and on
   the trace options: the camera chunk at 64³ and 128³ with ``over_relax``
   1.4 and 1.6 and with ``refine='newton'``, and the same rays at a smooth
   box (the fixed and Newton refinements, w 1.6), each with its
   evaluations a ray against w = 1 and its refinement evaluations.
   ``--kernels-only`` stops after these kernel cases (no later phase but
   the launch count of redistancing).
4. ``reference`` — a small primal render on the card against the same
   package's plain path on the host.
5. ``train``   — ``optimize_shape("bunny", no-tex-12, warp)`` at the
   published widths (12 views, batches of 6, 128² film, 64 + 256 spp, grid
   16³ → 32³ → 64³) for 3 iterations, writing checkpoints and
   ``metadata.json``; depth (iterations, reference spp) is cut.  Kernel
   launch counts are zeroed just before and read just after; every kernel
   must have run (redistancing at most 2 CUDA launches a call), and the grid
   must pass through 16³, 32³ and 64³.
6. ``cli``     — the two command-line entry points in-process:
   ``optimize_torch.main`` (``bunny``, ``no-tex-12``, 1 iteration) and
   ``render_turntable_torch.main`` on its checkpoint at the CLI's published
   512², 256 spp, 4 of its 64 frames; counts zeroed before and read after.
7. ``textured`` — ``optimize_shape("trefoil-hdr", principled-12, warp)``
   at the published widths (12 views, batches of 6, 128² film, 64 + 256 spp,
   a 64³ SDF, a 64³×3 albedo and a 16³ roughness volume under the
   principled BSDF, the checked-in HDR envmap, the 128³ ``.vol`` target);
   depth cut to 4 iterations, reference spp 64, SDF 16³ → 64³ after
   iterations 1 and 2, albedo 8³ → 64³ after 1, 2 and 3 (roughness keeps its
   fixed schedule and stays 4³, as in the first 128 iterations of a full
   run).  Counts zeroed before and read after; checkpoints of all three
   volumes read back; then ``render_turntable_torch.main`` on its output, 1
   frame at 512², 256 spp.
8. ``golden`` — the port's renders of the ``trefoil``, ``blob`` and
   ``cinquefoil`` assets (64³, 64², 16 spp, view 0, seed 0) against the JAX
   package's golden EXRs at its own bound (atol 5e-4, rtol 1e-3).
9. ``shadow`` — ``optimize_shape("torus-shadow", torus-shadow-1, warp)`` at
   the published widths (1 view, 64 + 256 spp, the diffuse floor under the
   vMF sun, grid 8³ → 128³, film 128² then 256²), depth cut to 5 iterations
   with the grid doubling after 1, 2, 3 and 4 and the film after 4,
   reference spp 64, checkpoints read back; seconds per iteration by (grid,
   film), peak memory and the launches of each kernel; then
   ``render_turntable_torch.main`` on its output (1 frame at 512², 256 spp)
   and ``optimize_torch.main`` for 1 iteration.
10. ``mirror`` — ``optimize_shape("mirror-opt", mirror-opt-1, warp)``: 3
   iterations at its published widths, the grid 16³ → 64³.
11. ``plane_area`` — NEE-only and MIS primal renders (128², 256 spp) and a
   MIS grad-mode render with its backward pass on the 128³ target, then 2
   iterations of ``optimize_shape("plane_area", no-tex-1, warp)``.
12. ``prb`` — path-replay backpropagation: ``optimize_shape("bunny",
   no-tex-12, warpprb)`` at the published widths (depth 4) for 1 iteration
   at 16³ with checkpoints, ``optimize_torch.main`` with ``--configs
   warpprbprimary`` for 1, ``torus-shadow-1`` (8³ → 16³) and
   ``mirror-opt-1`` with ``warpprb``, and PRB's oracle (depth 2 against the
   direct integrator with MIS, depth 4 against depth 2) on a 64³ ``bunny``
   view; K1, K2 and redistancing must launch in each run.
13. ``conv`` — the convolution-warp baseline: ``optimize_shape("bunny",
   no-tex-12, conv)`` at the published widths (16 auxiliary rays for each
   reparameterized ray) for 2 iterations at 16³ with checkpoints, then
   ``optimize_torch.main`` with ``--configs conv32`` for 1 iteration; K1,
   K2 and redistancing must launch in each run; seconds per iteration and
   peak memory.
14. ``scenefile`` — the scene files, the mesh -> SDF tools and the
   validation and optimisation tools, one line an item: each checked-in
   scene file (``scenes/example/example.json``, ``hybrid_floor.json``,
   ``scenes/studio/studio.json``) loaded on the card at its own widths,
   every view rendered primal at 64 spp and view 0 grad-mode with a backward
   pass to the grid, and the studio's view 0 at 4 spp against the host's
   plain path; ``eval_forward_gradient`` on the studio's view 0 (forward
   mode, and central differences at ε = 1e-3, 2048 spp) with the two
   images' agreement; ``create_sdf`` of the trefoil, blob and cinquefoil
   meshes at 64³ and 128³ against the checked-in ``.vol`` assets, host and
   card seconds apart; ``optimize_torch.main`` with ``--configs fd`` (1
   iteration, ``no-tex-12``); ``optimize_shape`` (``bunny``, ``no-tex-12``,
   2 iterations) with progress images, then resumed from checkpoint 0, the
   stitched losses and wall time checked, the loss plot reported, the
   convergence video and ``device_time`` of one render; ``trace_2d`` at a
   disk and a ``Grid2d`` on the card against the host.  K1, K2 and
   redistancing must launch where each item runs them.
15. ``launch_count`` — the CUDA launches of one redistancing call at every
   size (at most 2) and of one K1 call, as ``torch.profiler`` records them,
   after the timed phases; and the launches and device time of one view of
   the textured step with and without its texture volumes bound.
16. the ``{"kernels": [...]}`` summary line, the ``nvidia-smi`` line, and the
   final ``{"ok": true, ...}`` line.
"""

from __future__ import annotations

import importlib.metadata
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the script's start, for the total of the timing line
T_START = time.perf_counter()

# Published peaks of one H100 SXM: HBM bytes/s and fp32 FLOP/s outside the
# tensor cores.  Used for the lower bound on a kernel's time.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# Arithmetic of one voxel in one Godunov pass (csrc/redistance.cu): 3
# neighbour mins, 4 for the sorting network, 4 for a2, 1 + 13 + 16 for the
# three candidate solutions, 4 for the selection, 2 for min and frozen select.
REDISTANCE_OPS_PER_VOXEL_PASS = 47
# Arithmetic of one value-only grid evaluation in csrc/sphere_trace.cu (see
# csrc/tricubic.cuh), counted for the separable contraction that the kernel
# uses, the fewest operations the function needs: ray point 9;
# per axis 4 for the fraction and 19 for the basis weights (69); contraction
# 16 rows x (4 products, 3 adds) over x, 4 x 7 over y, 7 over z (147); step
# and tests 5.  Integer index arithmetic is not counted.
TRACE_OPS_PER_EVAL = 230
# Bytes of a trace: the rays and per-lane operands as the caller passes them
# (a broadcast operand, such as a camera's origin, counts once), its_t
# written (4 B a ray), the SDF's parameters read once; see trace_bytes.  The
# kernel's num_steps output is a diagnostic (the step statistics and the
# operation count read it; sphere_trace drops it), so the bound does not
# charge it.
TRACE_OUT_BYTES_PER_RAY = 4
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


def level_sets(shape, rng):
    """Two test inputs on a grid of ``shape`` (an int for a cube; numpy, from
    the seeded ``rng``): a noise-perturbed sphere SDF and a level set that is
    not a distance; and the distance to its zero level set, the r = 0.28
    sphere."""
    import numpy as np

    shape = (shape,) * 3 if isinstance(shape, int) else shape
    z, y, x = np.meshgrid(*((np.arange(n, dtype=np.float32) + 0.5) / n for n in shape), indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    perturbed = (r - 0.3 + 0.02 * rng.standard_normal(r.shape)).astype(np.float32)
    non_sdf = ((r - 0.28) * 3.0 * (1.0 + 0.5 * np.sin(7.0 * x) * np.cos(5.0 * y))).astype(np.float32)
    return {"perturbed_sphere": perturbed, "non_sdf": non_sdf}, (r - 0.28).astype(np.float32)


# Grid sizes of the redistancing checks and timings: the training path's
# 16³, 32³ and 64³, the 128³ target and the 256³ grids of the ``-hqq``
# configurations; and two non-cubic grids, a small one and one of about the
# voxel count of the training path's 64³.
REDISTANCE_SIZES = (16, 32, 64, 128, 256)
REDISTANCE_NON_CUBIC = ((8, 12, 16), (48, 64, 80))


def redistance_bound(shape, iters):
    """Least time of one redistancing call of ``iters`` passes on ``shape``:
    47 operations a voxel-pass plus 2 a voxel (the finish), against dist0,
    frozen and sign read once and the output written once."""
    n = shape[0] * shape[1] * shape[2]
    ops = REDISTANCE_OPS_PER_VOXEL_PASS * n * iters + 2 * n
    nbytes = n * (4 + 1 + 4 + 4)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S * 1e3, ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def redistance_plain_call(rd, phi, iters):
    """The plain version of a whole call: the prologue, then the passes."""
    import torch

    sign = torch.where(phi >= 0.0, 1.0, -1.0).to(torch.float32)
    dist0, frozen = rd._interface_init(phi, rd._spacing(phi.shape))
    return rd.redistance_plain(dist0, frozen, sign, iters)


_SASS_CLASSES = (
    ("memory", re.compile(r"^(LDG|STG|LDS|STS|LD|ST|ATOM|ATOMG|RED|LDGSTS)$")),
    ("float", re.compile(r"^(F[A-Z0-9]*|MUFU|DADD|DMUL|DFMA|DSETP|F2F|FRND)$")),
    ("integer", re.compile(r"^(U?IMAD|U?IADD3|U?LEA|U?SHF|U?LOP3|U?ISETP|U?IMNMX|VIMNMX|VIADD|IABS|U?SEL|I2F|F2I|"
                           r"U?POPC|U?FLO|U?BREV|U?SGXT|U?PRMT|IMUL|ISCADD|IDP|U?MOV|U?IMUL)$")),
    ("control", re.compile(r"^(BRA|EXIT|CALL|RET|BSSY|BSYNC|BAR|WARPSYNC|YIELD|BPT|JMP|JMX|BRX|ACQBULK)$")),
)


def sass_functions(text):
    """``{kernel: [(address, opcode, instruction), ...]}`` from ``cuobjdump
    -sass`` output, NOPs left out, branch labels replaced by addresses."""
    funcs, labels, name, pending = {}, {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name, pending = m.group(1), []
            funcs[name], labels[name] = [], {}
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if name is not None and m:
            pending.append(m.group(1))
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if name is not None and m:
            addr, ins = int(m.group(1), 16), m.group(2).strip()
            labels[name].update((lb, addr) for lb in pending)
            pending = []
            op = re.sub(r"^@!?U?P[T0-9]+\s+", "", ins).split()[0].split(".")[0]
            if op != "NOP":
                funcs[name].append((addr, op, ins))
    return {name: [(a, op, re.sub(r"`\((\.L_x_\d+)\)", lambda m: hex(labels[name].get(m.group(1), -1)), ins))
                   for a, op, ins in body] for name, body in funcs.items()}


def sass_class_counts(ins):
    counts = {"total": len(ins)}
    for _, op, _ in ins:
        cls = next((c for c, pat in _SASS_CLASSES if pat.match(op)), "other")
        counts[cls] = counts.get(cls, 0) + 1
    return counts


def voxel_pass_sass(ins):
    """The instructions that update one voxel in one pass: the smallest loop
    (a backward branch and its target) that holds a MUFU (the update's root
    or reciprocal), or, in a kernel without such a loop, its main body (the
    instructions before the first subroutine that a CALL enters: the slow
    paths of division, square root and 64-bit integer division)."""
    loops = []
    for addr, op, text in ins:
        m = re.search(r"BRA\s+(?:\S+\s+)?(0x[0-9a-f]+)$", text) if op == "BRA" else None
        if m and int(m.group(1), 16) < addr:
            body = [x for x in ins if int(m.group(1), 16) <= x[0] <= addr]
            if any(x[1] == "MUFU" for x in body):
                loops.append(body)
    if loops:
        return "smallest loop holding the update", min(loops, key=len)
    calls = [int(m.group(1), 16) for _, op, text in ins if op == "CALL"
             for m in [re.search(r"(0x[0-9a-f]+)$", text)] if m]
    return "main body", [x for x in ins if x[0] < min(calls, default=1 << 62)]


def redistance_sass():
    """Static SASS of every kernel in the redistancing library, by class, and
    of its voxel-pass code (:func:`voxel_pass_sass`)."""
    from differentiable_sdf_rendering_tpu_torch import kernels

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", os.path.join(kernels.build_dir(), "libredistance.so")],
                          check=True, capture_output=True, text=True).stdout
    out = {}
    for name, ins in sass_functions(text).items():
        where, body = voxel_pass_sass(ins)
        out[name] = {"function": sass_class_counts(ins), "voxel_pass": sass_class_counts(body), "voxel_pass_is": where}
    return out


def cubic_voxel_pass_sass(sass):
    """Per-voxel-pass SASS counts of the kernel that runs cubic grids."""
    name = next(n for n in sass if "Lb1E" in n)
    return sass[name]["voxel_pass"]


def barrier_probe_us(shapes):
    """Microseconds of one grid-wide barrier (``grid.sync()``) in a cooperative
    launch of ``blocks`` blocks of ``threads`` threads, for each ``(blocks,
    threads)`` of ``shapes``: the time of 64 barriers less that of none, over
    64."""
    import torch

    from differentiable_sdf_rendering_tpu_torch import kernels

    lib = kernels.library("redistance")
    stream = torch.cuda.current_stream().cuda_stream

    def probe(blocks, threads, syncs):
        err = lib.redistance_barrier_probe(blocks, threads, syncs, stream)
        if err != 0:
            raise RuntimeError(f"barrier probe ({blocks} x {threads}): CUDA error {err}")

    out = {}
    for b, t in shapes:
        t64, t0 = cuda_ms(lambda: probe(b, t, 64)), cuda_ms(lambda: probe(b, t, 0))
        out[f"{b}x{t}"] = (t64 - t0) * 1e3 / 64
    return out


def redistance_launch_shape(shape):
    """``(blocks, threads, seg_len)`` of the launch ``redistance_run`` makes."""
    import ctypes

    from differentiable_sdf_rendering_tpu_torch import kernels

    vals = [ctypes.c_int(0) for _ in range(3)]
    err = kernels.library("redistance").redistance_launch_shape(*shape, *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"redistance_launch_shape: CUDA error {err}")
    return tuple(v.value for v in vals)


def redistance_timing(rd, phi):
    """Times of one redistancing call of ``max(shape)`` passes on ``phi``:
    the kernel alone, the whole call (``redistance(phi)``), the plain passes
    (``redistance_plain``; one run at 256³ and above), the bound, and the CUDA
    launches of a whole call as the kernel's C entry counts them;
    ``plain_equal``: the kernel's result equals the plain version's bit for
    bit."""
    import torch

    iters = max(phi.shape)
    sign = torch.where(phi >= 0.0, 1.0, -1.0).to(torch.float32)
    dist0, frozen = rd._interface_init(phi, rd._spacing(phi.shape))
    before = rd.redistance.cuda_launches
    got = rd.redistance(phi)
    cuda_launches = rd.redistance.cuda_launches - before
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    want = rd.redistance_plain(dist0, frozen, sign, iters)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end) if phi.numel() >= 256 ** 3 else cuda_ms(
        lambda: rd.redistance_plain(dist0, frozen, sign, iters), repeats=3 if phi.numel() >= 128 ** 3 else 10, warmup=1)
    bound_ms, bound_by = redistance_bound(phi.shape, iters)
    return {
        "iterations": iters,
        "ms": cuda_ms(lambda: rd._redistance_kernel(phi, iters)),
        "wrapper_ms": cuda_ms(lambda: rd.redistance(phi)),
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "cuda_launches_per_call": cuda_launches,
        "plain_equal": bool(torch.equal(got, want)),
        "max_abs_diff": float((got - want).abs().max()),
    }


def phase_kernels(device):
    """The redistancing kernel against its plain version on the card, bit
    for bit: both level sets at every size of ``REDISTANCE_SIZES`` and on the
    two non-cubic grids, at 0, 1, 5, max(shape) and 2 max(shape) passes (at
    256³ the plain version runs max(shape) passes once, on the perturbed
    sphere); two launches bit-identical; the sphere-distance sanity check
    with its float64 witness; then the timings, the barrier probe at each
    size's launch and the per-voxel-pass SASS."""
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import redistance as rd

    rng = np.random.default_rng(0)
    max_err, checked, by_res, sphere_dev = 0.0, [], {}, {}
    for shape in [(res,) * 3 for res in REDISTANCE_SIZES] + list(REDISTANCE_NON_CUBIC):
        res = max(shape)
        inputs, true_dist = level_sets(shape, rng)
        for name, phi_np in inputs.items():
            phi = torch.as_tensor(phi_np, device=device)
            iter_counts = [0, 1, 5] if res >= 256 else [0, 1, 5, res, 2 * res]
            for iters in iter_counts:
                got = rd.redistance(phi, iterations=iters)
                want = redistance_plain_call(rd, phi, iters)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                max_err = max(max_err, err)
                # tolerance: none — the kernel is compiled without FMA
                # contraction and must equal the plain version bit for bit
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"redistance kernel != plain version on {shape} / {name} / {iters} passes: "
                        f"max abs diff {err}")
                checked.append([list(shape), name, iters])
            got = rd.redistance(phi, iterations=res)
            # one thread a column segment, each voxel from the previous pass
            # only: two launches are bit-identical
            if not torch.equal(got, rd.redistance(phi, iterations=res)):
                raise AssertionError(f"two launches of the redistancing kernel differ on {shape} / {name}")
            if name == "non_sdf":
                # sanity: the zero level set is the r = 0.28 sphere, so the
                # result must be its distance up to the scheme's error, first
                # order in h.  In float32 the cancellation in the quadratic
                # solve adds to it and grows with the size (in the JAX
                # package's solver as well), so the witness that the scheme
                # itself stays within the bound is the plain version in
                # float64 on the same input, held to it at every size; the
                # kernel's float32 reading is held to it up to 128^3 and
                # recorded above, where the kernel is held to the float32
                # plain version bit for bit instead
                h = 1.0 / min(shape)
                bound = max(2.0 * h, 0.05)
                band = np.abs(true_dist) < 0.15
                dev = float(np.abs(got.cpu().numpy() - true_dist)[band].max())
                want64 = redistance_plain_call(rd, phi.double(), res)
                dev64 = float(np.abs(want64.cpu().numpy() - true_dist)[band].max())
                del want64
                sphere_dev[str(list(shape))] = {"kernel_float32": dev, "plain_float64": dev64}
                if not dev64 < bound:
                    raise AssertionError(f"float64 plain redistancing off the sphere distance by {dev64} on {shape}")
                if res <= 128 and not dev < bound:
                    raise AssertionError(f"redistance off the sphere distance by {dev} on {shape}")
        if len(set(shape)) == 1:
            # timings on the perturbed sphere, full pass count; at 256^3 this
            # is the check at max(shape) passes too
            timing = redistance_timing(rd, torch.as_tensor(inputs["perturbed_sphere"], device=device))
            if not timing["plain_equal"]:
                raise AssertionError(f"redistance kernel != plain version at {res}^3 / perturbed_sphere / "
                                     f"{res} passes: max abs diff {timing['max_abs_diff']}")
            if res >= 256:
                checked.append([list(shape), "perturbed_sphere", res])
            blocks, threads, seg_len = redistance_launch_shape(shape)
            by_res[res] = {**timing, "blocks": blocks, "threads": threads, "seg_len": seg_len}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    probe = barrier_probe_us({(sms, 1024), (8 * sms, 256)} | {(r["blocks"], r["threads"]) for r in by_res.values()})
    sass = redistance_sass()
    for r in by_res.values():
        r["us_per_barrier"] = probe[f"{r['blocks']}x{r['threads']}"]
        r["sass_per_voxel_pass"] = cubic_voxel_pass_sass(sass)
    emit({"phase": "kernels", "redistance": {
        "max_abs_diff": max_err, "checked": checked, "by_res": by_res, "barrier_probe_us": probe,
        "non_sdf_max_abs_dev_from_sphere_distance": sphere_dev,
        "sass": {name.split("_cu_")[-1]: v for name, v in sass.items()}}})
    return max_err, by_res


def camera_chunk_rays(cam, spp, device, n_uni=6):
    """Camera rays of the first lane chunk of a primal render of ``cam`` at
    ``spp`` samples a pixel, as ``render_lane_block`` makes them, and the
    ``n_uni`` uniforms of those lanes."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, lane_chunks
    from differentiable_sdf_rendering_tpu_torch.ops.film import BORDER
    from differentiable_sdf_rendering_tpu_torch.ops.sampling import lane_uniforms

    lane = lane_chunks(cam, RenderConfig(spp=spp), device)[0]
    pw = cam.resx + 2 * BORDER
    pix = torch.div(lane, spp, rounding_mode="floor")
    py = torch.div(pix, pw, rounding_mode="floor").to(torch.float32) - BORDER
    px = (pix % pw).to(torch.float32) - BORDER
    uni = lane_uniforms(0, lane, n_uni)
    o, d = cam.sample_ray(torch.stack([px + uni[:, 0], py + uni[:, 1]], dim=-1))
    return o, d, uni


def primal_chunk_rays(device):
    """Camera rays of the first lane chunk of a primal render of view 0 of
    the ``no-tex-12`` rig (128² film, 256 spp), the uniforms of those lanes
    and the trace parameters."""
    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig

    cam = regular_cameras(12, resx=128, resy=128, device=device).view(0)
    return (*camera_chunk_rays(cam, 256, device), RenderConfig().trace)


def step_statistics(steps):
    """How well one-thread-per-ray lanes in lane order fill their warps, from
    the per-ray grid evaluations ``steps`` (the kernel's ``num_steps``): SIMT
    efficiency = sum of steps / sum over 32-lane warps of 32 x the warp's
    longest ray; the sum over 128-lane blocks of their longest ray; the lanes
    of 128 steps or more."""
    import torch

    s = steps.reshape(-1).to(torch.int64)

    def group_max(k):
        return torch.nn.functional.pad(s, (0, (-s.numel()) % k)).view(-1, k).amax(dim=1)

    warp_max = int(group_max(32).sum())
    return {
        "simt_efficiency": int(s.sum()) / (32 * warp_max) if warp_max else 1.0,
        "sum_block_max_steps": int(group_max(128).sum()),
        "lanes_ge_128_steps": int((s >= 128).sum()),
    }


def k1_bare(sdf, o, d, params, lanes_kw):
    """A function that launches K1 alone, on operands prepared once as the
    wrapper prepares them."""
    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    operands, _ = tr._kernel_operands(sdf, o, d, params, **lanes_kw)
    return lambda: tr._launch_sphere_trace(operands, params)


# Sessions of torch.profiler that one measurement may take: a session has come
# back from an H100 with no device activity at all for a call that did launch
# (a 1.6 ms redistancing call at 128³, launched by the kernel's C entry);
# such a session lost its records and is taken again.
PROFILER_SESSIONS = 3


def cuda_launches_per_call(fn):
    """``(launches, device_ms, sessions)``: the CUDA kernels (and memsets) that
    one call of ``fn`` puts on the card and the sum of their device times, as
    ``torch.profiler`` records them, and the profiler sessions that took: one
    that recorded no device activity is taken again, at most
    ``PROFILER_SESSIONS`` times, after which its zero stands.  Run after the
    timed phases, so that the profiler's tracing cannot reach the times of
    the training step, whose host launches are its pace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for session in range(1, PROFILER_SESSIONS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if rows:
            break
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows) / 1e3, session


def trace_bytes(sdf, o, d, lanes_kw):
    """Bytes a trace must move: the grid, and the ``active`` mask of every
    lane, read once; the other per-lane operands (o, d, ``maxt``,
    ``refine_active``) read once for the active lanes only, since an inactive
    lane's ray is never traced; its_t written once for every lane.  A
    stride-0 broadcast counts one row."""
    import torch

    active = lanes_kw.get("active")
    per_lane = isinstance(active, torch.Tensor) and active.dim() > 0 and active.stride(0) != 0
    n_active = int(active.sum()) if per_lane else d.shape[0]

    def stored(x, rows):
        return x.element_size() * x[0].numel() * (1 if x.stride(0) == 0 else rows)

    params = ([sdf.data, sdf.p] if hasattr(sdf, "data") else [sdf.p, sdf.r.reshape(1)] if hasattr(sdf, "r")
              else [sdf.p, sdf.extents, sdf.smoothing.reshape(1)])
    rays = [o, d, *(v for k, v in lanes_kw.items() if k != "active" and isinstance(v, torch.Tensor))]
    mask = [active] if per_lane else []
    return (sum(p.numel() * p.element_size() for p in params) + sum(stored(x, n_active) for x in rays)
            + sum(stored(x, d.shape[0]) for x in mask) + d.shape[0] * TRACE_OUT_BYTES_PER_RAY)


def trace_case(sdf, o, d, params, lanes_kw, ops=None):
    """K1 against its plain version on one set of rays: agreement, CUDA-event
    times of the bare launch and of the plain version, and the bound from
    the steps this run's rays took (``ops(evaluations per ray)`` counts the
    operations; by default ``TRACE_OPS_PER_EVAL`` an evaluation).
    Diagnostics: the step statistics of the rays in lane order, and the bare
    launch with the rays of 128 steps or more switched off through
    ``active``."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    its_k, evals_per_ray = tr._sphere_trace_kernel(sdf, o, d, params, **lanes_kw)
    its_k2, evals2 = tr._sphere_trace_kernel(sdf, o, d, params, **lanes_kw)
    its_p = tr.sphere_trace_plain(sdf, o, d, params, **lanes_kw)
    torch.cuda.synchronize()
    # a ray's result depends on its own inputs only, whatever lane or block
    # took it: two launches are bit-identical
    if not (torch.equal(its_k, its_k2) and torch.equal(evals_per_ray, evals2)):
        raise AssertionError("two launches of the sphere-trace kernel on the same rays differ")
    hit_k, hit_p = torch.isfinite(its_k), torch.isfinite(its_p)
    both = hit_k & hit_p
    differ = hit_k != hit_p
    max_dt = float((its_k[both] - its_p[both]).abs().max()) if bool(both.any()) else 0.0
    n = o.shape[0]
    evals = int(evals_per_ray.sum())
    t_ops = (evals * TRACE_OPS_PER_EVAL if ops is None else ops(evals_per_ray)) / PEAK_FP32_FLOPS * 1e3
    t_bytes = trace_bytes(sdf, o, d, lanes_kw) / PEAK_BYTES_PER_S * 1e3
    short = evals_per_ray < 128
    # the lanes the path traces: with an ``active`` mask, the others are
    # misses by construction in both versions, so shares are of the active
    # lanes (a differing inactive lane still counts against them)
    active = lanes_kw.get("active", torch.ones_like(hit_k))
    n_active = int(active.sum())
    short = short & active
    return {
        "rays": n, "grid_res": sdf.data.shape[0] if hasattr(sdf, "data") else None,
        "hit_share": float(hit_k.float().mean()),
        "hit_bits_differ_share": float(differ.float().mean()), "max_abs_dits_t_both_hit": max_dt,
        "active_rays": n_active, "hit_bits_differ_rays": int(differ.sum()),
        "hit_bits_differ_share_active": int(differ.sum()) / max(n_active, 1),
        "plain_hit_share_active": int((hit_p & active).sum()) / max(n_active, 1),
        "mean_num_steps": float(evals_per_ray.float().mean()), "max_num_steps": int(evals_per_ray.max()),
        "p99_num_steps": float(torch.quantile(evals_per_ray[active].float(), 0.99)) if n_active else 0.0,
        "ms": cuda_ms(k1_bare(sdf, o, d, params, lanes_kw)),
        "wrapper_ms": cuda_ms(lambda: tr.sphere_trace(sdf, o, d, params, **lanes_kw)),
        # one run of the plain version: the agreement run above warmed it up
        "plain_ms": cuda_ms(lambda: tr.sphere_trace_plain(sdf, o, d, params, **lanes_kw), repeats=1, warmup=0),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "grid_evaluations": evals,
        **step_statistics(evals_per_ray),
        "ms_without_ge_128_step_rays": cuda_ms(k1_bare(sdf, o, d, params, {**lanes_kw, "active": short})),
    }


# Arithmetic of one evaluation of the analytic sphere in csrc/sphere_trace.cu:
# ray point 9, |x - c| - r 10 (3 differences, 5 for the squared norm, the
# root, the radius), step and tests 5.
SPHERE_OPS_PER_EVAL = 24


def sphere_probe_rays(device):
    """The analytic sphere and the rays of the Pallas probe
    scripts/trace_probe_r3.py::probe_pallas: ``(sdf, o, d, params)``."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops.sdf import SphereSDF, TraceParams

    n = 262_144
    ang = torch.arange(n, dtype=torch.float32, device=device) * (6.283 / n)
    o = torch.stack([0.5 + 2.0 * torch.cos(ang), 0.5 + 2.0 * torch.sin(ang), torch.full_like(ang, 0.5)], dim=-1)
    d = 0.5 - o
    return SphereSDF.create(device=device), o, d / torch.linalg.norm(d, dim=-1, keepdim=True), TraceParams()


def sphere_case(device):
    """K1 on the analytic sphere that the Pallas probe
    scripts/trace_probe_r3.py::probe_pallas traces: 262,144 rays from a ring
    of radius 2 around the centre of the r = 0.3 sphere at (0.5, 0.5, 0.5),
    aimed at the centre.  Held against the plain version (the limits of the
    grid cases) and against the analytic hit distance |o - c| - 0.3 (the
    probe's own check: median error below 1e-3)."""
    import math

    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    sdf, o, d, params = sphere_probe_rays(device)
    n = o.shape[0]
    its_k, steps = tr._sphere_trace_kernel(sdf, o, d, params)
    its_p = tr.sphere_trace_plain(sdf, o, d, params)
    torch.cuda.synchronize()
    hit_k, hit_p = torch.isfinite(its_k), torch.isfinite(its_p)
    both = hit_k & hit_p
    case = {
        "rays": n, "hit_share": float(hit_k.float().mean()),
        "hit_bits_differ_share": float((hit_k != hit_p).float().mean()),
        "max_abs_dits_t_both_hit": float((its_k[both] - its_p[both]).abs().max()) if bool(both.any()) else math.inf,
        "median_abs_err_analytic": float((its_k - (torch.linalg.norm(o - 0.5, dim=-1) - 0.3)).abs().median()),
        "mean_num_steps": float(steps.float().mean()), "max_num_steps": int(steps.max()),
    }
    if not (case["hit_bits_differ_share"] <= 1e-3 and case["max_abs_dits_t_both_hit"] <= 1e-5
            and case["median_abs_err_analytic"] < 1e-3 and case["hit_share"] == 1.0):
        raise AssertionError(f"sphere-trace kernel on the analytic sphere: {case}")
    t_ops = int(steps.sum()) * SPHERE_OPS_PER_EVAL / PEAK_FP32_FLOPS * 1e3
    t_bytes = trace_bytes(sdf, o, d, {}) / PEAK_BYTES_PER_S * 1e3
    case.update(
        ms=cuda_ms(k1_bare(sdf, o, d, params, {})),
        wrapper_ms=cuda_ms(lambda: tr.sphere_trace(sdf, o, d, params)),
        plain_ms=cuda_ms(lambda: tr.sphere_trace_plain(sdf, o, d, params), repeats=3, warmup=1),
        bound_ms=max(t_ops, t_bytes), bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    emit({"phase": "kernels", "sphere_trace_analytic_sphere": case})
    return case


def morton_order(pts, origin, res):
    """Permutation that sorts points by the Morton code of their voxel."""
    import torch

    v = torch.floor((pts - origin) * res).clamp(0, res - 1).to(torch.int64)
    code = torch.zeros_like(v[:, 0])
    for bit in range(max(1, (res - 1).bit_length())):
        for axis in range(3):
            code |= ((v[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code)


def grid_eval_case(data, origin, pts, float64_witness=False):
    """K2 against its plain version on one point set: agreement (relative to
    the output's scale) of both row-load paths, CUDA-event times and the
    bound.  The scalar-row path is reached through a copy of the grid 4
    bytes off 16-byte alignment.

    With ``float64_witness``, both versions are also held against the plain
    version in float64, and the kernel may differ from it by twice the plain
    float32 version's own error where that exceeds 1e-5 of the scale: on the
    128³ ``torus-shadow`` floor points the taps are ≈ 0.5 and the gradient
    (≈ 0.57 across the floor) is their difference times 128, so float32
    rounding alone puts the plain version 1.1-1.3e-5 off float64 there (an
    H100, 700 W), and two float32 orders of summation 1.5-1.8e-5 apart."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import grid as gridops

    misaligned = torch.empty(data.numel() + 1, device=data.device)[1:].view(data.shape)
    misaligned.copy_(data)
    vk, gk = gridops.grid_eval_grad_detached(data, pts, origin)
    vs, gs = gridops._grid_eval_grad_kernel(misaligned, pts, origin)
    vp, gp = gridops.grid_eval_grad_detached_plain(data, pts, origin)
    torch.cuda.synchronize()
    rel_v = max(float((v - vp).abs().max() / vp.abs().max()) for v in (vk, vs))
    rel_g = max(float((g - gp).abs().max() / gp.abs().max()) for g in (gk, gs))
    n = pts.shape[0]
    t_ops = n * GRID_EVAL_OPS_PER_POINT / PEAK_FP32_FLOPS * 1e3
    t_bytes = (n * GRID_EVAL_BYTES_PER_POINT + data.numel() * 4 + 12) / PEAK_BYTES_PER_S * 1e3
    witness = {}
    if float64_witness:
        v64, g64 = gridops.grid_eval_grad(data.double(), pts.double() - origin.double())
        scale_v, scale_g = float(v64.abs().max()), float(g64.abs().max())
        witness = {
            "value_rel_err_vs_float64": {"kernel": max(float((v.double() - v64).abs().max()) for v in (vk, vs)) / scale_v,
                                         "plain": float((vp.double() - v64).abs().max()) / scale_v},
            "grad_rel_err_vs_float64": {"kernel": max(float((g.double() - g64).abs().max()) for g in (gk, gs)) / scale_g,
                                        "plain": float((gp.double() - g64).abs().max()) / scale_g},
        }
        agree = all(e["kernel"] <= max(1e-5, 2.0 * e["plain"]) for e in witness.values())
    else:
        # tolerance: the kernel and torch.sum add the 64 weighted taps in
        # different orders; the difference is rounding (relative to the
        # output's scale)
        agree = rel_v <= 1e-5 and rel_g <= 1e-5
    if not agree:
        raise AssertionError(f"grid-evaluation kernel disagrees with its plain version: "
                             f"relative {rel_v} (value), {rel_g} (gradient); {witness}")
    return {
        "points": n, "grid_res": data.shape[0], "max_rel_diff_value": rel_v, "max_rel_diff_grad": rel_g, **witness,
        "max_abs_diff": max(float((a - b).abs().max()) for a, b in ((vk, vp), (vs, vp), (gk, gp), (gs, gp))),
        "ms": cuda_ms(lambda: gridops._grid_eval_grad_kernel(data, pts, origin)),
        # the same kernel on a copy of the grid 4 bytes off 16-byte alignment,
        # where it reads every row with scalar loads
        "ms_scalar_rows": cuda_ms(lambda: gridops._grid_eval_grad_kernel(misaligned, pts, origin)),
        "plain_ms": cuda_ms(lambda: gridops.grid_eval_grad_detached_plain(data, pts, origin)),
        "bound_ms": max(t_ops, t_bytes), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }


def path_ray_sets(device):
    """K1's four ray sets on the main path's shapes, as ``(name, sdf, o, d,
    params, lanes_kw, surface)``: the camera rays of
    :func:`primal_chunk_rays` and the shadow rays from their hits (an active
    mask, no refinement: the occlusion query of a primal render), each at a
    64^3 grid and at the 128^3 target.  ``surface`` is the surface
    interaction of the camera rays that a shadow set starts from (None for a
    camera set)."""
    import dataclasses

    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.interaction import compute_surface_interaction
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace_plain

    o, d, uni, params = primal_chunk_rays(device)
    ds_d = scene_rig_full("bunny", device=device)["emitter"].sample_direction(uni[:, 2:4])[0]
    occlusion = dataclasses.replace(params, refine_intersection=False)
    for res in (64, 128):
        sdf = GridSDF.create(target_sdf("bunny", res, device=device))
        yield f"camera_{res}", sdf, o, d, params, {}, None
        si = compute_surface_interaction(sdf, o, d, sphere_trace_plain(sdf, o, d, params), differentiable=False)
        yield f"shadow_{res}", sdf, si.p + ds_d * 1e-3, ds_d, occlusion, {"active": si.valid}, si


def hybrid_ray_sets(device):
    """K1's ray sets of the hybrid scenes, as ``(name, sdf, o, d, params,
    lanes_kw, si)``, each on the 128³ target of its rig and the first lane
    chunk of a primal render at 256 spp (the training path's primal spp):

    - ``floor_shadow_128``: ``torus-shadow`` at its 256² film; the shadow
      rays toward the vMF sun from the camera lanes whose nearest hit is the
      floor (y = 0.22, below the SDF's bbox), occlusion query;
    - ``mirror_reflected_128``: ``mirror-opt`` at 128²; the reflected rays
      of the camera lanes that hit the mirror, with refinement;
    - ``area_shadow_128``: ``plane_area`` at 128²; the NEE shadow rays from
      the SDF hits toward the area light or the ambient, each with its
      finite (or infinite) ``maxt``, occlusion query.

    The hits, reflections and samples come from the port's own hybrid
    intersection, mirror bounce and NEE sampler (``models/integrator.py``).
    ``si`` is the camera lanes' surface interaction, whose points ``si.p``
    (the camera where a lane missed) are those the primal path hands K2."""
    import dataclasses
    import math

    import torch

    from differentiable_sdf_rendering_tpu_torch.models import integrator as integ
    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF

    cfg = integ.RenderConfig()
    occlusion = dataclasses.replace(cfg.trace, refine_intersection=False)
    for name, film in (("torus-shadow", 256), ("mirror-opt", 128), ("plane_area", 128)):
        rig = scene_rig_full(name, device=device)
        scene = Scene(sdf=GridSDF.create(target_sdf(name, 128, device=device)), bsdf=rig["bsdf"],
                      emitter=rig["emitter"], cameras=regular_cameras(1, resx=film, resy=film, device=device),
                      mesh=rig["mesh"], area_emitter=rig["area_emitter"])
        o, d, uni = camera_chunk_rays(scene.cameras.view(0), 256, device)
        its_t, d1, _, maux = integ._ray_intersect(scene, o, d, 0, cfg, "primal")
        si, is_mesh = integ._compute_si(scene, o, d1, its_t, maux, differentiable=False)
        if name == "mirror-opt":
            is_mirror = is_mesh & maux[3]
            o_r, d_r = integ._mirror_rays(si, o, d1, is_mirror, cfg)
            yield "mirror_reflected_128", scene.sdf, o_r, d_r, cfg.trace, {"active": is_mirror}, si
            continue
        ds_d, ds_pdf, _, ds_dist = integ._nee_sample(scene, si.p, uni[:, 2:4])
        shade = (is_mesh if name == "torus-shadow" else si.valid) & (ds_pdf > 0)
        lanes_kw = {"active": shade}
        if name == "plane_area":
            lanes_kw["maxt"] = torch.where(torch.isfinite(ds_dist), ds_dist * (1.0 - 1e-3) - cfg.shadow_eps,
                                           torch.full_like(ds_dist, math.inf))
        label = "floor_shadow_128" if name == "torus-shadow" else "area_shadow_128"
        yield label, scene.sdf, si.p + ds_d * cfg.shadow_eps, ds_d, occlusion, lanes_kw, si


# K1 on the hybrid ray sets: the share of the active lanes whose hit bit may
# differ from the plain version's.  K1 and its plain version round the
# tricubic sums differently, so a ray that grazes the surface within a
# rounding of the hit threshold can flip; on an H100 that was 1 floor shadow
# ray of 571,859 active and none on the other two sets.  Each set's plain hit
# share must be far above the limit, so that a kernel that misses every ray
# cannot pass.
HYBRID_HIT_BITS_LIMIT = 1e-5
HYBRID_MIN_HIT_SHARE = 100 * HYBRID_HIT_BITS_LIMIT


def prb_bunny_view(device):
    """The scene of PRB's ray sets and of its oracle: the ``bunny`` rig at
    its 64³ target under the 12 cameras of ``no-tex-12`` at 128² (view 0 is
    rendered)."""
    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF

    rig = scene_rig_full("bunny", device=device)
    return Scene(sdf=GridSDF.create(target_sdf("bunny", 64, device=device)), bsdf=rig["bsdf"],
                 emitter=rig["emitter"], cameras=regular_cameras(12, resx=128, resy=128, device=device))


def prb_cup_view(device):
    """The bowl of the tier-1 PRB parity test (tests/test_torch_prb.py::
    _cup_sdf) at the oracle's 64³ grid and 128² film: a hollow sphere of
    radii 0.38 and 0.26 cut open by a plane facing view 0's camera, under
    the default BSDF and constant emitter.  Paths bounce inside it, so the
    vertices past the second add light (the bunny is all but convex)."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene

    res = 64
    c = (torch.arange(res, dtype=torch.float64, device=device) + 0.5) / res - 0.5
    z, y, x = torch.meshgrid(c, c, c, indexing="ij")
    n = torch.tensor([1.0, 0.3, 0.4], dtype=torch.float64, device=device)
    n = n / torch.linalg.norm(n)
    r = torch.sqrt(x * x + y * y + z * z)
    cut = x * n[0] + y * n[1] + z * n[2] - 0.12
    data = torch.maximum(torch.maximum(r - 0.38, 0.26 - r), cut).float()
    return Scene.create(data, cameras=regular_cameras(1, resx=128, resy=128, device=device), device=device)


def prb_ray_sets(device):
    """K1's ray sets of PRB's detached path trace (``models/prb.py::
    _trace_primal``) on view 0 of :func:`prb_bunny_view`, 64 spp, depth 4
    (one lane chunk), as ``(name, sdf, o, d, params, lanes_kw, points)``:
    the cosine-sampled bounce rays of depths 1 and 2 (leaving the first and
    second hits; incoherent, active where the path goes on) and the NEE
    shadow rays toward the sky from the first hits, with their ``maxt``.
    ``points`` are those K2 is held on: the points the path hands it for the
    bounce sets' hits (lane order, misses at the ray origin), and the shadow
    rays' hit points."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models import integrator as integ
    from differentiable_sdf_rendering_tpu_torch.models import prb
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace

    cfg = integ.RenderConfig(integrator="sdf_prb_reparam", spp=64, max_depth=4)
    scene = prb_bunny_view(device)
    o, d, uni = camera_chunk_rays(scene.cameras.view(0), cfg.spp, device, integ.n_uniforms(cfg))
    recs, _ = prb._trace_primal(scene, o, d, uni, cfg)
    for k in (1, 2):
        r = recs[k]
        yield f"prb_bounce_{k}_64", scene.sdf, r["ray_o"], r["ray_d"], cfg.trace, {"active": r["active"]}, r["si"].p
    r = recs[0]
    em_o = r["si"].p + r["ds_d"] * cfg.shadow_eps
    lanes_kw = {"active": r["active_em"], "maxt": r["shadow_maxt"]}
    its_t = sphere_trace(scene.sdf, em_o, r["ds_d"], cfg.trace, **lanes_kw)
    hit = torch.isfinite(its_t)
    yield "prb_shadow_1_64", scene.sdf, em_o, r["ds_d"], cfg.trace, lanes_kw, em_o[hit] + its_t[hit, None] * r["ds_d"][hit]


# K1 on PRB's ray sets: a depth-2 bounce set of one 128² view holds a few
# thousand active rays (the bunny covers a sixteenth of the film, and 2-3 %
# of the first bounce's rays hit it again), fewer than the hybrid sets'.
PRB_MIN_ACTIVE_RAYS = 1_000


def phase_prb_trace_kernels(device):
    """K1 against its plain version on PRB's ray sets (:func:`prb_ray_sets`)
    at the hybrid sets' limits (hit bits over the active lanes, ``its_t``
    within 1e-5 where both hit, a plain hit share of at least
    ``HYBRID_MIN_HIT_SHARE``), and K2 against its plain version on their
    points within 1e-5 of the output's scale (the 64³ limit).  The shadow
    rays' hit points lie on the surface, so every value there is within
    5e-5 of 0 and float32 rounding alone (1.6e-9, either version against
    float64 on an H100, 700 W) is 3e-5 of that scale: that set is held to
    the float64 witness of :func:`grid_eval_case`."""
    import torch

    trace, grid_eval = {}, {}
    with torch.no_grad():
        for name, sdf, o, d, params, lanes_kw, pts in prb_ray_sets(device):
            trace[name] = trace_case(sdf, o, d, params, lanes_kw)
            grid_eval[name] = grid_eval_case(sdf.data, sdf.p, pts.contiguous(),
                                             float64_witness=name.startswith("prb_shadow"))
    emit({"phase": "kernels", "sphere_trace_prb": trace, "grid_eval_grad_prb": grid_eval})
    for name, case in trace.items():
        if not (case["hit_bits_differ_share_active"] <= HYBRID_HIT_BITS_LIMIT
                and case["max_abs_dits_t_both_hit"] <= 1e-5):
            raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")
        if case["active_rays"] < PRB_MIN_ACTIVE_RAYS or not case["plain_hit_share_active"] >= HYBRID_MIN_HIT_SHARE:
            raise AssertionError(f"the {name} ray set is degenerate: {case}")
    return trace, grid_eval


# Arithmetic of one evaluation of the trace options in csrc/sphere_trace.cu.
# Over-relaxed step: the value-only evaluation and 6 more (|f| + previous
# |f| < previous step, the retreat or w |f| select, w and the two carried
# values).  Newton refinement: value and gradient from the cached window,
# the K2 count without its point setup (GRID_EVAL_OPS_PER_POINT - 3) plus
# the ray point 9, then slope 6, rate 3, step 3 and tests 3.  The box: ray
# point 9, q 9, max(q, 0) 3, its norm 6, the largest q 2, min, sum and
# smoothing 3, step and tests 5; its gradient for Newton 20 more (signs,
# the unit vector, the inside axis) and the Newton step 15.
RELAX_OPS_PER_EVAL = TRACE_OPS_PER_EVAL + 6
NEWTON_OPS_PER_EVAL = GRID_EVAL_OPS_PER_POINT - 3 + 9 + 15
BOX_OPS_PER_EVAL = 37
BOX_NEWTON_OPS_PER_EVAL = BOX_OPS_PER_EVAL + 20 + 15
# over-relaxation factors of the option sets (the JAX package's documented
# range 1.2-1.6)
OVER_RELAX = (1.4, 1.6)


def option_ops(trace_only, per_eval, per_refine_eval):
    """``ops`` for :func:`trace_case`: ``per_eval`` for each evaluation of
    the trace loop (``trace_only``, the evaluations a launch without the
    refinement takes on the same rays) and ``per_refine_eval`` for each
    evaluation of the refinement."""
    n_trace = int(trace_only.sum())
    return lambda evals: n_trace * per_eval + (int(evals.sum()) - n_trace) * per_refine_eval


def trace_option_sets(device):
    """K1's sets for the trace options, as ``(name, sdf, o, d, params,
    lanes_kw, ops, trace_only)``: the camera chunk of
    :func:`primal_chunk_rays` at 64³ and at the 128³ target with
    ``over_relax`` 1.4 and 1.6 and with ``refine='newton'``; and the same
    rays at a smooth box (centre 0.5, half-extents (0.3, 0.2, 0.25),
    smoothing 0.02) with the fixed and the Newton refinement and with
    ``over_relax`` 1.6.  ``trace_only`` holds each ray's evaluations of the
    trace loop alone: a launch with the same options and ``refine_steps =
    0``, whose loop takes the same steps (the refinement comes after it)."""
    import dataclasses

    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import target_sdf
    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import BoxSDF, GridSDF

    o, d, _, params = primal_chunk_rays(device)
    box = BoxSDF.create(p=(0.5, 0.5, 0.5), extents=(0.3, 0.2, 0.25), smoothing=0.02, device=device)
    sdfs = [(f"{res}", GridSDF.create(target_sdf("bunny", res, device=device))) for res in (64, 128)]

    def with_trace_only(name, sdf, set_params, trace_eval, refine_eval):
        trace_only = tr._sphere_trace_kernel(sdf, o, d, dataclasses.replace(set_params, refine_steps=0))[1]
        return name, sdf, o, d, set_params, {}, option_ops(trace_only, trace_eval, refine_eval), trace_only

    for label, sdf in [*sdfs, ("box", box)]:
        per_eval, newton_eval = ((BOX_OPS_PER_EVAL, BOX_NEWTON_OPS_PER_EVAL) if label == "box"
                                 else (TRACE_OPS_PER_EVAL, NEWTON_OPS_PER_EVAL))
        for omega in OVER_RELAX[1:] if label == "box" else OVER_RELAX:
            yield with_trace_only(f"over_relax_{omega}_{label}", sdf, dataclasses.replace(params, over_relax=omega),
                                  per_eval + RELAX_OPS_PER_EVAL - TRACE_OPS_PER_EVAL, per_eval)
        yield with_trace_only(f"newton_{label}", sdf, dataclasses.replace(params, refine="newton"),
                              per_eval, newton_eval)
        if label == "box":
            yield with_trace_only(f"fixed_{label}", sdf, params, per_eval, per_eval)


def phase_option_trace_kernels(device, trace):
    """K1 against its plain version on :func:`trace_option_sets` at the
    hybrid sets' limits (hit bits over the rays at ``HYBRID_HIT_BITS_LIMIT``,
    ``its_t`` within 1e-5 where both hit, a plain hit share of at least
    ``HYBRID_MIN_HIT_SHARE``).  Reports, beside the default-option camera
    sets of ``trace`` (w = 1, fixed refinement), the mean and p99
    evaluations a ray (trace and refinement together) of the over-relaxed
    sets, the mean evaluations of their trace loop alone, and the mean
    refinement evaluations of a refined ray with Newton and with the fixed
    rate."""
    import dataclasses

    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    cases = {}
    with torch.no_grad():
        for name, sdf, o, d, params, lanes_kw, ops, trace_only in trace_option_sets(device):
            case = trace_case(sdf, o, d, params, lanes_kw, ops)
            _, evals = tr._sphere_trace_kernel(sdf, o, d, params, **lanes_kw)
            refined = evals > trace_only
            case["mean_trace_evals"] = float(trace_only.float().mean())
            case["mean_refine_evals_of_refined_rays"] = (float((evals - trace_only)[refined].float().mean())
                                                         if bool(refined.any()) else 0.0)
            base = trace.get(f"camera_{name.rsplit('_', 1)[1]}")
            if base is not None:
                case["omega_1"] = {"mean_num_steps": base["mean_num_steps"], "p99_num_steps": base["p99_num_steps"]}
            if name.startswith("newton"):
                fixed = dataclasses.replace(params, refine="fixed")
                _, evals_fixed = tr._sphere_trace_kernel(sdf, o, d, fixed, **lanes_kw)
                refined = evals_fixed > trace_only
                case["fixed_mean_refine_evals_of_refined_rays"] = (
                    float((evals_fixed - trace_only)[refined].float().mean()) if bool(refined.any()) else 0.0)
            cases[name] = case
    emit({"phase": "kernels", "sphere_trace_options": cases})
    for name, case in cases.items():
        if not (case["hit_bits_differ_share_active"] <= HYBRID_HIT_BITS_LIMIT
                and case["max_abs_dits_t_both_hit"] <= 1e-5):
            raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")
        if not case["plain_hit_share_active"] >= HYBRID_MIN_HIT_SHARE:
            raise AssertionError(f"the {name} ray set is degenerate: {case}")
    return cases


def conv_ray_sets(device):
    """K1's ray sets of the conv warp (``ops/warp_conv.py``) on view 0 of
    :func:`prb_bunny_view` (64³, 128² film), the first lane chunk of a grad
    render at the ``conv`` method's 64 spp, 16 auxiliary rays a
    reparameterized ray, as ``(name, sdf, o, d, params, lanes_kw)``: the
    auxiliary rays of index 0 about the camera rays, and those of index 0
    about the NEE shadow rays (the depth-1 block of uniforms; occlusion
    query, no refinement), every lane of the chunk, as the conv estimator
    traces them."""
    import dataclasses

    from differentiable_sdf_rendering_tpu_torch.models import integrator as integ
    from differentiable_sdf_rendering_tpu_torch.ops.interaction import compute_surface_interaction
    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace
    from differentiable_sdf_rendering_tpu_torch.ops.vecmath import normalize
    from differentiable_sdf_rendering_tpu_torch.ops.warp_conv import aux_directions

    cfg = integ.RenderConfig(spp=64, warp_kind="conv")
    scene = prb_bunny_view(device)
    o, d, uni = camera_chunk_rays(scene.cameras.view(0), cfg.spp, device, integ.n_uniforms(cfg))
    omega, _ = aux_directions(normalize(d), integ._conv_uni(uni, cfg, 0)[:, 0:2], cfg.conv.kappa)
    yield "conv_aux_primary_64", scene.sdf, o, omega, cfg.trace, {}
    si = compute_surface_interaction(scene.sdf, o, d, sphere_trace(scene.sdf, o, d, cfg.trace), differentiable=False)
    ds_d = integ._nee_sample(scene, si.p, uni[:, 2:4])[0]
    omega, _ = aux_directions(normalize(ds_d), integ._conv_uni(uni, cfg, 1)[:, 0:2], cfg.conv.kappa)
    occlusion = dataclasses.replace(cfg.trace, refine_intersection=False)
    yield "conv_aux_shadow_64", scene.sdf, si.p + ds_d * cfg.shadow_eps, omega, occlusion, {}


def phase_conv_trace_kernels(device):
    """K1 against its plain version on the conv warp's auxiliary rays
    (:func:`conv_ray_sets`) at the hybrid sets' limits."""
    import torch

    cases = {}
    with torch.no_grad():
        for name, sdf, o, d, params, lanes_kw in conv_ray_sets(device):
            cases[name] = trace_case(sdf, o, d, params, lanes_kw)
    emit({"phase": "kernels", "sphere_trace_conv": cases})
    for name, case in cases.items():
        if not (case["hit_bits_differ_share_active"] <= HYBRID_HIT_BITS_LIMIT
                and case["max_abs_dits_t_both_hit"] <= 1e-5):
            raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")
        if not case["plain_hit_share_active"] >= HYBRID_MIN_HIT_SHARE:
            raise AssertionError(f"the {name} ray set is degenerate: {case}")
    return cases


def phase_hybrid_trace_kernels(device):
    """K1 against its plain version on the hybrid scenes' ray sets
    (:func:`hybrid_ray_sets`): hit bits over the active lanes at
    ``HYBRID_HIT_BITS_LIMIT``, ``its_t`` within 1e-5 where both hit.  K2
    against its plain version on the 128³ ``torus-shadow`` grid, on the
    points the primal path hands it on the 256² camera chunk (floor and
    torus hits, lane order) and on the 2²¹ resampled points of
    :func:`grid_eval_point_sets`, with the float64 witness of
    :func:`grid_eval_case`."""
    import torch

    trace, grid_eval = {}, {}
    with torch.no_grad():
        for name, sdf, o, d, params, lanes_kw, si in hybrid_ray_sets(device):
            case = trace_case(sdf, o, d, params, lanes_kw)
            if "maxt" in lanes_kw:
                case["finite_maxt_rays"] = int((torch.isfinite(lanes_kw["maxt"]) & lanes_kw["active"]).sum())
            trace[name] = case
            if name == "floor_shadow_128":
                grid_eval = {f"torus_shadow_128_{key}": grid_eval_case(sdf.data, sdf.p, pts, float64_witness=True)
                             for key, pts in grid_eval_point_sets(sdf, si.p, si.p[si.valid]).items()}
    emit({"phase": "kernels", "sphere_trace_hybrid": trace, "grid_eval_grad_hybrid": grid_eval})
    for name, case in trace.items():
        if not (case["hit_bits_differ_share_active"] <= HYBRID_HIT_BITS_LIMIT
                and case["max_abs_dits_t_both_hit"] <= 1e-5):
            raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")
        if case["active_rays"] < 10_000 or not case["plain_hit_share_active"] >= HYBRID_MIN_HIT_SHARE:
            raise AssertionError(f"the {name} ray set is degenerate: {case}")
    if not trace["area_shadow_128"]["finite_maxt_rays"] > 10_000:
        raise AssertionError(f"too few area-light shadow rays with a finite maxt: {trace['area_shadow_128']}")
    return trace, grid_eval


def grid_eval_point_sets(sdf, path_pts, hits):
    """K2's three point sets on the grid of ``sdf``: (a) ``path_order``, the
    points that compute_surface_interaction hands it on the camera chunk, in
    lane order (misses sit at the camera); (b) ``random``, 2^21 points near
    the surface: the ``hits`` resampled in random order and jittered by up to
    half a voxel (the headline); (c) ``morton``, the points of (b) sorted by
    the Morton code of their voxel."""
    import torch

    device = hits.device
    gen = torch.Generator(device=device).manual_seed(0)
    n = 1 << 21
    idx = torch.randint(0, hits.shape[0], (n,), device=device, generator=gen)
    pts = hits[idx] + (torch.rand(n, 3, device=device, generator=gen) - 0.5) / sdf.data.shape[0]
    return {
        "path_order": path_pts.contiguous(),
        "random": pts,
        "morton": pts[morton_order(pts, sdf.p, sdf.data.shape[0])].contiguous(),
    }


def phase_trace_kernels(device):
    """K1 (csrc/sphere_trace.cu) and K2 (csrc/grid_eval.cu) against their
    plain versions at the path's shapes."""
    import torch

    trace = {}
    with torch.no_grad():
        for name, sdf, o, d, params, lanes_kw, si in path_ray_sets(device):
            trace[name] = trace_case(sdf, o, d, params, lanes_kw)
            if name == "shadow_64":
                # K2's inputs below: the camera rays' surface points at 64^3
                path_pts, hits, grid64 = si.p, si.p[si.valid], sdf
        for name, case in trace.items():
            if not (case["hit_bits_differ_share"] <= 1e-3 and case["max_abs_dits_t_both_hit"] <= 1e-5):
                raise AssertionError(f"sphere-trace kernel disagrees with its plain version ({name}): {case}")

        grid_eval = {name: grid_eval_case(grid64.data, grid64.p, pts)
                     for name, pts in grid_eval_point_sets(grid64, path_pts, hits).items()}
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


# depth cuts of the train phase: iterations (512 in a full run; 3 run the
# grid at 16³, 32³ and 64³) and samples per pixel of the reference images
# (512 in a full run)
ITERS = 3
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


def counted(fn):
    """``fn()`` with every kernel count zeroed just before it and the peak
    memory statistic reset: ``(its result, the counts read just after, wall
    seconds, peak bytes allocated)``."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, read_counts(), time.perf_counter() - t0, torch.cuda.max_memory_allocated()


def require_launched(where, *counts):
    """Fail unless K1 and K2 were launched in each of ``counts``."""
    for c in counts:
        if c["sphere_trace"] == 0 or c["grid_eval_grad"] == 0:
            raise AssertionError(f"a kernel of the {where} path was not launched: {c}")


def run_optimize(scene_name, opt_cfg, method, n_iter, **kw):
    """``optimize_shape`` through :func:`counted`, recording the parameters'
    shapes after each iteration (the shapes they had during it): ``(result,
    counts, seconds, peak, shapes)``, ``shapes`` a list of ``{key: shape}``.
    Fails unless it took ``n_iter`` finite losses."""
    import math

    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt

    shapes = []

    def record(i, params, losses):
        shapes.append({k: tuple(v.shape) for k, v in params.items()})

    result, counts, seconds, peak = counted(lambda: shape_opt.optimize_shape(
        scene_name, opt_cfg, method, n_iter=n_iter, verbose=False, checkpoint_cb=record, **kw))
    if len(result.loss_values) != n_iter or not all(math.isfinite(v) for v in result.loss_values):
        raise AssertionError(f"{scene_name}: losses {result.loss_values} in {n_iter} iterations")
    return result, counts, seconds, peak, shapes


def check_checkpoints(out_dir, specs, result, n_iter, device):
    """The run's checkpoint files: each variable's first, last and EMA
    volumes, the last and the EMA read back equal to the run's tensors.
    Returns the file names."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import load_checkpoint

    specs = list(specs)
    files = sorted(os.listdir(os.path.join(out_dir, "params")))
    want = sorted({f"{s.key}-{tag}.vol" for s in specs for tag in ("data-0000", f"data-{n_iter - 1:04d}", "final")})
    if files != want:
        raise AssertionError(f"checkpoints written: {files}, expected {want}")
    ema_back = load_checkpoint(out_dir, "final", specs, device=device)
    last_back = load_checkpoint(out_dir, n_iter - 1, specs, device=device)
    for s in specs:
        if not (torch.equal(ema_back[s.key], result.ema[s.key]) and torch.equal(last_back[s.key], result.params[s.key])):
            raise AssertionError(f"the '{s.key}' checkpoints do not read back as the run's tensors and EMA")
    return files


def phase_train(device):
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    opt_cfg, _ = get_opt_config("no-tex-12")
    method = get_config("warp")
    # depth cut: the grid is upsampled after 1 and 2 iterations instead of
    # 64 and 128, so 16³, 32³ and 64³ all run; widths are the published ones
    opt_cfg.upsample_iter = (1, 2)
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy, opt_cfg.sdf_res) == (12, 6, 128, 128, 64)
    assert (method.spp, method.primal_spp_mult) == (64, 4)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as out_dir:
        result, counts, seconds, peak, shapes = run_optimize(
            "bunny", opt_cfg, method, ITERS, output_dir=out_dir, ref_spp=REF_SPP, target_res=128)
        files = check_checkpoints(out_dir, opt_cfg.variables(), result, ITERS, device)
        with open(os.path.join(out_dir, "metadata.json")) as f:
            if not np.allclose(json.load(f)["loss_values"], result.loss_values):
                raise AssertionError("metadata.json does not hold the run's losses")
    launches, cuda_launches = counts["redistance"], counts["redistance_cuda_launches"]
    seen = [s["sdf"] for s in shapes]
    final = result.params["sdf"]
    if tuple(final.shape) != (64, 64, 64) or not {(16,) * 3, (32,) * 3, (64,) * 3} <= set(seen):
        raise AssertionError(f"grid went through {seen}, expected 16^3, 32^3 and 64^3")
    if not torch.isfinite(final).all() or not torch.isfinite(result.ema["sdf"]).all():
        raise AssertionError("final grid has non-finite values")
    # every iteration redistances (more than once at an upsampling), and
    # each call is one cooperative launch
    if launches < ITERS or not 0 < cuda_launches <= 2 * launches:
        raise AssertionError(f"redistance kernel: {launches} calls, {cuda_launches} CUDA launches "
                             f"in {ITERS} iterations")
    require_launched("training", counts)
    eik = eikonal_median(final)
    if not 0.7 < eik < 1.3:
        raise AssertionError(f"final grid is not a distance field near its surface: median |grad f| = {eik}")
    emit({
        "phase": "train", "scene": "bunny", "opt_config": "no-tex-12", "method": "warp",
        "iterations": ITERS, "ref_spp": REF_SPP, "target_res": 128, "upsample_iter": [1, 2],
        "loss": result.loss_values, "iter_seconds": result.iter_seconds,
        "grid_res": [s[0] for s in seen], "seconds_total": seconds,
        "kernel_launches": counts, "eikonal_median": eik,
        "peak_memory_bytes": peak,
        "checkpoints": files,
    })
    return counts


# depth cut of the turntable: frames (64 in the CLI's default)
TURNTABLE_FRAMES = 4


def frame_recorder(render_chunked, frames, device):
    """A stand-in for ``utils/video.render_chunked`` that records, for each
    turntable frame, its image before tonemapping (finite values, shape,
    seconds) and its coverage: the share of pixel-centre camera rays that
    hit the shape, traced by the plain version so that no kernel launch is
    counted."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops.trace import sphere_trace_plain

    def recording_render(scene, **kw):
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

    return recording_render


def run_turntable(args, frame_dir, n_frames, device):
    """``render_turntable_torch.main(args)`` for ``n_frames`` frames through
    :func:`counted`, each frame recorded by :func:`frame_recorder`, and the
    PNGs it wrote in ``frame_dir`` read back.  Fails unless every frame is
    finite, 512², covers 1-99 % of the image and launched K1 and K2.
    Returns ``(seconds, counts, frames)``."""
    import render_turntable_torch
    from differentiable_sdf_rendering_tpu_torch.utils import io, video

    frames = []
    render_chunked = video.render_chunked
    video.render_chunked = frame_recorder(render_chunked, frames, device)
    try:
        _, counts, seconds, _ = counted(lambda: render_turntable_torch.main([*args, "--n_frames", str(n_frames)]))
    finally:
        video.render_chunked = render_chunked
    pngs = sorted(os.listdir(frame_dir))
    shapes = [io.read_png(os.path.join(frame_dir, f)).shape for f in pngs]
    if len(pngs) != n_frames or any(sh != (512, 512, 3) for sh in shapes) or len(frames) != n_frames:
        raise AssertionError(f"turntable frames written: {pngs} of shapes {shapes}")
    if not all(f["finite"] and 0.01 < f["coverage"] < 0.99 and f["shape"] == [512, 512, 4] for f in frames):
        raise AssertionError(f"turntable frames: {frames}")
    require_launched("turntable", counts)
    return seconds, counts, frames


def frame_fields(seconds, counts, frames):
    """A turntable run's numbers for a phase line."""
    return {"turntable_seconds": seconds, "turntable_frame_seconds": [f["seconds"] for f in frames],
            "turntable_coverage": [f["coverage"] for f in frames], "turntable_kernel_launches": counts}


def phase_cli(device):
    """``optimize_torch.main`` then ``render_turntable_torch.main`` in-process,
    at the published widths: ``bunny`` / ``no-tex-12`` / ``warp`` for one
    iteration (reference spp cut to 64 as in the train phase), then the
    turntable at 512², 256 spp for 4 of its 64 frames."""
    import optimize_torch

    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as out_dir:
        _, optimize_counts, optimize_seconds, _ = counted(lambda: optimize_torch.main(
            ["bunny", "--optconfig", "no-tex-12", "--configs", "warp", "--n_iter", "1",
             "--refspp", str(REF_SPP), "--outputdir", out_dir]))
        turntable = run_turntable(["bunny", "--optconfig", "no-tex-12", "--config", "warp", "--outputdir", out_dir],
                                  os.path.join(out_dir, "bunny", "no-tex-12", "warp", "turntable"),
                                  TURNTABLE_FRAMES, device)
    require_launched("CLI", optimize_counts)
    emit({
        "phase": "cli", "optimize_seconds": optimize_seconds, "optimize_kernel_launches": optimize_counts,
        "turntable_frames": TURNTABLE_FRAMES, **frame_fields(*turntable),
    })
    return optimize_counts, turntable[1]


# depth cuts of the textured phase: iterations (512 in a full run; the
# reference spp of the train phase); the SDF and albedo schedules are cut so
# that every size runs within them
TEX_ITERS = 4
TEX_SCENE, TEX_CONFIG = "trefoil-hdr", "principled-12"


def phase_textured(device):
    """``optimize_shape("trefoil-hdr", principled-12, warp)`` at the published
    widths with checkpoints, then ``render_turntable_torch.main`` on its
    output for one 512², 256-spp frame (counts zeroed before each, read
    after).  Returns the run's result and the counts of both."""
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.emitter import GridEnvmap
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import ASSET_DIR
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
    from differentiable_sdf_rendering_tpu_torch.utils import io

    opt_cfg, _ = get_opt_config(TEX_CONFIG)
    method = get_config("warp")
    # depth cuts: the SDF doubles after iterations 1 and 2 (16³ → 64³), the
    # albedo after 1, 2 and 3 (8³ → 64³); widths are the published ones
    opt_cfg.upsample_iter = (1, 2)
    opt_cfg.tex_upsample_iter = (1, 2, 3)
    specs = {s.key: s for s in opt_cfg.variables()}
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy) == (12, 6, 128, 128)
    assert (method.spp, method.primal_spp_mult) == (64, 4)
    assert [(k, s.resolution, s.initial_resolution) for k, s in specs.items()] == [
        ("sdf", 64, 16), ("albedo", 64, 8), ("roughness", 16, 4)]

    targets = []
    target_sdf = shape_opt.target_sdf

    def recording_target(*a, **kw):
        targets.append(target_sdf(*a, **kw))
        return targets[-1]

    with tempfile.TemporaryDirectory(prefix="chip_smoke_textured_") as root:
        out_dir = os.path.join(root, TEX_SCENE, TEX_CONFIG, method.name)
        shape_opt.target_sdf = recording_target
        try:
            result, counts, seconds, peak, seen = run_optimize(TEX_SCENE, opt_cfg, method, TEX_ITERS,
                                                               output_dir=out_dir, ref_spp=REF_SPP)
        finally:
            shape_opt.target_sdf = target_sdf
        files = check_checkpoints(out_dir, specs.values(), result, TEX_ITERS, device)
        turntable = run_turntable([TEX_SCENE, "--optconfig", TEX_CONFIG, "--config", method.name, "--outputdir", root],
                                  os.path.join(out_dir, "turntable"), 1, device)

    # the target the run used is the 128³ asset, redistanced on the card
    vol = io.read_vol(os.path.join(ASSET_DIR, "sdfs", "trefoil_128.vol"))[..., 0]
    if len(targets) != 1 or not torch.equal(targets[0], redistance(torch.from_numpy(vol.copy()).to(device))):
        raise AssertionError("the target grid is not redistance(read_vol(trefoil_128.vol)) on the card")
    emitter = result.scene.emitter
    sky = io.read_exr(os.path.join(ASSET_DIR, "envmaps", "studio_sky.exr"))
    if not (isinstance(emitter, GridEnvmap) and tuple(emitter.image.shape) == (128, 256, 3)
            and np.array_equal(emitter.image.cpu().numpy(), sky)):
        raise AssertionError("the emitter is not the GridEnvmap of envmaps/studio_sky.exr")
    shapes = {k: tuple(v.shape) for k, v in result.params.items()}
    if shapes != {"sdf": (64,) * 3, "albedo": (64, 64, 64, 3), "roughness": (4, 4, 4, 1)}:
        raise AssertionError(f"final parameter shapes {shapes}")
    if [s["albedo"][0] for s in seen] != [8, 16, 32, 64] or [s["sdf"][0] for s in seen] != [16, 32, 64, 64]:
        raise AssertionError(f"parameter shapes by iteration: {seen}")
    albedo, rough = result.params["albedo"], result.params["roughness"]
    if not all(bool(torch.isfinite(v).all()) for v in (*result.params.values(), *result.ema.values())):
        raise AssertionError("non-finite parameters")
    if not (float(albedo.min()) >= 1e-5 and float(albedo.max()) <= 1.0
            and float(rough.min()) >= 0.1 and float(rough.max()) <= 0.8):
        raise AssertionError("texture values outside their clamps")
    albedo_moved = float((albedo - 0.5).abs().max())
    if not albedo_moved > 1e-3:
        raise AssertionError(f"the albedo did not move off its start (max |albedo - 0.5| = {albedo_moved})")
    require_launched("textured", counts)
    if counts["redistance"] < TEX_ITERS:
        raise AssertionError(f"redistance kernel: {counts['redistance']} calls in {TEX_ITERS} iterations")
    emit({
        "phase": "textured", "scene": TEX_SCENE, "opt_config": TEX_CONFIG, "method": method.name,
        "iterations": TEX_ITERS, "ref_spp": REF_SPP, "target_res": 128, "upsample_iter": [1, 2],
        "tex_upsample_iter": [1, 2, 3], "loss": result.loss_values, "iter_seconds": result.iter_seconds,
        "shapes_by_iteration": seen, "seconds_total": seconds, "peak_memory_bytes": peak,
        "kernel_launches": counts, "albedo_range": [float(albedo.min()), float(albedo.max())],
        "albedo_max_move": albedo_moved, "roughness_range": [float(rough.min()), float(rough.max())],
        "checkpoints": files, **frame_fields(*turntable),
    })
    return result, counts, turntable[1]


# depth cuts of the shadow phase: iterations (512 in a full run) and the
# schedules, compressed so that every grid size up to 128³ and the 256²
# film run: the grid doubles after iterations 1, 2, 3 and 4 (128, 140, 180
# and 220 in a full run), the film after 4 (220); one iteration at 128³
SHADOW_ITERS = 5
SHADOW_SCENE, SHADOW_CONFIG = "torus-shadow", "torus-shadow-1"
SHADOW_UPSAMPLE, SHADOW_RENDER_UPSAMPLE = (1, 2, 3, 4), (4,)


def iteration_table(opt_cfg, seen, seconds):
    """Seconds of each iteration with its grid and film,
    ``[{"grid": r, "film": [x, y], "seconds": s}, ...]``; ``seen`` holds the
    grid's shape after each iteration (the shape it had during it)."""
    return [{"grid": shape[0], "film": list(opt_cfg.res_at(i)), "seconds": sec}
            for i, (shape, sec) in enumerate(zip(seen, seconds))]


def phase_shadow(device):
    """``optimize_shape("torus-shadow", torus-shadow-1, warp)`` at the
    published widths (1 view, 64 + 256 spp, grid 8³ → 128³, film 128² then
    256², the diffuse floor under the vMF sun) with checkpoints, cut in depth
    only; then ``render_turntable_torch.main`` on its output for one 512²,
    256-spp frame, and ``optimize_torch.main`` for one iteration.  Counts
    zeroed before each and read after."""
    import torch

    import optimize_torch
    from differentiable_sdf_rendering_tpu_torch.models.emitter import VMFEmitter
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    opt_cfg, _ = get_opt_config(SHADOW_CONFIG)
    method = get_config("warp")
    assert (opt_cfg.n_sensors, opt_cfg.resx, opt_cfg.resy, opt_cfg.sdf_res) == (1, 256, 256, 128)
    assert (opt_cfg.upsample_iter, opt_cfg.render_upsample_iter) == ((128, 140, 180, 220), (220,))
    assert (method.spp, method.primal_spp_mult) == (64, 4)
    opt_cfg.upsample_iter, opt_cfg.render_upsample_iter = SHADOW_UPSAMPLE, SHADOW_RENDER_UPSAMPLE
    with tempfile.TemporaryDirectory(prefix="chip_smoke_shadow_") as root:
        out_dir = os.path.join(root, SHADOW_SCENE, SHADOW_CONFIG, method.name)
        result, counts, seconds, peak, shapes = run_optimize(SHADOW_SCENE, opt_cfg, method, SHADOW_ITERS,
                                                             output_dir=out_dir, ref_spp=REF_SPP, device=device)
        files = check_checkpoints(out_dir, opt_cfg.variables(), result, SHADOW_ITERS, device)
        turntable = run_turntable([SHADOW_SCENE, "--optconfig", SHADOW_CONFIG, "--config", method.name,
                                   "--outputdir", root], os.path.join(out_dir, "turntable"), 1, device)
        cli_root = os.path.join(root, "cli")
        _, cli_counts, cli_seconds, _ = counted(lambda: optimize_torch.main(
            [SHADOW_SCENE, "--optconfig", SHADOW_CONFIG, "--configs", method.name, "--n_iter", "1",
             "--refspp", str(REF_SPP), "--outputdir", cli_root]))
        if not os.path.exists(os.path.join(cli_root, SHADOW_SCENE, SHADOW_CONFIG, method.name, "metadata.json")):
            raise AssertionError("optimize_torch.main wrote no metadata.json")

    seen = [s["sdf"] for s in shapes]
    films = [opt_cfg.res_at(i) for i in range(SHADOW_ITERS)]
    if [s[0] for s in seen] != [8, 16, 32, 64, 128]:
        raise AssertionError(f"grid went through {seen}, expected 8³, 16³, 32³, 64³ and 128³")
    if films != [(128, 128)] * 4 + [(256, 256)]:
        raise AssertionError(f"films by iteration {films}")
    scene = result.scene
    if scene.mesh is None or scene.mesh.material != "diffuse" or not isinstance(scene.emitter, VMFEmitter):
        raise AssertionError("the final scene lost the floor or the vMF sun")
    if not torch.isfinite(result.params["sdf"]).all() or not torch.isfinite(result.ema["sdf"]).all():
        raise AssertionError("final grid has non-finite values")
    require_launched("shadow", counts, cli_counts)
    if counts["redistance"] < SHADOW_ITERS or cli_counts["redistance"] < 1:
        raise AssertionError(f"redistance kernel: {counts['redistance']} calls in {SHADOW_ITERS} iterations")
    emit({
        "phase": "shadow", "scene": SHADOW_SCENE, "opt_config": SHADOW_CONFIG, "method": method.name,
        "iterations": SHADOW_ITERS, "ref_spp": REF_SPP, "target_res": 128,
        "upsample_iter": list(SHADOW_UPSAMPLE), "render_upsample_iter": list(SHADOW_RENDER_UPSAMPLE),
        "loss": result.loss_values, "iter_seconds": iteration_table(opt_cfg, seen, result.iter_seconds),
        "seconds_total": seconds, "peak_memory_bytes": peak, "kernel_launches": counts,
        "checkpoints": files, **frame_fields(*turntable), "optimize_cli_seconds": cli_seconds,
        "optimize_cli_kernel_launches": cli_counts,
    })
    return counts, turntable[1], cli_counts


def phase_mirror(device):
    """``optimize_shape("mirror-opt", mirror-opt-1, warp)`` at the published
    widths (1 view, 128² film, 64 + 256 spp, the torus seen directly and in
    the mirror rect), 3 iterations with the grid doubling after 1 and 2
    (16³ → 64³; 128 and 220 in a full run)."""
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    opt_cfg, _ = get_opt_config("mirror-opt-1")
    method = get_config("warp")
    assert (opt_cfg.n_sensors, opt_cfg.resx, opt_cfg.sdf_res, opt_cfg.upsample_iter) == (1, 128, 64, (128, 220))
    opt_cfg.upsample_iter = (1, 2)
    result, counts, seconds, peak, shapes = run_optimize("mirror-opt", opt_cfg, method, 3, ref_spp=REF_SPP,
                                                         device=device)
    seen = [s["sdf"] for s in shapes]
    if [s[0] for s in seen] != [16, 32, 64]:
        raise AssertionError(f"mirror run: grids {seen}")
    if result.scene.mesh is None or result.scene.mesh.material != "mirror":
        raise AssertionError("the final scene lost its mirror")
    require_launched("mirror", counts)
    if counts["redistance"] < 3:
        raise AssertionError(f"redistance kernel: {counts['redistance']} calls in 3 iterations")
    emit({
        "phase": "mirror", "scene": "mirror-opt", "opt_config": "mirror-opt-1", "method": method.name,
        "iterations": 3, "ref_spp": REF_SPP, "upsample_iter": [1, 2], "loss": result.loss_values,
        "iter_seconds": iteration_table(opt_cfg, seen, result.iter_seconds), "seconds_total": seconds,
        "peak_memory_bytes": peak, "kernel_launches": counts,
    })
    return counts


def phase_plane_area(device):
    """The ``plane_area`` rig (area panel over a dim ambient) on its 128³
    target at 128², 256 spp: a primal render with NEE only and one with MIS
    BSDF sampling (the same integral: their means within 8 %, the bound of
    the JAX package's test), then a 64-spp grad-mode render with MIS whose
    backward pass reaches the grid; then two iterations of
    ``optimize_shape("plane_area", no-tex-1, warp)`` at 16³, 128², 64 + 256
    spp.  Counts zeroed before and read after."""
    import dataclasses

    import torch

    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig_full, target_sdf
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    rig = scene_rig_full("plane_area", device=device)
    scene = Scene.create(target_sdf("plane_area", 128, device=device), bsdf=rig["bsdf"], emitter=rig["emitter"],
                         cameras=regular_cameras(1, resx=128, resy=128, device=device),
                         area_emitter=rig["area_emitter"], device=device)
    leaf = scene.sdf.data.clone().requires_grad_(True)

    def renders():
        nee = render(scene, 0, seed=0, cfg=RenderConfig(spp=256), device=device)
        mis = render(scene, 0, seed=1, cfg=RenderConfig(spp=256, use_mis=True), device=device)
        grad_img = render(scene.replace(sdf=scene.sdf.with_data(leaf)), 0, seed=2,
                          cfg=RenderConfig(spp=64, use_mis=True), mode="grad", device=device)
        grad_img[..., :3].sum().backward()
        return nee, mis, grad_img

    (nee, mis, grad_img), render_counts, render_seconds, _ = counted(renders)
    means = [float(img[..., :3].mean()) for img in (nee, mis, grad_img.detach())]
    grad_norm = float(leaf.grad.norm())
    if not all(bool(torch.isfinite(x).all()) for x in (nee, mis, grad_img, leaf.grad)):
        raise AssertionError("plane_area renders or gradient not finite")
    if not abs(means[0] - means[1]) / means[0] < 0.08 or not grad_norm > 1e-3:
        raise AssertionError(f"plane_area: NEE / MIS / grad means {means}, gradient norm {grad_norm}")

    opt_cfg, _ = get_opt_config("no-tex-1")
    result, counts, optimize_seconds, _, _ = run_optimize(
        "plane_area", dataclasses.replace(opt_cfg, scene_name=None), get_config("warp"), 2, ref_spp=REF_SPP,
        device=device)
    if result.scene.area_emitter is None:
        raise AssertionError("the final plane_area scene lost its area light")
    require_launched("plane_area", render_counts, counts)
    emit({
        "phase": "plane_area", "render_spp": [256, 256, 64], "means_nee_mis_grad": means,
        "grid_gradient_norm": grad_norm, "render_seconds": render_seconds, "render_kernel_launches": render_counts,
        "optimize_opt_config": "no-tex-1", "optimize_loss": result.loss_values,
        "optimize_iter_seconds": result.iter_seconds, "optimize_seconds": optimize_seconds,
        "optimize_kernel_launches": counts,
    })
    return render_counts, counts



# depth cuts of the prb phase: iterations (512 in a full run; the grids stay
# at their first sizes, or double once, as early in a full run); the bunny
# run at the published widths takes one
PRB_ITERS = 2
PRB_BUNNY_ITERS = 1
PRB_ORACLE_SEEDS = 3


def require_all_launched(where, counts):
    """Fail unless K1, K2 and redistancing were launched in ``counts``."""
    require_launched(where, counts)
    if counts["redistance"] == 0:
        raise AssertionError(f"redistancing was not launched on the {where} path: {counts}")


# The cup's depth-4 gain over depth 2 (m4 / m2 - 1) must lie within
# PRB_CUP_GAIN_BAND: the port measured 0.0258 on the host (the plain
# versions, this view at 8 spp, 3 seeds, each seed's gain within 0.001 of
# it), where depth 3 alone gains 0.0164 and a replay that adds nothing past
# the second vertex 0; the band is that reading ± 20 %.
PRB_CUP_GAIN_BAND = (0.0206, 0.0310)


def prb_oracle(device):
    """PRB's own oracle at 128², 64 spp, ``PRB_ORACLE_SEEDS`` seeds each, on
    view 0 of :func:`prb_bunny_view` and of :func:`prb_cup_view`: at depth 2
    PRB estimates direct illumination with MIS, so the means of the two
    agree within 2.5 % (tests/test_prb.py; the seeds differ, and so do the
    random streams); depth 4 adds interreflection, so on the bunny its mean
    is no lower than depth 2's, and in the cup, where the later vertices
    carry light, it gains ``PRB_CUP_GAIN_BAND`` over depth 2."""
    import statistics

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render

    def means(scene, seeds, **fields):
        return [float(render(scene, 0, seed=s, cfg=RenderConfig(spp=64, **fields), device=device)[..., :3].mean())
                for s in seeds]

    def renders():
        even, odd = range(0, 2 * PRB_ORACLE_SEEDS, 2), range(1, 2 * PRB_ORACLE_SEEDS, 2)
        return {view: {"prb_depth2": means(scene, even, integrator="sdf_prb_reparam", max_depth=2),
                       "direct_mis": means(scene, odd, use_mis=True),
                       "prb_depth4": means(scene, even, integrator="sdf_prb_reparam", max_depth=4)}
                for view, scene in (("bunny", prb_bunny_view(device)), ("cup", prb_cup_view(device)))}

    out, counts, seconds, _ = counted(renders)
    line = {"means": out, "seconds": seconds, "kernel_launches": counts, "cup_gain_band": PRB_CUP_GAIN_BAND}
    ok = True
    for view, v in out.items():
        m = {k: statistics.fmean(x) for k, x in v.items()}
        rel = abs(m["prb_depth2"] - m["direct_mis"]) / m["direct_mis"]
        gain = m["prb_depth4"] / m["prb_depth2"] - 1.0
        line[f"rel_gap_depth2_vs_direct_mis_{view}"], line[f"depth4_gain_{view}"] = rel, gain
        more = (m["prb_depth4"] >= m["prb_depth2"] - 1e-4 if view == "bunny"
                else PRB_CUP_GAIN_BAND[0] <= gain <= PRB_CUP_GAIN_BAND[1])
        ok = ok and rel < 0.025 and more
    if not ok:
        raise AssertionError(f"PRB oracle: {line}")
    require_launched("PRB oracle", counts)
    return line


def phase_prb(device):
    """Path-replay backpropagation (``sdf_prb_reparam``, the methods
    ``warpprb`` and ``warpprbprimary``) through the entry points, cut in
    depth only:

    - ``optimize_shape("bunny", no-tex-12, warpprb)`` at the published
      widths (12 views, batches of 6, 128² film, 64 + 256 spp, depth 4;
      references from the direct integrator), ``PRB_BUNNY_ITERS`` iteration at
      the 16³ grid, checkpoints read back;
    - ``optimize_torch.main`` with ``--configs warpprbprimary``, 1 iteration;
    - ``torus-shadow-1`` with ``warpprb`` (diffuse-mesh vertices, vMF NEE at
      every bounce): ``PRB_ITERS`` iterations at 128², grid 8³ → 16³;
    - ``mirror-opt-1`` with ``warpprb`` (mirror, delta, vertices): 1
      iteration at 128²;
    - :func:`prb_oracle`.

    Each run: seconds per iteration, peak memory, the launches of K1, K2 and
    redistancing (all three required), finite losses."""
    import math

    import optimize_torch
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    method = get_config("warpprb")
    assert method.integrator == "sdf_prb_reparam" and (method.spp, method.primal_spp_mult) == (64, 4)
    runs = {}

    def record(name, result, counts, seconds, peak, shapes):
        require_all_launched(f"PRB {name}", counts)
        runs[name] = {"iter_seconds": result.iter_seconds, "loss": result.loss_values,
                      "grid_res": [s["sdf"][0] for s in shapes], "seconds_total": seconds,
                      "peak_memory_bytes": peak, "kernel_launches": counts}

    opt_cfg, _ = get_opt_config("no-tex-12")
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy) == (12, 6, 128, 128)
    assert opt_cfg.upsample_iter[0] >= PRB_BUNNY_ITERS  # the grid stays 16³
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prb_") as out_dir:
        result, *rest = run_optimize("bunny", opt_cfg, method, PRB_BUNNY_ITERS, output_dir=out_dir, ref_spp=REF_SPP,
                                     target_res=128, device=device)
        files = check_checkpoints(out_dir, opt_cfg.variables(), result, PRB_BUNNY_ITERS, device)
    record("bunny_no-tex-12", result, *rest)
    runs["bunny_no-tex-12"]["checkpoints"] = files

    with tempfile.TemporaryDirectory(prefix="chip_smoke_prb_cli_") as out_dir:
        _, counts, seconds, peak = counted(lambda: optimize_torch.main(
            ["bunny", "--optconfig", "no-tex-12", "--configs", "warpprbprimary", "--n_iter", "1",
             "--refspp", str(REF_SPP), "--outputdir", out_dir]))
        with open(os.path.join(out_dir, "bunny", "no-tex-12", "warpprbprimary", "metadata.json")) as f:
            losses = json.load(f)["loss_values"]
    if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"optimize_torch.main --configs warpprbprimary: losses {losses}")
    require_all_launched("PRB CLI", counts)
    runs["cli_warpprbprimary"] = {"loss": losses, "seconds_total": seconds, "peak_memory_bytes": peak,
                                  "kernel_launches": counts}

    opt_cfg, _ = get_opt_config(SHADOW_CONFIG)
    # depth cut: the grid doubles once, after iteration 1, and stops at 16³
    opt_cfg.sdf_res, opt_cfg.upsample_iter = 16, (1,)
    assert opt_cfg.res_at(PRB_ITERS - 1) == (128, 128)
    result, *rest = run_optimize(SHADOW_SCENE, opt_cfg, method, PRB_ITERS, ref_spp=REF_SPP, device=device)
    if result.scene.mesh is None or [s["sdf"][0] for s in rest[-1]] != [8, 16]:
        raise AssertionError(f"torus-shadow PRB run: grids {rest[-1]}, mesh {result.scene.mesh}")
    record("torus-shadow-1", result, *rest)

    opt_cfg, _ = get_opt_config("mirror-opt-1")
    result, *rest = run_optimize("mirror-opt", opt_cfg, method, 1, ref_spp=REF_SPP, device=device)
    if result.scene.mesh is None or result.scene.mesh.material != "mirror":
        raise AssertionError("the final mirror-opt scene lost its mirror")
    record("mirror-opt-1", result, *rest)

    oracle = prb_oracle(device)
    emit({"phase": "prb", "method": method.name, "iterations": PRB_ITERS, "bunny_iterations": PRB_BUNNY_ITERS,
          "ref_spp": REF_SPP, "max_depth": 4,
          "runs": runs, "oracle": oracle})
    return [r["kernel_launches"] for r in runs.values()] + [oracle["kernel_launches"]]

# depth cut of the conv phase: iterations (512 in a full run; the grid stays
# at its first size, 16³, as in the first 64 iterations of a full run)
CONV_ITERS = 2


def phase_conv(device):
    """The convolution-warp baseline (Bangaru et al. 2020, ``warp_kind=
    'conv'``) through the entry points, cut in depth only:

    - ``optimize_shape("bunny", no-tex-12, conv)`` at the published widths
      (12 views, batches of 6, 128² film, 64 + 256 spp, 16 auxiliary rays
      for each reparameterized ray: the camera ray and the NEE shadow ray),
      ``CONV_ITERS`` iterations at the 16³ grid, checkpoints read back;
    - ``optimize_torch.main`` with ``--configs conv32`` (32 auxiliary rays,
      4·32 auxiliary traces a lane), 1 iteration.

    Each run: seconds per iteration, peak memory, the launches of K1, K2 and
    redistancing (all three required), finite losses."""
    import math

    import optimize_torch
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    method = get_config("conv")
    assert (method.warp_kind, method.n_aux_rays, method.spp, method.primal_spp_mult) == ("conv", 16, 64, 4)
    opt_cfg, _ = get_opt_config("no-tex-12")
    assert (opt_cfg.n_sensors, opt_cfg.batch_size, opt_cfg.resx, opt_cfg.resy) == (12, 6, 128, 128)
    assert opt_cfg.upsample_iter[0] >= CONV_ITERS  # the grid stays 16³
    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_conv_") as out_dir:
        result, counts, seconds, peak, shapes = run_optimize("bunny", opt_cfg, method, CONV_ITERS,
                                                             output_dir=out_dir, ref_spp=REF_SPP, target_res=128,
                                                             device=device)
        files = check_checkpoints(out_dir, opt_cfg.variables(), result, CONV_ITERS, device)
    require_all_launched("conv", counts)
    runs["bunny_no-tex-12"] = {"iter_seconds": result.iter_seconds, "loss": result.loss_values,
                               "grid_res": [s["sdf"][0] for s in shapes], "seconds_total": seconds,
                               "peak_memory_bytes": peak, "kernel_launches": counts, "checkpoints": files}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_conv32_") as out_dir:
        _, counts32, seconds32, peak32 = counted(lambda: optimize_torch.main(
            ["bunny", "--optconfig", "no-tex-12", "--configs", "conv32", "--n_iter", "1",
             "--refspp", str(REF_SPP), "--outputdir", out_dir]))
        with open(os.path.join(out_dir, "bunny", "no-tex-12", "conv32", "metadata.json")) as f:
            metadata = json.load(f)
    losses = metadata["loss_values"]
    if len(losses) != 1 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"optimize_torch.main --configs conv32: losses {losses}")
    require_all_launched("conv32 CLI", counts32)
    runs["cli_conv32"] = {"loss": losses, "iter_seconds": metadata["iter_seconds"], "seconds_total": seconds32,
                          "peak_memory_bytes": peak32, "kernel_launches": counts32}
    emit({"phase": "conv", "method": method.name, "n_aux_rays": method.n_aux_rays, "iterations": CONV_ITERS,
          "ref_spp": REF_SPP, "runs": runs})
    return [counts, counts32]


# the scenefile phase: the checked-in scene files at their own widths, the
# samples of their primal renders, the gradient images' settings (the JAX
# package's defaults: ε 1e-3, 2048 spp for FD) and the mesh -> SDF grids
SCENE_FILES = ("scenes/example/example.json", "scenes/example/hybrid_floor.json", "scenes/studio/studio.json")
SCENE_SPP = 64
FD_EPS, FD_SPP = 1e-3, 2048
MESH_SDFS = (("trefoil", 64), ("trefoil", 128), ("blob", 64), ("blob", 128), ("cinquefoil", 64),
             ("cinquefoil", 128))
SCENEFILE_ITERS = 2
# create_sdf on the card against the checked-in assets, (max, 99.9th
# percentile) of |difference| a resolution.  The card redistances as the
# plain version does, bit for bit, and the assets are the JAX package's
# create_sdf (its CPU build reproduces them bit for bit).  Measured on the
# host: 1.3e-5 to 2.4e-5 at 64³ (99.9th percentile 1.1e-5); at 128³ up to
# 1.68e-3 on 367-643 voxels far from the surface, where both packages are
# 3e-3 to 5e-3 off the exact distance and the JAX package's compiled
# redistancing moves 1.4e-3 under a 1-ulp change of its input (the port's
# 1.2e-5), 99.9th percentile 4.2e-5 (ROADMAP §C gap 1)
CREATE_SDF_LIMITS = {64: (3e-5, 1.5e-5), 128: (2e-3, 5e-5)}


def scene_file_case(path, device):
    """``load_scene_file(path)`` on the card at the file's widths; every view
    primal at ``SCENE_SPP``; view 0 grad-mode with a backward pass to the
    grid (finite, non-zero).  Returns its record and the two count dicts."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render_chunked
    from differentiable_sdf_rendering_tpu_torch.models.scene_file import load_scene_file

    scene, load_counts, load_seconds, _ = counted(lambda: load_scene_file(path, device=device))
    cfg = RenderConfig(spp=SCENE_SPP)
    leaf = scene.sdf.data.clone().requires_grad_(True)

    def renders():
        imgs = [render_chunked(scene, v, seed=v, cfg=cfg, mode="primal", device=device)
                for v in range(scene.n_views)]
        grad_img = render_chunked(scene.replace(sdf=scene.sdf.with_data(leaf)), 0, seed=scene.n_views, cfg=cfg,
                                  mode="grad", device=device)
        grad_img[..., :3].sum().backward()
        return imgs

    imgs, counts, seconds, peak = counted(renders)
    cams = scene.cameras
    if not all(img.shape == (cams.resy, cams.resx, 4) and bool(torch.isfinite(img).all()) for img in imgs):
        raise AssertionError(f"{path}: primal renders not finite or of the wrong shape")
    grad_norm = float(leaf.grad.norm())
    if not (bool(torch.isfinite(leaf.grad).all()) and grad_norm > 0):
        raise AssertionError(f"{path}: grid gradient {grad_norm}")
    # the procedural grid is redistanced on load; the renders trace (K1) and
    # shade (K2) on the card
    require_launched(path, counts)
    if load_counts["redistance"] == 0:
        raise AssertionError(f"{path}: loading the scene did not redistance on the card: {load_counts}")
    record = {
        "grid": list(scene.sdf.data.shape), "views": scene.n_views, "film": [cams.resx, cams.resy],
        "triangles": 0 if scene.mesh is None else scene.mesh.n_triangles,
        "area_light": scene.area_emitter is not None, "emitter": type(scene.emitter).__name__,
        "load_seconds": load_seconds, "render_seconds": seconds, "peak_memory_bytes": peak,
        "image_means": [float(img[..., :3].mean()) for img in imgs], "grid_gradient_norm": grad_norm,
        "load_kernel_launches": load_counts, "render_kernel_launches": counts,
    }
    return scene, record, [load_counts, counts]


def studio_host_check(scene, path, device):
    """View 0 of the studio scene at 4 spp on the card against the same
    scene loaded and rendered on the host (the plain versions), at the
    ``reference`` phase's tolerance."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
    from differentiable_sdf_rendering_tpu_torch.models.scene_file import load_scene_file

    cfg = RenderConfig(spp=4)
    card = render(scene, 0, seed=0, cfg=cfg, device=device).cpu()
    host = render(load_scene_file(path, device="cpu"), 0, seed=0, cfg=cfg, device="cpu")
    diff = (card - host).abs()
    mean_diff, max_diff = float(diff.mean()), float(diff.max())
    if not (bool(torch.isfinite(card).all()) and mean_diff < 1e-6 and max_diff < 1e-4):
        raise AssertionError(f"studio view 0: card vs host abs diff mean {mean_diff}, max {max_diff}")
    return {"spp": 4, "mean_abs_diff": mean_diff, "max_abs_diff": max_diff}


def forward_gradient_case(scene, device):
    """``eval_forward_gradient`` on view 0, axis 0: forward mode through the
    grad-mode render at ``SCENE_SPP`` and central differences of two primal
    renders at ±``FD_EPS`` with ``FD_SPP`` samples; their agreement is
    recorded (the warp estimator's bias against FD is the reference's own)."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig
    from differentiable_sdf_rendering_tpu_torch.opt.validation import eval_forward_gradient

    cfg = RenderConfig(spp=SCENE_SPP)
    out = {}
    for method in ("ad", "fd"):
        (img, grad, _), counts, seconds, peak = counted(lambda: eval_forward_gradient(
            scene, cfg, axis=0, view_idx=0, seed=0, method=method, fd_eps=FD_EPS, fd_spp=FD_SPP))
        if not (bool(torch.isfinite(img).all()) and bool(torch.isfinite(grad).all())):
            raise AssertionError(f"eval_forward_gradient({method}): not finite")
        out[method] = {"grad": grad.double().flatten(), "seconds": seconds, "peak_memory_bytes": peak,
                       "kernel_launches": counts, "grad_abs_sum": float(grad.abs().sum())}
    a, f = out["ad"].pop("grad"), out["fd"].pop("grad")
    if not float(a.abs().sum()) > 0:
        raise AssertionError("the forward-mode gradient image is zero")
    # the FD renders are primal (K1, K2); the forward-mode render is a
    # grad-mode render, whose traces are the masked sphere_trace_warp loop
    # and whose evaluations are attached: no K1 or K2 launch is expected there
    require_launched("eval_forward_gradient(fd)", out["fd"]["kernel_launches"])
    ac, fc = a - a.mean(), f - f.mean()
    return {
        "view": 0, "axis": 0, "ad_spp": SCENE_SPP, "fd_eps": FD_EPS, "fd_spp": FD_SPP, **out,
        "relative_l2_ad_vs_fd": float((a - f).norm() / f.norm()),
        "pearson_ad_fd": float((ac * fc).sum() / (ac.norm() * fc.norm())),
    }


def mesh_sdf_cases(device):
    """``create_sdf`` of the three generated meshes at 64³ and 128³ on the
    card against the checked-in ``.vol`` assets (built by the JAX package's
    ``create_sdf``): differences, the host (native) and card (redistancing)
    seconds, the redistancing launches."""
    import numpy as np

    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import ASSET_DIR
    from differentiable_sdf_rendering_tpu_torch.utils import mesh as mesh_mod
    from differentiable_sdf_rendering_tpu_torch.utils.io import read_vol
    from differentiable_sdf_rendering_tpu_torch.utils.profiling import Timer

    cases = {}
    for name, res in MESH_SDFS:
        mesh = getattr(mesh_mod, name)()
        timer = Timer(device)
        grid, counts, seconds, _ = counted(lambda: mesh_mod.create_sdf(mesh, res, device=device, timer=timer))
        asset = read_vol(os.path.join(ASSET_DIR, "sdfs", f"{name}_{res}.vol"))[..., 0]
        diff = np.abs(grid.cpu().numpy() - asset)
        p999 = float(np.percentile(diff, 99.9))
        max_limit, p999_limit = CREATE_SDF_LIMITS[res]
        if not (grid.shape == (res, res, res) and diff.max() <= max_limit and p999 <= p999_limit
                and counts["redistance"] == 2):
            raise AssertionError(f"create_sdf({name}, {res}): max diff {diff.max()}, 99.9th percentile {p999}, "
                                 f"counts {counts}")
        near = np.abs(asset) < 2.0 / res
        cases[f"{name}_{res}"] = {
            "triangles": len(mesh[1]), "max_abs_diff": float(diff.max()), "p99_9_abs_diff": p999,
            "voxels_over_1e-4": int((diff > 1e-4).sum()), "max_abs_diff_within_2_voxels": float(diff[near].max()),
            "seconds": seconds,
            "native_seconds": timer.sections["native"], "card_seconds": timer.sections["redistance"],
            "kernel_launches": counts,
        }
    return cases


def resume_case(device):
    """``optimize_shape("bunny", no-tex-12, warp)`` for ``SCENEFILE_ITERS``
    iterations with checkpoints and progress images, then resumed from
    checkpoint 0 to the same end; the stitched losses and wall time of
    ``metadata.json``, the loss plot, the convergence video over the written
    images and ``device_time`` of one render of the result."""
    import math

    import numpy as np

    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
    from differentiable_sdf_rendering_tpu_torch.utils.io import read_png
    from differentiable_sdf_rendering_tpu_torch.utils.profiling import device_time
    from differentiable_sdf_rendering_tpu_torch.utils.video import convergence_video

    opt_cfg, _ = get_opt_config("no-tex-12")
    method = get_config("warp")
    n = SCENEFILE_ITERS
    with tempfile.TemporaryDirectory(prefix="chip_smoke_resume_") as out_dir:
        first, counts, seconds, peak, _ = run_optimize("bunny", opt_cfg, method, n, output_dir=out_dir,
                                                       ref_spp=REF_SPP, target_res=128, write_images=True,
                                                       device=device)
        require_all_launched("resume (first run)", counts)
        with open(os.path.join(out_dir, "metadata.json")) as f:
            first_time = json.load(f)["total_time"]
        images = sorted(os.listdir(os.path.join(out_dir, "opt")))
        want = [f"opt-{i:04d}-{v:02d}.png" for i in range(n) for v in range(6)]
        if images != want:
            raise AssertionError(f"progress images {images}, expected {want}")
        loss_plot = os.path.exists(os.path.join(out_dir, "loss.png"))

        import differentiable_sdf_rendering_tpu_torch.opt.shape_opt as shape_opt

        resumed, resume_counts, resume_seconds, _ = counted(lambda: shape_opt.optimize_shape(
            "bunny", opt_cfg, method, output_dir=out_dir, ref_spp=REF_SPP, target_res=128, n_iter=n,
            resume_from=0, verbose=False, device=device))
        with open(os.path.join(out_dir, "metadata.json")) as f:
            meta = json.load(f)
        stitched_ok = (len(resumed.loss_values) == n and resumed.loss_values[0] == first.loss_values[0]
                       and math.isfinite(resumed.loss_values[-1]) and meta["loss_values"] == resumed.loss_values
                       and meta["total_time"] > first_time)
        if not stitched_ok:
            raise AssertionError(f"resume: losses {resumed.loss_values} after {first.loss_values}, "
                                 f"total_time {meta['total_time']} after {first_time}")
        require_all_launched("resume", resume_counts)

        def png(name):
            return (read_png(os.path.join(out_dir, "opt", name))[..., :3].astype(np.float32) / 255.0) ** 2.2

        # each iteration's views over the last iteration's (the run renders
        # its references inside optimize_shape and returns none)
        opt_images = {i: [png(f"opt-{i:04d}-{v:02d}.png") for v in range(6)] for i in range(n)}
        ffmpeg_ran = convergence_video(out_dir, opt_images, opt_images[n - 1])
        frames = sorted(os.listdir(os.path.join(out_dir, "convergence")))

    scene = resumed.scene
    cfg = RenderConfig(spp=SCENE_SPP)
    render_s, img = device_time(lambda: render(scene, 0, seed=0, cfg=cfg, device=device), n_runs=5, device=device)
    if not bool(img.isfinite().all()):
        raise AssertionError("device_time: the render is not finite")
    return {
        "iterations": n, "loss": first.loss_values, "iter_seconds": first.iter_seconds, "seconds_total": seconds,
        "peak_memory_bytes": peak, "kernel_launches": counts, "progress_images": len(images),
        "loss_png_written": loss_plot, "resume_from": 0, "resumed_loss": resumed.loss_values,
        "resumed_iter_seconds": resumed.iter_seconds, "resume_seconds": resume_seconds,
        "resume_kernel_launches": resume_counts, "total_time_before_and_after": [first_time, meta["total_time"]],
        "convergence_frames": len(frames), "ffmpeg_ran": ffmpeg_ran,
        "device_time_render_s": render_s, "device_time_render": f"view 0, {scene.cameras.resx}x{scene.cameras.resy}, {SCENE_SPP} spp, 5 runs",
    }


def trace_2d_case(device):
    """``trace_2d`` of 2¹⁶ rays at a disk and at a 256² ``Grid2d`` of a
    disk with noise, on the card against the plain host path: hit bits
    equal, ``its_t`` of the hits within 5e-5 (measured 1.0e-5 on the disk:
    the card's sqrt and pow round otherwise, over up to 64 steps), step
    counts equal on all but 1e-3 of the rays (measured: 1 of 65,536)."""
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import sdf2d

    rng = np.random.default_rng(2)
    n, res = 1 << 16, 256
    o = np.stack([rng.uniform(-0.5, 1.5, n), np.full(n, -1.0)], -1).astype(np.float32)
    d = np.stack([rng.uniform(-0.6, 0.6, n), np.ones(n)], -1).astype(np.float32)
    xs = (np.arange(res) + 0.5) / res
    x, y = np.meshgrid(xs, xs)
    grid = (np.sqrt((x - 0.5) ** 2 + (y - 0.45) ** 2) - 0.3 + 0.002 * rng.standard_normal((res, res)))
    out = {}
    for name in ("disk", "grid"):
        runs = {}
        for dev in ("cpu", device):
            sdf = (sdf2d.DiskSDF.create((0.5, 0.45), 0.3, device=dev) if name == "disk"
                   else sdf2d.Grid2d(data=torch.tensor(grid, dtype=torch.float32, device=dev)))
            t0 = time.perf_counter()
            r = sdf2d.trace_2d(sdf, torch.tensor(o, device=dev), torch.tensor(d, device=dev))
            if torch.device(dev).type == "cuda":
                torch.cuda.synchronize()
            runs[str(dev)] = ({k: v.cpu() for k, v in r.items()}, time.perf_counter() - t0)
        (host, host_s), (card, card_s) = runs["cpu"], runs[str(device)]
        hit_h, hit_c = torch.isfinite(host["its_t"]), torch.isfinite(card["its_t"])
        both = hit_h & hit_c
        dt = float((host["its_t"][both] - card["its_t"][both]).abs().max())
        steps_differ = float((host["i"] != card["i"]).double().mean())
        if not (torch.equal(hit_h, hit_c) and dt < 5e-5 and steps_differ < 1e-3 and 0.1 < float(hit_h.double().mean()) < 0.9):
            raise AssertionError(f"trace_2d({name}): hit bits equal {torch.equal(hit_h, hit_c)}, its_t {dt}, "
                                 f"steps differ on {steps_differ}")
        out[name] = {"rays": n, "hit_share": float(hit_h.double().mean()), "max_abs_dits_t": dt,
                     "steps_differ_share": steps_differ, "card_seconds": card_s, "host_seconds": host_s}
    return out


def phase_scenefile(device):
    """Scene files, the mesh -> SDF tools, the validation and optimisation
    tools on the card: each item prints its own line (``phase`` =
    ``scenefile``, ``item`` its name); returns the kernel counts of the
    phase's runs."""
    import optimize_torch

    all_counts = []
    studio = None
    for path in SCENE_FILES:
        scene, record, counts = scene_file_case(path, device)
        all_counts += counts
        if path.endswith("studio.json"):
            studio = scene
            record["host_check"] = studio_host_check(scene, path, device)
        emit({"phase": "scenefile", "item": "scene_file", "path": path, **record})

    grad = forward_gradient_case(studio, device)
    all_counts += [grad["ad"]["kernel_launches"], grad["fd"]["kernel_launches"]]
    emit({"phase": "scenefile", "item": "eval_forward_gradient", "scene": SCENE_FILES[-1], **grad})

    meshes = mesh_sdf_cases(device)
    all_counts += [c["kernel_launches"] for c in meshes.values()]
    emit({"phase": "scenefile", "item": "create_sdf", "grids": meshes})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_fd_") as out_dir:
        _, fd_counts, fd_seconds, fd_peak = counted(lambda: optimize_torch.main(
            ["bunny", "--optconfig", "no-tex-12", "--configs", "fd", "--n_iter", "1",
             "--refspp", str(REF_SPP), "--outputdir", out_dir]))
        with open(os.path.join(out_dir, "bunny", "no-tex-12", "fd", "metadata.json")) as f:
            fd_meta = json.load(f)
    if len(fd_meta["loss_values"]) != 1 or not all(map(math.isfinite, fd_meta["loss_values"])):
        raise AssertionError(f"optimize_torch.main --configs fd: losses {fd_meta['loss_values']}")
    require_all_launched("fd CLI", fd_counts)
    all_counts.append(fd_counts)
    emit({"phase": "scenefile", "item": "cli_fd", "loss": fd_meta["loss_values"],
          "iter_seconds": fd_meta["iter_seconds"], "seconds_total": fd_seconds, "peak_memory_bytes": fd_peak,
          "kernel_launches": fd_counts})

    resume = resume_case(device)
    all_counts += [resume["kernel_launches"], resume["resume_kernel_launches"]]
    emit({"phase": "scenefile", "item": "resume_images", **resume})

    emit({"phase": "scenefile", "item": "trace_2d", **trace_2d_case(device)})
    return all_counts


GOLDEN_NAMES = ("trefoil", "blob", "cinquefoil")


def golden_render(name, device):
    """The render of ``tests/test_assets.py``'s golden regression: the 64³
    asset, two 64² cameras, view 0, seed 0, 16 spp, primal."""
    from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
    from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import target_sdf

    scene = Scene.create(target_sdf(name, 64, device=device),
                         cameras=regular_cameras(2, resx=64, resy=64, device=device), device=device)
    return render(scene, 0, seed=0, cfg=RenderConfig(integrator="sdf_direct_reparam", spp=16), mode="primal",
                  device=device)[..., :3].cpu().numpy()


def phase_golden(device):
    """Each asset's render on the card against the JAX package's golden EXR at
    that test's bound (atol 5e-4, rtol 1e-3).  Where pixels miss it, they are
    listed with the same render on the host (the plain versions of K1 and
    K2) before the phase fails."""
    import numpy as np

    from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import ASSET_DIR
    from differentiable_sdf_rendering_tpu_torch.utils import io

    out, failed = {}, []
    for name in GOLDEN_NAMES:
        img = golden_render(name, device)
        golden = io.read_exr(os.path.join(ASSET_DIR, "golden", f"{name}_direct_s0.exr"))
        diff = np.abs(img - golden)
        miss = diff > 5e-4 + 1e-3 * np.abs(golden)
        out[name] = {"max_abs_diff": float(diff.max()), "mean_abs_diff": float(diff.mean()),
                     "pixels_beyond_bound": int(miss.any(-1).sum())}
        if miss.any():
            host = golden_render(name, "cpu")
            ys, xs = np.nonzero(miss.any(-1))
            out[name]["missed"] = [{"pixel": [int(y), int(x)], "card": img[y, x].tolist(), "golden": golden[y, x].tolist(),
                                    "host": host[y, x].tolist()} for y, x in zip(ys[:20], xs[:20])]
            out[name]["host_max_abs_diff"] = float(np.abs(host - golden).max())
            failed.append(name)
    emit({"phase": "golden", "atol": 5e-4, "rtol": 1e-3, "renders": out})
    if failed:
        raise AssertionError(f"golden images missed on the card: {failed}")
    return out


def texture_cost_per_view(device, result):
    """Launches and device ms (``torch.profiler``) and wall seconds of one
    view of the textured training step at the run's final state, with the
    albedo and roughness volumes bound and with the same step on the SDF
    alone (the principled BSDF's constants): what the attached texture
    lookups add to a view."""
    import torch

    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
    from differentiable_sdf_rendering_tpu_torch.opt import shape_opt
    from differentiable_sdf_rendering_tpu_torch.opt.configs import get_config
    from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config

    opt_cfg, _ = get_opt_config(TEX_CONFIG)
    method = get_config("warp")
    scene = result.scene
    cams = shape_opt._make_cameras(opt_cfg, opt_cfg.resx, opt_cfg.resy, device)
    base = Scene(sdf=GridSDF.create(torch.zeros_like(result.params["sdf"])), bsdf=scene.bsdf, emitter=scene.emitter,
                 cameras=cams)
    cfg_primal, cfg_grad = shape_opt.render_configs(method)
    ref = torch.zeros(1, opt_cfg.resy, opt_cfg.resx, 3, device=device)
    out = {}
    for name, params in (("with_textures", result.params), ("sdf_only", {"sdf": result.params["sdf"]})):
        def view():
            shape_opt._view_batch_loss_grads(params, base, [0], [0], [13], ref, loss_name=opt_cfg.loss,
                                             cfg_primal=cfg_primal, cfg_grad=cfg_grad, batch=1)

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        view()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, device_ms, sessions = cuda_launches_per_call(view)
        out[name] = {"wall_seconds": wall, "cuda_launches": launches, "device_ms": device_ms,
                     "profiler_sessions": sessions}
    return out


def phase_launch_count(device, k1=True, textured=None):
    """CUDA launches (kernels and memsets, as ``torch.profiler`` records
    them) of one ``redistance`` call on the perturbed sphere at every size of
    ``REDISTANCE_SIZES`` (the kernel alone: at most 2) with their device
    time, and of one ``sphere_trace`` call on the camera chunk at 64^3 (the
    kernel and the fill of its ray counter)."""
    import numpy as np
    import torch

    from differentiable_sdf_rendering_tpu_torch.ops import redistance as rd
    from differentiable_sdf_rendering_tpu_torch.ops import trace as tr

    redistance_launches, device_ms, sessions = {}, {}, {}
    for res in REDISTANCE_SIZES:
        phi = torch.as_tensor(level_sets(res, np.random.default_rng(res))[0]["perturbed_sphere"], device=device)
        redistance_launches[res], device_ms[res], sessions[res] = cuda_launches_per_call(lambda: rd.redistance(phi))
    if not all(0 < n <= 2 for n in redistance_launches.values()):
        raise AssertionError(f"CUDA launches of one redistance call: {redistance_launches}")
    line = {"phase": "launch_count", "redistance_cuda_launches_per_call": redistance_launches,
            "redistance_device_ms_per_call": device_ms, "redistance_profiler_sessions": sessions}
    launches = None
    if k1:
        name, sdf, o, d, params, lanes_kw, _ = next(path_ray_sets(device))
        with torch.no_grad():
            launches, _, k1_sessions = cuda_launches_per_call(lambda: tr.sphere_trace(sdf, o, d, params, **lanes_kw))
        line.update(set=name, sphere_trace_cuda_launches_per_call=launches, sphere_trace_profiler_sessions=k1_sessions)
    if textured is not None:
        line["textured_view"] = texture_cost_per_view(device, textured)
    emit(line)
    return launches, redistance_launches


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from differentiable_sdf_rendering_tpu_torch import kernels, native

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({
        "phase": "device", "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "torch": torch.__version__, "cuda": torch.version.cuda, "triton": triton_version(),
        "tf32_matmul": torch.backends.cuda.matmul.allow_tf32, "tf32_cudnn": torch.backends.cudnn.allow_tf32,
    })

    built = kernels.build_all(verbose_ptxas=True)
    t_native = time.perf_counter()
    native.library()  # the host helpers of create_sdf, g++ from native/voxelize.cpp
    emit({"phase": "build", "seconds": built["seconds"], "built": built["built"],
          "native_seconds": time.perf_counter() - t_native,
          "native_library": os.path.relpath(native._lib_path()),
          "ptxas": [ln for ln in built["log"].splitlines() if "registers" in ln or "spill" in ln]})

    phase_seconds = {}

    def timed(name, phase, *args, **kw):
        """``phase(*args, **kw)``, its wall seconds recorded under ``name``."""
        t0 = time.perf_counter()
        out = phase(*args, **kw)
        phase_seconds[name] = time.perf_counter() - t0
        return out

    max_err, by_res = timed("kernels_redistance", phase_kernels, device)
    if argv not in ([], ["--kernels-only"]):
        raise SystemExit(f"usage: chip_smoke.py [--kernels-only]; got {argv}")
    trace, grid_eval = timed("kernels_path", phase_trace_kernels, device)
    sphere = timed("kernels_sphere", sphere_case, device)
    hybrid, hybrid_grid_eval = timed("kernels_hybrid", phase_hybrid_trace_kernels, device)
    prb_trace, prb_grid_eval = timed("kernels_prb", phase_prb_trace_kernels, device)
    conv_trace = timed("kernels_conv", phase_conv_trace_kernels, device)
    option_trace = timed("kernels_options", phase_option_trace_kernels, device, trace)
    if argv == ["--kernels-only"]:
        phase_launch_count(device, k1=False)
        return 0
    timed("reference", phase_reference, device)
    train_counts = timed("train", phase_train, device)
    optimize_counts, turntable_counts = timed("cli", phase_cli, device)
    textured, textured_counts, textured_turntable_counts = timed("textured", phase_textured, device)
    timed("golden", phase_golden, device)
    shadow_counts = timed("shadow", phase_shadow, device)
    mirror_counts = timed("mirror", phase_mirror, device)
    plane_area_counts = timed("plane_area", phase_plane_area, device)
    prb_counts = timed("prb", phase_prb, device)
    conv_counts = timed("conv", phase_conv, device)
    scenefile_counts = timed("scenefile", phase_scenefile, device)
    k1_launches, redistance_launches = timed("launch_count", phase_launch_count, device, textured=textured)
    emit({"phase": "timing", "seconds": phase_seconds, "since_start": time.perf_counter() - T_START})

    def launches_in(counts, key):
        return sum(c[key] for c in counts)

    def slice_launches(key):
        """The launches of the hybrid phases: the shadow run (+ its turntable
        frame and CLI iteration), the mirror run, the plane_area renders and
        run; of the prb phase (its four runs and its oracle); of the conv
        phase (its run and the conv32 CLI iteration); and of the scenefile
        phase (all its items)."""
        return {"shadow_launches": launches_in(shadow_counts, key), "mirror_launches": mirror_counts[key],
                "plane_area_launches": launches_in(plane_area_counts, key),
                "prb_launches": launches_in(prb_counts, key), "conv_launches": launches_in(conv_counts, key),
                "scenefile_launches": launches_in(scenefile_counts, key)}

    # Each kernel's times at the main path's shapes; the other shapes are in
    # the ``kernels`` phase lines.  ``launches`` counts the wrapper's calls
    # into the kernel during the train phase, ``cli_launches`` during the two
    # CLI runs, ``textured_launches`` during the textured run and its
    # turntable frame, ``shadow_launches``, ``mirror_launches`` and
    # ``plane_area_launches`` during the hybrid phases, ``prb_launches``
    # during the prb phase, ``conv_launches`` during the conv phase;
    # ``cuda_launches`` the
    # CUDA launches of the redistancing calls (counted by the kernel's C entry).  No single PyTorch call computes any
    # of these functions, so ``library_ms`` is null.
    main_res = by_res[64]
    k1 = trace["camera_64"]
    k1_sets = {**trace, **hybrid, **prb_trace, **conv_trace, **option_trace}
    k2 = grid_eval["random"]
    emit({"kernels": [
        {
            "name": "redistance", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/redistance.cu",
            "replaces": "differentiable_sdf_rendering_tpu/ops/pallas_redistance.py:113",
            "launches": train_counts["redistance"], "cuda_launches": train_counts["redistance_cuda_launches"],
            "cli_launches": optimize_counts["redistance"] + turntable_counts["redistance"],
            "textured_launches": textured_counts["redistance"] + textured_turntable_counts["redistance"],
            **slice_launches("redistance"),
            "max_abs_err": max_err, "ms": main_res["ms"], "plain_ms": main_res["plain_ms"],
            "bound_ms": main_res["bound_ms"], "bound_by": main_res["bound_by"], "library_ms": None,
            "wrapper_ms": main_res["wrapper_ms"], "wrapper_cuda_launches": redistance_launches[64],
            "shape": "64x64x64 fp32, 64 passes",
            "by_res": {res: {key: r[key] for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}
                       for res, r in by_res.items()},
        },
        {
            "name": "sphere_trace", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/sphere_trace.cu",
            "replaces": "scripts/trace_probe_r3.py:360",
            "launches": train_counts["sphere_trace"],
            "cli_launches": optimize_counts["sphere_trace"] + turntable_counts["sphere_trace"],
            "textured_launches": textured_counts["sphere_trace"] + textured_turntable_counts["sphere_trace"],
            **slice_launches("sphere_trace"),
            "max_abs_err": max(c["max_abs_dits_t_both_hit"] for c in [*k1_sets.values(), sphere]),
            "hit_bits_differ_share": max(c["hit_bits_differ_share"] for c in [*k1_sets.values(), sphere]),
            "hybrid_hit_bits_differ_share_active": max(
                c["hit_bits_differ_share_active"]
                for c in [*hybrid.values(), *prb_trace.values(), *conv_trace.values(), *option_trace.values()]),
            "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
            "library_ms": None, "wrapper_ms": k1["wrapper_ms"],
            "wrapper_cuda_launches": k1_launches,
            "shape": f"{k1['rays']} camera rays of a bunny view (128^2 film, 256 spp), 64^3 fp32 grid",
            "sets": {name: {key: c[key] for key in ("ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}
                     for name, c in {**k1_sets, "analytic_sphere": sphere}.items()},
        },
        {
            "name": "grid_eval_grad", "route": "cuda",
            "source": "differentiable_sdf_rendering_tpu_torch/csrc/grid_eval.cu",
            "replaces": "scripts/trace_probe_r3.py:421",
            "also_replaces": ["scripts/trace_probe_r3.py:482", "scripts/gather_probe.py:206",
                              "scripts/gather_probe.py:262"],
            "launches": train_counts["grid_eval_grad"],
            "cli_launches": optimize_counts["grid_eval_grad"] + turntable_counts["grid_eval_grad"],
            "textured_launches": textured_counts["grid_eval_grad"] + textured_turntable_counts["grid_eval_grad"],
            **slice_launches("grid_eval_grad"),
            "max_abs_err": max(c["max_abs_diff"]
                               for c in [*grid_eval.values(), *hybrid_grid_eval.values(), *prb_grid_eval.values()]),
            "ms": k2["ms"], "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
            "bound_by": k2["bound_by"], "library_ms": None,
            "shape": f"{k2['points']} points near the surface in random order, 64^3 fp32 grid",
            "sets": {name: {key: c[key] for key in ("points", "grid_res", "ms", "plain_ms", "bound_ms", "bound_by")}
                     for name, c in {**grid_eval, **hybrid_grid_eval, **prb_grid_eval}.items()},
        },
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
