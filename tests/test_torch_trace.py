"""Sphere tracing of the port vs the JAX package on a perturbed 16³ sphere:
512 rays including misses, grazing rays, rays from inside the box, shadow
rays with a finite extent, inactive lanes and lanes without refinement.

``sphere_trace`` on CPU tensors is the plain version of the CUDA kernel
``csrc/sphere_trace.cu`` (``sphere_trace_plain``); the kernel itself is held
against that plain version on the card by ``chip_smoke.py``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import trace as jtrace
from differentiable_sdf_rendering_tpu.ops.redistance import redistance as jredistance
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF, TraceParams as JTraceParams
from differentiable_sdf_rendering_tpu_torch.ops import trace as ttrace
from differentiable_sdf_rendering_tpu_torch.ops.sdf import BoxSDF, GridSDF, SphereSDF, TraceParams
from torch_port_helpers import JIT_LEVEL0, perturbed_sphere, t, to_np


def _rays(rng, n):
    """Origins on a radius-2 sphere around the grid, aimed at points spread
    over (and beyond) the shape; a quarter aimed at its silhouette ring; the
    last 64 start inside the box."""
    o = rng.normal(size=(n, 3))
    o = 0.5 + 2.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = 0.5 + rng.uniform(-0.55, 0.55, size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    k = n // 4  # grazing: offset the aim perpendicular to the view axis by ~the radius
    axis = (0.5 - o[:k]) / np.linalg.norm(0.5 - o[:k], axis=-1, keepdims=True)
    perp = np.cross(axis, rng.normal(size=(k, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    aim = 0.5 + perp * rng.uniform(0.27, 0.33, size=(k, 1))
    d[:k] = (aim - o[:k]) / np.linalg.norm(aim - o[:k], axis=-1, keepdims=True)
    o[-64:] = rng.uniform(0.05, 0.95, size=(64, 3))
    return o.astype(np.float32), d.astype(np.float32)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    grid = np.asarray(jax.jit(jredistance, **JIT_LEVEL0)(jnp.asarray(perturbed_sphere(16, seed=7, sigma=0.02))))
    o, d = _rays(rng, 512)
    maxt = np.full(512, np.inf, np.float32)
    maxt[::7] = rng.uniform(0.5, 2.5, size=maxt[::7].shape)
    return grid, o, d, maxt


@pytest.fixture(scope="module")
def masked(case):
    """The JAX package's ``sphere_trace`` (traced once) and the port's plain
    version on the same rays, with a per-lane ``active`` mask (every fifth
    lane off), ``refine_active`` off on every third lane and the finite
    ``maxt`` of ``case``."""
    grid, o, d, maxt = case
    active = np.arange(512) % 5 != 4
    refine = np.arange(512) % 3 != 0
    want = np.asarray(jax.jit(lambda g, o, d, m, a, r: jtrace.sphere_trace(
        JGridSDF.create(g), o, d, JTraceParams(), maxt=m, active=a, refine_active=r,
    ), **JIT_LEVEL0)(grid, o, d, maxt, active, refine))
    args = (GridSDF.create(t(grid)), t(o), t(d), TraceParams())
    kw = dict(maxt=t(maxt), active=torch.tensor(active), refine_active=torch.tensor(refine))
    got = to_np(ttrace.sphere_trace_plain(*args, **kw))
    return dict(want=want, got=got, active=active, refine=refine, args=args, kw=kw)


def test_trace_params_defaults_equal():
    import dataclasses

    assert dataclasses.asdict(TraceParams()) == dataclasses.asdict(JTraceParams())


def test_sphere_trace(masked):
    want = masked["want"]
    # the wrapper on CPU tensors: the plain version, bit for bit
    got = to_np(ttrace.sphere_trace(*masked["args"], **masked["kw"]))
    np.testing.assert_array_equal(got, masked["got"])
    hit = np.isfinite(want)
    assert 100 < hit.sum() < 450  # the ray set has both hits and misses
    np.testing.assert_array_equal(np.isfinite(got), hit)
    # its_t ends inside the (0, 1e-6·maxt] shell of a surface crossed at up to
    # 60°: the two sides may stop a last-bit step apart
    np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-5)


def _lane_group(name, case, masked):
    _, o, _, maxt = case
    inside = np.all((o >= -0.05) & (o <= 1.05), axis=-1)  # the 0.05-expanded bbox of the grid
    return {
        "inactive": ~masked["active"],
        "refine_off": masked["active"] & ~masked["refine"],
        "finite_maxt": masked["active"] & np.isfinite(maxt),
        "inside_start": masked["active"] & inside,
    }[name]


@pytest.mark.parametrize("group", ["inactive", "refine_off", "finite_maxt", "inside_start"])
def test_sphere_trace_plain_lane_groups(case, masked, group):
    """The kernel's plain version against the JAX package on each kind of
    lane the kernel treats apart: hit bits equal, ``its_t`` within 1e-5."""
    sel = _lane_group(group, case, masked)
    want, got = masked["want"][sel], masked["got"][sel]
    assert sel.sum() >= 40
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    hit = np.isfinite(want)
    np.testing.assert_allclose(got[hit], want[hit], rtol=0, atol=1e-5)
    if group == "inactive":
        assert not hit.any()
    else:
        assert 5 < hit.sum() < sel.sum()  # the group has both hits and misses


def test_sphere_trace_warp(case):
    grid, o, d, maxt = case
    rj = jax.jit(lambda g, o, d, m: jtrace.sphere_trace_warp(JGridSDF.create(g), o, d, JTraceParams(), maxt=m),
                 **JIT_LEVEL0)(grid, o, d, maxt)
    rt = ttrace.sphere_trace_warp(GridSDF.create(t(grid)), t(o), t(d), TraceParams(), maxt=t(maxt))
    hit = np.isfinite(np.asarray(rj.its_t))
    np.testing.assert_array_equal(np.isfinite(to_np(rt.its_t)), hit)
    # The loop stops at f < 1e-6·max(maxt, 1); f is a 64-term float32 sum that
    # the two frameworks take in different orders (~1e-8 apart), so a lane
    # whose f lands within that of the threshold takes one step more or less
    # on one side (about 1% of lanes; measured here: 8 of 512).  Such a lane's
    # last segment has length ~1e-6, so every other output still agrees.
    steps_t, steps_j = to_np(rt.num_steps).astype(int), np.asarray(rj.num_steps).astype(int)
    assert np.abs(steps_t - steps_j).max() <= 1
    assert (steps_t != steps_j).mean() <= 0.03
    np.testing.assert_allclose(to_np(rt.its_t)[hit], np.asarray(rj.its_t)[hit], rtol=0, atol=1e-5)
    valid = np.isfinite(np.asarray(rj.warp_t))
    assert 100 < valid.sum()
    np.testing.assert_array_equal(np.isfinite(to_np(rt.warp_t)), valid)
    np.testing.assert_allclose(to_np(rt.warp_t)[valid], np.asarray(rj.warp_t)[valid], rtol=0, atol=1e-5)
    # raw weight sum: the per-step weight is (1e-6 + |f| + …)^-3, i.e. up to
    # 1e18 next to the surface, so the last-bit differences in f (and the
    # one-step lanes above) show as up to 2e-3 relative; the clamped
    # multiplier the renderer consumes is tight
    np.testing.assert_allclose(to_np(rt.weight_sum), np.asarray(rj.weight_sum), rtol=5e-3, atol=1e-6)
    np.testing.assert_allclose(to_np(rt.warp_weight), np.asarray(rj.warp_weight), rtol=1e-4, atol=1e-6)
    # derivative accumulators: warp_t_d = (mixed − warp_t·Σw_d)/Σw subtracts
    # two large weighted sums (the JAX package documents up to ~1% from
    # reassociation alone on near-surface lanes).  Relative to each ray's own
    # scale: 1e-3 on 99% of the entries, 1e-2 on all (measured: 1 entry of
    # 1536 at 1.8e-3).
    for name in ("warp_t_d", "warp_weight_d"):
        a, b = to_np(getattr(rt, name)), np.asarray(getattr(rj, name))
        scale = np.abs(b).max(axis=-1, keepdims=True) + 1e-3
        assert np.all(np.isfinite(a))
        err = np.abs(a - b) / scale
        assert err.max() < 1e-2, (name, err.max())
        assert (err < 1e-3).mean() >= 0.99, (name, (err < 1e-3).mean())
    # misses: inf warp_t, zero derivative terms
    assert np.all(to_np(rt.warp_t_d)[~valid] == 0) and np.all(to_np(rt.warp_weight)[~valid] == 0)


def test_compaction_is_lane_reordering(case):
    """A lane's result does not depend on which lanes share its batch."""
    grid, o, d, maxt = case
    sdf = GridSDF.create(t(grid))
    big = lambda a: t(np.tile(a, (8,) + (1,) * (a.ndim - 1)))  # 4096 lanes: compaction kicks in
    full = ttrace.sphere_trace_warp(sdf, big(o), big(d), TraceParams(), maxt=big(maxt))
    part = ttrace.sphere_trace_warp(sdf, t(o[:100]), t(d[:100]), TraceParams(), maxt=t(maxt[:100]))
    for f in ("its_t", "warp_t", "warp_t_d", "warp_weight_d", "num_steps", "weight_sum"):
        np.testing.assert_array_equal(to_np(getattr(full, f))[:100], to_np(getattr(part, f)), err_msg=f)
        np.testing.assert_array_equal(to_np(getattr(full, f))[512:612], to_np(getattr(part, f)), err_msg=f)


def test_unported_options_raise(case):
    """What still raises: over-relaxation outside [1, 2) and without the
    refinement (the JAX package's assertions), an unknown refinement, and
    operands the kernel cannot read."""
    grid, o, d, _ = case
    sdf = GridSDF.create(t(grid))
    for bad in (dict(over_relax=2.0), dict(over_relax=0.9), dict(over_relax=1.4, refine_intersection=False),
                dict(refine="bisect")):
        with pytest.raises(ValueError):
            ttrace.sphere_trace(sdf, t(o), t(d), TraceParams(**bad))
        # the kernel's operand setup (reached on a CUDA tensor) refuses them too
        with pytest.raises(ValueError):
            ttrace._kernel_operands(sdf, t(o), t(d), TraceParams(**bad))
    with pytest.raises(NotImplementedError):
        ttrace._kernel_operands(object(), t(o), t(d), TraceParams())
    for data in (t(grid).double(), t(grid).transpose(0, 2)):
        with pytest.raises(ValueError):
            ttrace._kernel_operands(GridSDF(data=data, p=torch.zeros(3)), t(o), t(d), TraceParams())
    with pytest.raises(ValueError):
        ttrace._kernel_operands(sdf, t(o).double(), t(d).double(), TraceParams())


def test_ray_setup_matches_jax(case):
    """``_ray_setup`` (the setup the plain version runs, and the order of
    operations the kernel's setup follows) against the JAX package's on the
    same rays, unnormalised directions and a finite ``maxt`` on some lanes."""
    grid, o, d, maxt = case
    d = d * np.random.default_rng(3).uniform(0.5, 2.0, size=(d.shape[0], 1)).astype(np.float32)
    jd, (jlo, jhi), jhit, jinside, jt0, jmaxt, jeps = jtrace._ray_setup(
        JGridSDF.create(grid), jnp.asarray(o), jnp.asarray(d), JTraceParams(), jnp.asarray(maxt))
    td, (tlo, thi), thit, tinside, tt0, tmaxt, teps = ttrace._ray_setup(
        GridSDF.create(t(grid)), t(o), t(d), TraceParams(), t(maxt))
    np.testing.assert_array_equal(to_np(thit), np.asarray(jhit))
    np.testing.assert_array_equal(to_np(tinside), np.asarray(jinside))
    assert 100 < int(np.asarray(jhit).sum()) < 512 and np.asarray(jinside).sum() >= 40
    for got, want in ((td, jd), (tlo, jlo), (thi, jhi), (tt0, jt0), (tmaxt, jmaxt), (teps, jeps)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_kernel_operands(case, masked):
    """What the wrapper hands the CUDA kernel, which sets the rays up itself:
    the grid and its origin as they are; the rays as (N, 3) views, a
    broadcast origin with a lane stride of 0; per-lane ``maxt`` / ``active``
    / ``refine_active`` as flat float32 / bool views, and scalars as values.
    Nothing is copied when the inputs already have those layouts."""
    grid, o, d, maxt = case
    sdf = masked["args"][0]
    ops, lead = ttrace._kernel_operands(*masked["args"], **masked["kw"])
    assert lead == (512,)
    assert ops["sdf_kind"] == 0 and ops["r"] is None
    assert ops["grid"].data_ptr() == sdf.data.data_ptr() and ops["p"].data_ptr() == sdf.p.data_ptr()
    for key in ("o", "d"):
        assert ops[key].shape == (512, 3) and ops[key].dtype == torch.float32 and ops[key].stride() == (3, 1)
    for key, dtype in (("maxt", torch.float32), ("active", torch.bool), ("refine_active", torch.bool)):
        x, value = ops[key]
        assert value is None and x.shape == (512,) and x.dtype == dtype and x.stride() == (1,)
        assert x.data_ptr() == masked["kw"][key].data_ptr()
    np.testing.assert_array_equal(to_np(ops["maxt"][0]), maxt)
    np.testing.assert_array_equal(to_np(ops["active"][0]), masked["active"])
    np.testing.assert_array_equal(to_np(ops["refine_active"][0]), masked["refine"])
    # a camera: one origin for every lane, scalar maxt and masks
    cam_o = t(o[0]).expand(512, 3)
    ops1, _ = ttrace._kernel_operands(sdf, cam_o, t(d), TraceParams(), maxt=2.0, active=True, refine_active=False)
    assert ops1["o"].stride() == (0, 1) and ops1["o"].data_ptr() == cam_o.data_ptr()
    assert ops1["maxt"] == (None, 2.0) and ops1["active"] == (None, True) and ops1["refine_active"] == (None, False)
    # a 0-dim maxt broadcasts with a stride of 0; a uint8 mask becomes bool;
    # a strided mask is made contiguous
    ops2, _ = ttrace._kernel_operands(sdf, t(o), t(d), TraceParams(), maxt=torch.tensor(3.0),
                                      active=torch.ones(1024, dtype=torch.uint8)[::2])
    assert ops2["maxt"][0].stride() == (0,) and float(ops2["maxt"][0][7]) == 3.0
    assert ops2["active"][0].dtype == torch.bool and ops2["active"][0].stride() == (1,)


def test_kernel_operands_sphere(case):
    """The analytic sphere goes to the kernel as its centre and radius (the
    kernel computes its box as ``SphereSDF.bbox`` does); the rays as for a
    grid."""
    _, o, d, _ = case
    sphere = SphereSDF.create(p=(0.4, 0.5, 0.6), r=0.25, device="cpu")
    ops, lead = ttrace._kernel_operands(sphere, t(o), t(d), TraceParams())
    assert lead == (512,) and ops["sdf_kind"] == 1 and ops["grid"] is None
    assert ops["p"].data_ptr() == sphere.p.data_ptr() and ops["r"].data_ptr() == sphere.r.data_ptr()
    assert ops["o"].shape == ops["d"].shape == (512, 3)
    # the box the kernel computes from the centre: (p - 0.5) - expand, (p + 0.5) + expand
    lo, hi = sphere.bbox(TraceParams().bbox_expand)
    p = to_np(sphere.p)
    np.testing.assert_array_equal(to_np(lo), (p - np.float32(0.5)) - np.float32(0.05))
    np.testing.assert_array_equal(to_np(hi), (p + np.float32(0.5)) + np.float32(0.05))
    # and the plain version (what the kernel is held against on the card)
    # traces it: every ray aimed near the centre from outside hits at
    # |o - c| - r up to the refinement's tolerance
    aim = t(0.4 + 0 * o) + torch.tensor([0.0, 0.1, 0.2])
    rays_d = aim - t(o)
    its = to_np(ttrace.sphere_trace_plain(sphere, t(o), rays_d, TraceParams()))
    outside = np.linalg.norm(o - np.array([0.4, 0.5, 0.6]), axis=-1) > 0.6
    want = np.linalg.norm(o - np.array([0.4, 0.5, 0.6]), axis=-1) - 0.25
    np.testing.assert_allclose(its[outside], want[outside], atol=1e-5)


def test_kernel_operands_box(case):
    """The box goes to the kernel as its centre and, as 4 floats, its
    half-extents and smoothing (``sdf_kind`` 2; the kernel computes its box as
    ``BoxSDF.bbox`` does)."""
    _, o, d, _ = case
    box = BoxSDF.create(p=(0.5, 0.45, 0.55), extents=(0.3, 0.2, 0.25), smoothing=0.02, device="cpu")
    ops, lead = ttrace._kernel_operands(box, t(o), t(d), TraceParams(refine="newton"))
    assert lead == (512,) and ops["sdf_kind"] == 2 and ops["grid"] is None
    assert ops["p"].data_ptr() == box.p.data_ptr()
    np.testing.assert_array_equal(to_np(ops["r"]), np.array([0.3, 0.2, 0.25, 0.02], np.float32))
    lo, hi = box.bbox(0.05)
    p = to_np(box.p)
    np.testing.assert_array_equal(to_np(lo), (p - np.float32(0.5)) - np.float32(0.05))
    np.testing.assert_array_equal(to_np(hi), (p + np.float32(0.5)) + np.float32(0.05))


def test_launch_arguments_match_c_signature(case, monkeypatch):
    """The wrapper's call into ``sphere_trace_run``, run against a stand-in
    for the library (the kernel itself runs only on the card): as many
    arguments as the C entry in ``csrc/sphere_trace.cu`` declares and
    ``kernels.SOURCES`` binds, each accepted by its ctypes type; scalars
    passed as values, per-lane operands as pointers with their strides."""
    import contextlib
    import ctypes
    import os
    import re

    from differentiable_sdf_rendering_tpu_torch import kernels

    grid, o, d, maxt = case
    src = open(os.path.join(os.path.dirname(kernels.__file__), "csrc", "sphere_trace.cu")).read()
    params = re.search(r'extern "C" int sphere_trace_run\(([^)]*)\)', src).group(1)
    _, argtypes = kernels.SOURCES["sphere_trace"]["sphere_trace_run"]
    assert len(params.split(",")) == len(argtypes)
    calls = []

    def run(*args):
        assert len(args) == len(argtypes)
        for a, typ in zip(args, argtypes):
            typ.from_param(a)
        calls.append(args)
        return 0

    monkeypatch.setitem(kernels._LIBS, "sphere_trace", type("Lib", (), {"sphere_trace_run": staticmethod(run)}))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: type("Stream", (), {"cuda_stream": 0}))
    before = ttrace.sphere_trace.kernel_launches
    sdf = GridSDF.create(t(grid))
    its, steps = ttrace._sphere_trace_kernel(sdf, t(o[0]).expand(512, 3), t(d), TraceParams(), maxt=t(maxt),
                                             active=True)
    assert its.shape == steps.shape == (512,) and ttrace.sphere_trace.kernel_launches == before + 1
    args = calls[-1]
    assert args[:5] == (0, sdf.data.data_ptr(), 16, 16, 16) and args[6] is None  # grid, no radius
    assert args[8] == 0 and args[10] == 3  # broadcast origin, per-lane directions
    assert args[11] is not None and args[12] == 1  # per-lane maxt, stride 1
    assert args[14] is None and args[16] == 1  # scalar active = True
    assert args[19] == 1 and args[26] == 192 and args[27] == 10 and args[-2] == 512  # refinement on
    assert args[23].value == 1.0 and args[24].value == 0.0 and args[25] == 0  # w = 1, fixed rate
    sphere = SphereSDF.create(device="cpu")
    ttrace._sphere_trace_kernel(sphere, t(o), t(d), TraceParams(refine_intersection=False))
    args = calls[-1]
    assert args[0] == 1 and args[1] is None and args[6] == sphere.r.data_ptr() and args[27] == 0  # no refinement
    # the options: w and the retreat factor 1 - w as float32, Newton as a flag
    box = BoxSDF.create(p=(0.5, 0.5, 0.5), device="cpu")
    ttrace._sphere_trace_kernel(box, t(o), t(d), TraceParams(over_relax=1.4, refine="newton"))
    args = calls[-1]
    assert args[0] == 2 and args[1] is None and args[25] == 1
    assert args[23].value == np.float32(1.4) and args[24].value == np.float32(1.0 - 1.4)


def test_chip_smoke_trace_bound_charges_active_rays():
    """The bytes half of K1's bound in ``chip_smoke.py``: the grid, the
    ``active`` mask and its_t of every lane, and the rays and per-lane
    ``maxt`` of the active lanes only (an inactive lane's ray is not read);
    a stride-0 origin counts one row."""
    import chip_smoke

    sdf = GridSDF.create(torch.zeros(8, 8, 8))
    n = 100
    o, d, maxt = torch.zeros(n, 3), torch.zeros(n, 3), torch.ones(n)
    active = torch.arange(n) < 7
    grid = 8 ** 3 * 4 + 3 * 4
    assert chip_smoke.trace_bytes(sdf, o, d, {}) == grid + n * (12 + 12) + n * 4
    assert chip_smoke.trace_bytes(sdf, o, d, {"active": True}) == grid + n * (12 + 12) + n * 4
    assert chip_smoke.trace_bytes(sdf, o, d, {"active": active, "maxt": maxt}) == grid + 7 * (12 + 12 + 4) + n + n * 4
    assert chip_smoke.trace_bytes(sdf, o[:1].expand(n, 3), d, {"active": active}) == grid + 12 + 7 * 12 + n + n * 4


# The trace options: over-relaxation (ω), Newton refinement and the box SDF.
_OPTION_CASES = {
    "grid": [dict(over_relax=1.4), dict(over_relax=1.6), dict(refine="newton")],
    "wall": [dict(over_relax=1.6)],
    "box": [dict(), dict(refine="newton")],
}
_BOX = dict(p=(0.5, 0.5, 0.5), extents=(0.3, 0.2, 0.25), smoothing=0.02)


def _wall_grid():
    """The bbox-exit case of the JAX package's tests/test_trace.py: a 32³ wall
    whose surface is the plane z = 0.9, near the far face of the box."""
    from differentiable_sdf_rendering_tpu.ops.initializers import voxel_centers

    return np.asarray(jax.jit(lambda: jredistance((0.9 - voxel_centers(32)[..., 2]) * -1.0), **JIT_LEVEL0)())


@pytest.fixture(scope="module")
def option_traces(case):
    """Every option case of ``_OPTION_CASES`` traced by the JAX package (one
    jitted program for all) and by the port's plain version.  The wall takes
    the JAX test's ray (from z = -0.04 along +z: an ω step overshoots the box
    exit while the surface lies before it) and 63 more rays from below the
    box at small angles; the grid and the box the rays of ``case`` with its
    finite ``maxt`` lanes."""
    from differentiable_sdf_rendering_tpu.ops.sdf import BoxSDF as JBoxSDF

    grid, o, d, maxt = case
    rng = np.random.default_rng(8)
    wo = np.concatenate([[[0.5, 0.5, -0.04]], rng.uniform([0.1, 0.1, -0.5], [0.9, 0.9, -0.05], (63, 3))])
    wd = np.concatenate([[[0.0, 0.0, 1.0]], rng.normal([0.0, 0.0, 1.0], 0.3, (63, 3))])
    wd /= np.linalg.norm(wd, axis=-1, keepdims=True)
    inputs = {"grid": (grid, o, d, maxt), "wall": (_wall_grid(), wo.astype(np.float32), wd.astype(np.float32),
                                                   np.full(64, np.inf, np.float32)), "box": (None, o, d, maxt)}

    def sdf_j(name, g):
        return JBoxSDF.create(**_BOX) if name == "box" else JGridSDF.create(g)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def traces(args):
        return {name: [jtrace.sphere_trace(sdf_j(name, g), o_, d_, JTraceParams(**kw), maxt=m)
                       for kw in _OPTION_CASES[name]] for name, (g, o_, d_, m) in args.items()}

    want = jax.tree_util.tree_map(np.asarray, traces({k: tuple(None if x is None else jnp.asarray(x) for x in v)
                                                      for k, v in inputs.items()}))
    got = {}
    for name, (g, o_, d_, m) in inputs.items():
        sdf = BoxSDF.create(**_BOX, device="cpu") if name == "box" else GridSDF.create(t(g))
        got[name] = [to_np(ttrace.sphere_trace(sdf, t(o_), t(d_), TraceParams(**kw), maxt=t(m)))
                     for kw in _OPTION_CASES[name]]
    return inputs, want, got


@pytest.mark.parametrize("name,k", [(n, k) for n, cases in _OPTION_CASES.items() for k in range(len(cases))])
def test_trace_options_match_jax(option_traces, name, k):
    """The plain version against the JAX package under each option: hit bits
    equal, ``its_t`` within 1e-5.  Newton on the box leaves out the rays
    that start inside the box (f < 0 from t = 0): there the JAX package's
    gradient of the box is NaN (``jnp.linalg.norm``'s derivative at 0), so
    its Newton step falls back to the fixed rate, while the port's analytic
    gradient takes the Newton step (``ops/sdf.py::BoxSDF``)."""
    inputs, want, got = option_traces
    w, g = want[name][k], got[name][k]
    sel = np.ones(w.shape, bool)
    if name == "box" and _OPTION_CASES[name][k].get("refine") == "newton":
        o = inputs[name][1]
        sel = ~np.all(np.abs(o - 0.5) <= np.array(_BOX["extents"]) + _BOX["smoothing"], axis=-1)
        assert (~sel).sum() >= 1
    hit = np.isfinite(w[sel])
    assert 5 < hit.sum() and (name == "wall" or hit.sum() < sel.sum())
    np.testing.assert_array_equal(np.isfinite(g[sel]), hit)
    np.testing.assert_allclose(g[sel][hit], w[sel][hit], rtol=0, atol=1e-5)
    if name == "wall":  # the JAX test's ray is not taken for a miss
        assert np.isfinite(g[0])


def test_box_sdf_matches_jax():
    """``BoxSDF``'s value, gradient, Hessian and bbox against the JAX package
    at points away from its ties (the tie rules differ: ``BoxSDF``'s
    docstring) and outside the sharp box, where the JAX package's gradient
    is defined; inside, the port's gradient is the max term's."""
    from differentiable_sdf_rendering_tpu.ops.sdf import BoxSDF as JBoxSDF

    rng = np.random.default_rng(5)
    x = (0.5 + rng.uniform(-0.48, 0.48, size=(2048, 3))).astype(np.float32)
    jb, tb = JBoxSDF.create(**_BOX), BoxSDF.create(**_BOX, device="cpu")
    q = np.abs(x - 0.5) - np.array(_BOX["extents"], np.float32)
    qs = np.sort(q, axis=-1)
    outside = (q > 1e-4).any(-1) & (np.abs(q) > 1e-4).all(-1)
    inside = (q < -1e-4).all(-1) & (qs[:, 2] - qs[:, 1] > 1e-4)
    assert outside.sum() > 500 and inside.sum() > 100
    vj, gj, hj = (np.asarray(a) for a in jax.jit(jb.eval_all)(jnp.asarray(x)))
    vt, gt, ht = (to_np(a) for a in tb.eval_all(t(x)))
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(to_np(tb.eval(t(x))), vj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gt[outside], gj[outside], rtol=1e-5, atol=1e-6)
    # the Hessian (I − u uᵀ)/|max(q, 0)| grows without bound near the sharp
    # box: relative to the largest entry
    np.testing.assert_allclose(ht[outside], hj[outside], rtol=1e-4, atol=1e-5 * np.abs(hj[outside]).max())
    for got in (tb.eval_and_grad(t(x))[1], tb.eval_grad(t(x))):
        np.testing.assert_array_equal(to_np(got), gt)
    # inside: JAX's gradient is NaN, the port's a unit axis with the sign of x − p
    assert np.isnan(gj[inside]).all()
    axis = np.argmax(q[inside], -1)
    np.testing.assert_array_equal(np.abs(gt[inside]), np.eye(3, dtype=np.float32)[axis])
    np.testing.assert_array_equal(ht[inside], 0.0)
    for got, want in zip(tb.bbox(0.05), jb.bbox(0.05)):
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
