"""Sphere tracing of the port vs the JAX package on a perturbed 16³ sphere:
512 rays including misses, grazing rays, rays from inside the box, shadow
rays with a finite extent, inactive lanes and lanes without refinement.

``sphere_trace`` on CPU tensors is the plain version of the CUDA kernel
``csrc/sphere_trace.cu`` (``sphere_trace_plain``); the kernel itself is held
against that plain version on the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import trace as jtrace
from differentiable_sdf_rendering_tpu.ops.redistance import redistance as jredistance
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF, TraceParams as JTraceParams
from differentiable_sdf_rendering_tpu_torch.ops import trace as ttrace
from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF, SphereSDF, TraceParams
from torch_port_helpers import perturbed_sphere, t, to_np


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
    grid = np.asarray(jredistance(jnp.asarray(perturbed_sphere(16, seed=7, sigma=0.02))))
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
    want = np.asarray(jtrace.sphere_trace(
        JGridSDF.create(grid), jnp.asarray(o), jnp.asarray(d), JTraceParams(),
        maxt=jnp.asarray(maxt), active=jnp.asarray(active), refine_active=jnp.asarray(refine),
    ))
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
    rj = jtrace.sphere_trace_warp(
        JGridSDF.create(grid), jnp.asarray(o), jnp.asarray(d), JTraceParams(), maxt=jnp.asarray(maxt)
    )
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
    grid, o, d, _ = case
    sdf = GridSDF.create(t(grid))
    with pytest.raises(NotImplementedError):
        ttrace.sphere_trace(sdf, t(o), t(d), TraceParams(over_relax=1.4))
    with pytest.raises(NotImplementedError):
        ttrace.sphere_trace(sdf, t(o), t(d), TraceParams(refine="newton"))
    # the kernel's operand setup (reached on a CUDA tensor) refuses the same
    # options, and any SDF but a grid
    with pytest.raises(NotImplementedError):
        ttrace._kernel_lanes(sdf, t(o), t(d), TraceParams(refine="newton"))
    with pytest.raises(NotImplementedError):
        ttrace._kernel_lanes(SphereSDF.create(device="cpu"), t(o), t(d), TraceParams())


def test_kernel_operands(case, masked):
    """The flat per-lane operands handed to the CUDA kernel: shapes, types,
    contiguity, and the ray setup they carry (inactive and missed lanes
    inactive; finite maxt kept per lane)."""
    grid, o, d, maxt = case
    lanes, lead = ttrace._kernel_lanes(*masked["args"], **masked["kw"])
    assert lead == (512,)
    for key in ("o", "d"):
        assert lanes[key].shape == (512, 3) and lanes[key].dtype == torch.float32
    for key in ("t0", "maxt", "trace_eps", "active", "refine_active"):
        assert lanes[key].shape == (512,) and lanes[key].is_contiguous()
    assert lanes["active"].dtype == lanes["refine_active"].dtype == torch.uint8
    np.testing.assert_allclose(np.linalg.norm(to_np(lanes["d"]), axis=-1), 1.0, rtol=1e-6)
    active = to_np(lanes["active"]).astype(bool)
    assert not active[~masked["active"]].any()
    np.testing.assert_array_equal(to_np(lanes["refine_active"]).astype(bool), masked["refine"])
    # every lane that hits in the plain version is active for the kernel
    assert active[np.isfinite(masked["got"])].all()
    fin = np.isfinite(maxt) & active
    assert np.all(to_np(lanes["maxt"])[fin] <= maxt[fin])
    # a scalar mask and maxt broadcast to every lane
    lanes1, _ = ttrace._kernel_lanes(GridSDF.create(t(grid)), t(o), t(d), TraceParams(), maxt=2.0, active=True,
                                     refine_active=False)
    assert not to_np(lanes1["refine_active"]).any() and np.all(to_np(lanes1["maxt"]) <= 2.0)
