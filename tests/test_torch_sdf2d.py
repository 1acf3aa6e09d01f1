"""The 2-D SDFs and the 2-D weighted trace of the port (``ops/sdf2d.py``)
against the JAX package's, on seeded numpy points; and the JAX package's
behavioural checks (``tests/test_misc_components.py``) run on the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import sdf2d as jsdf2d
from differentiable_sdf_rendering_tpu_torch.ops import sdf2d
from torch_port_helpers import JIT_LEVEL0, to_np

RNG = np.random.default_rng(7)
PTS = RNG.uniform(0.05, 0.95, (256, 2)).astype(np.float32)
N_GRID = 24
_XS = (np.arange(N_GRID) + 0.5) / N_GRID
_X, _Y = np.meshgrid(_XS, _XS)
GRID = (np.sqrt((_X - 0.5) ** 2 + (_Y - 0.45) ** 2) - 0.3 + 0.01 * RNG.standard_normal((N_GRID, N_GRID))).astype(
    np.float32)


def _pair(name):
    """(JAX SDF, port SDF) of one kind, same parameters."""
    if name == "grid":
        return jsdf2d.Grid2d(data=jnp.asarray(GRID)), sdf2d.Grid2d(data=torch.tensor(GRID))
    if name == "disk":
        return jsdf2d.DiskSDF.create((0.4, 0.6), 0.25), sdf2d.DiskSDF.create((0.4, 0.6), 0.25, device="cpu")
    if name == "rectangle":
        return jsdf2d.RectangleSDF.create((0.5, 0.45), (0.2, 0.1)), sdf2d.RectangleSDF.create(
            (0.5, 0.45), (0.2, 0.1), device="cpu")
    if name == "halfspace":
        return jsdf2d.HalfSpaceSDF.create((0.3, 1.0), 0.4), sdf2d.HalfSpaceSDF.create((0.3, 1.0), 0.4, device="cpu")
    if name == "union":
        j = jsdf2d.UnionSDF(a=jsdf2d.DiskSDF.create((0.4, 0.5), 0.2), b=jsdf2d.DiskSDF.create((0.6, 0.5), 0.2), k=0.1)
        t = sdf2d.UnionSDF(a=sdf2d.DiskSDF.create((0.4, 0.5), 0.2, device="cpu"),
                           b=sdf2d.DiskSDF.create((0.6, 0.5), 0.2, device="cpu"), k=0.1)
        return j, t
    raise ValueError(name)


@pytest.mark.parametrize("name", ["grid", "disk", "rectangle", "halfspace", "union"])
def test_sdf2d_jet_matches_jax(name):
    """Value and gradient at rtol 1e-5, atol 1e-6.  The Hessian at rtol 1e-5
    and atol 4e-6 of its largest entry: it is a sum of taps scaled by res²
    (the grid: both packages are 4.4e-5 off its float64 value at a scale of
    25), or the JAX package's Hessian of a norm rounds to 6e-5 where the
    exact value is 0 (the rectangle's edge regions, scale 20).  Inside the
    rectangle the JAX package's gradient is NaN; those points are held to
    the face term instead."""
    jsdf, tsdf = _pair(name)
    # the JAX side compiled at backend level 0: it rounds as run op by op
    want = [np.asarray(a) for a in jax.jit(lambda x: jsdf.eval_all(x), **JIT_LEVEL0)(jnp.asarray(PTS))]
    got = [to_np(a) for a in tsdf.eval_all(torch.tensor(PTS))]
    finite = np.isfinite(want[1]).all(-1)
    assert finite.mean() > 0.6
    for k, (g, w) in enumerate(zip(got, want)):
        atol = 1e-6 if k < 2 else 4e-6 * np.abs(w[finite]).max()
        np.testing.assert_allclose(g[finite], w[finite], rtol=1e-5, atol=atol, err_msg=f"{name} order {k}")
    np.testing.assert_allclose(to_np(tsdf.eval(torch.tensor(PTS))), want[0], rtol=1e-5, atol=1e-6)
    v, g = tsdf.eval_and_grad(torch.tensor(PTS))
    np.testing.assert_array_equal(to_np(g), got[1])
    if name == "rectangle":
        inside = ~finite
        q = np.abs(PTS - [0.5, 0.45]) - [0.2, 0.1]
        face = np.eye(2)[np.argmax(q, -1)] * np.sign(PTS - [0.5, 0.45])
        np.testing.assert_array_equal(got[1][inside], face[inside])
        assert np.all(got[2][inside] == 0)


def test_sdf2d_helpers_match_jax():
    x = torch.tensor(PTS)
    np.testing.assert_allclose(to_np(sdf2d.disk_sdf(x, (0.45, 0.5), 0.2)),
                               np.asarray(jsdf2d.disk_sdf(jnp.asarray(PTS), (0.45, 0.5), 0.2)), rtol=1e-5, atol=1e-6)
    for aperture in (0.5, 1.2, 2.5):
        np.testing.assert_allclose(to_np(sdf2d.arc_sdf(x, aperture=aperture)),
                                   np.asarray(jsdf2d.arc_sdf(jnp.asarray(PTS), aperture=aperture)), rtol=1e-5,
                                   atol=1e-6)


def _fan(n=64):
    o = np.broadcast_to(np.asarray([0.5, -1.0], np.float32), (n, 2)).copy()
    xs = np.linspace(0.05, 0.95, n, dtype=np.float32)
    d = np.stack([xs - 0.5, np.full((n,), 1.5, np.float32)], -1)
    return o, d


# relative limits on warp_t and the weight sums: w = denom⁻³ triples the
# relative rounding of denom (measured 2.4e-5 on the disk, 2.0e-5 on the
# union); on the grid, the fan's last, grazing ray is 1.4 % (port) and 2.2 %
# (JAX package) off its float64 weight sum in float32.  Two rays of the fan
# meet the rectangle where the JAX package's gradient is NaN (the face at
# f = 0, the norm of a zero vector), and its weight sums are NaN there; the
# port's are finite, and the rays are compared elsewhere
TRACE_SUMS_RTOL = {"disk": 5e-5, "union": 5e-5, "rectangle": 5e-5, "grid": 5e-2}


@pytest.mark.parametrize("name", sorted(TRACE_SUMS_RTOL))
def test_trace_2d_matches_jax(name):
    """``its_t`` within 1e-5 and step counts identical;
    ``warp_t`` and the weight sums as ``TRACE_SUMS_RTOL`` says."""
    jsdf, tsdf = _pair(name)
    o, d = _fan()
    want = jsdf2d.trace_2d(jsdf, jnp.asarray(o), jnp.asarray(d))
    got = sdf2d.trace_2d(tsdf, torch.tensor(o), torch.tensor(d))
    its_w, its_g = np.asarray(want["its_t"]), to_np(got["its_t"])
    np.testing.assert_array_equal(np.isfinite(its_g), np.isfinite(its_w))
    hit = np.isfinite(its_w)
    assert 0 < hit.mean() < 1
    np.testing.assert_allclose(its_g[hit], its_w[hit], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(to_np(got["i"]), np.asarray(want["i"]))
    jax_nan = np.isnan(np.asarray(want["weight_sum"]))
    assert jax_nan.sum() == (2 if name == "rectangle" else 0) and hit[jax_nan].all()
    assert np.isfinite(to_np(got["weight_sum"])).all()
    for key in ("warp_t", "weight_sum"):
        w, g = np.asarray(want[key])[~jax_nan], to_np(got[key])[~jax_nan]
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=TRACE_SUMS_RTOL[name], atol=0, err_msg=key)


# --- the JAX package's behavioural checks (tests/test_misc_components.py) ---


def test_2d_trace_disk():
    disk = sdf2d.DiskSDF.create((0.5, 0.5), 0.3, device="cpu")
    n = 64
    o = torch.tensor([0.5, -1.0]).expand(n, 2)
    xs = torch.linspace(0.1, 0.9, n)
    d = torch.stack([xs - 0.5, torch.full((n,), 1.5)], -1)
    res = sdf2d.trace_2d(disk, o, d)
    its = to_np(res["its_t"])
    assert np.isfinite(its[n // 2])
    np.testing.assert_allclose(its[n // 2], 1.2, atol=5e-3)  # the disk's bottom at y = 0.2
    miss = ~np.isfinite(its)
    assert np.isfinite(to_np(res["warp_t"])[miss]).sum() > 0  # warp_t on near-silhouette misses


def test_2d_grid_matches_disk():
    n = 48
    xs = (torch.arange(n, dtype=torch.float32) + 0.5) / n
    y, x = torch.meshgrid(xs, xs, indexing="ij")
    g = sdf2d.Grid2d(data=torch.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2) - 0.3)
    pts = torch.tensor(np.random.default_rng(0).uniform(0.2, 0.8, (64, 2)), dtype=torch.float32)
    exact = torch.linalg.norm(pts - 0.5, dim=-1) - 0.3
    np.testing.assert_allclose(to_np(g.eval(pts)), to_np(exact), atol=5e-3)
    leaf = pts.clone().requires_grad_(True)
    g.eval(leaf).sum().backward()
    _, grad, _ = g.eval_all(pts)
    np.testing.assert_allclose(to_np(grad), to_np(leaf.grad), atol=1e-4)


def test_union_sdf_smooth():
    u = sdf2d.UnionSDF(a=sdf2d.DiskSDF.create((0.4, 0.5), 0.2, device="cpu"),
                       b=sdf2d.DiskSDF.create((0.6, 0.5), 0.2, device="cpu"))
    pts = torch.tensor([[0.5, 0.5], [0.0, 0.0]])
    v = to_np(u.eval(pts))
    assert v[0] < 0 and v[1] > 0
    _, g, h = u.eval_all(pts)
    assert torch.isfinite(g).all() and torch.isfinite(h).all()
    # the written-out derivatives are those of eval
    leaf = torch.tensor(PTS, dtype=torch.float64).requires_grad_(True)
    u64 = sdf2d.UnionSDF(a=sdf2d.DiskSDF(p=torch.tensor([0.4, 0.5], dtype=torch.float64), r=torch.tensor(0.2)),
                         b=sdf2d.DiskSDF(p=torch.tensor([0.6, 0.5], dtype=torch.float64), r=torch.tensor(0.2)))
    u64.eval(leaf).sum().backward()
    np.testing.assert_allclose(to_np(u64.eval_all(leaf.detach())[1]), to_np(leaf.grad), rtol=1e-10, atol=1e-12)
