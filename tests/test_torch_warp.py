"""Warp-field reparameterization and surface interactions of the port vs the
JAX package: values and the VJP w.r.t. the grid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import interaction as jint
from differentiable_sdf_rendering_tpu.ops import warp as jwarp
from differentiable_sdf_rendering_tpu.ops.redistance import redistance as jredistance
from differentiable_sdf_rendering_tpu.ops.sdf import GridSDF as JGridSDF
from differentiable_sdf_rendering_tpu_torch.ops import interaction as tint
from differentiable_sdf_rendering_tpu_torch.ops import warp as twarp
from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
from test_torch_trace import _rays
from torch_port_helpers import perturbed_sphere, t, to_np

RTOL, ATOL = 1e-4, 1e-6


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1)
    grid = np.asarray(jredistance(jnp.asarray(perturbed_sphere(16, seed=8, sigma=0.02))))
    o, d = _rays(rng, 256)
    return grid, o, d


@pytest.fixture(scope="module")
def its(case):
    """The JAX package's primal trace of ``case``'s rays."""
    from differentiable_sdf_rendering_tpu.ops.trace import sphere_trace

    grid, o, d = case
    return np.asarray(jax.jit(lambda g: sphere_trace(JGridSDF.create(g), jnp.asarray(o), jnp.asarray(d)))(grid))


def test_warp_config_defaults_equal():
    import dataclasses

    assert dataclasses.asdict(twarp.WarpConfig()) == dataclasses.asdict(jwarp.WarpConfig())


def test_reparameterize_values_and_grid_vjp(case):
    grid, o, d = case

    def fj(data):
        its_t, d1, det = jwarp.reparameterize(JGridSDF.create(data), jnp.asarray(o), jnp.asarray(d))
        return jnp.sum(d1 * c_d) + jnp.sum(det * c_det), (its_t, d1, det)

    rng = np.random.default_rng(2)
    c_d = rng.normal(size=d.shape).astype(np.float32)
    c_det = rng.normal(size=d.shape[0]).astype(np.float32)
    # one XLA program (jit) instead of one compilation per primitive
    (_, (its_j, d1_j, det_j)), g_j = jax.jit(jax.value_and_grad(fj, has_aux=True))(jnp.asarray(grid))

    data = t(grid).requires_grad_(True)
    its_t, d1, det = twarp.reparameterize(GridSDF.create(data), t(o), t(d))
    (torch.sum(d1 * t(c_d)) + torch.sum(det * t(c_det))).backward()

    np.testing.assert_array_equal(np.isfinite(to_np(its_t)), np.isfinite(np.asarray(its_j)))
    # primal values: d1 = d and det = 1 exactly (replace_grad)
    np.testing.assert_allclose(to_np(d1), np.asarray(d1_j), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(to_np(det), np.ones(d.shape[0], np.float32))
    # the grid gradient inherits the tracer's derivative accumulators
    # (cancellation, ~1e-3 relative per ray): compare against its own scale
    g_t, g_j = to_np(data.grad), np.asarray(g_j)
    assert np.abs(g_j).max() > 1.0
    np.testing.assert_allclose(g_t, g_j, rtol=1e-3, atol=1e-3 * np.abs(g_j).max())


def test_warp_eval_divergence_and_vjp(case):
    """warp_eval alone, fed the JAX tracer's outputs on both sides: no
    tracer differences, so the tight tolerance holds."""
    grid, o, d = case
    from differentiable_sdf_rendering_tpu.ops.trace import sphere_trace_warp

    res = jax.jit(lambda g: sphere_trace_warp(JGridSDF.create(g), jnp.asarray(o), jnp.asarray(d)))(jnp.asarray(grid))
    wt = np.asarray(res.warp_t)
    x = o + np.where(np.isfinite(wt), wt, 0.0)[:, None] * d
    args = dict(t=wt, dt_dx=np.asarray(res.warp_t_d), mult=np.asarray(res.warp_weight),
                mult_d=np.asarray(res.warp_weight_d))
    rng = np.random.default_rng(3)
    c_w = rng.normal(size=d.shape).astype(np.float32)
    c_div = rng.normal(size=d.shape[0]).astype(np.float32)

    def fj(data):
        warp, div = jwarp.warp_eval(
            JGridSDF.create(data), jnp.asarray(x), jnp.asarray(d), jnp.asarray(args["t"]),
            jnp.asarray(args["dt_dx"]), jwarp.WarpConfig(),
            warp_weight_mult=jnp.asarray(args["mult"]), warp_weight_mult_d=jnp.asarray(args["mult_d"]),
        )
        return jnp.sum(warp * c_w) + jnp.sum(div * c_div), div

    (_, div_j), g_j = jax.jit(jax.value_and_grad(fj, has_aux=True))(jnp.asarray(grid))
    data = t(grid).requires_grad_(True)
    warp, div = twarp.warp_eval(
        GridSDF.create(data), t(x), t(d), t(args["t"]), t(args["dt_dx"]), twarp.WarpConfig(),
        warp_weight_mult=t(args["mult"]), warp_weight_mult_d=t(args["mult_d"]),
    )
    (torch.sum(warp * t(c_w)) + torch.sum(div * t(c_div))).backward()
    div_j = np.asarray(div_j)
    assert (div_j != 0).sum() > 20
    np.testing.assert_allclose(to_np(div), div_j, rtol=RTOL, atol=1e-4 * np.abs(div_j).max())
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(to_np(data.grad), g_j, rtol=RTOL, atol=1e-5 * np.abs(g_j).max())


@pytest.mark.parametrize("differentiable", [True, False])
def test_surface_interaction(case, its, differentiable):
    """Both branches; ``differentiable=False`` with autograd off (the primal
    render) takes the normal from the detached grid evaluation, whose CPU
    path is the plain version of the CUDA kernel ``csrc/grid_eval.cu``."""
    grid, o, d = case
    sj = jint.compute_surface_interaction(JGridSDF.create(grid), jnp.asarray(o), jnp.asarray(d), jnp.asarray(its),
                                          differentiable=differentiable)
    with torch.set_grad_enabled(differentiable):
        st = tint.compute_surface_interaction(GridSDF.create(t(grid)), t(o), t(d), t(its),
                                              differentiable=differentiable)
    np.testing.assert_array_equal(to_np(st.valid), np.asarray(sj.valid))
    v = np.asarray(sj.valid)
    assert 50 < v.sum() < 250
    # missed lanes sit at the ray origin, outside the grid, where the clamped
    # interpolant is flat and the normalised gradient is rounding noise
    for f in ("p", "n", "s", "b", "wi"):
        np.testing.assert_allclose(
            to_np(getattr(st, f))[v], np.asarray(getattr(sj, f))[v], rtol=0, atol=2e-5, err_msg=f
        )
        assert np.all(np.isfinite(to_np(getattr(st, f))))
    np.testing.assert_allclose(to_np(st.p)[~v], o[~v], rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(st.t)[v], np.asarray(sj.t)[v], rtol=0, atol=1e-5)
    assert np.all(np.isinf(to_np(st.t)[~v]))
    if not differentiable:
        # the detached normal: elementwise float32 with the gradient's
        # 64-term sums taken in another order
        np.testing.assert_allclose(to_np(st.n)[v], np.asarray(sj.n)[v], rtol=1e-5, atol=1e-6)
