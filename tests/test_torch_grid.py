"""Cubic B-spline grid interpolation of the port vs the JAX package's per-tap
path: value, gradient, Hessian and the VJPs w.r.t. grid and points."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import grid as jgrid
from differentiable_sdf_rendering_tpu_torch.ops import grid as tgrid
from torch_port_helpers import t, to_np

# elementwise float32 with a 64-term sum taken in another order
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    data = rng.normal(size=(8, 12, 16)).astype(np.float32)
    interior = rng.uniform(0.15, 0.85, size=(40, 3))
    boundary = rng.uniform(0.0, 1.0, size=(40, 3))
    boundary[:, rng.integers(0, 3, 40)] *= 0.02  # inside the clamped border taps
    outside = rng.uniform(-0.3, 1.3, size=(40, 3))
    p = np.concatenate([interior, boundary, outside]).astype(np.float32)
    return data, p


def test_bspline_weights():
    f = np.linspace(0, 1, 33, dtype=np.float32)
    for a, b in zip(jgrid.bspline_weights(jnp.asarray(f)), tgrid.bspline_weights(t(f))):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_eval_value_grad_hessian(case):
    data, p = case
    vj, gj, hj = jgrid.grid_eval_all(jnp.asarray(data), jnp.asarray(p))
    vt, gt, ht = tgrid.grid_eval_all(t(data), t(p))
    np.testing.assert_allclose(to_np(vt), np.asarray(vj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=RTOL, atol=1e-4)   # × res
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=RTOL, atol=2e-3)   # × res²
    v2, g2 = tgrid.grid_eval_grad(t(data), t(p))
    np.testing.assert_allclose(to_np(v2), to_np(vt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(g2), to_np(gt), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(
        to_np(tgrid.grid_eval(t(data), t(p))), np.asarray(jgrid.grid_eval(jnp.asarray(data), jnp.asarray(p))),
        rtol=RTOL, atol=ATOL,
    )


def test_trilinear(case):
    data, p = case
    want = jgrid.grid_eval_trilinear(jnp.asarray(data), jnp.asarray(p))
    np.testing.assert_allclose(to_np(tgrid.grid_eval_trilinear(t(data), t(p))), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_vjp_data_and_points(case):
    data, p = case
    rng = np.random.default_rng(1)
    cv = rng.normal(size=p.shape[0]).astype(np.float32)
    cg = rng.normal(size=p.shape).astype(np.float32)

    def fj(d, q):
        v, g = jgrid.grid_eval_grad(d, q)
        return jnp.sum(v * cv) + jnp.sum(g * cg)

    dj, pj = jax.grad(fj, argnums=(0, 1))(jnp.asarray(data), jnp.asarray(p))
    d_t = t(data).requires_grad_(True)
    p_t = t(p).requires_grad_(True)
    v, g = tgrid.grid_eval_grad(d_t, p_t)
    (torch.sum(v * t(cv)) + torch.sum(g * t(cg))).backward()
    # gradient sums of up to 120×64 scattered terms, taken in another order
    np.testing.assert_allclose(to_np(d_t.grad), np.asarray(dj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(p_t.grad), np.asarray(pj), rtol=1e-4, atol=2e-3)
