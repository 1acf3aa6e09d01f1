"""Cubic B-spline grid interpolation of the port vs the JAX package's per-tap
path: value, gradient, Hessian and the VJPs w.r.t. grid and points; the
detached value-and-gradient entry whose CPU path is the plain version of the
CUDA kernel ``csrc/grid_eval.cu``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import grid as jgrid
from differentiable_sdf_rendering_tpu_torch.ops import grid as tgrid
from torch_port_helpers import JIT_LEVEL0, t, to_np

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


ORIGIN = np.array([0.1, -0.05, 0.2], np.float32)


@pytest.fixture(scope="module")
def jax_side(case):
    """Every JAX function of this file on ``case``, in one jitted program
    compiled at backend optimisation level 0 (``JIT_LEVEL0``)."""
    data, p = case
    rng = np.random.default_rng(1)
    cv = rng.normal(size=p.shape[0]).astype(np.float32)
    cg = rng.normal(size=p.shape).astype(np.float32)

    def fj(d, q):
        v, g = jgrid.grid_eval_grad(d, q)
        return jnp.sum(v * cv) + jnp.sum(g * cg)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def run(data, p):
        return {
            "all": jgrid.grid_eval_all(data, p), "value": jgrid.grid_eval(data, p),
            "trilinear": jgrid.grid_eval_trilinear(data, p), "vjp": jax.grad(fj, argnums=(0, 1))(data, p),
            "at_origin": jgrid.grid_eval_grad(data, p - ORIGIN),
        }

    out = jax.tree_util.tree_map(np.asarray, run(data, p))
    out["cotangents"] = (cv, cg)
    return out


def test_bspline_weights():
    f = np.linspace(0, 1, 33, dtype=np.float32)
    for a, b in zip(jgrid.bspline_weights(jnp.asarray(f)), tgrid.bspline_weights(t(f))):
        np.testing.assert_allclose(to_np(b), np.asarray(a), rtol=RTOL, atol=ATOL)


def test_eval_value_grad_hessian(case, jax_side):
    data, p = case
    vj, gj, hj = jax_side["all"]
    vt, gt, ht = tgrid.grid_eval_all(t(data), t(p))
    np.testing.assert_allclose(to_np(vt), np.asarray(vj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=RTOL, atol=1e-4)   # × res
    np.testing.assert_allclose(to_np(ht), np.asarray(hj), rtol=RTOL, atol=2e-3)   # × res²
    v2, g2 = tgrid.grid_eval_grad(t(data), t(p))
    np.testing.assert_allclose(to_np(v2), to_np(vt), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(g2), to_np(gt), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(to_np(tgrid.grid_eval(t(data), t(p))), jax_side["value"], rtol=RTOL, atol=ATOL)


def test_trilinear(case, jax_side):
    data, p = case
    np.testing.assert_allclose(to_np(tgrid.grid_eval_trilinear(t(data), t(p))), jax_side["trilinear"], rtol=RTOL,
                               atol=ATOL)


def test_vjp_data_and_points(case, jax_side):
    data, p = case
    cv, cg = jax_side["cotangents"]
    dj, pj = jax_side["vjp"]
    d_t = t(data).requires_grad_(True)
    p_t = t(p).requires_grad_(True)
    v, g = tgrid.grid_eval_grad(d_t, p_t)
    (torch.sum(v * t(cv)) + torch.sum(g * t(cg))).backward()
    # gradient sums of up to 120×64 scattered terms, taken in another order
    np.testing.assert_allclose(to_np(d_t.grad), np.asarray(dj), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(p_t.grad), np.asarray(pj), rtol=1e-4, atol=2e-3)


def test_grid_eval_grad_detached(case, jax_side):
    """The plain version of the grid-evaluation kernel against the JAX
    package's ``grid_eval_grad`` at ``p - origin``, rtol 1e-5 (a 64-term sum
    taken in another order); the wrapper on CPU tensors is that plain
    version, and it builds no graph."""
    data, p = case
    origin = ORIGIN
    vj, gj = jax_side["at_origin"]
    d_t = t(data).requires_grad_(True)
    vt, gt = tgrid.grid_eval_grad_detached(d_t, t(p), t(origin))
    assert not vt.requires_grad and not gt.requires_grad
    np.testing.assert_allclose(to_np(vt), np.asarray(vj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(gt), np.asarray(gj), rtol=RTOL, atol=1e-4)   # × res
    vp, gp = tgrid.grid_eval_grad_detached_plain(t(data), t(p), t(origin))
    assert torch.equal(vp, vt) and torch.equal(gp, gt)
