"""Per-lane random numbers (bit-exact with the JAX package) and the
direction warps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.ops import sampling as jsamp
from differentiable_sdf_rendering_tpu_torch.ops import sampling as tsamp
from torch_port_helpers import t, to_np


@pytest.mark.parametrize("seed", [0, 7, 12345, 2**31 - 1])
def test_lane_uniforms_bit_exact(seed):
    lanes = np.concatenate([
        np.arange(0, 300), np.arange(65_500, 65_600), np.arange(2_999_900, 3_000_000),
        np.array([2**31 - 1, 2**32 - 1]),
    ]).astype(np.uint32)
    want = np.asarray(jsamp.lane_uniforms(seed, jnp.asarray(lanes), 6))
    got = to_np(tsamp.lane_uniforms(seed, torch.tensor(lanes.astype(np.int64)), 6))
    assert got.dtype == np.float32 and got.shape == (lanes.size, 6)
    np.testing.assert_array_equal(got, want)
    assert got.min() >= 0.0 and got.max() < 1.0


def test_lane_uniforms_other_widths():
    lanes = np.arange(1000, 1064, dtype=np.uint32)
    for n in (1, 2, 38):
        want = np.asarray(jsamp.lane_uniforms(3, jnp.asarray(lanes), n))
        got = to_np(tsamp.lane_uniforms(3, torch.tensor(lanes.astype(np.int64)), n))
        np.testing.assert_array_equal(got, want)


def test_direction_warps():
    u = np.random.default_rng(0).random((256, 2)).astype(np.float32)
    for name in ("square_to_cosine_hemisphere", "square_to_uniform_sphere"):
        want = np.asarray(getattr(jsamp, name)(jnp.asarray(u)))
        got = to_np(getattr(tsamp, name)(t(u)))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)  # sin/cos/sqrt last bits
    wo = jsamp.square_to_cosine_hemisphere(jnp.asarray(u))
    np.testing.assert_allclose(
        to_np(tsamp.cosine_hemisphere_pdf(t(np.asarray(wo)))), np.asarray(jsamp.cosine_hemisphere_pdf(wo)),
        rtol=1e-6, atol=1e-7,
    )
    a, b = u[:, 0], u[:, 1] * (u[:, 0] > 0.3)
    np.testing.assert_allclose(
        to_np(tsamp.mis_weight(t(a), t(b))), np.asarray(jsamp.mis_weight(jnp.asarray(a), jnp.asarray(b))),
        rtol=1e-6, atol=1e-7,
    )
