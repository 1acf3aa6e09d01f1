"""Redistancing: the port's plain version (what its wrapper runs on a CPU
tensor, and what the CUDA kernel is held against on the card) vs the JAX
package's Pallas kernel in interpret mode and its XLA solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from differentiable_sdf_rendering_tpu.ops import redistance as jrd
from differentiable_sdf_rendering_tpu.ops.pallas_redistance import redistance_pallas
from differentiable_sdf_rendering_tpu_torch.ops import redistance as trd
from torch_port_helpers import perturbed_sphere, t, to_np

# On power-of-two grids the JAX side is exact between its own two paths
# (1/h² is a power of two, so the Pallas and XLA formulations round alike).
# The port is not bit-equal to them: XLA's CPU code generator contracts
# a*b+c into an FMA and fuses 1/sqrt, PyTorch rounds every operation; each
# pass adds a last-bit difference, which travels outward with the front.
# Measured here: 1.5e-6 after 24 passes on a noisy 16³ sphere (values ~0.5).
ATOL = 5e-6


def _non_sdf(res):
    zs = (np.arange(res, dtype=np.float32) + 0.5) / res
    z, y, x = np.meshgrid(zs, zs, zs, indexing="ij")
    r = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2)
    return ((r - 0.28) * 3.0).astype(np.float32)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 16)])
def test_interface_init(shape):
    phi = perturbed_sphere(shape, seed=1)
    h = tuple(1.0 / n for n in shape)
    dj, fj = jrd._interface_init(jnp.asarray(phi), h)
    dt, ft = trd._interface_init(t(phi), trd._spacing(shape))
    np.testing.assert_array_equal(to_np(ft), np.asarray(fj))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=1e-6, atol=ATOL)


@pytest.mark.parametrize("shape", [(16, 16, 16), (8, 12, 16)], ids=["uniform", "nonuniform"])
def test_godunov_update(shape):
    rng = np.random.default_rng(2)
    u = np.abs(perturbed_sphere(shape, seed=2)) + 0.01
    u[rng.random(shape) < 0.3] = 1e5  # unreached voxels
    u = u.astype(np.float32)
    h = tuple(1.0 / n for n in shape)
    want = np.asarray(jrd._godunov_update(jnp.asarray(u), h))
    got = to_np(trd._godunov_update(t(u), trd._spacing(shape)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=ATOL)


@pytest.fixture(scope="module")
def sphere16():
    phi = perturbed_sphere(16, seed=3)
    return phi, {
        "pallas24": np.asarray(redistance_pallas(jnp.asarray(phi), iterations=24, interpret=True)),
        "xla24": np.asarray(jrd.redistance(jnp.asarray(phi), iterations=24, prefer_pallas=False)),
    }


def test_redistance_16_24_passes(sphere16):
    phi, ref = sphere16
    got = to_np(trd.redistance(t(phi), iterations=24))
    np.testing.assert_array_equal(ref["pallas24"], ref["xla24"])  # the JAX side's own two paths
    np.testing.assert_allclose(got, ref["pallas24"], rtol=0, atol=ATOL)
    assert np.all(np.sign(got) == np.where(phi >= 0, 1.0, -1.0))


def test_redistance_fixed_point_non_sdf():
    phi = _non_sdf(16)
    want_p = np.asarray(redistance_pallas(jnp.asarray(phi), interpret=True))
    want_x = np.asarray(jrd.redistance(jnp.asarray(phi), prefer_pallas=False))
    got = to_np(trd.redistance(t(phi)))
    np.testing.assert_allclose(got, want_p, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, want_x, rtol=0, atol=ATOL)
    # the default pass count (res) has not converged the far corners yet;
    # 2·res passes have, and further passes change nothing
    fixed = to_np(trd.redistance(t(phi), iterations=32))
    np.testing.assert_array_equal(to_np(trd.redistance(t(phi), iterations=48)), fixed)
    want_fixed = np.asarray(jrd.redistance(jnp.asarray(phi), iterations=48, prefer_pallas=False))
    np.testing.assert_allclose(fixed, want_fixed, rtol=0, atol=ATOL)
    # and it is the sphere's distance to first order
    zs = (np.arange(16, dtype=np.float32) + 0.5) / 16
    z, y, x = np.meshgrid(zs, zs, zs, indexing="ij")
    true = np.sqrt((x - 0.5) ** 2 + (y - 0.5) ** 2 + (z - 0.5) ** 2) - 0.28
    assert np.abs(got - true).max() < 1.0 / 16


def test_redistance_non_power_of_two():
    # 24³: 1/h² is not a power of two, the JAX side's two paths differ in the
    # last bits themselves (their own test allows 1e-5); so does the port.
    phi = _non_sdf(24)
    # jitted: one compile instead of one per operation of the eager call (no
    # other test compiles this shape); the port is 4.2e-6 from either
    redistance = jax.jit(jrd.redistance, static_argnames=("iterations", "prefer_pallas"))
    want = np.asarray(redistance(jnp.asarray(phi), iterations=24, prefer_pallas=False))
    got = to_np(trd.redistance(t(phi), iterations=24))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_redistance_zero_iterations_and_channel_dim():
    phi = perturbed_sphere(16, seed=4)
    out0 = to_np(trd.redistance(t(phi), iterations=0))
    want0 = np.asarray(jrd.redistance(jnp.asarray(phi), iterations=0, prefer_pallas=False))
    np.testing.assert_allclose(out0, want0, rtol=1e-6, atol=ATOL)
    out4 = trd.redistance(t(phi)[..., None])
    assert tuple(out4.shape) == (16, 16, 16, 1)
    np.testing.assert_array_equal(to_np(out4[..., 0]), to_np(trd.redistance(t(phi))))


def test_redistance_non_cubic():
    phi = perturbed_sphere((8, 12, 16), seed=5, radius=0.25)
    want = np.asarray(jrd.redistance(jnp.asarray(phi), prefer_pallas=False))
    got = to_np(trd.redistance(t(phi)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_redistance_non_cubic_beyond_max_shape():
    # more passes than max(shape): the front has reached every voxel and the
    # later passes must leave it where the JAX package leaves it; tolerance as
    # in test_redistance_non_cubic (per-axis weights that are not powers of
    # two, and XLA's FMA contraction against PyTorch's one rounding an op)
    phi = perturbed_sphere((8, 12, 16), seed=7, radius=0.25)
    want = np.asarray(jrd.redistance(jnp.asarray(phi), iterations=20, prefer_pallas=False))
    got = to_np(trd.redistance(t(phi), iterations=20))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(to_np(trd.redistance(t(phi), iterations=32)), got)


def test_kernel_wrapper_rejects_a_host_tensor():
    # the CUDA wrapper never runs the plain version: a CPU tensor raises
    # before anything is built or counted
    before = (trd.redistance.kernel_launches, trd.redistance.cuda_launches)
    with pytest.raises(ValueError, match="CUDA tensor"):
        trd._redistance_kernel(t(perturbed_sphere(8, seed=8)), 4)
    assert (trd.redistance.kernel_launches, trd.redistance.cuda_launches) == before


def test_wrapper_is_detached_and_counts_no_launch_on_cpu():
    phi = t(perturbed_sphere(8, seed=6)).requires_grad_(True)
    before = trd.redistance.kernel_launches
    out = trd.redistance(phi)
    assert not out.requires_grad
    assert trd.redistance.kernel_launches == before  # CPU tensor: plain version, no kernel
