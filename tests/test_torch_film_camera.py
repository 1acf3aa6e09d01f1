"""Cameras and film of the port vs the JAX package: rays, projection, the
regular rig, splat (with its VJPs) and develop."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import camera as jcam
from differentiable_sdf_rendering_tpu.ops import film as jfilm
from differentiable_sdf_rendering_tpu_torch.models import camera as tcam
from differentiable_sdf_rendering_tpu_torch.ops import film as tfilm
from torch_port_helpers import JIT_LEVEL0, t, to_np

# float32 elementwise chains (sin/cos/exp differ in the last bits)
TOL = 1e-5


@pytest.mark.parametrize("n,shift,top", [(12, 0.0, False), (2, 0.0, False), (1, 0.0, False), (6, 0.25, True)])
def test_regular_cameras(n, shift, top):
    fj = jcam.regular_cameras_top if top else jcam.regular_cameras
    ft = tcam.regular_cameras_top if top else tcam.regular_cameras
    cj = fj(n, shift, 32, 24)
    ct = ft(n, shift, 32, 24, device="cpu")
    assert (ct.resx, ct.resy, ct.n_views) == (32, 24, cj.n_views)
    np.testing.assert_allclose(to_np(ct.origin), np.asarray(cj.origin), atol=TOL)
    np.testing.assert_allclose(to_np(ct.rot), np.asarray(cj.rot), atol=TOL)
    np.testing.assert_allclose(to_np(ct.tan_half_fov), np.asarray(cj.tan_half_fov), atol=1e-7)


def test_sample_ray_and_project():
    rng = np.random.default_rng(0)
    cj = jcam.regular_cameras(3, resx=32, resy=24).view(1)
    ct = tcam.regular_cameras(3, resx=32, resy=24, device="cpu").view(1)
    pos = (rng.random((200, 2)) * [36, 28] - 2).astype(np.float32)
    dist = rng.uniform(1.0, 3.0, (200, 1)).astype(np.float32)

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(pos, dist):
        o, d = cj.sample_ray(pos)
        pts = o + d * dist
        return o, d, pts, cj.project(pts)

    oj, dj, pts, (pj, ij) = jax_side(pos, dist)
    ot, dt = ct.sample_ray(t(pos))
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), atol=TOL)
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), atol=TOL)
    pts = np.asarray(pts)
    pt, it = ct.project(t(pts))
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), atol=1e-4)  # pixels, up to 36
    np.testing.assert_allclose(to_np(it), np.asarray(ij), rtol=TOL)
    np.testing.assert_allclose(to_np(pt), pos, atol=1e-3)  # project inverts sample_ray


def test_splat_and_vjp():
    rng = np.random.default_rng(1)
    n, h, w = 300, 10, 12
    pos = (rng.random((n, 2)) * [w + 4, h + 4] - 2).astype(np.float32)
    vals = rng.normal(size=(n, 5)).astype(np.float32)
    cot = rng.normal(size=(h + 4, w + 4, 5)).astype(np.float32)
    act = rng.random(n) < 0.5

    @functools.partial(jax.jit, **JIT_LEVEL0)
    def jax_side(pos, vals, act):
        grads = jax.grad(lambda p, v: jnp.sum(jfilm.splat(p, v, h, w) * cot), argnums=(0, 1))(pos, vals)
        return jfilm.splat(pos, vals, h, w), grads, jfilm.splat(pos, vals, h, w, active=act)

    want, (gp_j, gv_j), want_m = jax_side(pos, vals, act)
    p_t, v_t = t(pos).requires_grad_(True), t(vals).requires_grad_(True)
    got = tfilm.splat(p_t, v_t, h, w)
    assert tuple(got.shape) == (h + 4, w + 4, 5)
    np.testing.assert_allclose(to_np(got), np.asarray(want), atol=TOL)
    torch.sum(got * t(cot)).backward()
    np.testing.assert_allclose(to_np(p_t.grad), np.asarray(gp_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(to_np(v_t.grad), np.asarray(gv_j), rtol=1e-4, atol=TOL)
    # masked lanes contribute nothing
    got_m = tfilm.splat(t(pos), t(vals), h, w, active=torch.tensor(act))
    np.testing.assert_allclose(to_np(got_m), np.asarray(want_m), atol=TOL)


def test_gaussian_weight_and_develop():
    x = np.linspace(-2.5, 2.5, 41, dtype=np.float32)
    np.testing.assert_allclose(
        to_np(tfilm.gaussian_weight(t(x))), np.asarray(jfilm.gaussian_weight(jnp.asarray(x))), atol=1e-7
    )
    rng = np.random.default_rng(2)
    block = rng.random((12, 14, 5)).astype(np.float32)
    block[3, 4, -1] = 0.0  # empty pixel: safe divide
    want = jfilm.develop(jnp.asarray(block))
    got = tfilm.develop(t(block))
    assert tuple(got.shape) == (8, 10, 4)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=TOL)
    assert (tfilm.BORDER, tfilm.FILTER_RADIUS) == (jfilm.BORDER, jfilm.FILTER_RADIUS)


@pytest.mark.parametrize("uniform", [False, True])
def test_spherical_camera(uniform):
    """``SphericalCamera`` (equirectangular and uniform-sphere) against the
    JAX package: rays and projection under one jitted program, then the
    round trip of the JAX package's tests/test_misc_components.py (unit
    directions; equirectangular: ``project(o + 2 d)`` back to the film
    position within 1e-3 px, since ``project`` maps θ linearly in both
    modes, as in the JAX package) on the port alone; its scene dict round
    trip through ``utils/convert``."""
    from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
    from differentiable_sdf_rendering_tpu_torch.utils import convert

    rng = np.random.default_rng(3)
    origin = np.array([0.5, 0.4, 0.6], np.float32)
    pos = (rng.random((300, 2)) * [64, 32]).astype(np.float32)
    pts = (0.5 + rng.normal(size=(300, 3))).astype(np.float32)
    cj = jcam.SphericalCamera(origin=jnp.asarray(origin), resx=64, resy=32, uniform=uniform)
    ct = tcam.SphericalCamera(origin=t(origin), resx=64, resy=32, uniform=uniform)
    (oj, dj), (pj, ij) = jax.jit(lambda p, x: (cj.sample_ray(p), cj.project(x)))(pos, pts)
    ot, dt = ct.sample_ray(t(pos))
    pt, it = ct.project(t(pts))
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), atol=TOL)
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), atol=TOL)
    # film positions in pixels: 64 px span the 2π of the longitude
    np.testing.assert_allclose(to_np(pt), np.asarray(pj), atol=64 * TOL)
    np.testing.assert_array_equal(to_np(it), np.asarray(ij))
    assert ct.view(3) is ct and ct.n_views == 1

    grid = np.asarray([[10.0, 8.0], [32.0, 16.0], [50.0, 25.0]], np.float32)
    o, d = ct.sample_ray(t(grid))
    np.testing.assert_allclose(np.linalg.norm(to_np(d), axis=-1), 1.0, atol=1e-6)
    if not uniform:
        np.testing.assert_allclose(to_np(ct.project(o + d * 2.0)[0]), grid, atol=1e-3)

    scene = Scene.create(torch.zeros(4, 4, 4), cameras=ct, device="cpu")
    back = convert.scene_from_numpy(convert.scene_to_numpy(scene), "cpu").cameras
    assert isinstance(back, tcam.SphericalCamera) and (back.resx, back.resy, back.uniform) == (64, 32, uniform)
    np.testing.assert_array_equal(to_np(back.origin), origin)
