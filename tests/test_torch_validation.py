"""The gradient-image harness of the port (``opt/validation.py``) against the
JAX package's ``eval_forward_gradient``, on the studio scene file at 8²:
central differences of two primal renders against the JAX function compiled
at backend level 0; forward mode against the port's own reverse mode (and,
slow, against the JAX package's ``jax.jvp``); and the JAX package's
behavioural check (``tests/test_misc_components.py``) on the port."""

import os

import jax
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models.integrator import RenderConfig as JRenderConfig
from differentiable_sdf_rendering_tpu.models.scene_file import load_scene_file as jload_scene_file
from differentiable_sdf_rendering_tpu.opt import validation as jvalidation
from differentiable_sdf_rendering_tpu.opt.validation import eval_forward_gradient as jeval_forward_gradient
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.models.scene_file import load_scene_file
from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf
from differentiable_sdf_rendering_tpu_torch.opt import validation as tvalidation
from differentiable_sdf_rendering_tpu_torch.opt.validation import eval_forward_gradient
from torch_port_helpers import JIT_LEVEL0, to_np

STUDIO = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scenes", "studio",
                      "studio.json")
SIZE = dict(resx=8, resy=8, sdf_res=16)
SPP, FD_EPS, FD_SPP = 4, 1e-3, 4


@pytest.fixture(scope="module")
def studio():
    return load_scene_file(STUDIO, device="cpu", **SIZE)


def _jax_gradient(method):
    """The JAX package's gradient image of the studio view 0, axis 0, jitted
    at backend level 0 (its multiply-adds rounded apart, as the port's)."""
    scene = jload_scene_file(STUDIO, **SIZE)
    cfg = JRenderConfig(spp=SPP)
    fn = jax.jit(lambda sc: jeval_forward_gradient(sc, cfg, 0, 0, 0, method, FD_EPS, FD_SPP)[:2], **JIT_LEVEL0)
    return [np.asarray(a) for a in fn(scene)]


def test_fd_gradient_matches_jax(studio, monkeypatch):
    """Each ±ε image within 2e-5 of the JAX package's (their mean is the
    returned image), the gradient within 2e-5 / (2ε).  The JAX function runs
    as it is, its primal render compiled once at backend level 0 for both
    renders; each package's two renders are recorded as they are made."""
    renders = {"port": [], "jax": []}

    def recorded(name, fn):
        def wrapper(*args, **kwargs):
            renders[name].append(fn(*args, **kwargs)[..., :3])
            return renders[name][-1]
        return wrapper

    monkeypatch.setattr(tvalidation, "render_chunked", recorded("port", tvalidation.render_chunked))
    img, grad, stats = eval_forward_gradient(studio, RenderConfig(spp=SPP), axis=0, method="fd", fd_eps=FD_EPS,
                                             fd_spp=FD_SPP)
    monkeypatch.setattr(jvalidation, "render", recorded("jax", jax.jit(
        jvalidation.render, static_argnames=("view_idx", "cfg", "mode"), **JIT_LEVEL0)))
    want_img, want_grad, _ = jvalidation.eval_forward_gradient(jload_scene_file(STUDIO, **SIZE), JRenderConfig(spp=SPP),
                                                               0, 0, 0, "fd", FD_EPS, FD_SPP)
    want_img, want_grad = np.asarray(want_img), np.asarray(want_grad)
    assert stats["method"] == "fd" and img.shape == (8, 8, 3)
    assert np.abs(want_grad).max() > 1.0
    np.testing.assert_allclose(to_np(img), want_img, rtol=0, atol=2e-5)
    np.testing.assert_allclose(to_np(grad), want_grad, rtol=0, atol=2e-5 / (2 * FD_EPS))
    # the two primal renders behind them, at p + ε and p − ε
    assert len(renders["port"]) == len(renders["jax"]) == 2
    for got, want in zip(renders["port"], renders["jax"]):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(to_np(img), to_np(0.5 * (renders["port"][0] + renders["port"][1])))


@pytest.mark.parametrize("axis", [0, 1])
def test_ad_gradient_is_the_reverse_derivative(studio, axis):
    """Forward mode through the grad-mode render: its image is the grad-mode
    render, and its summed gradient image the reverse-mode derivative of the
    summed image with respect to p[axis], at rtol 1e-4."""
    cfg = RenderConfig(spp=SPP)
    img, grad, _ = eval_forward_gradient(studio, cfg, axis=axis, method="ad")
    p = torch.zeros(3, requires_grad=True)
    out = render(studio.replace(sdf=studio.sdf.replace(p=p)), 0, seed=0, cfg=cfg, mode="grad", device="cpu")[..., :3]
    out.sum().backward()
    assert torch.equal(img, out.detach())
    assert abs(float(p.grad[axis])) > 1e-2
    np.testing.assert_allclose(float(grad.sum()), float(p.grad[axis]), rtol=1e-4)


# ~7 s of JAX compilation: the tier-1 cases above hold the forward mode to
# the port's reverse mode, and the reverse mode is held against the JAX
# package's VJPs by the render and warp tests
@pytest.mark.slow
def test_ad_gradient_matches_jax(studio):
    """The forward-mode image against the JAX package's ``jax.jvp``: the
    images within 2e-5, the gradient images within 1e-3 of their largest
    entry (ROADMAP §C gap 1: the warp trace's accumulators)."""
    img, grad, _ = eval_forward_gradient(studio, RenderConfig(spp=SPP), axis=0, method="ad")
    want_img, want_grad = _jax_gradient("ad")
    np.testing.assert_allclose(to_np(img), want_img, rtol=0, atol=2e-5)
    scale = np.abs(want_grad).max()
    np.testing.assert_allclose(to_np(grad), want_grad, rtol=0, atol=1e-3 * scale)


def test_forward_gradient_harness():
    """The JAX package's behavioural check: forward mode and FD concentrate on
    the same silhouette (correlation > 0.7)."""
    scene = Scene.create(create_sphere_sdf(16, radius=0.3, device="cpu"),
                         cameras=regular_cameras(2, resx=16, resy=16, device="cpu"), device="cpu")
    cfg = RenderConfig(integrator="sdf_silhouette_reparam", spp=8)
    img, grad_ad, _ = eval_forward_gradient(scene, cfg, axis=0, method="ad")
    _, grad_fd, _ = eval_forward_gradient(scene, cfg, axis=0, method="fd", fd_spp=128)
    assert img.shape == (16, 16, 3)
    a, f = to_np(grad_ad).ravel(), to_np(grad_fd).ravel()
    denom = np.linalg.norm(a) * np.linalg.norm(f)
    assert denom > 0 and float(np.dot(a, f) / denom) > 0.7


def test_unknown_method_raises(studio):
    with pytest.raises(ValueError, match="method"):
        eval_forward_gradient(studio, RenderConfig(spp=1), method="jvp")
