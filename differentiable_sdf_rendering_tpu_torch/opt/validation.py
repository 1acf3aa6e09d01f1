"""Gradient validation: gradient images with respect to the SDF translation
``sdf.p``.

Counterpart of the JAX package's ``opt/validation.py::eval_forward_gradient``:
the image ∂(render)/∂p_axis either by forward-mode AD through the
reparameterized (grad-mode) render, or by central finite differences of two
primal renders at p ± ε with many samples — the comparison behind the
paper's gradient figures.

Forward mode uses ``torch.autograd.forward_ad``: ``p`` becomes a dual
tensor, and the tangent follows it through the render's attached
operations.  Where the JAX package stops gradients, the port detaches
(``.detach()`` drops a dual tensor's tangent).  The grad-mode render traces
with the masked warp loop and takes its normals from attached evaluations,
so forward mode launches neither K1 nor K2; the finite-difference pair of
primal renders runs both on the card.
"""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.autograd.forward_ad as fwAD

from ..models.integrator import RenderConfig, render_chunked

__all__ = ["eval_forward_gradient"]


def _with_p(scene, p):
    return scene.replace(sdf=scene.sdf.replace(p=p))


def eval_forward_gradient(
    scene,
    cfg: RenderConfig,
    axis: int = 0,
    view_idx: int = 0,
    seed: int = 0,
    method: str = "ad",
    fd_eps: float = 1e-3,
    fd_spp: int = 2048,
):
    """Gradient image w.r.t. ``sdf.p[axis]`` → ``(image (H, W, 3), grad
    (H, W, 3), stats)``, on the scene's device.

    ``method='ad'``: forward mode through the grad-mode render at
    ``cfg.spp``; the image is that render.  ``method='fd'``: two primal
    renders at ``p ± fd_eps`` along ``axis`` at ``fd_spp`` samples a pixel
    (in lane chunks), their central difference; the image is their mean.
    """
    if method not in ("ad", "fd"):
        raise ValueError(f"method must be 'ad' or 'fd', got {method!r}")
    device = scene.device
    t0 = time.time()
    p0 = scene.sdf.p.detach()
    unit = torch.zeros(3, dtype=p0.dtype, device=device)
    unit[axis] = 1.0

    if method == "fd":
        cfg_fd = dataclasses.replace(cfg, spp=fd_spp)
        dp = unit * fd_eps

        def primal(p):
            return render_chunked(_with_p(scene, p), view_idx, seed=seed, cfg=cfg_fd, mode="primal",
                                  device=device)[..., :3]

        img_p = primal(p0 + dp)
        img_m = primal(p0 - dp)
        grad = (img_p - img_m) / (2 * fd_eps)
        img = 0.5 * (img_p + img_m)
    else:
        # autograd stays on, so that the render takes its attached branches
        # (normals and hit points as functions of p); no input requires a
        # gradient, so it records no backward graph
        with fwAD.dual_level():
            out = render_chunked(_with_p(scene, fwAD.make_dual(p0, unit)), view_idx, seed=seed, cfg=cfg,
                                 mode="grad", device=device)[..., :3]
            img, grad = fwAD.unpack_dual(out)
            if grad is None:  # the image does not depend on p
                grad = torch.zeros_like(img)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    stats = {"total_time": time.time() - t0, "method": method, "axis": axis}
    return img, grad, stats
