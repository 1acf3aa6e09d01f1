"""The shape-reconstruction training loop.

Counterpart of the JAX package's ``opt/shape_opt.py``, single device, eager:
per iteration — primal renders, loss, the backward pass through the
reparameterized gradient renders, regularizer, gradient validation, Adam,
bbox clamp and eikonal redistancing, EMA.  Python sequences the phases
(grid-upsampling and film-resolution schedule boundaries).

Semantics kept from the reference:
  * primal image at ``spp·primal_spp_mult``, gradients pulled back through a
    separate ``spp``-sample reparameterized render with its own seed;
  * strided view batches, per-view loss / batch_size;
  * seed bookkeeping ``seed += 1 + n_sensors`` per view;
  * Laplacian regularizer, grad clamp ±0.1, NaN suppression;
  * adaptive LR ``32/res · lr/(1+0.02 i)``; Adam state reset on upsampling;
  * EMA of parameters;
  * with an ``output_dir``: ``params/<key>-data-NNNN.vol`` every
    ``checkpoint_frequency`` iterations and at the last one, the EMA in
    ``params/<key>-final.vol`` and ``metadata.json`` (written also when the
    run fails), read back by :func:`load_checkpoint`.

Not implemented here: resume, the per-view progress images and the loss
plot of the JAX package's ``optimize_shape``, device meshes.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import time

import torch

from .. import resolve_device
from ..models.camera import regular_cameras, regular_cameras_top
from ..models.integrator import MAX_LANES, RenderConfig, lane_chunks, render_chunked, render_lane_block
from ..models.scene import Scene
from ..models.scenes_zoo import scene_rig_full, target_sdf
from ..ops.film import BORDER, develop
from ..ops.initializers import upsample_sdf
from ..ops.sdf import GridSDF
from ..utils.io import dump_metadata, read_vol, write_vol
from . import losses as losses_mod
from .adam import adam_init, adam_step
from .configs import BaseConfig
from .opt_configs import SdfConfig
from .regularizations import discrete_laplacian_reg
from .variables import SdfVariableSpec, ema_update

__all__ = ["optimize_shape", "render_reference_images", "load_checkpoint", "OptimizationResult"]

_LOSSES = {
    "l1": losses_mod.l1,
    "l2": losses_mod.l2,
    "mape": losses_mod.mape,
    "multiscale_l1": losses_mod.multiscale_l1,
}


@dataclasses.dataclass
class OptimizationResult:
    params: dict
    ema: dict
    loss_values: list
    total_time: float
    scene: object
    # wall-clock seconds of each iteration (device-synchronised on the card)
    iter_seconds: list = dataclasses.field(default_factory=list)


def _make_cameras(opt_cfg: SdfConfig, resx, resy, device):
    fn = regular_cameras_top if opt_cfg.cameras_top else regular_cameras
    return fn(opt_cfg.n_sensors, opt_cfg.angle_shift, resx, resy, device=device)


def _build_scene(base: Scene, params: dict) -> Scene:
    return base.replace(sdf=base.sdf.with_data(params["sdf"]))


@torch.no_grad()
def render_reference_images(scene: Scene, opt_cfg: SdfConfig, ref_spp: int = 512,
                            cfg: RenderConfig | None = None, max_lanes: int = MAX_LANES):
    """Render per-view references at full res (seed ``view + 41``) + the
    pyramid of halved resolutions for the multiscale-rendering schedule.
    Returns ``{(resx, resy): (n_views, H, W, 3)}``."""
    cfg = dataclasses.replace(cfg or RenderConfig(), spp=ref_spp)
    fullres = (opt_cfg.resx, opt_cfg.resy)
    per_view = [
        render_chunked(scene, seed=v + 41, cfg=cfg, mode="primal", camera=scene.cameras.view(v),
                       max_lanes=max_lanes, device=scene.device)[..., :3]
        for v in range(opt_cfg.n_sensors)
    ]
    refs = {fullres: torch.stack(per_view)}
    res, cur = fullres, refs[fullres]
    while min(res) > 8:
        res = (res[0] // 2, res[1] // 2)
        cur = torch.stack([losses_mod.downsample_half(im) for im in cur])
        refs[res] = cur
    return refs


def _view_batch_loss_grads(params, base, view_indices, seeds, seeds_grad, refs, *,
                           loss_name, cfg_primal, cfg_grad, batch, max_lanes=MAX_LANES):
    """Loss + parameter gradients of a strided view batch.

    Per view: primal image (no graph) at ``cfg_primal.spp`` with ``seed_p``;
    ``dimg = ∂(loss/batch)/∂img`` at that image; grad-mode render at
    ``cfg_grad.spp`` with ``seed_g``, pulled back with ``dimg``.

    The grad-mode wavefront is cut into lane chunks.  With one chunk its
    graph is differentiated directly.  With several, a first pass without a
    graph sums the chunk blocks, ``develop`` is differentiated at that sum to
    get the block cotangent ``dB``, and a second pass back-propagates ``dB``
    through one chunk's graph at a time — only one chunk's residuals are ever
    alive.  Gradients accumulate into a fresh leaf copy of each parameter.
    """
    loss_fn = _LOSSES[loss_name]
    device = params["sdf"].device
    leaves = {k: p.detach().clone().requires_grad_(True) for k, p in params.items()}
    scene_att = _build_scene(base, leaves)
    scene_det = _build_scene(base, {k: p.detach() for k, p in params.items()})
    b = BORDER if cfg_grad.sample_border else 0
    total_loss = torch.zeros((), dtype=torch.float32, device=device)

    for vidx, seed_p, seed_g, ref in zip(view_indices, seeds, seeds_grad, refs):
        cam = base.cameras.view(vidx)
        img_p = render_chunked(scene_det, seed=seed_p, cfg=cfg_primal, mode="primal", camera=cam,
                               max_lanes=max_lanes, device=device)[..., :3]
        img_p = img_p.detach().requires_grad_(True)
        lval = loss_fn(img_p, ref) / batch
        (dimg,) = torch.autograd.grad(lval, img_p)
        total_loss = total_loss + lval.detach()

        chunks = lane_chunks(cam, cfg_grad, device, max_lanes=max_lanes)
        if len(chunks) == 1:
            block = render_lane_block(scene_att, cam, chunks[0], seed_g, cfg_grad, "grad")
            develop(block, border=b)[..., :3].backward(dimg)
            continue
        with torch.no_grad():
            block = sum(render_lane_block(scene_det, cam, c, seed_g, cfg_grad, "grad") for c in chunks)
        block.requires_grad_(True)
        (d_block,) = torch.autograd.grad(develop(block, border=b)[..., :3], block, dimg)
        for c in chunks:
            render_lane_block(scene_att, cam, c, seed_g, cfg_grad, "grad").backward(d_block)

    grads = {
        k: leaf.grad if leaf.grad is not None else torch.zeros_like(leaf) for k, leaf in leaves.items()
    }
    return total_loss, grads


def _finish_step(params, adam_state, ema, grads, total_loss, lrs, *, specs, mask_updates):
    """Step tail: SDF regularizer, gradient validation, Adam, parameter
    validation (clamps + redistancing), EMA."""
    spec_by_key = {s.key: s for s in specs}

    # Laplacian regularizer on the SDF
    sdf_spec: SdfVariableSpec = spec_by_key["sdf"]
    if sdf_spec.regularizer_weight > 0:
        leaf = params["sdf"].detach().clone().requires_grad_(True)
        rval = sdf_spec.regularizer_weight * discrete_laplacian_reg(leaf)
        (rg,) = torch.autograd.grad(rval, leaf)
        grads = dict(grads)
        grads["sdf"] = grads["sdf"] + rg
        total_loss = total_loss + rval.detach()

    with torch.no_grad():
        grads = {k: spec_by_key[k].validate_gradient(g) for k, g in grads.items()}
        new_params, new_state = adam_step(params, grads, adam_state, lrs, mask_updates=mask_updates)
        # parameter validation: clamps + redistancing (upsampling happens at
        # phase boundaries in the caller)
        new_params = {k: spec_by_key[k].validate(p, -1) for k, p in new_params.items()}
        new_ema = {
            k: ema_update(ema.get(k), p, spec_by_key[k].beta) if spec_by_key[k].beta is not None else p
            for k, p in new_params.items()
        }
    return new_params, new_state, new_ema, total_loss


def _write_params(output_dir, params: dict, tag: str):
    for key, value in params.items():
        write_vol(os.path.join(output_dir, "params", f"{key}-{tag}.vol"), value.detach().cpu().numpy())


def load_checkpoint(output_dir: str, iteration, specs, device=None):
    """Restore saved parameters from ``output_dir/params``.  ``iteration`` is
    an int (``<key>-data-NNNN.vol``) or a tag such as ``'final'``
    (``<key>-final.vol``, the EMA).  A missing file falls back to the latest
    iteration checkpoint (never silently to the EMA), then to any file of the
    key.  ``device=None`` means the card (raises when there is none)."""
    device = resolve_device(device)
    params = {}
    pdir = os.path.join(output_dir, "params")
    for s in specs:
        if isinstance(iteration, int):
            path = os.path.join(pdir, f"{s.key}-data-{iteration:04d}.vol")
        else:
            path = os.path.join(pdir, f"{s.key}-{iteration}.vol")
        if not os.path.exists(path):
            cands = sorted(glob.glob(os.path.join(pdir, f"{s.key}-data-*.vol")))
            if not cands:
                cands = sorted(glob.glob(os.path.join(pdir, f"{s.key}-*.vol")))
            if not cands:
                raise FileNotFoundError(f"no checkpoint for '{s.key}' in {pdir}")
            print(f"[load_checkpoint] '{path}' missing; using '{cands[-1]}'")
            path = cands[-1]
        data = read_vol(path)
        if data.shape[-1] == 1 and s.key == "sdf":
            data = data[..., 0]
        params[s.key] = torch.as_tensor(data, device=device)
    return params


def optimize_shape(
    scene_name: str,
    opt_cfg: SdfConfig,
    method_cfg: BaseConfig,
    output_dir: str | None = None,
    ref_spp: int = 512,
    scene_dir: str | None = None,
    target_res: int | None = None,
    n_iter: int | None = None,
    verbose: bool = True,
    checkpoint_cb=None,
    max_lanes: int = MAX_LANES,
    device=None,
) -> OptimizationResult:
    """Run a full reconstruction: reference images are rendered here from the
    target SDF, then ``n_iter`` training iterations.

    ``device=None`` runs on the CUDA card and raises when there is none;
    pass ``device="cpu"`` for the host.  ``max_lanes`` caps the lanes of one
    render chunk.  ``checkpoint_cb(i, params, loss_values)`` is called after
    every iteration.  With ``output_dir``, checkpoints, the final EMA and
    ``metadata.json`` are written there (see the module docstring).
    """
    if method_cfg.use_finite_differences:
        raise NotImplementedError("finite-difference gradients are not ported")
    device = resolve_device(device)
    on_card = device.type == "cuda"
    t_start = time.time()
    n_iter = n_iter if n_iter is not None else method_cfg.n_iter
    specs = tuple(opt_cfg.variables())
    name = opt_cfg.scene_name or scene_name

    # ---- target scene & reference images at every scheduled resolution ----
    tres = target_res or max(128, opt_cfg.sdf_res)
    rig = scene_rig_full(name, opt_cfg.param_keys, device=device)
    bsdf, emitter = rig["bsdf"], rig["emitter"]
    tgt_sdf = GridSDF.create(target_sdf(name, tres, scene_dir, device=device))
    cams_full = _make_cameras(opt_cfg, opt_cfg.resx, opt_cfg.resy, device)
    target_scene = Scene(sdf=tgt_sdf, bsdf=bsdf, emitter=emitter, cameras=cams_full)
    integrator = method_cfg.integrator
    ref_cfg = RenderConfig(
        integrator=integrator if integrator != "sdf_prb_reparam" else "sdf_direct_reparam",
        warp=method_cfg.warp_config(),
        trace=method_cfg.trace_params(),
    )
    refs_pyramid = render_reference_images(target_scene, opt_cfg, ref_spp, ref_cfg, max_lanes)

    # ---- initial parameters ----
    params = {s.key: s.initialize(device=device) for s in specs}
    adam_state = adam_init(params)
    ema = dict(params)
    loss_values, iter_seconds = [], []
    seed = 0

    cfg_grad = RenderConfig(
        integrator=integrator,
        spp=method_cfg.spp,
        warp=method_cfg.warp_config(),
        trace=method_cfg.trace_params(),
        use_warp=method_cfg.warp_kind != "dummy",
        warp_kind=method_cfg.warp_kind,
    )
    cfg_primal = dataclasses.replace(cfg_grad, spp=method_cfg.spp * method_cfg.primal_spp_mult)

    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
    try:
        for i in range(n_iter):
            t_iter = time.perf_counter()
            # --- phase bookkeeping: film res + grid upsampling ---
            res = opt_cfg.res_at(i)
            cams = _make_cameras(opt_cfg, res[0], res[1], device)
            for s in specs:
                if s.upsample_iter and i in s.upsample_iter:
                    params[s.key] = upsample_sdf(params[s.key])
                    # Adam state (incl. the per-key step counter t) resets on
                    # shape change
                    sub = adam_init({s.key: params[s.key]})
                    for part in ("m", "v", "t"):
                        adam_state[part][s.key] = sub[part][s.key]
                    params[s.key] = s.validate(params[s.key], -1)
                    ema[s.key] = params[s.key]
            base = Scene(sdf=GridSDF.create(torch.zeros_like(params["sdf"])), bsdf=bsdf,
                         emitter=emitter, cameras=cams)

            view_indices = opt_cfg.sensor_indices(i)
            batch = len(view_indices)
            seeds, seeds_grad = [], []
            for _ in range(batch):
                seeds.append(seed)
                seeds_grad.append(seed + 1 + opt_cfg.n_sensors)
                seed += 1 + opt_cfg.n_sensors
            refs = refs_pyramid[res][view_indices]

            lrs = {s.key: s.lr_for(method_cfg.learning_rate, i, params[s.key].shape[0]) for s in specs}

            loss, grads = _view_batch_loss_grads(
                params, base, view_indices, seeds, seeds_grad, refs,
                loss_name=opt_cfg.loss, cfg_primal=cfg_primal, cfg_grad=cfg_grad,
                batch=batch, max_lanes=max_lanes,
            )
            params, adam_state, ema, loss = _finish_step(
                params, adam_state, ema, grads, loss, lrs,
                specs=specs, mask_updates=method_cfg.mask_optimizer,
            )
            loss_values.append(float(loss))  # synchronises with the device
            if on_card:
                torch.cuda.synchronize(device)
            iter_seconds.append(time.perf_counter() - t_iter)
            if verbose and (i % 8 == 0 or i == n_iter - 1):
                print(f"[{i:4d}] loss = {loss_values[-1]:.5f}  res={res}  sdf={tuple(params['sdf'].shape)}")
            if output_dir and (i % opt_cfg.checkpoint_frequency == 0 or i == n_iter - 1):
                _write_params(output_dir, params, f"data-{i:04d}")
            if checkpoint_cb is not None:
                checkpoint_cb(i, params, loss_values)
    finally:
        # record what there is, also when an iteration raised
        total_time = time.time() - t_start
        if output_dir:
            _write_params(output_dir, ema, "final")
            dump_metadata(method_cfg, opt_cfg, {"total_time": total_time, "loss_values": loss_values},
                          os.path.join(output_dir, "metadata.json"))
    final_scene = Scene(sdf=GridSDF.create(params["sdf"]), bsdf=bsdf, emitter=emitter, cameras=cams_full)
    return OptimizationResult(params, ema, loss_values, total_time, final_scene, iter_seconds)
