"""The slice as a whole, through the two command-line entry points of the
port: ``optimize_torch.main`` writes a checkpoint, the JAX package reads it,
``render_turntable_torch.main`` renders a frame from it, and the frame equals
the JAX package's render of the same checkpoint through the same turntable
camera.  Tiny widths: 2 views of an 8² film, 16³ grid and 16³ target, 2 spp,
one iteration."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import optimize_torch
import render_turntable_torch
from differentiable_sdf_rendering_tpu.models import emitter as jemitter
from differentiable_sdf_rendering_tpu.models.camera import regular_cameras as jregular_cameras
from differentiable_sdf_rendering_tpu.models.camera import turntable_cameras as jturntable_cameras
from differentiable_sdf_rendering_tpu.models.integrator import RenderConfig as JRenderConfig
from differentiable_sdf_rendering_tpu.models.integrator import render_chunked as jrender_chunked
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.models.scenes_zoo import scene_rig as jscene_rig
from differentiable_sdf_rendering_tpu.opt.opt_configs import get_opt_config as jget_opt_config
from differentiable_sdf_rendering_tpu.opt.shape_opt import load_checkpoint as jload_checkpoint
from differentiable_sdf_rendering_tpu_torch.models.scenes_zoo import scene_rig
from differentiable_sdf_rendering_tpu_torch.opt.opt_configs import get_opt_config
from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import load_checkpoint
from differentiable_sdf_rendering_tpu_torch.utils import video
from torch_port_helpers import JIT_LEVEL0, to_np

TINY = ["--sdf_res=16", "--n_sensors=2", "--batch_size=2", "--resx=8", "--resy=8", "--upsample_iter=()",
        "--spp=2", "--primal_spp_mult=1"]


def test_optimize_then_turntable_match_jax(tmp_path, monkeypatch):
    out = str(tmp_path)
    # The CLI, like optimize.py, renders its references from a target grid of
    # max(128, sdf_res)³; a 16³ target keeps this test small.  The final
    # parameters of the run are recorded through the checkpoint callback.
    final = []
    monkeypatch.setattr(optimize_torch, "optimize_shape", functools.partial(
        optimize_torch.optimize_shape, target_res=16,
        checkpoint_cb=lambda i, params, losses: final.append(params["sdf"].clone())))
    optimize_torch.main(["cubes", "--cpu", "--optconfig", "no-tex-12", "--n_iter", "1", "--refspp", "2",
                         "--outputdir", out, *TINY])
    run_dir = os.path.join(out, "cubes", "no-tex-12", "warp")
    assert sorted(os.listdir(os.path.join(run_dir, "params"))) == ["sdf-data-0000.vol", "sdf-final.vol"]
    assert os.path.exists(os.path.join(run_dir, "metadata.json"))

    # the JAX package reads the port's checkpoints: the run's last grid and its EMA
    specs = jget_opt_config("no-tex-12")[0].variables()
    last = np.asarray(jload_checkpoint(run_dir, 0, specs)["sdf"])
    ema = np.asarray(jload_checkpoint(run_dir, "final", specs)["sdf"])
    assert last.shape == ema.shape == (16, 16, 16)
    np.testing.assert_array_equal(last, to_np(final[-1]))
    port_specs = get_opt_config("no-tex-12")[0].variables()
    np.testing.assert_array_equal(ema, to_np(load_checkpoint(run_dir, "final", port_specs, device="cpu")["sdf"]))

    # the turntable frame, captured before tonemapping
    frames = []
    write_png = video.write_png
    monkeypatch.setattr(video, "write_png", lambda path, img: (frames.append(img), write_png(path, img)))
    render_turntable_torch.main(["cubes", "--cpu", "--outputdir", out, "--resx", "8", "--resy", "8",
                                 "--spp", "2", "--n_frames", "1"])
    assert os.listdir(os.path.join(run_dir, "turntable")) == ["frame-0000.png"]
    (got,) = frames

    # The JAX render, first with the port's sky tables.  The two packages
    # compute the gradient sky's image with their own float32 sin/cos/pow
    # (equal to rtol 1e-5, test_torch_render.py::test_grid_envmap), and the
    # alias sampler's intra-texel jitter u/p turns that into sample
    # directions up to 8e-5 apart next to the sun; with the tables shared,
    # the frame is held to the primal-image tolerance of the traced geometry.
    bsdf, jax_emitter = jscene_rig("cubes")
    e = scene_rig("cubes", device="cpu")[1]
    port_emitter = jemitter.GridEnvmap(
        image=jnp.asarray(to_np(e.image)), image_rows=jnp.asarray(to_np(e.image_rows)),
        pdf_table=jnp.asarray(to_np(e.pdf_table)), alias_prob=jnp.asarray(to_np(e.alias_prob)),
        alias_idx=jnp.asarray(to_np(e.alias_idx), jnp.int32))
    cam = jturntable_cameras(1, resx=8, resy=8).view(0)
    render = jax.jit(lambda sc, cm: jrender_chunked(sc, seed=0, cfg=JRenderConfig(spp=2), mode="primal",
                                                    camera=cm, n_chunks=1), **JIT_LEVEL0)

    def jax_frame(emitter):
        scene = JScene.create(ema, bsdf=bsdf, emitter=emitter, cameras=jregular_cameras(1))
        return np.asarray(render(scene, cam))[..., :3]

    want = jax_frame(port_emitter)
    assert got.shape == want.shape == (8, 8, 3) and np.isfinite(got).all()
    assert np.ptp(want) > 0.05  # the frame shows the shape against the sky
    # the primal-image tolerance of test_torch_render.py: same samples
    # (bit-equal random numbers), float32 shading chains and splat sums in
    # another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    # Then through the JAX package's own sky, so that a fault in the port's
    # sky construction or alias sampler fails here too: the sky's rounding
    # above moves a few shadow samples' radiance, by 8.8e-5 on this frame.
    np.testing.assert_allclose(got, jax_frame(jax_emitter), rtol=0, atol=1.5e-4)


def test_cli_print_params_and_skip(tmp_path, capsys):
    """``--print_params`` resolves the configs (with the ``--key=value``
    cascade) and runs nothing; an existing run is skipped without
    ``--force``."""
    optimize_torch.main(["cubes", "--cpu", "--print_params", "--outputdir", str(tmp_path), *TINY, "--nope=1"])
    text = capsys.readouterr().out
    assert "unconsumed arguments: ['--nope=1']" in text and "sdf_res=16" in text and "spp=2" in text
    run_dir = tmp_path / "cubes" / "no-tex-12" / "warp"
    run_dir.mkdir(parents=True)
    (run_dir / "metadata.json").write_text("{}")
    optimize_torch.main(["cubes", "--cpu", "--outputdir", str(tmp_path), *TINY])
    assert "[skip]" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        render_turntable_torch.main(["cubes", "--cpu", "--outputdir", str(tmp_path), "--n_frames", "1"])
