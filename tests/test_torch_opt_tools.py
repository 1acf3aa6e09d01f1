"""The optimisation tools of the port: the method ``fd`` (trained as the JAX
package trains it: shading gradients only, bit for bit the
``onlyshadinggrad`` run), ``ema_smooth``, the loss plot, the resume history
helper, ``convergence_video`` and the profiling helpers.  The files that
``optimize_shape`` writes and a resume from them are held against the JAX
package in ``tests/test_torch_shape_opt.py``."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.opt.losses import ema_smooth as jema_smooth
from differentiable_sdf_rendering_tpu.utils.video import convergence_video as jconvergence_video
from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs, shape_opt
from differentiable_sdf_rendering_tpu_torch.opt.losses import ema_smooth
from differentiable_sdf_rendering_tpu_torch.utils import profiling
from differentiable_sdf_rendering_tpu_torch.utils.io import read_png
from differentiable_sdf_rendering_tpu_torch.utils.video import convergence_video

TINY = dict(n_sensors=2, resx=16, resy=16, sdf_res=16, scene_name="cubes", upsample_iter=())


def _run_method(name, n_iter=1):
    method = tconfigs.get_config(name)
    method.spp, method.primal_spp_mult = 2, 2
    return shape_opt.optimize_shape("cubes", topt_configs.SdfConfig(**TINY), method, n_iter=n_iter, ref_spp=4,
                                    target_res=16, verbose=False, device="cpu")


def test_fd_trains_as_onlyshadinggrad():
    """The JAX package's ``optimize_shape`` never reads
    ``use_finite_differences``: ``fd`` trains with ``warp_kind='dummy'``,
    i.e. exactly as ``onlyshadinggrad``.  So does the port, bit for bit."""
    fd, ref = _run_method("fd"), _run_method("onlyshadinggrad")
    assert len(fd.loss_values) == 1 and all(np.isfinite(fd.loss_values))
    assert fd.loss_values == ref.loss_values
    for part in ("params", "ema"):
        assert torch.equal(getattr(fd, part)["sdf"], getattr(ref, part)["sdf"]), part


def test_fd_render_configs_equal_onlyshadinggrad():
    """The fields the training step's render configs are built from are
    those of ``onlyshadinggrad``."""
    fd, ref = tconfigs.get_config("fd"), tconfigs.get_config("onlyshadinggrad")
    assert fd.use_finite_differences and not ref.use_finite_differences
    for got, want in zip(shape_opt.render_configs(fd), shape_opt.render_configs(ref)):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.warp_kind == "dummy" and not got.use_warp


def test_fd_cli_reaches_optimize_shape(tmp_path, monkeypatch):
    """``optimize_torch.py --configs fd`` hands the ``fd`` method to
    ``optimize_shape`` (no refusal on the way)."""
    import optimize_torch

    seen = []

    def fake(scene, opt_cfg, method_cfg, **kw):
        seen.append((scene, method_cfg.name, method_cfg.warp_kind, kw["device"]))
        return shape_opt.OptimizationResult({}, {}, [0.5], 0.0, None)

    monkeypatch.setattr(optimize_torch, "optimize_shape", fake)
    optimize_torch.main(["cubes", "--configs", "fd", "--cpu", "--n_iter", "1", "--outputdir", str(tmp_path)])
    assert seen == [("cubes", "fd", "dummy", "cpu")]


def test_ema_smooth_equal_jax():
    values = np.random.default_rng(5).uniform(0, 1, 50).astype(np.float32).tolist()
    for beta in (0.9, 0.5, 0.0):
        got, want = ema_smooth(values, beta), jema_smooth(values, beta)
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)
    assert ema_smooth([]).shape == (0,)


def test_loss_plot_is_best_effort(tmp_path, monkeypatch, capsys):
    shape_opt._write_loss_plot([0.3, 0.2, 0.25], str(tmp_path))
    assert (tmp_path / "loss.png").exists() and (tmp_path / "loss.pdf").exists()
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # as on a host without matplotlib
    shape_opt._write_loss_plot([0.3], str(tmp_path / "none"))
    assert "loss plot skipped" in capsys.readouterr().out
    assert not (tmp_path / "none").exists()


def test_resumed_history(tmp_path):
    """The first ``resume_from + 1`` losses of ``metadata.json``, padded with
    NaN; NaNs and no prior time without a readable file."""
    files = {
        "present": (json.dumps({"loss_values": [0.5, 0.4, 0.3, 0.2], "total_time": 12.5}), [0.5, 0.4, 0.3], 12.5),
        "short": (json.dumps({"loss_values": [0.5], "total_time": 3.0}), [0.5, np.nan, np.nan], 3.0),
        "absent": (None, [np.nan] * 3, 0.0),
        "corrupt": ("{ not json", [np.nan] * 3, 0.0),
    }
    for case, (text, want_losses, want_time) in files.items():
        os.makedirs(tmp_path / case)
        if text is not None:
            (tmp_path / case / "metadata.json").write_text(text)
        losses, prior = shape_opt._resumed_history(str(tmp_path / case), 2)
        np.testing.assert_array_equal(losses, want_losses, err_msg=case)
        assert prior == want_time, case


def test_resume_requires_output_dir():
    with pytest.raises(ValueError, match="output_dir"):
        shape_opt.optimize_shape("cubes", topt_configs.SdfConfig(**TINY), tconfigs.get_config("warp"), resume_from=0,
                                 device="cpu")


def test_convergence_video_equal_jax(tmp_path):
    """The same frames as the JAX package's, from the same images; tensors
    are taken as well as arrays."""
    rng = np.random.default_rng(6)
    opt = {i: [rng.uniform(0, 1.2, (6, 5, 3)).astype(np.float32) for _ in range(4)] for i in (0, 8)}
    refs = [rng.uniform(0, 1.2, (6, 5, 3)).astype(np.float32) for _ in range(4)]
    jconvergence_video(str(tmp_path / "jax"), opt, refs)
    ran = convergence_video(str(tmp_path / "port"), {i: [torch.tensor(a) for a in ims] for i, ims in opt.items()}, refs)
    names = sorted(os.listdir(tmp_path / "port" / "convergence"))
    assert names == sorted(os.listdir(tmp_path / "jax" / "convergence")) == ["conv-0000.png", "conv-0001.png"]
    for name in names:
        got, want = (read_png(str(tmp_path / d / "convergence" / name)) for d in ("port", "jax"))
        assert got.shape == (4 * 6, 3 * 5, 3)
        np.testing.assert_array_equal(got, want)
    assert ran is False or (tmp_path / "port" / "video" / "convergence.mp4").exists()


def test_profiling_helpers(tmp_path):
    seconds, out = profiling.device_time(lambda x: x * 2 + 1, torch.ones(64), n_runs=2, device="cpu")
    assert seconds >= 0 and torch.equal(out, torch.full((64,), 3.0))
    timer = profiling.Timer("cpu")
    for _ in range(2):
        with timer.section("a"):
            torch.ones(8).sum()
    assert set(timer.sections) == {"a"} and timer.sections["a"] > 0
    with profiling.trace(str(tmp_path / "trace"), device="cpu") as prof:
        torch.ones(256).cumsum(0)
    assert (tmp_path / "trace" / "trace.json").exists() and len(prof.key_averages()) > 0
    if not torch.cuda.is_available():  # no card: device=None raises, no host fallback
        with pytest.raises(RuntimeError):
            profiling.Timer()
        with pytest.raises(RuntimeError):
            profiling.device_time(lambda: None)
