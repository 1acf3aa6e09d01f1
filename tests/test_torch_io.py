"""The turntable rig and the file formats of the port vs the JAX package:
``turntable_cameras``, ``.vol`` checkpoints written by one package and read
by the other, PNG bytes, ``dump_metadata`` and ``load_checkpoint``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from differentiable_sdf_rendering_tpu.models.camera import turntable_cameras as jturntable
from differentiable_sdf_rendering_tpu.utils import io as jio
from differentiable_sdf_rendering_tpu_torch.models.camera import turntable_cameras
from differentiable_sdf_rendering_tpu_torch.utils import io as tio
from torch_port_helpers import t, to_np


@pytest.mark.parametrize("n_frames,resx,resy", [(1, 8, 8), (64, 512, 512), (7, 32, 24)])
def test_turntable_cameras(n_frames, resx, resy):
    cj = jturntable(n_frames, resx=resx, resy=resy)
    ct = turntable_cameras(n_frames, resx=resx, resy=resy, device="cpu")
    assert (ct.resx, ct.resy, ct.n_views) == (cj.resx, cj.resy, n_frames)
    # numpy's float32 sin/cos against XLA's: within 1e-6
    for name in ("origin", "rot", "tan_half_fov"):
        np.testing.assert_allclose(to_np(getattr(ct, name)), np.asarray(getattr(cj, name)), rtol=0, atol=1e-6,
                                   err_msg=name)
    pos = np.array([[0.5, 0.5], [resx - 0.5, 0.25 * resy]], np.float32)
    oj, dj = cj.view(n_frames - 1).sample_ray(jnp.asarray(pos))
    ot, dt = ct.view(n_frames - 1).sample_ray(t(pos))
    np.testing.assert_allclose(to_np(dt), np.asarray(dj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(to_np(ot), np.asarray(oj), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(4, 5, 6), (3, 4, 5, 2)])
def test_vol_round_trip_across_packages(tmp_path, shape):
    data = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    tio.write_vol(str(tmp_path / "port.vol"), data, bbox_min=(0.0, -1.0, 0.5), bbox_max=(1.0, 2.0, 3.0))
    jio.write_vol(str(tmp_path / "jax.vol"), data, bbox_min=(0.0, -1.0, 0.5), bbox_max=(1.0, 2.0, 3.0))
    assert (tmp_path / "port.vol").read_bytes() == (tmp_path / "jax.vol").read_bytes()
    want = data if data.ndim == 4 else data[..., None]
    for reader in (tio.read_vol, jio.read_vol):
        for name in ("port.vol", "jax.vol"):
            np.testing.assert_array_equal(reader(str(tmp_path / name)), want)
    (tmp_path / "bad.vol").write_bytes(b"NOPE")
    with pytest.raises(ValueError):
        tio.read_vol(str(tmp_path / "bad.vol"))


def test_png_bytes_and_tonemap(tmp_path):
    rng = np.random.default_rng(1)
    hdr = (rng.random((9, 7, 3)) * 1.5).astype(np.float32)
    np.testing.assert_array_equal(tio.tonemap(hdr), jio.tonemap(hdr))
    for img in (hdr, rng.integers(0, 256, (5, 6, 4), dtype=np.uint8)):
        tio.write_png(str(tmp_path / "port.png"), img)
        jio.write_png(str(tmp_path / "jax.png"), img)
        assert (tmp_path / "port.png").read_bytes() == (tmp_path / "jax.png").read_bytes()
        want = jio.read_png(str(tmp_path / "jax.png"))
        np.testing.assert_array_equal(tio.read_png(str(tmp_path / "port.png")), want)
    with pytest.raises(ValueError):
        tio.write_png(str(tmp_path / "two.png"), np.zeros((2, 2, 2), np.uint8))


def test_metadata_and_load_checkpoint(tmp_path):
    """``dump_metadata`` of the port writes what the JAX package's writes;
    ``load_checkpoint`` of the port finds a
    JAX run's files the way the JAX package does."""
    import torch

    from differentiable_sdf_rendering_tpu.opt import configs as jconfigs, opt_configs as jopt_configs
    from differentiable_sdf_rendering_tpu.opt.shape_opt import load_checkpoint as jload
    from differentiable_sdf_rendering_tpu_torch.opt import configs as tconfigs, opt_configs as topt_configs
    from differentiable_sdf_rendering_tpu_torch.opt.shape_opt import load_checkpoint

    extra = {"total_time": 1.5, "loss_values": [0.25, 0.125]}
    tio.dump_metadata(tconfigs.get_config("warp"), topt_configs.get_opt_config("no-tex-12")[0], extra,
                      str(tmp_path / "port.json"))
    jio.dump_metadata(jconfigs.get_config("warp"), jopt_configs.get_opt_config("no-tex-12")[0], extra,
                      str(tmp_path / "jax.json"))
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("port.json", "jax.json"))
    assert got == want

    rng = np.random.default_rng(2)
    grids = {tag: rng.normal(size=(4, 4, 4)).astype(np.float32) for tag in ("data-0000", "data-0007", "final")}
    for tag, g in grids.items():
        jio.write_vol(str(tmp_path / "params" / f"sdf-{tag}.vol"), g)
    specs = topt_configs.get_opt_config("no-tex-12")[0].variables()
    jspecs = jopt_configs.get_opt_config("no-tex-12")[0].variables()
    for it, tag in (("final", "final"), (7, "data-0007"), (0, "data-0000"), (3, "data-0007")):
        got = load_checkpoint(str(tmp_path), it, specs, device="cpu")["sdf"]
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, 4, 4)
        np.testing.assert_array_equal(to_np(got), grids[tag])
        np.testing.assert_array_equal(to_np(got), np.asarray(jload(str(tmp_path), it, jspecs)["sdf"]))
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path / "none"), "final", specs, device="cpu")
