"""The checked-in assets through the port vs the JAX package: the EXR codec,
the HDR envmap (``GridEnvmap.from_image``), the ``.vol`` targets of
``target_sdf``, the ``-hdr`` and principled rigs, and the golden images.  The
same inputs go through both packages in one process."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import scenes_zoo as jzoo
from differentiable_sdf_rendering_tpu.models.emitter import GridEnvmap as JGridEnvmap
from differentiable_sdf_rendering_tpu.utils import io as jio
from differentiable_sdf_rendering_tpu_torch.models import scenes_zoo as tzoo
from differentiable_sdf_rendering_tpu_torch.models.bsdf import DiffuseBSDF, PrincipledBSDF
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.emitter import GridEnvmap
from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.utils import io as tio
from torch_port_helpers import perturbed_sphere, t, to_np

SKY = os.path.join(tzoo.ASSET_DIR, "envmaps", "studio_sky.exr")
TABLES = ("image", "image_rows", "pdf_table", "alias_prob", "alias_idx")


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 3), (4, 6, 4)], ids=["Y", "RGB", "RGBA"])
def test_exr_round_trip_across_packages(tmp_path, shape):
    img = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 40.0
    tio.write_exr(str(tmp_path / "port.exr"), img)
    jio.write_exr(str(tmp_path / "jax.exr"), img)
    assert (tmp_path / "port.exr").read_bytes() == (tmp_path / "jax.exr").read_bytes()
    want = img if img.ndim == 3 else img[..., None]
    for reader in (tio.read_exr, jio.read_exr):
        for name in ("port.exr", "jax.exr"):
            got = reader(str(tmp_path / name))
            assert got.dtype == np.float32
            np.testing.assert_array_equal(got, want)
    (tmp_path / "bad.exr").write_bytes(b"\0" * 16)
    with pytest.raises(ValueError):
        tio.read_exr(str(tmp_path / "bad.exr"))


def test_exr_assets_read_alike():
    sky = tio.read_exr(SKY)
    assert sky.shape == (128, 256, 3) and sky.dtype == np.float32 and 53.6 < sky.max() < 53.7
    np.testing.assert_array_equal(sky, jio.read_exr(SKY))
    for name in ("trefoil", "blob", "cinquefoil"):
        path = os.path.join(tzoo.ASSET_DIR, "golden", f"{name}_direct_s0.exr")
        golden = tio.read_exr(path)
        assert golden.shape == (64, 64, 3)
        np.testing.assert_array_equal(golden, jio.read_exr(path))


@pytest.fixture(scope="module")
def envmaps():
    """The HDR envmap of both packages."""
    return JGridEnvmap.from_image(SKY), GridEnvmap.from_image(SKY, device="cpu")


def test_envmap_from_image_tables_bit_equal(envmaps):
    ej, et = envmaps
    assert tuple(et.image.shape) == (128, 256, 3) and et.alias_idx.dtype == torch.int64
    # the alias sampler's jitter turns any table difference into a shifted
    # sample (ROADMAP §C gap 3), so the tables are held bit for bit
    for name in TABLES:
        np.testing.assert_array_equal(to_np(getattr(et, name)), np.asarray(getattr(ej, name)), err_msg=name)


# ~3 s of op-by-op JAX; the same eval and sampler code is held against the
# JAX package in tier-1 by test_torch_render.py::test_grid_envmap (gradient sky)
@pytest.mark.slow
def test_envmap_eval_and_sample_match_jax(envmaps):
    """Radiance, samples and densities of seeded inputs.  The JAX side runs
    op by op, as test_torch_render.py's envmap test does: a fused program
    contracts ``1 - y·y`` of the density's sin θ into a multiply-add, which
    near a pole moves the density by 1.5e-5 of itself."""
    ej, et = envmaps
    rng = np.random.default_rng(7)
    u = rng.random((4096, 2)).astype(np.float32)
    d = rng.normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    dj, pj, rj = (np.asarray(x) for x in ej.sample_direction(jnp.asarray(u)))
    np.testing.assert_allclose(to_np(et.eval(t(d))), np.asarray(ej.eval(jnp.asarray(d))), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(to_np(et.pdf_direction(t(d))), np.asarray(ej.pdf_direction(jnp.asarray(d))), rtol=1e-5)
    dt, pt, rt = et.sample_direction(t(u))
    np.testing.assert_allclose(to_np(dt), dj, rtol=1e-5, atol=1e-6)
    # pdf and radiance of each sample come from the texel re-derived from its
    # direction, which on a rounding-width sliver can be the neighbouring
    # one (ROADMAP §C, models/emitter.py:307 of the JAX package); the samples
    # where the two packages re-derive different texels are counted, the
    # rest held at rtol 1e-5
    same = to_np(GridEnvmap._cell_index(et.image, dt)) == np.asarray(JGridEnvmap._cell_index(ej.image, jnp.asarray(dj)))
    assert same.mean() > 0.99, same.mean()
    np.testing.assert_allclose(to_np(pt)[same], pj[same], rtol=1e-5)
    np.testing.assert_allclose(to_np(rt)[same], rj[same], rtol=1e-5, atol=1e-6)


def test_envmap_sampler_own_checks(envmaps):
    """The JAX package's own checks of the asset (tests/test_assets.py):
    E[1/pdf] over importance samples = 4π, and the brightest samples
    cluster around the sun lobe (0.8, 0.5, 0.2)."""
    _, et = envmaps
    u = t(np.random.default_rng(0).random((200_000, 2)))
    d, pdf, rad = et.sample_direction(u)
    np.testing.assert_allclose(float((1.0 / torch.clamp_min(pdf, 1e-12)).mean()), 4.0 * np.pi, rtol=0.05)
    sun = np.asarray([0.8, 0.5, 0.2])
    sun /= np.linalg.norm(sun)
    bright = to_np(rad).mean(-1) > 20.0
    assert bright.mean() > 0.05
    assert np.median(to_np(d)[bright] @ sun) > 0.95


def test_envmap_from_grey_exr_and_png_with_scale(tmp_path):
    rng = np.random.default_rng(3)
    tio.write_exr(str(tmp_path / "grey.exr"), rng.random((6, 12)).astype(np.float32) * 5.0)
    tio.write_png(str(tmp_path / "ldr.png"), (rng.random((6, 12, 3)) * 255).astype(np.uint8))
    for name in ("grey.exr", "ldr.png"):
        et = GridEnvmap.from_image(str(tmp_path / name), scale=2.5, device="cpu")
        ej = JGridEnvmap.from_image(str(tmp_path / name), scale=2.5)
        assert tuple(et.image.shape) == (6, 12, 3)
        for table in TABLES:
            np.testing.assert_array_equal(to_np(getattr(et, table)), np.asarray(getattr(ej, table)), err_msg=table)


@pytest.fixture(scope="module")
def trefoil64():
    """The 64³ trefoil target of the port (read from the asset and
    redistanced on the host)."""
    return tzoo.target_sdf("trefoil", 64, device="cpu")


@pytest.mark.slow  # the JAX package's 64³ redistancing alone takes ~4 s on one CPU thread
def test_target_sdf_asset_matches_jax(trefoil64):
    want = np.asarray(jzoo.target_sdf("trefoil", 64))
    # the redistancing rounding of tests/test_torch_redistance.py (5e-6 after
    # 24 passes at 16³), grown over 64 passes: each pass adds a last-bit
    # difference (XLA contracts FMAs) that the front carries outward.
    # Measured on this input after 1, 8, 16, 32, 48 and 64 passes: 5.6e-9,
    # 5.4e-7, 3.2e-6, 9.0e-6, 1.4e-5, 1.5e-5, at the far corner (value 0.54)
    np.testing.assert_allclose(to_np(trefoil64), want, rtol=0, atol=2e-5)


def test_target_sdf_asset(trefoil64):
    assert tuple(trefoil64.shape) == (64, 64, 64) and trefoil64.dtype == torch.float32
    assert 0.01 < float((trefoil64 < 0).float().mean()) < 0.5
    # no 32³ asset and no procedural 'trefoil': both packages raise
    for target_sdf in (jzoo.target_sdf, lambda *a: tzoo.target_sdf(*a, device="cpu")):
        with pytest.raises(ValueError):
            target_sdf("trefoil", 32)


def test_target_sdf_scene_dir(tmp_path):
    # scene_dir is searched before the checked-in assets (its file is
    # redistanced like an asset); a procedural name with no file there falls
    # back to its shape, an unknown one raises
    from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance

    os.makedirs(tmp_path / "sdfs")
    grid = perturbed_sphere(16, seed=9)
    tio.write_vol(str(tmp_path / "sdfs" / "knot_16.vol"), grid)
    assert torch.equal(tzoo.target_sdf("knot-hdr", 16, scene_dir=str(tmp_path), device="cpu"), redistance(t(grid)))
    assert torch.equal(tzoo.target_sdf("cubes", 16, scene_dir=str(tmp_path), device="cpu"),
                       tzoo.target_sdf("cubes", 16, device="cpu"))
    with pytest.raises(ValueError):
        tzoo.target_sdf("knot", 8, scene_dir=str(tmp_path), device="cpu")


def test_rigs_match_jax():
    # the HDR rigs against the JAX package's (its gradient sky is held in
    # test_torch_render.py); then the BSDF rule: 'principled' in the name or
    # more than two optimized parameters
    for name in ("trefoil-hdr", "principled-hdr"):
        rj, rt = jzoo.scene_rig_full(name), tzoo.scene_rig_full(name, device="cpu")
        assert type(rt["bsdf"]).__name__ == type(rj["bsdf"]).__name__
        assert isinstance(rt["emitter"], GridEnvmap) and tuple(rt["emitter"].image.shape) == (128, 256, 3)
        for table in TABLES:
            np.testing.assert_array_equal(to_np(getattr(rt["emitter"], table)), np.asarray(getattr(rj["emitter"], table)))
    for name, keys, kind in (("cubes", ("sdf", "albedo", "roughness"), PrincipledBSDF),
                             ("bunny", ("sdf", "albedo"), DiffuseBSDF)):
        rig = tzoo.scene_rig_full(name, keys, device="cpu")
        assert isinstance(rig["bsdf"], kind) and tuple(rig["emitter"].image.shape) == (64, 128, 3)
    p = tzoo.scene_rig_full("cubes", ("sdf", "albedo", "roughness"), device="cpu")["bsdf"]
    pj = jzoo.PrincipledBSDF.create()
    for field in ("base_color", "roughness"):
        np.testing.assert_array_equal(to_np(getattr(p, field)), np.asarray(getattr(pj, field)))
    assert p.specular == pj.specular
    # the mesh, area-light and vMF rigs (held field by field in
    # test_torch_mesh.py): the BSDF rule comes after a rig's own albedo, and a
    # '-hdr' name keeps the geometry
    keys3 = ("sdf", "albedo", "roughness")
    for keys, kind in ((("sdf",), DiffuseBSDF), (keys3, PrincipledBSDF)):
        assert type(tzoo.scene_rig_full("plane_red_object", keys, device="cpu")["bsdf"]) is kind
        assert type(jzoo.scene_rig_full("plane_red_object", keys)["bsdf"]).__name__ == kind.__name__
    assert torch.equal(tzoo.target_sdf("torus-shadow-hdr", 8, device="cpu"), tzoo.target_sdf("torus-shadow", 8, device="cpu"))


def _golden(name, target):
    scene = Scene.create(target, cameras=regular_cameras(2, resx=64, resy=64, device="cpu"), device="cpu")
    img = to_np(render(scene, 0, seed=0, cfg=RenderConfig(integrator="sdf_direct_reparam", spp=16), mode="primal",
                       device="cpu"))[..., :3]
    golden = tio.read_exr(os.path.join(tzoo.ASSET_DIR, "golden", f"{name}_direct_s0.exr"))
    # the bound of the JAX package's own regression test (tests/test_assets.py)
    np.testing.assert_allclose(img, golden, atol=5e-4, rtol=1e-3)


@pytest.mark.slow  # ~2.5 s each on one CPU thread, beyond the new tier-1 cases' 30 s; the card checks all three
@pytest.mark.parametrize("name", ["trefoil", "blob", "cinquefoil"])
def test_golden_render(name):
    _golden(name, tzoo.target_sdf(name, 64, device="cpu"))
