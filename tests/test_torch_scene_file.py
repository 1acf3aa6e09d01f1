"""Scene files in the port (``models/scene_file.py``) against the JAX
package's ``load_scene_file``: the checked-in scenes and scene files written
here, field by field (grid, BSDF, emitter and its tables, cameras, merged
mesh, area light) at a 16³ grid and small films; and the JAX package's
behavioural checks of scene files (``tests/test_mesh_intersect.py``) run on
the port."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models.scene_file import load_scene_file as jload_scene_file
from differentiable_sdf_rendering_tpu_torch.models.integrator import RenderConfig, render
from differentiable_sdf_rendering_tpu_torch.models.scene_file import load_scene_file
from differentiable_sdf_rendering_tpu_torch.utils.io import write_png, write_vol
from torch_port_helpers import perturbed_sphere, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKED_IN = ["scenes/example/example.json", "scenes/example/hybrid_floor.json", "scenes/studio/studio.json"]
RTOL, ATOL = 1e-5, 1e-6
# a grid redistanced on load: ROADMAP §C gap 1 (16 passes: 3.2e-6)
GRID_ATOL = 2e-5


def _close(got, want, what, atol=ATOL):
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _fields_close(got, want, what, skip=()):
    """Every tensor field of the port's dataclass against the JAX object's
    attribute of the same name; other fields equal."""
    assert (got is None) == (want is None), what
    if got is None:
        return
    for f in dataclasses.fields(got):
        if f.name in skip:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, torch.Tensor):
            _close(g.to(torch.float64) if g.dtype == torch.bool else g, np.asarray(w), f"{what}.{f.name}")
        elif g is None or isinstance(g, (str, int, float)):
            assert g == w, f"{what}.{f.name}: {g} != {w}"
        else:  # a nested dataclass
            _fields_close(g, w, f"{what}.{f.name}")


def _assert_scenes_close(path, gradient_sky=False, **kw):
    got = load_scene_file(path, device="cpu", **kw)
    want = jload_scene_file(path, **kw)
    _close(got.sdf.data, want.sdf.data, "sdf.data", atol=GRID_ATOL)
    _close(got.sdf.p, want.sdf.p, "sdf.p")
    # the gradient sky is built with numpy's sin/cos/pow here and XLA's there
    # (ROADMAP §C gap 3): its image and density agree at rtol 1e-5, and its
    # alias tables, built from them, are held bit for bit from one image by
    # tests/test_torch_render.py::test_grid_envmap
    for name in ("bsdf", "emitter", "mesh", "area_emitter"):
        assert type(getattr(got, name)).__name__ == type(getattr(want, name)).__name__, name
        skip = ("alias_prob", "alias_idx") if name == "emitter" and gradient_sky else ()
        _fields_close(getattr(got, name), getattr(want, name), name, skip)
    # cameras: origins, rotations (look_at) and tan(fov/2), computed in numpy
    # here and in float32 XLA there
    for name in ("origin", "rot", "tan_half_fov"):
        _close(getattr(got.cameras, name), getattr(want.cameras, name), f"cameras.{name}")
    assert (got.cameras.resx, got.cameras.resy) == (want.cameras.resx, want.cameras.resy)
    return got, want


@pytest.mark.parametrize("path", CHECKED_IN)
def test_checked_in_scene_matches_jax(path):
    got, _ = _assert_scenes_close(os.path.join(ROOT, path), resx=8, resy=6, sdf_res=16)
    assert got.sdf.data.shape == (16, 16, 16) and (got.cameras.resx, got.cameras.resy) == (8, 6)


def _write_scene(tmp_path, spec, name="scene.json"):
    path = tmp_path / name
    path.write_text(json.dumps(spec))
    return str(path)


def test_written_scene_matches_jax(tmp_path):
    """A ``vol`` grid, a principled BSDF, a PNG envmap with a scale, look-at
    cameras, an OBJ scaled then translated, a mirror rect, a floor of the
    ``meshes`` list and an area light."""
    write_vol(str(tmp_path / "grid.vol"), perturbed_sphere(16, seed=3))
    img = np.random.default_rng(4).uniform(0, 255, (8, 16, 3)).astype(np.uint8)
    write_png(str(tmp_path / "sky.png"), img)
    (tmp_path / "tri.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 0 1\nv 0 0 1\nf 1 2 3 4\n")
    spec = {
        "sdf": {"vol": "grid.vol"},
        "bsdf": {"type": "principled", "base_color": [0.5, 0.4, 0.7], "roughness": 0.3},
        "emitter": {"type": "envmap_png", "path": "sky.png", "scale": 1.7},
        "area_emitter": {"corner": [0.1, 1.5, 0.2], "e0": [0.7, 0, 0], "e1": [0, 0, 0.6]},
        "cameras": {"type": "lookat", "fov": 33, "origins": [[2.1, 0.7, 0.4], [0.5, 0.6, -1.6]],
                    "target": [0.5, 0.45, 0.5], "resx": 8, "resy": 8},
        "mesh": {"obj": "tri.obj", "scale": 2.5, "translate": [-0.7, 0.05, -0.6], "albedo": [0.6, 0.6, 0.5]},
        "meshes": [
            {"type": "rect", "corner": [-0.3, -0.5, -0.5], "e0": [0, 2, 0], "e1": [0, 0, 2],
             "albedo": [0.9, 0.9, 0.9], "material": "mirror"},
            {"type": "floor", "height": 0.05, "half_extent": 3.0},
        ],
    }
    got, want = _assert_scenes_close(_write_scene(tmp_path, spec))
    assert got.mesh.material == "mixed" and got.mesh.n_triangles == 6
    assert got.mesh.mirror.tolist() == [False, False, True, True, False, False]


@pytest.mark.parametrize("emitter", [
    {"type": "constant", "radiance": [2.0, 1.5, 1.0]},
    {"type": "vmf", "mu": [0.1, 1.0, 0.2], "kappa": 40.0},
    {},
])
def test_regular_rig_and_emitters_match_jax(tmp_path, emitter):
    """The regular rig with its options; constant, vMF and (by default) the
    gradient sky; a diffuse BSDF by default; a procedural grid."""
    spec = {
        "sdf": {"procedural": "cubes", "res": 16},
        "emitter": emitter,
        "cameras": {"type": "regular", "n": 3, "angle_shift": 0.5, "radius": 2.3, "resx": 8, "resy": 8},
    }
    _assert_scenes_close(_write_scene(tmp_path, spec), gradient_sky=not emitter)


# --- the JAX package's behavioural checks (tests/test_mesh_intersect.py) ---


def test_scene_file_mesh_entry(tmp_path):
    spec = {
        "sdf": {"procedural": "sphere", "res": 16},
        "mesh": {"type": "floor", "height": 0.12, "albedo": [0.6, 0.5, 0.4]},
        "cameras": {"type": "regular", "n": 2, "resx": 16, "resy": 16},
    }
    scene = load_scene_file(_write_scene(tmp_path, spec), device="cpu")
    assert scene.mesh is not None and scene.mesh.n_triangles == 2
    np.testing.assert_allclose(to_np(scene.mesh.albedo), [[0.6, 0.5, 0.4]] * 2)
    np.testing.assert_allclose(float(scene.mesh.v0[0, 1]), 0.12)
    no_mesh = {k: v for k, v in spec.items() if k != "mesh"}
    assert load_scene_file(_write_scene(tmp_path, no_mesh, "s2.json"), device="cpu").mesh is None
    spec["mesh"] = {"type": "wall"}
    with pytest.raises(ValueError, match="unknown mesh type"):
        load_scene_file(_write_scene(tmp_path, spec, "s3.json"), device="cpu")
    spec["mesh"] = {"type": "floor", "material": "glass"}
    with pytest.raises(ValueError, match="unknown mesh material"):
        load_scene_file(_write_scene(tmp_path, spec, "s4.json"), device="cpu")


def test_scene_file_mirror_material_and_rect(tmp_path):
    spec = {
        "sdf": {"procedural": "sphere", "res": 16},
        "mesh": {"type": "rect", "corner": [-0.3, -0.5, -0.5], "e0": [0, 2, 0], "e1": [0, 0, 2],
                 "albedo": [0.9, 0.9, 0.9], "material": "mirror"},
        "cameras": {"type": "regular", "n": 1, "resx": 16, "resy": 16},
    }
    scene = load_scene_file(_write_scene(tmp_path, spec), device="cpu")
    assert scene.mesh.material == "mirror" and scene.mesh.n_triangles == 2


def test_studio_scene_renders_and_differentiates():
    """The studio rig (an OBJ backdrop, a bounce card, an HDR envmap and an
    overhead area light) renders with the backdrop filling most of the
    frame, and the gradient reaches the SDF's translation."""
    scene = load_scene_file(os.path.join(ROOT, "scenes", "studio", "studio.json"), resx=16, resy=16, sdf_res=16,
                            device="cpu")
    assert scene.mesh.n_triangles == 8 and scene.area_emitter is not None
    img = to_np(render(scene, 0, seed=0, cfg=RenderConfig(spp=4), device="cpu"))
    assert np.isfinite(img).all() and (img[..., :3].max(-1) > 1e-3).mean() > 0.8
    p = torch.zeros(3, requires_grad=True)
    out = render(scene.replace(sdf=scene.sdf.replace(p=p)), 0, seed=1, cfg=RenderConfig(spp=4), mode="grad",
                 device="cpu")
    out[..., :3].sum().backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 1e-3


def test_load_scene_file_needs_a_device():
    """Without ``device`` the loader means the card; without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("this check is about hosts without a CUDA card")
    with pytest.raises(RuntimeError):
        load_scene_file(os.path.join(ROOT, CHECKED_IN[0]))
