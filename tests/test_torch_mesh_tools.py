"""The mesh → SDF tools of the port (``utils/mesh.py``, ``native/``) against
the JAX package's: the mesh generators and the OBJ loader exactly, the
native helpers bit for bit (the same source and ``g++`` flags, built apart),
``create_sdf`` within the redistancing gap; and the JAX package's own
behavioural checks (``tests/test_native_mesh.py``) run on the port."""

import os

import jax
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu import native as jnative
from differentiable_sdf_rendering_tpu.utils import mesh as jmesh
from differentiable_sdf_rendering_tpu_torch import native
from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf, voxel_centers
from differentiable_sdf_rendering_tpu_torch.ops.redistance import redistance
from differentiable_sdf_rendering_tpu_torch.utils import mesh
from differentiable_sdf_rendering_tpu_torch.utils.profiling import Timer
from torch_port_helpers import JIT_LEVEL0, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKDROP = os.path.join(ROOT, "scenes", "studio", "backdrop.obj")
# small watertight meshes (a few hundred to ~1,300 triangles) that keep the
# numpy versions quick
SMALL = {
    "icosphere": lambda m: m.icosphere(2),
    "trefoil": lambda m: m.trefoil(n_u=48, n_v=12),
    "blob": lambda m: m.blob(2),
}


def test_mesh_generators_equal_jax():
    for name, kwargs in [("icosphere", {}), ("icosphere", {"subdiv": 1, "radius": 0.2}), ("trefoil", {}),
                         ("cinquefoil", {}), ("blob", {})]:
        got, want = getattr(mesh, name)(**kwargs), getattr(jmesh, name)(**kwargs)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_load_obj_equal_jax():
    (v, f), (jv, jf) = mesh.load_obj(BACKDROP), jmesh.load_obj(BACKDROP)
    assert v.shape == (8, 3) and f.shape == (6, 3)  # the studio backdrop: 6 faces
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's native module, its library built by its own build
    command into a private path (so that no other test worker's build of
    the same file can race with it); restored afterwards."""
    saved = (jnative._LIB_PATH, jnative._lib, jnative._tried)
    jnative._LIB_PATH = str(tmp_path_factory.mktemp("jax_native") / "libsdfnative.so")
    jnative._lib, jnative._tried = None, False
    assert jnative.available()
    yield jnative
    jnative._LIB_PATH, jnative._lib, jnative._tried = saved


def _points(n, seed):
    return np.random.default_rng(seed).uniform(-0.1, 1.1, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(SMALL))
def test_native_bit_equal_jax(name, jax_native):
    """Same source, same flags, one machine: the port's build and the JAX
    package's agree bit for bit, and the numpy versions with them."""
    verts, tris = SMALL[name](mesh)
    for res in (16, 23):
        occ = native.mesh_occupancy(verts, tris, res)
        np.testing.assert_array_equal(occ, jax_native.mesh_occupancy(verts, tris, res))
        np.testing.assert_array_equal(occ, native.occupancy_plain(verts, tris, res))
    pts = _points(400, 1)
    dist = native.mesh_min_distance(verts, tris, pts)
    np.testing.assert_array_equal(dist, jax_native.mesh_min_distance(verts, tris, pts))
    # the C++ code may contract multiply-adds where numpy rounds each
    # operation, in float64: equal measured, held at 1 float32 ulp
    np.testing.assert_allclose(native.min_distance_plain(verts, tris, pts), dist, rtol=1.2e-7, atol=0)
    phi = np.random.default_rng(2).standard_normal((12, 12, 12)).astype(np.float32)
    np.testing.assert_array_equal(native.fsm_redistance(phi), jax_native.fsm_redistance(phi))


def test_jax_numpy_distance_fallback_underestimates():
    """The JAX package's numpy fallback ``_tri_dist2_np`` (used there only
    without g++) takes the plane projection even where it falls outside a
    triangle; the port's plain version follows the C++ regions."""
    verts, tris = mesh.icosphere(1)
    pts = _points(300, 3)
    a, b, c = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    fallback = np.sqrt(jnative._tri_dist2_np(pts[:, None, :], a[None], b[None], c[None]).min(-1))
    exact = native.mesh_min_distance(verts, tris, pts)
    assert (fallback < exact - 1e-3).mean() > 0.5
    np.testing.assert_allclose(native.min_distance_plain(verts, tris, pts), exact, rtol=1.2e-7)


@pytest.fixture(scope="module")
def jax_create_sdf():
    """The JAX package's ``create_sdf`` with its redistancing jitted at
    backend level 0 (op by op, each grid shape compiles every op anew: ~3 s
    a shape)."""
    saved = jmesh.redistance
    jmesh.redistance = jax.jit(saved, static_argnames=("iterations", "prefer_pallas"), **JIT_LEVEL0)
    try:
        verts, tris = SMALL["trefoil"](jmesh)
        return {res: np.asarray(jmesh.create_sdf((verts, tris), res)) for res in (16, 32)}
    finally:
        jmesh.redistance = saved


@pytest.mark.parametrize("res", [16, 32])
def test_create_sdf_matches_jax(res, jax_create_sdf):
    """Two redistancings of ``res`` passes each: the gap of ROADMAP §C gap 1
    (measured 9.8e-7 at 16³, 3.7e-6 at 32³ on the full trefoil; on this
    one 1.7e-6 and 5.0e-6 against the jitted JAX side, 1.0e-6 and 4.2e-6
    against it op by op)."""
    timer = Timer("cpu")
    got = mesh.create_sdf(SMALL["trefoil"](mesh), res, device="cpu", timer=timer)
    assert got.shape == (res, res, res) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), jax_create_sdf[res], rtol=0, atol=2e-5)
    assert set(timer.sections) == {"native", "redistance"}


def test_create_sdf_from_obj_path(tmp_path):
    """An ``.obj`` path is loaded with ``load_obj``."""
    verts, tris = mesh.icosphere(1)
    path = tmp_path / "ico.obj"
    path.write_text("".join(f"v {x} {y} {z}\n" for x, y, z in verts.tolist())
                    + "".join(f"f {a + 1} {b + 1} {c + 1}\n" for a, b, c in tris.tolist()))
    lv, lf = mesh.load_obj(str(path))
    np.testing.assert_array_equal(lf, tris)
    np.testing.assert_allclose(lv, verts, rtol=1e-6)
    got = mesh.create_sdf(str(path), 16, device="cpu")
    want = mesh.create_sdf((lv, lf), 16, device="cpu")
    assert torch.equal(got, want)


# --- the JAX package's behavioural checks (tests/test_native_mesh.py) ---


def test_fsm_matches_redistance():
    """The exact C++ FSM is the oracle of the Jacobi-Godunov solver."""
    res = 24
    pts = to_np(voxel_centers(res, "cpu"))
    phi = (np.linalg.norm(pts - 0.5, axis=-1) - 0.27).astype(np.float32) * 4.0
    exact = native.fsm_redistance(phi)
    ours = to_np(redistance(torch.from_numpy(phi)))
    band = np.abs(exact) < 6.0 / res
    assert np.abs(exact - ours)[band].max() < 1.5 / res


def test_mesh_occupancy_sphere():
    verts, tris = mesh.icosphere(3)
    occ = native.mesh_occupancy(verts, tris, 32)
    inside = np.linalg.norm(to_np(voxel_centers(32, "cpu")) - 0.5, axis=-1) < 0.3
    assert ((occ < 0) == inside).mean() > 0.98


def test_mesh_min_distance():
    verts, tris = mesh.icosphere(3)
    pts = np.asarray([[0.5, 0.5, 0.5], [0.5, 0.5, 0.85], [0.1, 0.5, 0.5]], np.float32)
    np.testing.assert_allclose(native.mesh_min_distance(verts, tris, pts), [0.3, 0.05, 0.1], atol=0.01)


def test_create_sdf_icosphere():
    sdf = to_np(mesh.create_sdf(mesh.icosphere(3), res=32, device="cpu"))
    exact = to_np(create_sphere_sdf(32, radius=0.3, device="cpu"))
    band = np.abs(exact) < 4.0 / 32
    assert np.abs(sdf - exact)[band].max() < 2.0 / 32


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """A failed build raises; nothing falls back to the numpy versions."""
    bad = tmp_path / "voxelize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_lib_path", lambda: str(tmp_path / "libsdfnative.so"))
    with pytest.raises(RuntimeError, match="failed"):
        native.mesh_occupancy(*mesh.icosphere(1), 8)
    assert not (tmp_path / "libsdfnative.so").exists()
