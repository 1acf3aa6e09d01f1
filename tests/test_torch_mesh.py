"""Meshes and mirrors of the port vs the JAX package: batched Möller–Trumbore
on the floor and the mirror rect (grazing and missing rays, the chunk loop,
the gradient of t with respect to the ray), the delta conductor, and the
four mesh / area-light / vMF rigs with their procedural targets; then the
JAX package's own behavioural checks of mirrors and the shadow floor
(tests/test_mirror.py) run on the port.  The same seeded numpy inputs go
through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import bsdf as jbsdf
from differentiable_sdf_rendering_tpu.models import scenes_zoo as jzoo
from differentiable_sdf_rendering_tpu.ops import mesh_intersect as jmesh
from differentiable_sdf_rendering_tpu.ops.interaction import SurfaceInteraction as JSI
from differentiable_sdf_rendering_tpu_torch.models import bsdf as tbsdf
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg
from differentiable_sdf_rendering_tpu_torch.models import scenes_zoo as tzoo
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.emitter import VMFEmitter
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.ops import mesh_intersect as tmesh
from differentiable_sdf_rendering_tpu_torch.ops.initializers import create_sphere_sdf
from differentiable_sdf_rendering_tpu_torch.ops.interaction import SurfaceInteraction
from differentiable_sdf_rendering_tpu_torch.ops.sampling import lane_uniforms
from differentiable_sdf_rendering_tpu_torch.ops.sdf import GridSDF
from torch_port_helpers import t, to_np

N = 2048
NEW_RIGS = ("torus-shadow", "mirror-opt", "plane_area", "plane_red_object")


def _floor(m, **kw):
    """The torus-shadow floor."""
    return m.TriangleMesh.floor(height=0.22, half_extent=4.0, albedo=(0.65, 0.65, 0.65), **kw)


def _mirror(m, **kw):
    """The mirror-opt mirror."""
    return m.TriangleMesh.rect(corner=(-0.35, -0.6, -0.6), e0=(0.0, 2.2, 0.0), e1=(0.0, 0.0, 2.2),
                               albedo=(0.88, 0.88, 0.92), material="mirror", **kw)


def _meshes(kind):
    """The floor, the mirror, or both merged into one mesh of material
    "mixed", in both packages."""
    if kind == "mixed":
        return (jmesh.TriangleMesh.merge([_floor(jmesh), _mirror(jmesh)]),
                tmesh.TriangleMesh.merge([_floor(tmesh, device="cpu"), _mirror(tmesh, device="cpu")]))
    make = _floor if kind == "floor" else _mirror
    return make(jmesh), make(tmesh, device="cpu")


def _rays(kind):
    """Rays from around the unit cube in all directions, plus a block aimed
    at the mesh, a block grazing its plane and a block passing beside it;
    for the merged mesh, the first halves of the floor's and the mirror's."""
    if kind == "mixed":
        (of, df), (om, dm) = _rays("floor"), _rays("mirror")
        return np.concatenate([of[:N // 2], om[:N // 2]]), np.concatenate([df[:N // 2], dm[:N // 2]])
    rng = np.random.default_rng(0 if kind == "floor" else 1)
    o = rng.uniform(-0.5, 1.5, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    axis = 1 if kind == "floor" else 0
    plane = 0.22 if kind == "floor" else -0.35
    d[:256, axis] = -np.abs(d[:256, axis]) * np.sign(o[:256, axis] - plane)  # toward the plane
    d[256:384, axis] = 0.0                                                    # parallel to it
    o[384:512, axis] = plane + 1e-3                                           # grazing, just off it
    d[384:512, axis] = -1e-4 * np.sign(o[384:512, axis] - plane)
    o[512:640, (axis + 1) % 3] += 5.0                                          # beside the quad,
    d[512:640, (axis + 1) % 3] = np.abs(d[512:640, (axis + 1) % 3])            # heading away
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


@pytest.mark.parametrize("chunk", [128, 1])
@pytest.mark.parametrize("kind", ["floor", "mirror", "mixed"])
def test_mesh_intersect_matches_jax(kind, chunk):
    mj, mt = _meshes(kind)
    for field in ("v0", "e1", "e2", "n", "albedo", "mirror"):
        np.testing.assert_array_equal(to_np(getattr(mt, field)), np.asarray(getattr(mj, field)), err_msg=field)
    assert mt.material == mj.material and mt.n_triangles == (4 if kind == "mixed" else 2)
    assert mt.material == {"floor": "diffuse", "mirror": "mirror", "mixed": "mixed"}[kind]
    beside = np.r_[512:640, N // 2 + 512:N // 2 + 640] if kind == "mixed" else np.r_[512:640]
    o, d = _rays(kind)
    w = np.random.default_rng(2).normal(size=N).astype(np.float32)

    @jax.jit
    def jax_side(oo, dd):
        """The intersection and the gradient of Σ w·t over hit lanes with
        respect to the ray (one compilation)."""
        def loss(oo, dd):
            tt = jmesh.mesh_intersect(mj, oo, dd, chunk=chunk)[0]
            return jnp.sum(jnp.where(jnp.isfinite(tt), tt, 0.0) * w)

        return jmesh.mesh_intersect_full(mj, oo, dd, chunk=chunk), jax.grad(loss, argnums=(0, 1))(oo, dd)

    want, (go_j, gd_j) = jax_side(jnp.asarray(o), jnp.asarray(d))
    want = [np.asarray(x) for x in want]
    got = tmesh.mesh_intersect_full(mt, t(o), t(d), chunk=chunk)
    hit = np.isfinite(want[0])
    assert 300 < hit.sum() < N - 300 and not hit[beside].any()
    np.testing.assert_array_equal(np.isfinite(to_np(got[0])), hit)
    # the same nearest triangle: identical normal, albedo and material bit
    np.testing.assert_allclose(to_np(got[0])[hit], want[0][hit], rtol=1e-5, atol=1e-6)
    for g, x in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(to_np(g), x)

    # t is differentiable with respect to the ray (origin and direction)
    ot, dt = t(o).requires_grad_(True), t(d).requires_grad_(True)
    tt = tmesh.mesh_intersect(mt, ot, dt, chunk=chunk)[0]
    torch.sum(torch.where(torch.isfinite(tt), tt, torch.zeros_like(tt)) * t(w)).backward()
    for g, gj in ((ot.grad, go_j), (dt.grad, gd_j)):
        np.testing.assert_allclose(to_np(g), np.asarray(gj), rtol=1e-5, atol=1e-5 * np.abs(np.asarray(gj)).max())


def test_conductor_bsdf():
    rng = np.random.default_rng(4)
    v = rng.normal(size=(3, 64, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    ones = np.ones(64, np.float32)
    mk = lambda cls, f: cls(valid=f(ones > 0), t=f(ones), p=f(v[1]), n=f(v[2]), s=f(v[2]), b=f(v[2]), wi=f(v[0]))
    si_j, si_t = mk(JSI, jnp.asarray), mk(SurfaceInteraction, t)
    bj, bt = jbsdf.ConductorBSDF.create((0.8, 0.9, 1.0)), tbsdf.ConductorBSDF.create((0.8, 0.9, 1.0), device="cpu")
    assert bt.delta and bj.delta
    u = rng.random((64, 2)).astype(np.float32)
    for got, want in zip(bt.sample(si_t, t(u)), bj.sample(si_j, jnp.asarray(u))):
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    for got, want in zip((bt.eval(si_t, t(v[1])), *bt.eval_pdf(si_t, t(v[1]))),
                         (bj.eval(si_j, jnp.asarray(v[1])), *bj.eval_pdf(si_j, jnp.asarray(v[1])))):
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # the JAX package's delta conventions (tests/test_mirror.py)
    stub = SurfaceInteraction(*[None] * 6, wi=torch.tensor([[0.3, -0.2, 0.9], [0.1, 0.1, -0.5]]))
    wo, pdf, w = bt.sample(stub, torch.zeros(2, 2))
    np.testing.assert_allclose(to_np(wo[0]), [-0.3, 0.2, 0.9], atol=1e-6)
    assert float(pdf[0]) == 1.0 and float(pdf[1]) == 0.0  # below the horizon: invalid
    np.testing.assert_allclose(to_np(w[0]), [0.8, 0.9, 1.0])
    val, p = bt.eval_pdf(stub, wo)
    assert float(val.abs().max()) == 0.0 and float(p.abs().max()) == 0.0


@pytest.fixture(scope="module")
def jax_targets():
    """The JAX package's procedural targets of the new rigs at 16³, jitted."""
    return {name: np.asarray(jax.jit(lambda n=name: jzoo.target_sdf(n, 16))()) for name in NEW_RIGS}


@pytest.mark.parametrize("name", NEW_RIGS)
def test_new_rigs_match_jax(name, jax_targets):
    rj, rt = jzoo.scene_rig_full(name), tzoo.scene_rig_full(name, device="cpu")

    def fields(x):
        return {k: v for k, v in vars(x).items() if v is not None}

    for key in ("bsdf", "emitter", "area_emitter", "mesh"):
        if rj[key] is None:
            assert rt[key] is None, key
            continue
        assert type(rt[key]).__name__ == type(rj[key]).__name__, key
        fj, ft = fields(rj[key]), fields(rt[key])
        assert fj.keys() == ft.keys(), key
        for f in fj:
            np.testing.assert_array_equal(to_np(ft[f]) if torch.is_tensor(ft[f]) else ft[f], np.asarray(fj[f]),
                                          err_msg=f"{key}.{f}")
    # the target: redistancing rounds differently (ROADMAP §C gap 1)
    np.testing.assert_allclose(to_np(tzoo.target_sdf(name, 16, device="cpu")), jax_targets[name], rtol=0, atol=5e-6)


# ---- the JAX package's behavioural checks (tests/test_mirror.py), on the port ----

def test_mirror_image_equivalence():
    """Radiance along a ray that first hits the planar mirror equals
    reflectance × the radiance of the reflected ray in the scene without
    the mirror: the one specular bounce of ``_sample_direct``."""
    mirror = tmesh.TriangleMesh.rect(corner=(-0.35, -0.6, -0.6), e0=(0.0, 2.2, 0.0), e1=(0.0, 0.0, 2.2),
                                     albedo=(0.9, 0.9, 0.9), material="mirror", device="cpu")
    scene = Scene.create(
        create_sphere_sdf(32, radius=0.22, device="cpu"),
        emitter=VMFEmitter.create(mu=(0.2, 0.9, 0.1), scale=(20.0,) * 3, ambient=(0.1,) * 3, kappa=40.0, device="cpu"),
        cameras=regular_cameras(1, resx=24, resy=24, device="cpu"), mesh=mirror, device="cpu",
    )
    n = 64
    o = torch.stack([torch.full((n,), 1.6), torch.linspace(0.9, 1.3, n), torch.full((n,), 0.55)], -1)
    d = torch.tensor([-1.0, 0.0, 0.0]).expand(n, 3)
    uni = lane_uniforms(7, torch.arange(n), 6)
    cfg = tinteg.RenderConfig(spp=1)
    rgb = tinteg._sample_direct(scene, o, d, uni, cfg, "primal")[0]
    # the mirrored ray leaves the x = -0.35 plane along +x
    hit_p = o + (o[:, 0] + 0.35)[:, None] * d
    d_r = torch.tensor([1.0, 0.0, 0.0]).expand(n, 3)
    rgb_ref = tinteg._sample_direct(scene.replace(mesh=None), hit_p + d_r * 1e-3, d_r, uni, cfg, "primal")[0]
    np.testing.assert_allclose(to_np(rgb), to_np(rgb_ref) * 0.9, rtol=1e-4, atol=1e-5)


def test_mixed_mesh_shades_like_its_parts():
    """A merged mesh of material "mixed" (a diffuse floor at y = 0.22 over a
    mirror at y = 0): a lane whose nearest hit is the mirror takes the one
    specular bounce, as in the scene without meshes along the reflected ray,
    and a lane whose nearest hit is the floor keeps its Lambertian shading,
    as in the floor-only scene (the mirror lies below every direction that
    lights the floor)."""
    floor = _floor(tmesh, device="cpu")
    mirror = tmesh.TriangleMesh.rect(corner=(-1.0, 0.0, -1.0), e0=(0.0, 0.0, 3.0), e1=(3.0, 0.0, 0.0),
                                     albedo=(0.9, 0.9, 0.9), material="mirror", device="cpu")
    mixed = tmesh.TriangleMesh.merge([floor, mirror])
    assert mixed.material == "mixed" and mixed.n_triangles == 4
    scene = Scene.create(
        create_sphere_sdf(16, radius=0.22, device="cpu"),
        emitter=VMFEmitter.create(mu=(0.2, 0.9, 0.1), scale=(20.0,) * 3, ambient=(0.1,) * 3, kappa=40.0, device="cpu"),
        cameras=regular_cameras(1, resx=8, resy=8, device="cpu"), mesh=mixed, device="cpu",
    )
    n = 64
    xs = torch.linspace(0.9, 1.3, n)
    uni = lane_uniforms(7, torch.arange(2 * n), 6)
    cfg = tinteg.RenderConfig(spp=1)
    # n rays down onto the floor, n rays up from below onto the mirror
    o = torch.cat([torch.stack([xs, torch.full((n,), 1.5), torch.full((n,), 0.55)], -1),
                   torch.stack([xs, torch.full((n,), -0.5), torch.full((n,), 0.55)], -1)])
    d = torch.cat([torch.tensor([0.0, -1.0, 0.0]).expand(n, 3), torch.tensor([0.0, 1.0, 0.0]).expand(n, 3)])
    rgb = tinteg._sample_direct(scene, o, d, uni, cfg, "primal")[0]
    assert float(rgb.min()) >= 0.0 and float(rgb[:n].max()) > 0.05 and float(rgb[n:].min()) > 0.01

    rgb_floor = tinteg._sample_direct(scene.replace(mesh=floor), o[:n], d[:n], uni[:n], cfg, "primal")[0]
    np.testing.assert_allclose(to_np(rgb[:n]), to_np(rgb_floor), rtol=1e-6, atol=1e-7)
    # the mirrored ray leaves the y = 0 plane downward
    hit_p = o[n:] + 0.5 * d[n:]
    d_r = torch.tensor([0.0, -1.0, 0.0]).expand(n, 3)
    rgb_ref = tinteg._sample_direct(scene.replace(mesh=None), hit_p + d_r * 1e-3, d_r, uni[n:], cfg, "primal")[0]
    np.testing.assert_allclose(to_np(rgb[n:]), to_np(rgb_ref) * 0.9, rtol=1e-4, atol=1e-5)


def test_torus_shadow_floor_receives_shadow():
    """The floor darkens under the torus (the reconstruction signal of
    ``torus-shadow-1``): without the SDF the image is brighter."""
    rig = tzoo.scene_rig_full("torus-shadow", device="cpu")
    cams = regular_cameras(1, resx=24, resy=24, device="cpu")
    cfg = tinteg.RenderConfig(spp=8)

    def image(data):
        scene = Scene(sdf=GridSDF.create(data), bsdf=rig["bsdf"], emitter=rig["emitter"], cameras=cams,
                      mesh=rig["mesh"])
        return to_np(tinteg.render(scene, 0, seed=0, cfg=cfg, device="cpu"))[..., :3]

    with_torus = image(tzoo.target_sdf("torus-shadow", 32, device="cpu"))
    without = image(torch.full((32, 32, 32), 0.5))
    assert without.mean() > with_torus.mean() * 1.05, (without.mean(), with_torus.mean())
