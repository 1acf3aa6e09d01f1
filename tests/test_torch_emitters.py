"""Emitters of the port vs the JAX package: the vMF warp and density, the
vMF sun of the ``torus-shadow`` / ``mirror-opt`` rigs, the rectangular area
light, the power proxies and the NEE mixture of ``plane_area``; then the JAX
package's own behavioural checks of the area light (tests/test_area_emitter.py)
run on the port.  The same seeded numpy inputs go through both packages; the
JAX functions here are small and run op by op."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_sdf_rendering_tpu.models import emitter as jemitter
from differentiable_sdf_rendering_tpu.models import integrator as jinteg
from differentiable_sdf_rendering_tpu.models import scenes_zoo as jzoo
from differentiable_sdf_rendering_tpu.models.scene import Scene as JScene
from differentiable_sdf_rendering_tpu.ops import sampling as jsampling
from differentiable_sdf_rendering_tpu_torch.models import emitter as temitter
from differentiable_sdf_rendering_tpu_torch.models import integrator as tinteg
from differentiable_sdf_rendering_tpu_torch.models import scenes_zoo as tzoo
from differentiable_sdf_rendering_tpu_torch.models.camera import regular_cameras
from differentiable_sdf_rendering_tpu_torch.models.scene import Scene
from differentiable_sdf_rendering_tpu_torch.ops import sampling as tsampling
from torch_port_helpers import t, to_np

N = 4096


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _close(got, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_inf(got, want):
    """``_close`` for values that may be inf (a miss): equal where either is
    infinite, close elsewhere."""
    got, want = to_np(got), np.asarray(want)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    _close(np.where(np.isfinite(got), got, 0.0), np.where(np.isfinite(want), want, 0.0))


@pytest.mark.parametrize("kappa", [2.0, 20.0, 60.0])
def test_vmf_warp_and_pdf(kappa):
    rng = np.random.default_rng(int(kappa))
    u = rng.random((N, 2)).astype(np.float32)
    u[:4, 0] = (0.0, 1e-7, 0.5, 0.9999999)  # the ends of the inverse CDF
    _close(tsampling.square_to_vmf(t(u), kappa), jsampling.square_to_vmf(jnp.asarray(u), kappa))
    cos = np.concatenate([np.linspace(-1.0, 1.0, 64), 1.0 - rng.random(N) * 0.2]).astype(np.float32)
    _close(tsampling.vmf_pdf(t(cos), kappa), jsampling.vmf_pdf(jnp.asarray(cos), kappa))


def test_vmf_sun_of_the_shadow_rig():
    """The rig's VMFEmitter (κ = 60): sample, pdf, eval and power proxy.

    At κ = 60 the lobe ``exp(κ(cos θ − 1))`` turns a one-ulp difference of
    cos θ = ⟨d, μ⟩ into 60 ulps of the result; both packages sum the three
    products in the same order, and the values agree within the
    elementwise tolerance."""
    ej = jzoo.scene_rig_full("torus-shadow")["emitter"]
    et = tzoo.scene_rig_full("torus-shadow", device="cpu")["emitter"]
    assert isinstance(et, temitter.VMFEmitter) and et.kappa == ej.kappa == 60.0
    for field in ("mu", "scale", "ambient"):
        _close(getattr(et, field), getattr(ej, field), rtol=0, atol=0)
    rng = np.random.default_rng(3)
    u = rng.random((N, 2)).astype(np.float32)
    for got, want in zip(et.sample_direction(t(u)), ej.sample_direction(jnp.asarray(u))):
        _close(got, want)
    d = np.concatenate([_unit(rng, N), np.asarray(ej.sample_direction(jnp.asarray(u))[0])])
    _close(et.pdf_direction(t(d)), ej.pdf_direction(jnp.asarray(d)))
    _close(et.eval(t(d)), ej.eval(jnp.asarray(d)))
    assert float(et.power_proxy()) == pytest.approx(float(ej.power_proxy()), rel=1e-6)
    # the lobe carries most of the sampling effort toward mu
    dt = to_np(et.sample_direction(t(u))[0])
    assert (dt @ to_np(et.mu) > 0.9).mean() > 0.6


def _panel(mod, **kw):
    return mod.AreaEmitter.create(corner=(0.2, 1.2, 0.2), e0=(0.6, 0.0, 0.0), e1=(0.0, 0.0, 0.6),
                                  radiance=(10.0, 10.0, 10.0), **kw)  # emits downward (e0 × e1 = -y)


PANEL = _panel(temitter, device="cpu")


def test_area_emitter_matches_jax():
    aj = _panel(jemitter)
    rng = np.random.default_rng(5)
    # reference points below (front side) and above (back side) the panel
    p = rng.random((N, 3)).astype(np.float32) * np.float32([1.0, 1.6, 1.0])
    u = rng.random((N, 2)).astype(np.float32)
    for got, want in zip(PANEL.sample_from(t(p), t(u)), aj.sample_from(jnp.asarray(p), jnp.asarray(u))):
        _close(got, want)
    # rays: toward the panel, away from it, grazing its plane, missing it
    d = _unit(rng, N)
    d[:64] = np.float32([0.0, 1.0, 0.0])
    d[64:128] = np.float32([0.0, -1.0, 0.0])
    d[128:192] = np.float32([1.0, 0.0, 0.0])
    p[128:192, 1] = 1.2
    d[192:256] = np.float32([0.6, 0.8, 0.0])
    pj, dj = jnp.asarray(p), jnp.asarray(d)
    for name in ("ray_hit", "occlude_t"):
        _close_inf(getattr(PANEL, name)(t(p), t(d)), getattr(aj, name)(pj, dj))
    for got, want in zip(PANEL.eval_hit(t(p), t(d)), aj.eval_hit(pj, dj)):
        _close_inf(got, want)
    _close(PANEL.pdf_direction_from(t(p), t(d)), aj.pdf_direction_from(pj, dj))
    assert float(PANEL.power_proxy()) == pytest.approx(float(aj.power_proxy()), rel=1e-6)
    for name in ("plane_area", "bunny"):  # a constant emitter, a grid envmap (the gradient sky)
        got = float(tzoo.scene_rig_full(name, device="cpu")["emitter"].power_proxy())
        assert got == pytest.approx(float(jzoo.scene_rig_full(name)["emitter"].power_proxy()), rel=1e-5)


def _rig_scenes(name):
    """The rig of ``name`` in both packages, as the NEE functions see it (no
    SDF or camera is read)."""
    rj, rt = jzoo.scene_rig_full(name), tzoo.scene_rig_full(name, device="cpu")
    sj = JScene(sdf=None, bsdf=rj["bsdf"], emitter=rj["emitter"], cameras=None, area_emitter=rj["area_emitter"])
    st = Scene(sdf=None, bsdf=rt["bsdf"], emitter=rt["emitter"], cameras=None, area_emitter=rt["area_emitter"])
    return sj, st


@pytest.mark.parametrize("name", ["plane_area", "torus-shadow"])
def test_nee_mixture_matches_jax(name):
    """The NEE sampler, its density and the emitted radiance along a ray,
    with (``plane_area``: power-proportional mixture, finite shadow-ray
    distance) and without (``torus-shadow``) an area emitter."""
    sj, st = _rig_scenes(name)
    rng = np.random.default_rng(7)
    p = (rng.random((N, 3)) * np.float32([1.0, 1.2, 1.0])).astype(np.float32)
    u = rng.random((N, 2)).astype(np.float32)
    if st.area_emitter is not None:
        assert float(tinteg._area_select_prob(st)) == pytest.approx(float(jinteg._area_select_prob(sj)), rel=1e-6)
    got, want = tinteg._nee_sample(st, t(p), t(u)), jinteg._nee_sample(sj, jnp.asarray(p), jnp.asarray(u))
    for g, w in zip(got, want):
        _close_inf(g, w)
    d = np.concatenate([_unit(rng, N), to_np(got[0])])
    p2 = np.concatenate([p, p])
    _close(tinteg._emitter_pdf(st, t(p2), t(d)), jinteg._emitter_pdf(sj, jnp.asarray(p2), jnp.asarray(d)))
    for g, w in zip(tinteg._emitted_along(st, t(p2), t(d)), jinteg._emitted_along(sj, jnp.asarray(p2), jnp.asarray(d))):
        _close_inf(g, w)


# ---- the JAX package's behavioural checks (tests/test_area_emitter.py), on the port ----

def test_area_pdf_normalisation():
    """E[1/pdf] over sampled directions is the rect's solid angle."""
    p = torch.tensor([0.5, 0.3, 0.5])
    u = torch.rand(200_000, 2, generator=torch.Generator().manual_seed(0))
    _, _, pdf, _ = PANEL.sample_from(p, u)
    est = float(torch.where(pdf > 0, 1.0 / pdf.clamp_min(1e-12), torch.zeros_like(pdf)).mean())
    uq = (torch.arange(256) + 0.5) / 256
    uu, vv = torch.meshgrid(uq, uq, indexing="ij")
    q = PANEL.corner + uu.reshape(-1, 1) * PANEL.e0 + vv.reshape(-1, 1) * PANEL.e1
    vec = q - p
    r = vec.norm(dim=-1)
    nl, area = PANEL._normal_area
    omega = float(torch.mean(torch.clamp_min(torch.sum(-(vec / r[:, None]) * nl, -1), 0.0) / r**2) * area)
    assert est == pytest.approx(omega, rel=0.02)


def test_area_pdf_matches_sampler():
    p = torch.tensor([0.45, 0.25, 0.6])
    u = torch.rand(512, 2, generator=torch.Generator().manual_seed(1))
    d, _, pdf, _ = PANEL.sample_from(p, u)
    pdf2 = PANEL.pdf_direction_from(p, d)
    m = pdf > 0
    np.testing.assert_allclose(to_np(pdf2[m]), to_np(pdf[m]), rtol=1e-3)


def test_area_ray_hit_faces_and_direct_view():
    o = torch.tensor([[0.5, 0.5, 0.5], [0.5, 2.0, 0.5]])
    d = torch.tensor([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    t_front, t_geo = PANEL.ray_hit(o, d), PANEL.occlude_t(o, d)
    # from below the front face is seen at t = 0.7; from above only the
    # geometry (the back face is dark)
    assert float(t_front[0]) == pytest.approx(0.7, rel=1e-5) and not torch.isfinite(t_front[1])
    assert float(t_geo[1]) == pytest.approx(0.8, rel=1e-5)
    scene = Scene(sdf=None, bsdf=None, emitter=temitter.ConstantEmitter.create((0.0, 0.0, 0.0), device="cpu"),
                  cameras=None, area_emitter=PANEL)
    rad, _ = tinteg._emitted_along(scene, o, d)
    np.testing.assert_allclose(to_np(rad), [[10.0, 10.0, 10.0], [0.0, 0.0, 0.0]], rtol=1e-5, atol=1e-6)


def test_mis_consistency_plane_area():
    """NEE-only and NEE + MIS BSDF sampling estimate the same image of the
    ``plane_area`` rig (they sample the same integral)."""
    rig = tzoo.scene_rig_full("plane_area", device="cpu")
    scene = Scene.create(tzoo.target_sdf("plane_area", 24, device="cpu"), bsdf=rig["bsdf"], emitter=rig["emitter"],
                         cameras=regular_cameras(1, resx=24, resy=24, device="cpu"),
                         area_emitter=rig["area_emitter"], device="cpu")
    base = tinteg.RenderConfig(spp=64)
    nee = to_np(tinteg.render(scene, 0, seed=0, cfg=base, device="cpu"))[..., :3]
    mis = to_np(tinteg.render(scene, 0, seed=1, cfg=dataclasses.replace(base, use_mis=True), device="cpu"))[..., :3]
    assert abs(nee.mean() - mis.mean()) / nee.mean() < 0.08, (nee.mean(), mis.mean())
