"""The dense Pallas brute-force intersector (``pallas_dense``) against the
jnp reference, and renders through it. The kernels run in the Pallas
interpreter here; chip_smoke.py runs them compiled on a GPU."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest

from tpu_pt import rng
from tpu_pt.intersect import moller, pallas_dense
from tpu_pt.render import CameraArrays, camera_rays
import tpu_pt


def closest(scene, o, d, **kw):
    return pallas_dense.intersect_closest(scene, o, d, interpret=True, **kw)


def occluded(scene, o, d, tmax, **kw):
    return pallas_dense.intersect_occluded(scene, o, d, tmax,
                                           interpret=True, **kw)


def use_kernel(monkeypatch):
    """Route the renderer's intersector choice to the interpreted kernel,
    bound as the path tracer binds it (``want_uv=False``)."""
    import tpu_pt.render
    monkeypatch.setattr(
        tpu_pt.render, "get_intersectors",
        lambda s, c, want_uv=False: (
            functools.partial(closest, s, want_uv=want_uv),
            functools.partial(occluded, s)))


@pytest.fixture(scope="module")
def rays(cornell_scene):
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    n = 2048
    pix = jnp.arange(n, dtype=jnp.uint32) * 97 % (64 * 64)
    jx, jy = rng.uniform2(pix, 0, 0, 0)
    o, d = camera_rays(cam, pix.astype(jnp.uint32), 64, 64, jx, jy)
    return o.to_array(), d.to_array()


def test_closest_matches_reference(cornell_scene, rays):
    o, d = rays
    ref = moller.intersect_closest(cornell_scene, o, d)
    out = closest(cornell_scene, o, d)
    np.testing.assert_array_equal(np.asarray(ref.hit), np.asarray(out.hit))
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(out.tri))
    np.testing.assert_allclose(np.asarray(ref.t), np.asarray(out.t),
                               rtol=1e-6)


def test_closest_matches_reference_mixed(mixed_scene, rays):
    o, d = rays
    ref = moller.intersect_closest(mixed_scene, o, d)
    out = closest(mixed_scene, o, d)
    np.testing.assert_array_equal(np.asarray(ref.tri), np.asarray(out.tri))
    np.testing.assert_allclose(np.asarray(ref.t), np.asarray(out.t),
                               rtol=1e-6)


def test_occluded_matches_reference(mixed_scene, rays):
    o, d = rays
    # Shadow-ray-like: from hit points toward the light.
    h = moller.intersect_closest(mixed_scene, o, d)
    p = o + h.t[..., None] * d * 0.999
    light = jnp.asarray([278.0, 547.0, 279.5])
    to_l = light - p
    dist = jnp.linalg.norm(to_l, axis=-1)
    ldir = to_l / jnp.maximum(dist, 1e-6)[..., None]
    tmax = dist - 0.01
    ref = moller.intersect_occluded(mixed_scene, p, ldir, tmax)
    out = occluded(mixed_scene, p, ldir, tmax)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_occluded_quirk_mode(mixed_scene, rays):
    o, d = rays
    tmax = jnp.full((o.shape[0],), 1e6)
    ref = moller.intersect_occluded(mixed_scene, o, d, tmax,
                                    quirk_first_hit=True)
    out = occluded(mixed_scene, o, d, tmax, quirk_first_hit=True)
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(out))


def test_nonaligned_ray_count(cornell_scene):
    # N not a multiple of BLOCK_R exercises the padding path.
    o = jnp.zeros((333, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (333, 3))
    o = o.at[:, 0].set(278.0)
    o = o.at[:, 2].set(279.0)
    out = closest(cornell_scene, o, d)
    ref = moller.intersect_closest(cornell_scene, o, d)
    np.testing.assert_allclose(np.asarray(ref.t), np.asarray(out.t),
                               rtol=1e-6)


def test_lean_single_matches_full(mixed_scene, rays):
    """``want_uv=False`` (the path tracer's binding) drops only the
    barycentric carry: every other field equals the ``want_uv=True``
    call exactly, u/v read as zeros, and the uv call's barycentrics
    match moller's."""
    o, d = rays
    full = closest(mixed_scene, o, d, want_uv=True)
    lean = closest(mixed_scene, o, d, want_uv=False)
    ref = moller.intersect_closest(mixed_scene, o, d)
    np.testing.assert_array_equal(np.asarray(full.hit), np.asarray(lean.hit))
    np.testing.assert_array_equal(np.asarray(full.tri), np.asarray(lean.tri))
    np.testing.assert_array_equal(np.asarray(full.t), np.asarray(lean.t))
    np.testing.assert_array_equal(np.asarray(full.mat), np.asarray(lean.mat))
    for c in "xyz":
        np.testing.assert_array_equal(
            np.asarray(getattr(full.normal, c)),
            np.asarray(getattr(lean.normal, c)))
    assert not np.asarray(lean.u).any() and not np.asarray(lean.v).any()
    hit = np.asarray(ref.hit)
    np.testing.assert_allclose(np.asarray(full.u)[hit],
                               np.asarray(ref.u)[hit], rtol=0, atol=2e-4)
    np.testing.assert_allclose(np.asarray(full.v)[hit],
                               np.asarray(ref.v)[hit], rtol=0, atol=2e-4)


def test_render_with_pallas_matches_bruteforce(cornell_scene, monkeypatch):
    from tpu_pt.render import render_wavefront
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    cfg = tpu_pt.RenderConfig(width=32, height=32, spp=2, max_depth=3,
                              use_direct_lighting=True,
                              use_importance_sampling=True,
                              intersector="bruteforce")
    ra, _ = render_wavefront(cornell_scene, cam, cfg, 0, 32 * 32, 0)
    use_kernel(monkeypatch)
    rb, _ = render_wavefront(cornell_scene, cam, cfg, 0, 32 * 32, 0)
    # The backends use different intersection algebra (Möller vs
    # plane+edge), so a handful of samples near geometric boundaries
    # (shadow tmax, RR threshold) legitimately land ~1e-4 apart.
    np.testing.assert_allclose(np.asarray(ra), np.asarray(rb), atol=1e-3)
    assert np.mean(np.abs(np.asarray(ra) - np.asarray(rb))) < 1e-6


def test_deep_render_cross_backend_agreement(mixed_scene, monkeypatch):
    """Regression: at 8 bounces on the mixed-BSDF scene, the kernel and
    bruteforce must agree tightly. Caught a real bug once: the jnp
    backend's mask-matmul normal/material select ran at default (bf16)
    precision, perturbing normals by ~1e-3 and diverging whole paths."""
    from tpu_pt.render import render_wavefront
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    cfg_a = tpu_pt.RenderConfig(width=64, height=64, spp=4, max_depth=8,
                                use_direct_lighting=True,
                                use_importance_sampling=True,
                                intersector="bruteforce")
    cfg_b = cfg_a.with_(scheduler="regen")
    ra, _ = render_wavefront(mixed_scene, cam, cfg_a, 0, 64 * 64, 0)
    use_kernel(monkeypatch)
    rb, _ = render_wavefront(mixed_scene, cam, cfg_b, 0, 64 * 64, 0)
    # Cross-formula (Möller vs plane+edge) boundary flips: rare samples
    # may diverge, but the image-mean error must stay tiny.
    diff = np.abs(np.asarray(ra) - np.asarray(rb))
    assert np.mean(diff) < 1e-5, f"mean {np.mean(diff)}"
    assert np.quantile(diff, 0.999) < 1e-3, f"p999 {np.quantile(diff, .999)}"


def test_trace_pixel_matches_renderer(mixed_scene):
    """The debug single-path replay must reproduce the renderer's radiance
    for its pixel (counter RNG => bitwise replay)."""
    from tpu_pt import debug
    from tpu_pt.render import render_wavefront

    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    cfg = tpu_pt.RenderConfig(width=16, height=16, spp=1, max_depth=4,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    radiance, _ = render_wavefront(mixed_scene, cam, cfg, 0, 16 * 16, 0)
    x, y = 5, 7
    recs = debug.trace_pixel(mixed_scene, cam, cfg, x, y)
    assert recs and recs[-1]["done"]
    assert recs[-1]["reason"] in ("MISS", "MAX_DEPTH", "RUSSIAN_ROULETTE",
                                  "LIGHT_HIT")
    total = np.sum([r["contrib"] for r in recs], axis=0)
    np.testing.assert_allclose(
        total, np.asarray(radiance)[y * 16 + x], rtol=1e-5, atol=1e-7)
    assert "d0:" in debug.format_trace(recs)
