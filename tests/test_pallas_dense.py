"""The dense kernel (``pallas_dense``, interpreted) against ``moller``
over the OBJ scenes, its edge cases, and the backend choice."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tpu_pt
from tpu_pt import render, rng
from tpu_pt.intersect import _resolve, moller, pallas_dense
from tpu_pt.render import CameraArrays, camera_rays
from tpu_pt.scene.arrays import (BSDF_REFRACTION, build_scene_arrays,
                                 default_cornell_light)
from tpu_pt.vec3 import V3
import tpu_pt.vec3 as v3

SCENES = ("cornell_box", "cornell_box_mixed", "cornell_box_sphere",
          "cornell_box_monkey")


@functools.lru_cache(maxsize=None)
def _scene(name):
    from conftest import ASSETS
    return tpu_pt.load_scene(str(ASSETS / f"{name}.obj"))


def _wavefront(scene, n):
    """``n`` real wavefront rays: camera rays, then their first bounce."""
    m = (n + 1) // 2
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    pix = jnp.arange(m, dtype=jnp.uint32) * 7919 % (96 * 96)
    jx, jy = rng.uniform2(pix, 0, 0, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, 96, 96, jx, jy)
    hit = moller.intersect_closest(scene, o, d)
    z = rng.uniform4(pix, 0, 0, rng.STREAM_BOUNCE_A)[:3]
    sh = render._shade_hit(scene, tpu_pt.RenderConfig(), o, d, hit, z)
    o2 = v3.where(hit.hit, sh["new_origin"], o)
    d2 = v3.where(hit.hit, sh["new_dir"], d)
    cat = lambda a, b: V3(*(jnp.concatenate([x, y])[:n]  # noqa: E731
                            for x, y in zip(a, b)))
    return cat(o, o2), cat(d, d2)


def _shadow(scene, o, d, h):
    """NEE segments where the renderer traces them (``render._nee``)."""
    lz1, lz2 = rng.uniform2(jnp.arange(h.t.shape[0], dtype=jnp.uint32),
                            0, 0, rng.STREAM_BOUNCE_B)
    L = scene.light
    p = o + d * jnp.where(h.hit, h.t, 0.0)
    lp = V3(*(L.corner[k] + L.v1[k] * lz1 + L.v2[k] * lz2 for k in range(3)))
    to_l = lp - p
    ldir = v3.normalize(to_l)
    nrm = v3.faceforward(h.normal, -d, h.normal)
    ok = (h.hit & (scene.mat_bsdf[h.mat] != BSDF_REFRACTION)
          & (v3.dot(nrm, ldir) > 0.0)
          & (-v3.dot(V3(*L.normal), ldir) > 0.0))
    return p, ldir, jnp.where(ok, v3.length(to_l) - 0.01, 0.0)


# Rays grazing an edge shared by two triangles may pick either one under
# the two formulas (plane + edge functions against Möller-Trumbore).
AGREE = 0.999


@pytest.mark.parametrize("n", [1, 129, 5000])
@pytest.mark.parametrize("mode", ["closest", "closest_uv", "occluded"])
@pytest.mark.parametrize("name", SCENES)
def test_kernel_matches_moller(name, mode, n):
    scene = _scene(name)
    o, d = _wavefront(scene, n)
    ref = moller.intersect_closest(scene, o, d)
    if mode == "occluded":
        so, sd, st = _shadow(scene, o, d, ref)
        want = np.asarray(moller.intersect_occluded(scene, so, sd, st))
        got = np.asarray(pallas_dense.intersect_occluded(
            scene, so, sd, st, interpret=True))
        assert (got == want).mean() >= AGREE
        return
    uv = mode == "closest_uv"
    out = pallas_dense.intersect_closest(scene, o, d, want_uv=uv,
                                         interpret=True)
    hit = np.asarray(ref.hit)
    same = ((np.asarray(out.hit) == hit)
            & (np.asarray(out.tri) == np.asarray(ref.tri)))
    assert same.mean() >= AGREE
    m = same & hit
    # Hit points agree to 1e-3 scene units along the surface normal; along
    # the ray the gap grows as 1 / cos for grazing rays.
    cos = np.abs(np.asarray(v3.dot(ref.normal, d)))
    dt = np.abs(np.asarray(out.t) - np.asarray(ref.t))
    assert (dt * cos)[m].max(initial=0.0) <= 1e-3
    assert (np.asarray(out.t)[same & ~hit] == moller.T_FAR).all()
    np.testing.assert_array_equal(np.asarray(out.mat)[same],
                                  np.asarray(ref.mat)[same])
    for c in "xyz":
        np.testing.assert_array_equal(
            np.asarray(getattr(out.normal, c))[same],
            np.asarray(getattr(ref.normal, c))[same])
    for c in "uv":
        got = np.asarray(getattr(out, c))
        if uv:
            np.testing.assert_allclose(got[m], np.asarray(getattr(ref, c))[m],
                                       rtol=0, atol=2e-4)
        else:
            assert not got.any()


_MATS = [dict(diffuse=(0.8, 0.8, 0.8), emission=(0, 0, 0), roughness=0.5,
              metallic=0.0, ior=1.5, bsdf=0),
         dict(diffuse=(1, 1, 1), emission=(0, 0, 0), roughness=0.0,
              metallic=0.0, ior=1.5, bsdf=BSDF_REFRACTION)]


def _tri_scene(tris, mats=None):
    tris = np.asarray(tris, np.float32)
    verts = tris.reshape(-1, 3)
    faces = np.arange(verts.shape[0]).reshape(-1, 3)
    mats = np.zeros(len(tris), np.int64) if mats is None else np.asarray(mats)
    return build_scene_arrays(verts, faces, mats, _MATS,
                              light=default_cornell_light())


def _rays(o, d):
    o = np.asarray(o, np.float32).reshape(-1, 3)
    d = np.asarray(d, np.float32).reshape(-1, 3)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return (V3(*(jnp.asarray(o[:, k]) for k in range(3))),
            V3(*(jnp.asarray(d[:, k]) for k in range(3))))


def test_kernel_degenerate_parallel_and_padding():
    """A zero-area triangle and a triangle parallel to the rays never
    hit; padding rows (the table is padded to whole blocks) never hit;
    the one proper triangle is found behind them."""
    tris = [[[0, 0, 5], [1, 0, 5], [2, 0, 5]],         # degenerate (line)
            [[-1, -1, 3], [1, -1, 3], [0, 1, 3]],      # proper, z = 3
            [[-1, 0, 1], [1, 0, 1], [0, 0, 2]]]        # in the plane y = 0
    scene = _tri_scene(tris)
    assert pallas_dense.pack_tris(scene).shape[1] % pallas_dense.BLOCK_T == 0
    xs = np.linspace(-0.4, 0.4, 37)
    o, d = _rays([[x, 0.0, -1.0] for x in xs], [[0, 0, 1]] * len(xs))
    h = pallas_dense.intersect_closest(scene, o, d, interpret=True)
    assert np.asarray(h.hit).all()
    assert (np.asarray(h.tri) == 1).all()
    np.testing.assert_allclose(np.asarray(h.t), 4.0, atol=1e-5)
    # Rays running along the parallel triangle's plane miss everything.
    o2, d2 = _rays([[0.0, 0.0, 0.0]] * 3, [[1, 0, 0], [0, 0, 1e-3 - 1],
                                          [-1, 0, 0]])
    h2 = pallas_dense.intersect_closest(scene.replace(
        tri_valid=scene.tri_valid.at[1].set(False)), o2, d2, interpret=True)
    assert not np.asarray(h2.hit).any()
    assert not np.asarray(h2.normal.x).any()


@pytest.mark.parametrize("tmin,tmax,expect", [(0.01, 1e16, True),
                                              (4.5, 1e16, False),
                                              (0.01, 3.9, False),
                                              (3.9, 4.1, True)])
def test_kernel_tmin_tmax(tmin, tmax, expect):
    scene = _tri_scene([[[-1, -1, 3], [1, -1, 3], [0, 1, 3]]])
    o, d = _rays([[0.0, -0.2, -1.0]], [[0, 0, 1]])
    h = pallas_dense.intersect_closest(scene, o, d, tmin=tmin, tmax=tmax,
                                       interpret=True)
    assert bool(h.hit[0]) is expect
    occ = pallas_dense.intersect_occluded(
        scene.replace(occ_index=None, num_occluders=-1), o, d,
        jnp.asarray([tmax], jnp.float32), tmin=tmin, interpret=True)
    assert bool(occ[0]) is expect


def test_kernel_refractive_does_not_occlude():
    """Refractive triangles pass shadow rays (cu:672-681) but still take
    closest hits."""
    scene = _tri_scene([[[-1, -1, 3], [1, -1, 3], [0, 1, 3]]], mats=[1])
    scene = scene.replace(occ_index=None, num_occluders=-1)
    o, d = _rays([[0.0, -0.2, -1.0]], [[0, 0, 1]])
    assert not bool(pallas_dense.intersect_occluded(
        scene, o, d, jnp.asarray([10.0]), interpret=True)[0])
    assert bool(pallas_dense.intersect_closest(scene, o, d,
                                               interpret=True).hit[0])


def test_kernel_raises_off_gpu_without_interpret(cornell_scene):
    o, d = _rays([[278.0, 273.0, -800.0]], [[0, 0, 1]])
    with pytest.raises(RuntimeError, match="compile only for a GPU"):
        pallas_dense.intersect_closest(cornell_scene, o, d)
    with pytest.raises(RuntimeError, match="compile only for a GPU"):
        pallas_dense.intersect_occluded(cornell_scene, o, d,
                                        jnp.asarray([1e3]))


@pytest.mark.parametrize("backend,name,intersector,want", [
    ("cpu", "cornell_box_mixed", "auto", "bruteforce"),
    ("gpu", "cornell_box_mixed", "auto", "pallas"),
    ("gpu", "cornell_box_monkey", "auto", "pallas"),
    ("cpu", "big", "auto", "bvh"),
    ("gpu", "big", "auto", "bvh"),
    ("gpu", "big_no_bvh", "auto", "pallas"),
    ("cpu", "big_no_bvh", "auto", "bruteforce"),
    ("gpu", "mid", "auto", "pallas"),
    ("cpu", "mid", "auto", "bvh"),
    ("gpu", "cornell_box_mixed", "bruteforce", "bruteforce"),
    ("cpu", "cornell_box_mixed", "bvh", "bvh"),
])
def test_resolve_backend(monkeypatch, backend, name, intersector, want):
    """``auto`` picks the LBVH past the device's crossover (when the
    scene has one), else the kernel on a GPU and the jnp sweep
    elsewhere; an explicit intersector is taken as given."""
    import types
    from tpu_pt import intersect
    if name == "mid":
        # Past the CPU's crossover, below the GPU's.
        scene = types.SimpleNamespace(
            num_tris_padded=intersect.GPU_BVH_CROSSOVER_TRIS - 128,
            bvh=object())
    elif name.startswith("big"):
        crossover = max(intersect.GPU_BVH_CROSSOVER_TRIS,
                        intersect.BVH_CROSSOVER_TRIS)
        scene = types.SimpleNamespace(
            num_tris_padded=crossover + 128,
            bvh=None if name == "big_no_bvh" else object())
    else:
        scene = _scene(name)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    cfg = tpu_pt.RenderConfig(intersector=intersector)
    assert _resolve(scene, cfg) == want
