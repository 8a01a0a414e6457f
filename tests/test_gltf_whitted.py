"""glTF loader, whitted direct-lighting pipeline, analytic primitives."""

import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest

import tpu_pt
from tpu_pt.camera import Camera
from tpu_pt.render import CameraArrays, init_accum
from tpu_pt.intersect import primitives as prims
from tpu_pt.vec3 import V3

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def gltf_assets(assets_dir):
    if not (assets_dir / "pbr_test.gltf").exists():
        subprocess.run([sys.executable,
                        str(REPO / "tools" / "make_gltf_assets.py")],
                       check=True)
    return assets_dir


@pytest.fixture(scope="module")
def pbr_scene(gltf_assets):
    from tpu_pt.scene.gltf import load_gltf
    return load_gltf(str(gltf_assets / "pbr_test.gltf"))


@pytest.fixture(scope="module")
def pbr_camera():
    return CameraArrays.from_camera(Camera(
        eye=np.array([6.0, 4.5, 7.0], np.float32),
        lookat=np.array([0.0, 0.8, 0.0], np.float32), fov_y=40.0))


def test_gltf_geometry_and_materials(pbr_scene):
    ws = pbr_scene
    assert int(np.asarray(ws.geom.tri_valid).sum()) > 700
    assert ws.base_color.shape[0] == 4
    m = np.asarray(ws.metallic)
    assert m[2] == 1.0 and m[0] == 0.0
    assert len(ws.textures) == 3    # checker, bump normals, MR
    assert int(np.asarray(ws.ntex_id).max()) >= 0
    assert int(np.asarray(ws.mrtex_id)[2]) >= 0   # sphere MR map
    assert int(np.asarray(ws.etex_id)[1]) >= 0    # red cube emissive
    assert int(ws.tex_id[0]) == 0 and int(ws.tex_id[1]) == -1
    assert int(ws.alpha_mode[3]) == 2  # BLEND
    # Light transformed by its node.
    np.testing.assert_allclose(np.asarray(ws.light_pos)[0], [3, 6, 3])


def test_gltf_glb_equivalence(gltf_assets):
    from tpu_pt.scene.gltf import load_gltf
    a = load_gltf(str(gltf_assets / "pbr_test.gltf"))
    b = load_gltf(str(gltf_assets / "pbr_test.glb"))
    np.testing.assert_allclose(np.asarray(a.geom.tri_v0),
                               np.asarray(b.geom.tri_v0))
    np.testing.assert_allclose(np.asarray(a.vtx_attr),
                               np.asarray(b.vtx_attr))


def test_gltf_node_transforms(pbr_scene):
    """The scaled cube instance must produce world-space triangles at its
    node translation with half extent."""
    v0 = np.asarray(pbr_scene.geom.tri_v0)
    valid = np.asarray(pbr_scene.geom.tri_valid)
    pts = v0[valid]
    # Instance at (2.5, 0.4, 2.0), scale 0.5 on a 1.5 cube -> extent 0.75.
    near = np.linalg.norm(pts - np.array([2.5, 0.4, 2.0]), axis=1) < 0.7
    assert near.any()


def test_whitted_render_smoke(pbr_scene, pbr_camera):
    from tpu_pt.whitted import render_whitted_frame
    cfg = tpu_pt.RenderConfig(width=64, height=64, spp=2, max_depth=4,
                              background=(0.1, 0.15, 0.25),
                              intersector="bruteforce")
    accum = init_accum(cfg)
    accum, img, stats = render_whitted_frame(pbr_scene, pbr_camera, cfg, 0, accum)
    a = np.asarray(accum)
    assert np.isfinite(a).all()
    assert a.max() > 0.1
    # Background pixels present (top corner) with the configured color.
    np.testing.assert_allclose(a[-1, 0], [0.1, 0.15, 0.25], atol=0.02)


def test_whitted_shadows_and_highlight(pbr_scene, pbr_camera):
    from tpu_pt.whitted import render_whitted_wavefront
    cfg = tpu_pt.RenderConfig(width=96, height=96, spp=4, max_depth=4,
                              background=(0.0, 0.0, 0.0),
                              intersector="bruteforce")
    rad, _ = render_whitted_wavefront(pbr_scene, pbr_camera, cfg, 0,
                                   96 * 96, 0)
    img = np.asarray(rad).reshape(96, 96, 3)
    # The metallic sphere should produce a strong specular peak.
    assert img.max() > 1.0
    # Shadowed ground exists: some ground pixels much darker than lit ones.
    ground = img[10:40]
    assert ground.max() > 4 * max(ground.min(), 1e-3)


def test_whitted_deterministic(pbr_scene, pbr_camera):
    from tpu_pt.whitted import render_whitted_wavefront
    cfg = tpu_pt.RenderConfig(width=32, height=32, spp=2, max_depth=4,
                              intersector="bruteforce")
    a, _ = render_whitted_wavefront(pbr_scene, pbr_camera, cfg, 0, 32 * 32, 0)
    b, _ = render_whitted_wavefront(pbr_scene, pbr_camera, cfg, 0, 32 * 32, 0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_whitted_pixelq_matches_wide(pbr_scene, pbr_camera):
    """The pixelq work-queue scheduler traces the exact same paths as
    the wide while_loop (counter RNG keys every draw by (pixel, sample,
    depth)), so per-path stats must match EXACTLY; radiance only up to
    f32 accumulation order."""
    from tpu_pt.whitted import render_whitted_wavefront
    mk = lambda s: tpu_pt.RenderConfig(      # noqa: E731
        width=48, height=48, spp=4, max_depth=6, scheduler=s,
        background=(0.1, 0.15, 0.25), intersector="bruteforce")
    a, sa = render_whitted_wavefront(pbr_scene, pbr_camera, mk("pixelq"),
                                     0, 48 * 48, 0)
    b, sb = render_whitted_wavefront(pbr_scene, pbr_camera, mk("scan"),
                                     0, 48 * 48, 0)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                               rtol=1e-5, atol=1e-5)
    assert float(sa.rays_traced) == float(sb.rays_traced)
    assert float(sa.shadow_rays) == float(sb.shadow_rays)
    np.testing.assert_array_equal(np.asarray(sa.done_histogram),
                                  np.asarray(sb.done_histogram))


def test_texture_uv_transform(pbr_scene, pbr_camera):
    """Per-material UV affine (KHR_texture_transform / the reference's
    texcoord offset+rotation+scale, cuda/LocalShading.h): a 3x UV scale
    must change textured pixels and leave untextured materials alone."""
    import jax.numpy as jnp
    from tpu_pt.whitted import render_whitted_wavefront

    cfg = tpu_pt.RenderConfig(width=32, height=32, spp=2, max_depth=2,
                              intersector="bruteforce")
    base = np.asarray(render_whitted_wavefront(
        pbr_scene, pbr_camera, cfg, 0, 32 * 32, 0)[0])
    uvx = np.tile(np.array([3.0, 0, 0, 0, 3.0, 0], np.float32),
                  (pbr_scene.tex_id.shape[0], 1))
    scaled_scene = pbr_scene.replace(tex_uvx=jnp.asarray(uvx))
    scaled = np.asarray(render_whitted_wavefront(
        scaled_scene, pbr_camera, cfg, 0, 32 * 32, 0)[0])
    has_tex = int(np.asarray(pbr_scene.tex_id).max()) >= 0
    assert has_tex
    assert not np.array_equal(base, scaled)    # textured pattern moved
    # Identity transform reproduces the original exactly.
    ident = np.asarray(render_whitted_wavefront(
        pbr_scene.replace(tex_uvx=pbr_scene.tex_uvx), pbr_camera, cfg,
        0, 32 * 32, 0)[0])
    np.testing.assert_array_equal(base, ident)


def test_normal_mapping(pbr_scene, pbr_camera):
    """Tangent-space normal mapping (whitted.cu normal mapping parity):
    the bump-mapped ground must shade differently from a flat-normal
    render of the same scene, and only where the mapped material is."""
    from tpu_pt.whitted import render_whitted_wavefront

    assert int(np.asarray(pbr_scene.ntex_id).max()) >= 0
    cfg = tpu_pt.RenderConfig(width=64, height=64, spp=2, max_depth=2,
                              intersector="bruteforce")
    bumped = np.asarray(render_whitted_wavefront(
        pbr_scene, pbr_camera, cfg, 0, 64 * 64, 0)[0])
    flat_scene = pbr_scene.replace(
        ntex_id=jnp.full_like(pbr_scene.ntex_id, -1))
    flat = np.asarray(render_whitted_wavefront(
        flat_scene, pbr_camera, cfg, 0, 64 * 64, 0)[0])
    d = np.abs(bumped - flat).sum(axis=1)
    assert (d > 1e-6).sum() > 500          # the ground visibly changed
    assert np.isfinite(bumped).all()


def test_checker_phong_material(pbr_scene, pbr_camera):
    """CheckerPhong (shading.cu:169-206): a KIND_CHECKER ground must show
    both parameter sets' diffuse colors in a spatial checkerboard."""
    from tpu_pt.scene.gltf import KIND_CHECKER
    from tpu_pt.whitted import render_whitted_wavefront

    kind = np.asarray(pbr_scene.kind).copy()
    kind[0] = KIND_CHECKER                      # ground material
    c2 = np.asarray(pbr_scene.checker2).copy()
    c2[0, 0:3] = [0.05, 0.4, 0.05]              # Kd2 green
    c2[0, 10:12] = [2.0, 2.0]                   # inv checker size
    base = np.asarray(pbr_scene.base_color).copy()
    base[0, 0:3] = [0.4, 0.05, 0.05]            # Kd1 red
    tex = np.asarray(pbr_scene.tex_id).copy()
    tex[0] = -1                                 # procedural, untextured
    scene = pbr_scene.replace(kind=jnp.asarray(kind),
                              checker2=jnp.asarray(c2),
                              base_color=jnp.asarray(base),
                              tex_id=jnp.asarray(tex))
    cfg = tpu_pt.RenderConfig(width=64, height=64, spp=2, max_depth=2,
                              intersector="bruteforce")
    img = np.asarray(render_whitted_wavefront(
        scene, pbr_camera, cfg, 0, 64 * 64, 0)[0]).reshape(64, 64, 3)
    ground = img[5:30]                          # ground rows
    reddish = (ground[..., 0] > 2 * ground[..., 1]) & (ground[..., 0] > .01)
    greenish = (ground[..., 1] > 2 * ground[..., 0]) & (ground[..., 1] > .01)
    assert reddish.sum() > 20 and greenish.sum() > 20


def test_mr_and_emissive_textures(pbr_scene, pbr_camera):
    """Metallic-roughness (G/B channels x factors) and emissive (sRGB x
    factor) textures — MaterialData.h:83,129 parity."""
    from tpu_pt.whitted import render_whitted_wavefront

    cfg = tpu_pt.RenderConfig(width=64, height=64, spp=2, max_depth=2,
                              intersector="bruteforce")
    img = np.asarray(render_whitted_wavefront(
        pbr_scene, pbr_camera, cfg, 0, 64 * 64, 0)[0])
    no_tex = pbr_scene.replace(
        mrtex_id=jnp.full_like(pbr_scene.mrtex_id, -1),
        etex_id=jnp.full_like(pbr_scene.etex_id, -1))
    img0 = np.asarray(render_whitted_wavefront(
        no_tex, pbr_camera, cfg, 0, 64 * 64, 0)[0])
    d = np.abs(img - img0).sum(axis=1)
    assert (d > 1e-6).sum() > 100          # sphere + cube shading changed
    assert np.isfinite(img).all()


# ---------------------------------------------------------------------------
# Analytic primitives (geometry.cu / sphere.cu parity)
# ---------------------------------------------------------------------------

def test_sphere_intersect():
    p = prims.make_primitives([dict(kind=prims.PRIM_SPHERE,
                                    center=(0, 0, 5), radius=1.0, mat=3)])
    o = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 3.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    h = prims.intersect_primitives(p, o, d)
    assert bool(h.hit[0]) and not bool(h.hit[1])
    np.testing.assert_allclose(float(h.t[0]), 4.0, atol=1e-5)
    assert int(h.mat[0]) == 3
    np.testing.assert_allclose(
        [float(h.normal.x[0]), float(h.normal.y[0]), float(h.normal.z[0])],
        [0, 0, -1], atol=1e-5)


def test_sphere_inside_hits_far_side():
    p = prims.make_primitives([dict(kind=prims.PRIM_SPHERE,
                                    center=(0, 0, 0), radius=2.0)])
    o = jnp.asarray([[0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    h = prims.intersect_primitives(p, o, d)
    np.testing.assert_allclose(float(h.t[0]), 2.0, atol=1e-5)


def test_sphere_shell():
    p = prims.make_primitives([dict(kind=prims.PRIM_SPHERE_SHELL,
                                    center=(0, 0, 0), radius1=1.0,
                                    radius2=2.0)])
    o = jnp.asarray([[0.0, 0.0, -5.0], [0.0, 0.0, 0.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]])
    h = prims.intersect_primitives(p, o, d)
    np.testing.assert_allclose(float(h.t[0]), 3.0, atol=1e-5)  # outer entry
    np.testing.assert_allclose(float(h.t[1]), 1.0, atol=1e-5)  # inner wall


def test_parallelogram():
    p = prims.make_primitives([dict(kind=prims.PRIM_PARALLELOGRAM,
                                    anchor=(0, 0, 3), v1=(2, 0, 0),
                                    v2=(0, 2, 0))])
    o = jnp.asarray([[1.0, 1.0, 0.0], [3.0, 1.0, 0.0], [1.0, 1.0, 5.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0], [0.0, 0.0, -1.0]])
    h = prims.intersect_primitives(p, o, d)
    assert bool(h.hit[0])        # inside extent
    assert not bool(h.hit[1])    # outside v1 range
    assert bool(h.hit[2])        # two-sided from behind
    np.testing.assert_allclose(float(h.t[0]), 3.0, atol=1e-5)


def test_combine_hits_with_triangles(cornell_scene):
    from tpu_pt.intersect import moller
    p = prims.make_primitives([dict(kind=prims.PRIM_SPHERE,
                                    center=(278, 273, 100), radius=50.0,
                                    mat=0)])
    o = jnp.asarray([[278.0, 273.0, -900.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    tri_hit = moller.intersect_closest(cornell_scene, o, d)
    prim_hit = prims.intersect_primitives(p, o, d)
    combined = prims.combine_hits(tri_hit, prim_hit)
    # Sphere at z=100-50=50 distance 950 is closer than the tall block.
    np.testing.assert_allclose(float(combined.t[0]), 950.0, atol=1e-3)


def test_select_rows_matches_gather(pbr_scene):
    """The one-hot matmul row select replacing the per-bounce
    vtx_attr/tri_tangent gathers must match the gather exactly down to
    the documented bf16 exponent floor (residual split parts below
    ~1.2e-38 flush; everything representable survives bitwise), at both
    the single-level and the forced two-level shape."""
    from tpu_pt import whitted as wh
    ws = pbr_scene
    tbl = jnp.concatenate([ws.vtx_attr, ws.tri_tangent], axis=1)
    t = tbl.shape[0]
    ids = (jnp.arange(733, dtype=jnp.int32) * 97) % t
    ref = np.asarray(tbl[ids])
    out = np.asarray(wh._select_rows(tbl, ids))
    np.testing.assert_allclose(ref, out, rtol=0, atol=1.2e-38)
    # Force the two-level path regardless of table size.
    old = wh._DIRECT_SELECT_MAX
    try:
        wh._DIRECT_SELECT_MAX = 1
        out2 = np.asarray(wh._select_rows(tbl, ids))
    finally:
        wh._DIRECT_SELECT_MAX = old
    np.testing.assert_allclose(ref, out2, rtol=0, atol=1.2e-38)


def test_whitted_primitives_from_gltf_extras(gltf_assets, pbr_camera):
    """glTF document extras can declare analytic primitives
    (tpu_pt_primitives), which render through the whitted pipeline with
    their analytic normals and glTF materials — the reference's
    custom-primitive whitted SBT binding (Scene.cpp:1368-1450,
    geometry.cu/sphere.cu) reachable from the asset itself."""
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_wavefront
    ws = load_gltf(str(gltf_assets / "pbr_prims.gltf"))
    assert ws.geom.prims is not None and ws.geom.prims.count == 3
    base = load_gltf(str(gltf_assets / "pbr_test.gltf"))
    cfg = tpu_pt.RenderConfig(width=72, height=72, spp=2, max_depth=4,
                              background=(0.0, 0.0, 0.0),
                              intersector="bruteforce")
    rad, _ = render_whitted_wavefront(ws, pbr_camera, cfg, 0, 72 * 72, 0)
    ref, _ = render_whitted_wavefront(base, pbr_camera, cfg, 0,
                                      72 * 72, 0)
    img = np.asarray(rad).reshape(72, 72, 3)
    refi = np.asarray(ref).reshape(72, 72, 3)
    assert np.isfinite(img).all()
    # The primitives change a substantial set of pixels vs the base
    # scene (they occlude geometry and cast point-light shadows).
    changed = (np.abs(img - refi).max(axis=-1) > 1e-3).mean()
    assert changed > 0.05


def test_whitted_curves_from_gltf_extras(gltf_assets, pbr_camera):
    """glTF document extras can declare swept-sphere curves
    (tpu_pt_curves, the mirror of tpu_pt_primitives) — the reference's
    round-curve geometry types (GeometryData.h:95-127) reachable from a
    glTF asset, shading with the exact swept-sphere normal
    (curve.h:312-443) through the whitted pipeline, and matching the
    committed golden."""
    from tpu_pt import film
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    ws = load_gltf(str(gltf_assets / "pbr_prims.gltf"))
    # 5-point cubic b-spline -> 2 sliding-window segments,
    # 4-point catmullrom -> 1.
    assert ws.geom.curves is not None and ws.geom.curves.count == 3
    cfg = tpu_pt.RenderConfig(width=128, height=128, spp=8, max_depth=8,
                              background=(0.1, 0.15, 0.25),
                              intersector="bruteforce")
    accum = init_accum(cfg)
    img = None
    for f in range(2):
        accum, img, _ = render_whitted_frame(ws, pbr_camera, cfg, f, accum)
    golden = film.read_png(
        str(REPO / "tests" / "goldens" / "whitted-prims-curves.png")
    ).astype(np.float32)
    ours = tpu_pt.image_to_host(img).astype(np.float32)
    err = film.rmse(ours / 255.0, golden / 255.0)
    assert err < 0.01, f"whitted prims+curves: RMSE {err:.4f}"


def _instanced_gltf(tmp_path, n_instances: int) -> str:
    """Minimal valid glTF: one triangle mesh instanced n times."""
    import base64
    import json
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    blob = pos.tobytes()
    doc = dict(
        asset=dict(version="2.0"),
        scene=0,
        scenes=[dict(nodes=list(range(n_instances)))],
        nodes=[dict(mesh=0, translation=[float(i), 0.0, 0.0])
               for i in range(n_instances)],
        meshes=[dict(primitives=[dict(attributes=dict(POSITION=0))])],
        accessors=[dict(bufferView=0, componentType=5126, count=3,
                        type="VEC3")],
        bufferViews=[dict(buffer=0, byteOffset=0, byteLength=len(blob))],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
    )
    path = tmp_path / f"instanced_{n_instances}.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def test_instancing_flatten_guardrail(tmp_path, monkeypatch):
    """Instance flattening is bounded: a 500-instance scene whose
    world-space expansion crosses the bound raises a clear error naming
    the amplification (the reference keeps an IAS, Scene.cpp:1134-1213;
    tpu_pt flattens — the guardrail makes the O(instances x mesh) memory
    trade explicit instead of exhausting memory). The default bound
    comes from the device's memory."""
    from tpu_pt.scene import gltf
    path = _instanced_gltf(tmp_path, 500)
    with pytest.raises(ValueError, match="instance flattening"):
        gltf.load_gltf(path, max_flat_tris=100)
    # Raising the bound loads the same file: 500 world-space triangles.
    ws = gltf.load_gltf(path, max_flat_tris=1000)
    assert int(np.asarray(ws.geom.tri_valid).sum()) == 500
    # The default bound is the device memory's share over the bytes per
    # flattened triangle.
    per_tri = gltf._BYTES_PER_FLAT_TRI
    monkeypatch.setattr(gltf, "_device_bytes_limit", lambda: 400 * per_tri)
    assert gltf.default_max_flat_tris() == int(
        400 * per_tri * gltf._FLAT_MEMORY_SHARE) // per_tri
    with pytest.raises(ValueError, match="derived from the device"):
        gltf.load_gltf(path)
    monkeypatch.setattr(gltf, "_device_bytes_limit",
                        lambda: 1000 * per_tri)
    ws2 = gltf.load_gltf(path)
    assert int(np.asarray(ws2.geom.tri_valid).sum()) == 500


def test_device_bytes_limit_reads_device_or_host():
    """The guardrail's memory limit: the device's reported bytes_limit,
    or the host's physical memory for a device that reports none."""
    import os
    import jax
    from tpu_pt.scene import gltf
    stats = jax.local_devices()[0].memory_stats() or {}
    want = stats.get("bytes_limit") or (os.sysconf("SC_PAGE_SIZE")
                                        * os.sysconf("SC_PHYS_PAGES"))
    assert gltf._device_bytes_limit() == want > 0


def test_mxu_texture_sampler_matches_gather(pbr_scene):
    """The per-bounce matmul bilinear pass (_sample_all_textures +
    _tex_lookup) matches the 4-tap gather sampler to fp association on
    every texture, wrap mode, and out-of-range UV, srgb on and off —
    including the oversized-texture gather fallback path."""
    from tpu_pt import whitted as wh
    ws = pbr_scene
    k_tex = len(ws.textures)
    assert k_tex >= 2
    n = 1024
    r = np.random.default_rng(7)
    uu = jnp.asarray(r.uniform(-1.5, 2.5, n).astype(np.float32))
    vv = jnp.asarray(r.uniform(-1.5, 2.5, n).astype(np.float32))
    tex_id = jnp.asarray((np.arange(n) % (k_tex + 1)) - 1, jnp.int32)

    for srgb in (True, False):
        g_rgb, g_a = wh._sample_textures(ws, tex_id, uu, vv, srgb=srgb)
        m_rgb, m_a = wh._tex_lookup(wh._sample_all_textures(ws, uu, vv),
                                    tex_id, srgb=srgb)
        np.testing.assert_allclose(np.asarray(m_rgb.to_array()),
                                   np.asarray(g_rgb.to_array()),
                                   rtol=0, atol=3e-5)
        np.testing.assert_allclose(np.asarray(m_a), np.asarray(g_a),
                                   rtol=0, atol=3e-5)
    # Force every texture through the oversized-texture fallback.
    old = wh._WTEX_MAX_TEXELS
    try:
        wh._WTEX_MAX_TEXELS = 1
        f_rgb, f_a = wh._tex_lookup(wh._sample_all_textures(ws, uu, vv),
                                    tex_id)
    finally:
        wh._WTEX_MAX_TEXELS = old
    g_rgb, g_a = wh._sample_textures(ws, tex_id, uu, vv)
    np.testing.assert_allclose(np.asarray(f_rgb.to_array()),
                               np.asarray(g_rgb.to_array()),
                               rtol=0, atol=3e-5)
    np.testing.assert_allclose(np.asarray(f_a), np.asarray(g_a),
                               rtol=0, atol=3e-5)


def test_gltf_sparse_accessor(tmp_path):
    """glTF 2.0 sparse accessors (core spec; tinygltf parity): the base
    bufferView (or implicit zeros) with `count` substitutions at the
    sparse indices. A displaced-vertex POSITION accessor round-trips."""
    import base64
    import json
    from tpu_pt.scene.gltf import _Gltf
    base_pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                        np.float32)
    sparse_vals = np.array([[5.0, 6.0, 7.0]], np.float32)
    sparse_idx = np.array([2], np.uint16)
    blob = base_pos.tobytes() + sparse_vals.tobytes() + sparse_idx.tobytes()
    doc = dict(
        asset=dict(version="2.0"),
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
        bufferViews=[
            dict(buffer=0, byteOffset=0, byteLength=48),
            dict(buffer=0, byteOffset=48, byteLength=12),
            dict(buffer=0, byteOffset=60, byteLength=2),
        ],
        accessors=[
            dict(bufferView=0, componentType=5126, count=4, type="VEC3",
                 sparse=dict(count=1,
                             indices=dict(bufferView=2,
                                          componentType=5123),
                             values=dict(bufferView=1))),
            # No bufferView: implicit zero base + substitution.
            dict(componentType=5126, count=4, type="VEC3",
                 sparse=dict(count=1,
                             indices=dict(bufferView=2,
                                          componentType=5123),
                             values=dict(bufferView=1))),
        ],
    )
    path = tmp_path / "sparse.gltf"
    path.write_text(json.dumps(doc))
    g = _Gltf(str(path))
    out = g.accessor(0)
    expect = base_pos.copy()
    expect[2] = [5.0, 6.0, 7.0]
    np.testing.assert_array_equal(out, expect)
    out0 = g.accessor(1)
    expect0 = np.zeros((4, 3), np.float32)
    expect0[2] = [5.0, 6.0, 7.0]
    np.testing.assert_array_equal(out0, expect0)


def test_gltf_camera_loaded(gltf_assets):
    """The asset's perspective camera loads like sutil::Scene's
    (Scene.cpp:166-191): eye = node world origin, view = world -Z,
    up = world +Y, fov from yfov."""
    from tpu_pt.scene.gltf import load_gltf
    ws = load_gltf(str(gltf_assets / "pbr_test.gltf"))
    assert ws.camera, "pbr_test declares a camera"
    eye, lookat, up, fov = ws.camera
    np.testing.assert_allclose(eye, [6.0, 4.5, 7.0], atol=1e-6)
    assert abs(fov - 40.0) < 1e-3
    d = np.asarray(lookat) - np.asarray(eye)
    d /= np.linalg.norm(d)
    np.testing.assert_allclose(d, [-0.604, -0.3724, -0.7046], atol=2e-3)
    assert up[1] > 0.9


def test_bilinear_rows_partition_of_unity():
    """_bilinear_rows rows are a partition of unity (weights sum to 1,
    two taps except at the collapsed edge texel) — the property that
    makes the matmul an interpolation rather than a filter."""
    from tpu_pt import whitted as wh
    x = jnp.asarray(np.linspace(0.0, 15.0, 97, dtype=np.float32))
    a = np.asarray(wh._bilinear_rows(x, 16))
    np.testing.assert_allclose(a.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    assert ((a > 0).sum(axis=1) <= 2).all()
    assert (a >= 0).all()


def test_expand_curve_spec_errors():
    """Curve spec validation names the offending field."""
    from tpu_pt.intersect.curves import expand_curve_spec
    with pytest.raises(ValueError, match="basis"):
        expand_curve_spec(dict(basis="nurbs", points=[[0, 0, 0]] * 4), 0)
    with pytest.raises(ValueError, match="points"):
        expand_curve_spec(dict(basis="cubic_bspline",
                               points=[[0, 0, 0]] * 3), 0)
    with pytest.raises(ValueError, match="radii"):
        expand_curve_spec(dict(basis="linear",
                               points=[[0, 0, 0], [1, 0, 0]],
                               radii=[0.1]), 0)
    # 5 points cubic -> 2 sliding windows.
    segs = expand_curve_spec(dict(basis="cubic_bspline",
                                  points=[[i, 0, 0] for i in range(5)],
                                  radii=0.2), 3)
    assert len(segs) == 2 and all(s["mat"] == 3 for s in segs)


def test_whitted_scheduler_width_invariance(pbr_scene, pbr_camera,
                                            monkeypatch):
    """Radiance is item-keyed (counter RNG), so the pixelq wavefront
    width and ladder are pure scheduling: TPT_ITEMS_PER_LANE and
    TPT_LADDER changes must be bitwise-invisible in the image — the
    invariant behind the round-4 integrator/scene-size-tuned
    defaults."""
    from tpu_pt.whitted import render_whitted_frame
    cfg = tpu_pt.RenderConfig(width=64, height=64, spp=4, max_depth=6,
                              background=(0.1, 0.15, 0.25),
                              intersector="bruteforce")
    outs = []
    for ipl, ladder in (("16", "1,8"), ("4", "1,8"), ("16", "1")):
        monkeypatch.setenv("TPT_ITEMS_PER_LANE", ipl)
        monkeypatch.setenv("TPT_LADDER", ladder)
        accum = init_accum(cfg)
        accum, img, _ = render_whitted_frame(pbr_scene, pbr_camera, cfg,
                                             0, accum)
        outs.append(np.asarray(img))
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


# ---------------------------------------------------------------------------
# Fractional shadow occlusion (__anyhit__occlusion parity,
# /root/reference/cuda/whitted.cu:113-138): textured MASK occluders
# below cutoff pass light entirely, other textured non-opaque hits
# multiply the shadow transmission by (1 - tex_alpha), untextured /
# opaque hits terminate the ray.

@pytest.fixture(scope="module")
def alpha_scene(gltf_assets):
    if not (gltf_assets / "alpha_shadow.gltf").exists():
        subprocess.run([sys.executable,
                        str(REPO / "tools" / "make_gltf_assets.py")],
                       check=True)
    from tpu_pt.scene.gltf import load_gltf
    return load_gltf(str(gltf_assets / "alpha_shadow.gltf"))


def test_alpha_occlusion_split_built(alpha_scene):
    ao = alpha_scene.alpha_occ
    assert ao is not None
    # Two textured quads x 2 tris x 2 layers of the blend quad = 6
    # alpha triangles; ground + untextured blend quad stay boolean.
    assert ao.geom.num_tris == 6
    assert ao.occ_geom.num_tris == 4
    assert ao.max_hits >= 2      # the stacked blend quads need 2 marches


def test_alpha_occlusion_transmissions(alpha_scene):
    """Analytic transmissions through each occluder class (the texture
    alphas 51/255 = 0.2 and 204/255 = 0.8 are exact in float)."""
    from tpu_pt.whitted import _make_occlusion
    ws = alpha_scene
    cfg = tpu_pt.RenderConfig(width=8, height=8, spp=1,
                              intersector="bruteforce")
    occ = _make_occlusion(ws, cfg)
    # (x, z, expected transmission) for a vertical segment from just
    # above the ground to below the light.
    probes = [
        (-3.5, 0.0, 0.8 * 0.8),  # 2 stacked blend layers, alpha 0.2
        (-2.5, 0.0, 0.2 * 0.2),  # same, alpha 0.8 half
        (-0.5, 0.0, 1.0),        # mask, alpha 0.2 < cutoff: passes
        (0.5, 0.0, 0.2),         # mask, alpha 0.8 >= cutoff: the
                                 # reference STILL attenuates by 1-a
                                 # (whitted.cu:123-136 falls through)
        (3.0, 0.0, 0.0),         # untextured blend: anyhit gates on
                                 # base_color_tex -> full occluder
        (0.0, 3.0, 1.0),         # clear sky
    ]
    n = len(probes)
    o = V3(jnp.array([p[0] for p in probes], jnp.float32),
           jnp.full((n,), 0.05, jnp.float32),
           jnp.array([p[1] for p in probes], jnp.float32))
    d = V3(jnp.zeros((n,), jnp.float32), jnp.ones((n,), jnp.float32),
           jnp.zeros((n,), jnp.float32))
    tmax = jnp.full((n,), 20.0, jnp.float32)
    got = np.asarray(occ(o, d, tmax))
    want = np.array([p[2] for p in probes], np.float32)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_alpha_occlusion_vs_numpy_reference(alpha_scene):
    """Independent-implementation A/B (the round-4 lesson: bitwise
    A/Bs of one path can't catch shared-path bugs): a numpy
    all-triangles sweep computing the reference's anyhit product is
    compared against _make_occlusion over random segments."""
    from tpu_pt.whitted import _make_occlusion
    from tpu_pt.scene.gltf import ALPHA_MASK, ALPHA_OPAQUE
    ws = alpha_scene
    cfg = tpu_pt.RenderConfig(width=8, height=8, spp=1,
                              intersector="bruteforce")
    occ = _make_occlusion(ws, cfg)

    rng_np = np.random.RandomState(7)
    n = 64
    o_np = np.stack([rng_np.uniform(-5, 5, n),
                     rng_np.uniform(0.05, 2.5, n),
                     rng_np.uniform(-2, 2, n)], axis=1).astype(np.float32)
    d_np = rng_np.normal(size=(n, 3)).astype(np.float32)
    d_np[:, 1] = np.abs(d_np[:, 1]) + 0.3          # upward-ish
    d_np /= np.linalg.norm(d_np, axis=1, keepdims=True)
    tmax_np = rng_np.uniform(3.0, 25.0, n).astype(np.float32)

    # Numpy reference: Moller over ALL triangles of the full geometry,
    # product of per-hit factors, 0 on any opaque-class hit.
    g = ws.geom
    v0 = np.asarray(g.tri_v0)[np.asarray(g.tri_valid)]
    e1 = np.asarray(g.tri_e1)[np.asarray(g.tri_valid)]
    e2 = np.asarray(g.tri_e2)[np.asarray(g.tri_valid)]
    mat = np.asarray(g.mat_id)[np.asarray(g.tri_valid)]
    amode = np.asarray(ws.alpha_mode)
    acut = np.asarray(ws.alpha_cutoff)
    tex_id = np.asarray(ws.tex_id)
    tex = np.asarray(ws.textures[0])
    # Per-triangle vertex UVs from the full scene's attribute table.
    uvs = np.asarray(ws.vtx_attr)[np.asarray(g.tri_valid), 9:15]

    def tex_alpha(uu, vv):
        h, w = tex.shape[0], tex.shape[1]
        x = (uu % 1.0) * (w - 1)
        y = (vv % 1.0) * (h - 1)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        x1, y1 = min(x0 + 1, w - 1), min(y0 + 1, h - 1)
        fx, fy = x - x0, y - y0
        return float(tex[y0, x0, 3] * (1 - fx) * (1 - fy)
                     + tex[y0, x1, 3] * fx * (1 - fy)
                     + tex[y1, x0, 3] * (1 - fx) * fy
                     + tex[y1, x1, 3] * fx * fy)

    want = np.ones(n, np.float32)
    tmin = cfg.t_min
    for i in range(n):
        o_i, d_i = o_np[i], d_np[i]
        trans = 1.0
        for k in range(v0.shape[0]):
            pvec = np.cross(d_i, e2[k])
            det = float(e1[k] @ pvec)
            if abs(det) < 1e-12:
                continue
            tvec = o_i - v0[k]
            u = float(tvec @ pvec) / det
            qvec = np.cross(tvec, e1[k])
            v = float(d_i @ qvec) / det
            t = float(e2[k] @ qvec) / det
            if u < 0 or v < 0 or u + v > 1 or t <= tmin or \
                    t >= tmax_np[i]:
                continue
            m = mat[k]
            if amode[m] == ALPHA_OPAQUE or tex_id[m] < 0:
                trans = 0.0
                continue
            w0 = 1.0 - u - v
            uu = uvs[k, 0] * w0 + uvs[k, 2] * u + uvs[k, 4] * v
            vv = uvs[k, 1] * w0 + uvs[k, 3] * u + uvs[k, 5] * v
            a = tex_alpha(uu, vv)
            if amode[m] == ALPHA_MASK and a < acut[m]:
                continue
            trans *= 1.0 - a
        want[i] = trans

    got = np.asarray(occ(V3(jnp.asarray(o_np[:, 0]),
                            jnp.asarray(o_np[:, 1]),
                            jnp.asarray(o_np[:, 2])),
                         V3(jnp.asarray(d_np[:, 0]),
                            jnp.asarray(d_np[:, 1]),
                            jnp.asarray(d_np[:, 2])),
                         jnp.asarray(tmax_np)))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_alpha_shadow_image(alpha_scene):
    """Image-level check: ground brightness under each occluder
    follows the transmission ordering (clear ~ mask-left >
    blend-left > blend-right > untextured-blend ~ ambient-only)."""
    from tpu_pt.whitted import render_whitted_wavefront
    from tpu_pt.camera import Camera
    ws = alpha_scene
    # Low camera: view rays to the shadowed ground pass UNDER the
    # floating quads (a top-down view would hit the blend quads first
    # and mix their radiance into the probe pixels).
    eye_np = np.array([0.0, 4.0, 14.0])
    look_np = np.array([0.0, 0.0, 0.0])
    cam = CameraArrays.from_camera(Camera(
        eye=eye_np.astype(np.float32),
        lookat=look_np.astype(np.float32), fov_y=45.0))
    res = 96
    cfg = tpu_pt.RenderConfig(width=res, height=res, spp=2, max_depth=4,
                              background=(0.0, 0.0, 0.0),
                              intersector="bruteforce")
    rad, _ = render_whitted_wavefront(ws, cam, cfg, 0, res * res, 0)
    img = np.asarray(rad).reshape(res, res, 3)
    assert np.isfinite(img).all()

    def ground_lum(x_world, z_world):
        # Project a ground point through the camera's UVW frame.
        from tpu_pt.camera import Camera as C
        c = C(eye=eye_np.astype(np.float32),
              lookat=look_np.astype(np.float32), fov_y=45.0)
        u, v, w = c.uvw_frame()
        p = np.array([x_world, 0.0, z_world]) - eye_np
        # Solve p ~ s*(dx*u + dy*v + w) for (dx, dy).
        m = np.stack([u, v, w], axis=1)
        q = np.linalg.solve(m, p)
        dx, dy = q[0] / q[2], q[1] / q[2]
        px = int((dx + 1) / 2 * res)
        py = int((dy + 1) / 2 * res)
        win = img[max(py - 1, 0): py + 2, max(px - 1, 0): px + 2]
        return float(win.mean())

    clear = ground_lum(0.0, 3.5)
    mask_l = ground_lum(-0.5, 0.0)
    blend_l = ground_lum(-3.5, 0.0)
    blend_r = ground_lum(-2.5, 0.0)
    plain = ground_lum(3.0, 0.0)
    # Mask-left passes the light fully.
    assert abs(mask_l - clear) < 0.15 * clear
    # Transmission ordering.
    assert clear > blend_l > blend_r > plain
    # Untextured blend casts a full shadow (ambient only).
    assert plain < 0.25 * clear


# ---------------------------------------------------------------------------
# Instancing at forest scale: one shared tree mesh, hundreds of node
# instances, flattened to world space with a per-mesh decode cache
# (Scene.cpp:1134-1213 is the reference's IAS; the flatten is tpu_pt's
# documented world-space equivalent).

def test_forest_instancing(tmp_path):
    sys.path.insert(0, str(REPO / "tools"))
    import make_gltf_assets
    make_gltf_assets.build_forest(str(tmp_path), n_trees=60)
    from tpu_pt.scene.gltf import load_gltf
    ws = load_gltf(str(tmp_path / "forest.gltf"))
    # ground (2) + 60 x (trunk 24 + canopy 960) world triangles.
    assert ws.geom.num_tris == 2 + 60 * (24 + 960)
    v0 = np.asarray(ws.geom.tri_v0)
    # Instances landed at distinct world positions (the transform was
    # applied per instance, not shared).
    trunk0 = v0[2:2 + 24].mean(axis=0)
    trunk1 = v0[2 + 984:2 + 984 + 24].mean(axis=0)
    assert np.linalg.norm(trunk0 - trunk1) > 1.0

    # Smoke render: the flattened forest draws trees over ground + sky.
    from tpu_pt.whitted import render_whitted_wavefront
    from tpu_pt.camera import Camera
    cam = CameraArrays.from_camera(Camera(
        eye=np.array([0.0, 35.0, 150.0], np.float32),
        lookat=np.array([0.0, 0.0, 0.0], np.float32), fov_y=50.0))
    cfg = tpu_pt.RenderConfig(width=48, height=36, spp=1, max_depth=2,
                              background=(0.5, 0.7, 0.9))
    rad, _ = render_whitted_wavefront(ws, cam, cfg, 0, 48 * 36, 0)
    img = np.asarray(rad).reshape(36, 48, 3)
    assert np.isfinite(img).all()
    # Sky at the top (row 0 is the image bottom), green-dominant
    # canopy pixels somewhere in the frame.
    assert img[-1, 0, 2] > img[-1, 0, 1]          # blue sky
    green_frac = float(((img[..., 1] > img[..., 0])
                        & (img[..., 1] > img[..., 2])).mean())
    assert green_frac > 0.02
