"""Scene loader tests (TinyObjWrapper parity)."""

import numpy as np

from tpu_pt.scene import (BSDF_DIFFUSE, BSDF_METALLIC, BSDF_REFRACTION,
                          classify_bsdf, detect_area_light, load_obj,
                          load_scene)


def test_classify_bsdf_name_rule():
    # TinyObjWrapper.cpp:153-164.
    assert classify_bsdf("RefractiveSphere") == BSDF_REFRACTION
    assert classify_bsdf("MetallicBlock") == BSDF_METALLIC
    assert classify_bsdf("WhiteDiffuse") == BSDF_DIFFUSE
    assert classify_bsdf("whatever") == BSDF_DIFFUSE
    # Substring, not prefix.
    assert classify_bsdf("MyMetallicThing") == BSDF_METALLIC


def test_load_cornell_counts(assets_dir):
    mesh = load_obj(str(assets_dir / "cornell_box.obj"))
    # 5 walls + light + 2 blocks x 5 quads = 16 quads = 32 triangles.
    assert mesh.indices.shape == (32, 3)
    assert mesh.mat_indices.shape == (32,)
    assert mesh.get_num_materials() >= 4
    # All triangle indices in range.
    assert mesh.indices.min() >= 0
    assert mesh.indices.max() < mesh.vertices.shape[0]


def test_tinyobj_parity_getters(assets_dir):
    mesh = load_obj(str(assets_dir / "cornell_box.obj"))
    v4 = mesh.get_vertices_float()
    assert v4.shape[1] == 4
    np.testing.assert_array_equal(v4[:, 3], 1.0)  # w=1, TinyObjWrapper 200-221
    flat = mesh.get_index_buffer()
    assert flat.shape == (32 * 3,)


def test_detect_area_light_matches_reference(assets_dir):
    mesh = load_obj(str(assets_dir / "cornell_box.obj"))
    light = detect_area_light(mesh)
    assert light is not None
    corner = np.asarray(light.corner)
    v1 = np.asarray(light.v1)
    v2 = np.asarray(light.v2)
    # The emissive quad is built exactly at the reference's hardcoded light
    # (PathTracerMain.cpp:154-158); the detector must recover it (up to
    # corner/edge permutation — check the rectangle and the normal).
    area = np.linalg.norm(np.cross(v1, v2))
    np.testing.assert_allclose(area, 130.0 * 105.0, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(light.normal), [0.0, -1.0, 0.0],
                               atol=1e-6)
    np.testing.assert_allclose(corner[1], 547.0, atol=1e-4)
    np.testing.assert_allclose(np.asarray(light.emission), [10.0, 10.0, 10.0])


def test_scene_arrays_padding(cornell_scene):
    s = cornell_scene
    assert s.num_tris_padded % 128 == 0
    valid = np.asarray(s.tri_valid)
    assert valid.sum() == 32
    # Padding triangles are degenerate (zero edges -> never hit).
    np.testing.assert_array_equal(np.asarray(s.tri_e1)[~valid], 0.0)
    # Normals are unit length on valid triangles.
    n = np.asarray(s.tri_normal)[valid]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


def test_mixed_scene_bsdfs(mixed_scene):
    bsdf = np.asarray(mixed_scene.mat_bsdf)
    assert (bsdf == BSDF_METALLIC).any()
    assert (bsdf == BSDF_REFRACTION).any()
    assert (bsdf == BSDF_DIFFUSE).any()
    ior = np.asarray(mixed_scene.mat_ior)
    refr = bsdf == BSDF_REFRACTION
    np.testing.assert_allclose(ior[refr], 1.5)


def test_negative_indices_and_polygons(tmp_path):
    # OBJ with relative indices and a quad face.
    p = tmp_path / "t.obj"
    p.write_text("""
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
f -4 -3 -2 -1
""")
    mesh = load_obj(str(p))
    assert mesh.indices.shape == (2, 3)  # fan-triangulated quad
    np.testing.assert_array_equal(mesh.indices[0], [0, 1, 2])
    np.testing.assert_array_equal(mesh.indices[1], [0, 2, 3])


def test_load_scene_end_to_end(assets_dir):
    s = load_scene(str(assets_dir / "cornell_box_mixed.obj"))
    n_valid = int(np.asarray(s.tri_valid).sum())
    assert n_valid > 32  # box + sphere triangles
    assert s.num_tris_padded % 128 == 0
    assert s.num_tris_padded >= n_valid
    assert np.asarray(s.mat_is_emissive).any()


def test_nee_occluder_subset(mixed_scene):
    """Occluder analysis culls hull walls + refractive tris, keeps blocks.

    Every triangle NOT in the subset must be provably unable to occlude:
    brute-check by shooting segments from random in-box points to random
    light points and verifying each culled triangle never intersects
    strictly inside (tmin, dist - 0.01) — the moller sweep over only the
    culled rows must report no occlusion the full sweep would miss."""
    import jax.numpy as jnp
    from tpu_pt.intersect import moller
    from tpu_pt.vec3 import V3

    s = mixed_scene
    assert s.num_occluders >= 0
    assert 0 < s.num_occluders < s.num_tris
    idx = np.asarray(s.occ_index)[: s.num_occluders]
    # Refractive triangles never occlude (cu:672-681) -> none in subset.
    bsdf = np.asarray(s.mat_bsdf)[np.asarray(s.mat_id)[idx]]
    from tpu_pt.scene.arrays import BSDF_REFRACTION
    assert not np.any(bsdf == BSDF_REFRACTION)

    rng_ = np.random.default_rng(7)
    n = 256
    o = V3(*[jnp.asarray(rng_.uniform(lo, hi, n).astype(np.float32))
             for lo, hi in ((1.0, 555.0), (1.0, 547.0), (1.0, 558.0))])
    lc = np.asarray(s.light.corner, np.float64)
    lp = (lc + rng_.uniform(0, 1, (n, 1)) * np.asarray(s.light.v1)
          + rng_.uniform(0, 1, (n, 1)) * np.asarray(s.light.v2))
    dx = jnp.asarray(lp[:, 0], jnp.float32) - o.x
    dy = jnp.asarray(lp[:, 1], jnp.float32) - o.y
    dz = jnp.asarray(lp[:, 2], jnp.float32) - o.z
    dist = jnp.sqrt(dx * dx + dy * dy + dz * dz)
    d = V3(dx / dist, dy / dist, dz / dist)
    tmax = dist - 0.01

    full = moller.intersect_occluded(s, o, d, tmax)
    # Scene restricted to the CULLED triangles only: valid &= ~in_subset.
    culled_valid = np.asarray(s.tri_valid).copy()
    culled_valid[idx] = False
    s_culled = s.replace(tri_valid=jnp.asarray(culled_valid))
    culled = moller.intersect_occluded(s_culled, o, d, tmax)
    assert not bool(jnp.any(culled & ~full))  # sanity (subset of full)
    assert not bool(jnp.any(culled)), "a culled triangle occluded a segment"


class TestSceneJSON:
    """Scene JSON: primitives bound into the pipeline (VERDICT round-1 #2;
    reference custom-primitive programs cuda/geometry.cu + sphere.cu)."""

    def _scene(self, assets_dir):
        import tpu_pt
        return tpu_pt.load_scene(str(assets_dir / "cornell_prims.json"))

    def test_load(self, assets_dir):
        from tpu_pt.intersect.primitives import (PRIM_SPHERE,
                                                 PRIM_SPHERE_SHELL,
                                                 PRIM_PARALLELOGRAM)
        scene = self._scene(assets_dir)
        assert scene.prims is not None
        assert set(scene.prims.kind) == {PRIM_SPHERE, PRIM_SPHERE_SHELL,
                                         PRIM_PARALLELOGRAM}
        # "Refractive..." name-substring rule carries over from the MTL
        # convention (TinyObjWrapper.cpp:153-164).
        from tpu_pt.scene.arrays import BSDF_REFRACTION, BSDF_METALLIC
        bsdf = np.asarray(scene.mat_bsdf)
        mats = np.asarray(scene.prims.mat)
        kinds = list(scene.prims.kind)
        shell_mat = mats[kinds.index(PRIM_SPHERE_SHELL)]
        sphere_mat = mats[kinds.index(PRIM_SPHERE)]
        assert bsdf[shell_mat] == BSDF_REFRACTION
        assert bsdf[sphere_mat] == BSDF_METALLIC
        # Refractive shell never occludes NEE shadow rays.
        assert scene.prims.occludes[kinds.index(PRIM_SPHERE_SHELL)] is False
        assert scene.prims.occludes[kinds.index(PRIM_SPHERE)] is True

    def test_closest_combines_primitives(self, assets_dir):
        """A ray aimed at the metal primitive sphere hits it (id offset past
        the padded triangle range), one aimed at a wall hits the mesh."""
        import jax.numpy as jnp
        from tpu_pt.config import RenderConfig
        from tpu_pt.intersect import get_intersectors
        from tpu_pt.vec3 import V3
        scene = self._scene(assets_dir)
        cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                           intersector="bruteforce")
        closest, occluded = get_intersectors(scene, cfg)
        # Sphere at (400, 90, 120) r=60; shoot from the front opening.
        o = V3(jnp.array([400.0, 278.0]), jnp.array([90.0, 278.0]),
               jnp.array([-400.0, -400.0]))
        d = V3(jnp.array([0.0, 0.0]), jnp.array([0.0, 0.0]),
               jnp.array([1.0, 1.0]))
        hit = closest(o, d)
        t_pad = scene.num_tris_padded
        assert bool(hit.hit[0]) and int(hit.tri[0]) >= t_pad
        np.testing.assert_allclose(float(hit.t[0]), 520.0 - 60.0, rtol=1e-4)
        # Second ray passes the sphere, lands on the back wall (a triangle).
        assert bool(hit.hit[1]) and int(hit.tri[1]) < t_pad
        # Occlusion: a segment through the metal sphere is blocked; one
        # through the glass shell is not (refractive pass-through).
        o2 = V3(jnp.array([400.0, 190.0]), jnp.array([90.0, 320.0]),
                jnp.array([-200.0, -200.0]))
        d2 = V3(jnp.array([0.0, 0.0]), jnp.array([0.0, 0.0]),
                jnp.array([1.0, 1.0]))
        # Lane 1's tmax stops short of the red panel primitive at
        # z=398.5 (t=598.5) so only the glass shell lies on the segment.
        tmax = jnp.array([700.0, 550.0])
        occ = occluded(o2, d2, tmax)
        assert bool(occ[0]) is True      # metal sphere blocks
        assert bool(occ[1]) is False     # glass shell passes light


class TestCurveSceneJSON:
    """Scene JSON curves bound into the pipeline (VERDICT round-2 #4; the
    reference's four round-curve geometry types,
    ``cuda/GeometryData.h:95-127``, normals ``cuda/curve.h:312-443``)."""

    def _scene(self, assets_dir):
        import tpu_pt
        return tpu_pt.load_scene(str(assets_dir / "cornell_curves.json"))

    def test_load(self, assets_dir):
        from tpu_pt.intersect.curves import (CURVE_LINEAR,
                                             CURVE_QUADRATIC_BSPLINE,
                                             CURVE_CUBIC_BSPLINE,
                                             CURVE_CATMULLROM)
        scene = self._scene(assets_dir)
        assert scene.curves is not None
        # Sliding-window segmentation: 6-pt cubic -> 3, 4-pt catmullrom
        # -> 1, 3-pt linear -> 2, 4-pt quadratic -> 2.
        assert scene.curves.count == 8
        assert scene.curves.k0.shape == (8, 4)
        assert len(scene.curves.occludes) == 8
        assert all(scene.curves.occludes)   # no refractive curve material

    def test_closest_combines_curves(self, assets_dir):
        """A ray aimed at the linear rope segment hits it (id offset past
        the padded triangle range); one missing every curve lands on the
        back wall."""
        import jax.numpy as jnp
        from tpu_pt.config import RenderConfig
        from tpu_pt.intersect import get_intersectors
        from tpu_pt.vec3 import V3
        scene = self._scene(assets_dir)
        cfg = RenderConfig(width=8, height=8, spp=1, max_depth=2,
                           intersector="bruteforce")
        closest, occluded = get_intersectors(scene, cfg)
        # Linear strand passes through (120, 484, 295) (midpoint of its
        # first control segment) with radius 8; shoot from the front.
        o = V3(jnp.array([120.0, 50.0]), jnp.array([484.0, 50.0]),
               jnp.array([-400.0, -400.0]))
        d = V3(jnp.array([0.0, 0.0]), jnp.array([0.0, 0.0]),
               jnp.array([1.0, 1.0]))
        hit = closest(o, d)
        t_pad = scene.num_tris_padded
        assert bool(hit.hit[0]) and int(hit.tri[0]) >= t_pad
        assert 680.0 < float(hit.t[0]) < 695.5
        # Surface normal faces the ray and is unit length.
        n = np.array([float(hit.normal.x[0]), float(hit.normal.y[0]),
                      float(hit.normal.z[0])])
        np.testing.assert_allclose(np.linalg.norm(n), 1.0, atol=1e-4)
        assert n[2] < 0.0
        # Second ray misses every curve: back wall triangle.
        assert bool(hit.hit[1]) and int(hit.tri[1]) < t_pad
        # Occlusion: a segment through the rope is blocked; a clear
        # segment is not.
        occ = occluded(o, d, jnp.array([900.0, 100.0]))
        assert bool(occ[0]) is True
        assert bool(occ[1]) is False


def test_occluder_subset_point_light_endpoints():
    """Whitted POINT lights extend the occluder hull test's endpoint
    set: a ground plane with a light BELOW it is a real occluder of
    surface->light segments and must survive the cull, while the same
    plane with all endpoints above it is correctly culled (the round-4
    fix: load_gltf used the Cornell quad's endpoints only, silently
    mis-culling for out-of-hull point lights)."""
    from tpu_pt.scene.arrays import nee_occluder_index

    # Geometry: a ground quad at y=0 and a small box ABOVE it.
    v0 = np.array([[-5, 0, -5], [-5, 0, -5],
                   [0.0, 1.0, 0.0], [0.0, 2.0, 0.0]], np.float32)
    e1 = np.array([[10, 0, 0], [0, 0, 10],
                   [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    e2 = np.array([[0, 0, 10], [10, 0, 0],
                   [0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    valid = np.ones(4, bool)
    refr = np.zeros(4, bool)
    # Area light far above (its quad endpoints are above the plane too).
    light = (np.array([0, 8, 0], np.float64),
             np.array([1, 0, 0], np.float64),
             np.array([0, 0, 1], np.float64))

    idx, n_occ = nee_occluder_index(v0, e1, e2, valid, refr, light)
    ground_in = {0, 1} & set(idx[:n_occ].tolist())
    assert not ground_in, "plane with everything above it must be culled"

    # A point light BELOW the plane: segments from above-ground surfaces
    # to it cross y=0, so the ground tris must now survive.
    idx2, n2 = nee_occluder_index(
        v0, e1, e2, valid, refr, light,
        extra_endpoints=np.array([[0.0, -3.0, 0.0]], np.float32))
    assert {0, 1} <= set(idx2[:n2].tolist())


def test_gltf_occluder_subset_includes_point_lights(tmp_path):
    """load_gltf recomputes the occluder subset with its point-light
    positions as endpoints: a light under the floor keeps the floor in
    the subset (shadows stay correct on the subset-sweeping backends)."""
    import base64
    import json
    from tpu_pt.scene.gltf import load_gltf

    # Floor quad at y=0 plus a small triangle above it; light below.
    pos = np.array([[-5, 0, -5], [5, 0, -5], [5, 0, 5],
                    [-5, 0, -5], [5, 0, 5], [-5, 0, 5],
                    [0, 1, 0], [1, 1, 0], [0, 1, 1]], np.float32)
    blob = pos.tobytes()
    doc = dict(
        asset=dict(version="2.0"), scene=0,
        scenes=[dict(nodes=[0, 1])],
        nodes=[dict(mesh=0),
               dict(translation=[0.0, -3.0, 0.0],
                    extensions=dict(KHR_lights_punctual=dict(light=0)))],
        meshes=[dict(primitives=[dict(attributes=dict(POSITION=0))])],
        accessors=[dict(bufferView=0, componentType=5126, count=9,
                        type="VEC3")],
        bufferViews=[dict(buffer=0, byteOffset=0, byteLength=len(blob))],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
        extensions=dict(KHR_lights_punctual=dict(lights=[
            dict(type="point", color=[1, 1, 1], intensity=2.0)])),
        extensionsUsed=["KHR_lights_punctual"],
    )
    path = tmp_path / "light_below.gltf"
    path.write_text(json.dumps(doc))
    ws = load_gltf(str(path))
    occ = set(np.asarray(ws.geom.occ_index)[
        : ws.geom.num_occluders].tolist())
    assert {0, 1} <= occ, "floor must stay an occluder for the low light"
