"""Flattened scene representation for the wavefront renderer.

The reference uploads vertices/indices/material-indices into an OptiX GAS and
dispatches materials via per-material SBT hitgroup records
(``PathTracerMain.cpp:260-398,544-627``). The equivalent here is a pure
SoA pytree: padded triangle arrays (pretransformed for Möller-Trumbore) plus
stacked material tables indexed by a ``mat_id`` array — the SBT becomes an
integer gather, the GAS becomes dense/BVH intersection kernels.
"""

from __future__ import annotations

import numpy as np
from .. import pytree
import jax.numpy as jnp

# BSDF ids — parity with ``TinyObjWrapper.h:27-31`` (BSDFType).
BSDF_DIFFUSE = 0
BSDF_METALLIC = 1
BSDF_REFRACTION = 2

# Triangle arrays are padded to a multiple of this, so intersection
# blocks (jnp sweep, Pallas kernel) divide the padded count evenly.
TRI_PAD = 128


@pytree.dataclass
class AreaLight:
    """Rectangular area light (``pathTracer.h:77-83`` AreaLight)."""
    corner: jnp.ndarray   # [3]
    v1: jnp.ndarray       # [3]
    v2: jnp.ndarray       # [3]
    normal: jnp.ndarray   # [3]
    emission: jnp.ndarray  # [3]


@pytree.dataclass
class SceneArrays:
    """Padded, device-ready scene. All leaves are jax arrays.

    Triangles are stored as (v0, e1, e2) with e1 = v1 - v0, e2 = v2 - v0 so the
    intersector never regathers vertices; ``tri_normal`` is the geometric
    normal ``normalize(cross(e1, e2))`` — the same N_0 the reference computes
    per hit (``pathTracerPrograms.cu:886-891``), hoisted to scene build time.
    """
    tri_v0: jnp.ndarray       # [T, 3] f32
    tri_e1: jnp.ndarray       # [T, 3] f32
    tri_e2: jnp.ndarray       # [T, 3] f32
    tri_normal: jnp.ndarray   # [T, 3] f32
    tri_valid: jnp.ndarray    # [T] bool (False on padding)
    mat_id: jnp.ndarray       # [T] i32

    mat_diffuse: jnp.ndarray   # [M, 3] f32
    mat_emission: jnp.ndarray  # [M, 3] f32
    mat_roughness: jnp.ndarray  # [M] f32
    mat_metallic: jnp.ndarray   # [M] f32
    mat_ior: jnp.ndarray        # [M] f32
    mat_bsdf: jnp.ndarray       # [M] i32
    mat_is_emissive: jnp.ndarray  # [M] bool

    light: AreaLight

    # Optional acceleration structure (tpu_pt.intersect.lbvh.BVH), attached
    # once at scene-build time — the analog of the reference's GAS handle in
    # PathTraceParams (``pathTracer.h:102``).
    bvh: object = None

    # Optional analytic primitives (tpu_pt.intersect.primitives.Primitives):
    # sphere / sphere-shell / parallelogram, the reference's custom-primitive
    # intersection programs (``cuda/geometry.cu:38-144``, ``cuda/sphere.cu``)
    # bound into the pipeline. Combined with triangle hits by min-t in
    # ``get_intersectors``; primitive ids live past ``num_tris_padded``.
    prims: object = None

    # Optional swept-sphere curves (tpu_pt.intersect.curves.CurveSegments):
    # the reference's four round-curve geometry types
    # (``cuda/GeometryData.h:95-127``, normals ``cuda/curve.h:312-443``),
    # declared in scene JSON and combined with triangle/primitive hits by
    # min-t in ``get_intersectors``; curve ids live past the primitives.
    curves: object = None

    # True (unpadded) triangle count, kept static so kernels can trim
    # their sweep range below the TRI_PAD granularity; 0 = unknown (use
    # the padded count).
    num_tris: int = pytree.static_field(default=0)

    # NEE shadow-ray occluder subset (see ``nee_occluder_index``): indices
    # into the padded triangle arrays of every triangle that can possibly
    # occlude a scene-surface -> area-light segment, padded to a multiple
    # of 8. None / -1 = unknown (occlusion kernels sweep all triangles).
    occ_index: jnp.ndarray = None          # [O_pad] i32
    num_occluders: int = pytree.static_field(default=-1)

    @property
    def num_tris_padded(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_diffuse.shape[0]


def default_cornell_light() -> AreaLight:
    """The reference's hardcoded Cornell area light
    (``PathTracerMain.cpp:154-158``). Host (numpy) leaves — converted to
    device arrays by ``build_scene_arrays`` — so scene-build-time geometry
    analysis (``nee_occluder_index``) never reads device memory back."""
    v1 = np.array([0.0, 0.0, 105.0], np.float32)
    v2 = np.array([-130.0, 0.0, 0.0], np.float32)
    n = np.cross(v1, v2)
    n = n / np.linalg.norm(n)
    return AreaLight(
        corner=np.array([343.0, 547.0, 227.0], np.float32),
        v1=v1,
        v2=v2,
        normal=n.astype(np.float32),
        emission=np.array([10.0, 10.0, 10.0], np.float32),
    )


def _host_light(light: AreaLight):
    """(corner, v1, v2) as numpy, or None if any leaf lives on device.

    Occluder analysis only runs when the light is host-backed, so scene
    build never waits on a device->host copy (every loader constructs
    lights on host; only hand-built device lights opt out, losing
    nothing but the culling optimization)."""
    leaves = (light.corner, light.v1, light.v2)
    if all(isinstance(x, (np.ndarray, list, tuple)) for x in leaves):
        return tuple(np.asarray(x, np.float64) for x in leaves)
    return None


def _device_light(light: AreaLight) -> AreaLight:
    return AreaLight(corner=jnp.asarray(light.corner, jnp.float32),
                     v1=jnp.asarray(light.v1, jnp.float32),
                     v2=jnp.asarray(light.v2, jnp.float32),
                     normal=jnp.asarray(light.normal, jnp.float32),
                     emission=jnp.asarray(light.emission, jnp.float32))


def nee_occluder_index(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       valid: np.ndarray, refractive: np.ndarray,
                       light_cvv: tuple, pad_align: int = 8,
                       extra_endpoints: np.ndarray | None = None):
    """Indices of every triangle that can occlude an NEE shadow segment.

    NEE shadow rays (``pathTracerPrograms.cu:1003-1026``) are segments from
    a scene-surface point to a point on the area light, tested over
    ``(tmin, l_dist - 0.01)``. Two whole classes of triangles can never
    produce such an occlusion and are culled here once at scene build:

    - refractive triangles — the reference's occlusion program lets light
      pass through them (``pathTracerPrograms.cu:672-681``);
    - hull-boundary triangles: if every possible segment endpoint (the
      scene AABB, hence every surface point, plus the light quad's four
      corners) lies on ONE side of the triangle's plane, no segment
      between two endpoints can properly cross that plane. In a Cornell
      box this removes the walls, floor and ceiling, leaving only the
      interior blocks — the occlusion sweep shrinks from the whole scene
      to a handful of rows.

    Points within ``eps`` of the plane count as "on" it: a segment whose
    endpoint sits on the plane only touches it at the endpoint, which the
    NEE tmin / (l_dist - 0.01) range excludes. The classification margin
    (1e-4 of the scene diagonal) dwarfs f32 rounding (~1e-7 relative),
    so the analysis runs in float32 — float64 tripled the 1M-triangle
    scene-build cost for identical classifications (verified on every
    asset scene).

    ``light_cvv`` is the host-side (corner, v1, v2) triple.
    ``extra_endpoints`` ([P, 3]) adds further possible segment
    endpoints — the whitted pipeline's POINT light positions, which may
    sit outside the scene AABB (a light below a ground plane makes that
    plane a real occluder the AABB+quad set alone would wrongly cull).
    Returns (occ_index int32 [O_pad] padded to ``pad_align``, n_occ).
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    valid = np.asarray(valid, bool)
    refractive = np.asarray(refractive, bool)

    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nlen > 0, n / np.maximum(nlen, np.float32(1e-30)), 0.0)
    d0 = np.sum(n * v0, axis=-1)                              # [T]

    vmask = np.concatenate([valid, valid, valid])
    pts = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)[vmask]
    if pts.size == 0:
        return np.zeros(pad_align, np.int32), 0
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)  # [8, 3]
    lc, lv1, lv2 = (np.asarray(x, np.float32) for x in light_cvv)
    endpoints = np.concatenate(
        [corners, [lc, lc + lv1, lc + lv2, lc + lv1 + lv2]], axis=0)
    if extra_endpoints is not None and len(extra_endpoints):
        endpoints = np.concatenate(
            [endpoints,
             np.asarray(extra_endpoints, np.float32).reshape(-1, 3)],
            axis=0)

    eps = 1e-4 * float(np.linalg.norm(hi - lo)) + 1e-12
    dist = endpoints @ n.T - d0[None, :]    # [E, T], E = 12 + extras
    one_side = np.all(dist >= -eps, axis=0) | np.all(dist <= eps, axis=0)

    mask = valid & ~refractive & ~one_side
    idx = np.flatnonzero(mask).astype(np.int32)
    n_occ = int(idx.size)
    o_pad = max(pad_align, -(-n_occ // pad_align) * pad_align)
    out = np.zeros(o_pad, np.int32)
    out[:n_occ] = idx
    return out, n_occ


def build_scene_arrays(vertices: np.ndarray,
                       indices: np.ndarray,
                       mat_ids: np.ndarray,
                       materials: list[dict],
                       light: AreaLight | None = None,
                       pad_to: int = TRI_PAD,
                       return_host: bool = False):
    """Flatten host-side mesh data into a padded SceneArrays pytree.

    ``vertices`` [V, 3], ``indices`` [T, 3] int, ``mat_ids`` [T] int,
    ``materials`` a list of dicts with keys diffuse/emission/roughness/
    metallic/ior/bsdf (the loader's Material struct, parity with
    ``TinyObjWrapper.h:33-40``).

    ``return_host=True`` additionally returns the padded numpy arrays
    (keys v0/e1/e2/normal/valid/mat_id/mat_bsdf) so scene-load-time
    consumers (the native LBVH builder) never read device memory back.
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    mat_ids = np.asarray(mat_ids, np.int64).reshape(-1)
    t = indices.shape[0]
    assert mat_ids.shape[0] == t, (mat_ids.shape, t)

    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nlen > 0, n / np.maximum(nlen, 1e-30), 0.0).astype(np.float32)

    t_pad = max(pad_to, ((t + pad_to - 1) // pad_to) * pad_to)

    def pad(a, fill=0.0):
        out = np.full((t_pad,) + a.shape[1:], fill, a.dtype)
        out[:t] = a
        return out

    if not materials:
        materials = [dict(diffuse=(0.8, 0.8, 0.8), emission=(0, 0, 0),
                          roughness=0.5, metallic=0.0, ior=1.0,
                          bsdf=BSDF_DIFFUSE)]
        mat_ids = np.zeros(t, np.int64)

    m = len(materials)
    diffuse = np.array([mm["diffuse"] for mm in materials], np.float32)
    emission = np.array([mm["emission"] for mm in materials], np.float32)
    roughness = np.array([mm["roughness"] for mm in materials], np.float32)
    metallic = np.array([mm["metallic"] for mm in materials], np.float32)
    ior = np.array([mm["ior"] for mm in materials], np.float32)
    bsdf = np.array([mm["bsdf"] for mm in materials], np.int32)
    is_emissive = np.linalg.norm(emission, axis=-1) > 0.0

    mat_ids = np.clip(mat_ids, 0, m - 1)

    host = dict(v0=pad(v0), e1=pad(e1), e2=pad(e2), normal=pad(n),
                valid=pad(np.ones(t, bool), fill=False),
                mat_id=pad(mat_ids.astype(np.int32)), mat_bsdf=bsdf)
    the_light = light if light is not None else default_cornell_light()
    light_cvv = _host_light(the_light)
    if light_cvv is not None:
        refr = bsdf[host["mat_id"]] == BSDF_REFRACTION
        occ_index, n_occ = nee_occluder_index(
            host["v0"], host["e1"], host["e2"], host["valid"], refr,
            light_cvv)
        occ_index = jnp.asarray(occ_index)
    else:
        occ_index, n_occ = None, -1
    scene = SceneArrays(
        tri_v0=jnp.asarray(host["v0"]),
        tri_e1=jnp.asarray(host["e1"]),
        tri_e2=jnp.asarray(host["e2"]),
        tri_normal=jnp.asarray(host["normal"]),
        tri_valid=jnp.asarray(host["valid"]),
        mat_id=jnp.asarray(host["mat_id"]),
        mat_diffuse=jnp.asarray(diffuse),
        mat_emission=jnp.asarray(emission),
        mat_roughness=jnp.asarray(roughness),
        mat_metallic=jnp.asarray(metallic),
        mat_ior=jnp.asarray(ior),
        mat_bsdf=jnp.asarray(bsdf),
        mat_is_emissive=jnp.asarray(is_emissive),
        light=_device_light(the_light),
        num_tris=t,
        occ_index=occ_index,
        num_occluders=n_occ,
    )
    return (scene, host) if return_host else scene
