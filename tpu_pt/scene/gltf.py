"""glTF 2.0 scene loader (the ``sutil::Scene`` pipeline's input path).

Capability parity with the reference's glTF loader (``sutil/Scene.cpp:
267-550`` + ``processGLTFNode:125-212``): buffers (external files, data:
URIs, GLB chunks), accessors with strides, triangle meshes with POSITION/
NORMAL/TEXCOORD_0, node TRS/matrix hierarchies with instancing, PBR
metallic-roughness materials (base color / metallic / roughness / emissive
factors, baseColorTexture, alpha modes, double-sided), KHR_lights_punctual
point lights, and cameras.

Geometry (the reference keeps a two-level GAS+IAS — per-mesh GAS
instanced under ``buildInstanceAccel``, ``Scene.cpp:1134``): instances
are flattened — triangles are pre-transformed into world space at load
time and one table/LBVH covers the whole scene, so traversal has no
transform indirection. The shared-mesh half of the IAS is kept: meshes
decode once and each instance pays only its transform (``_decoded_mesh``
cache), so a 500-instance forest loads in O(mesh + instances) time
(``assets/forest.gltf``, ~0.5M world tris). Memory scales O(instances x
mesh), so the flattened triangle count is bounded by what the device's
memory can hold (``max_flat_tris``).
"""

from __future__ import annotations

import base64
import json
import os
import struct as pystruct

import numpy as np
from .. import pytree
import jax.numpy as jnp

from .. import mathlib as ml
from .arrays import (SceneArrays, build_scene_arrays, AreaLight,
                     default_cornell_light, BSDF_DIFFUSE, BSDF_REFRACTION)

# Component types (glTF spec).
_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
          5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

# Material kinds (MaterialData tagged-union parity, cuda/MaterialData.h).
KIND_PBR = 0
KIND_GLASS = 1
KIND_PHONG = 2
KIND_CHECKER = 3

# Alpha modes (MaterialData::AlphaMode parity).
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2


@pytree.dataclass
class AlphaOccluders:
    """Shadow-ray transmission split (``__anyhit__occlusion`` parity,
    ``cuda/whitted.cu:113-138``).

    The reference's occlusion anyhit lets TEXTURED non-opaque occluders
    pass fractional light (MASK below cutoff passes entirely; otherwise
    the shadow attenuation multiplies by ``1 - tex_alpha``); everything
    else — untextured materials included, the anyhit gates on
    ``base_color_tex`` — terminates the ray. Here the triangle set is
    split once at scene build:

    - ``occ_geom``: the scene WITHOUT the alpha-class triangles (plus
      any analytic prims/curves) — the boolean occlusion sweep, a hit
      here means attenuation 0;
    - ``geom``: ONLY the alpha-class triangles, marched closest-hit-
      by-closest-hit (at most ``max_hits`` — each triangle can be hit
      once per segment) to accumulate the product of per-hit
      transmissions (``whitted._make_occlusion``).

    ``uv`` carries the subset triangles' per-vertex UVs ([Ta_pad, 6]:
    uv0 uv1 uv2) for sampling the base-color texture's alpha at each
    hit; material ids in ``geom.mat_id`` are the ORIGINAL glTF
    material indices, so the march reuses the whitted material table.
    Memory note: alpha-carrying scenes duplicate their opaque
    triangles into ``occ_geom`` (a deliberate trade — scenes without
    textured alpha materials build no split at all).
    """
    occ_geom: SceneArrays
    geom: SceneArrays
    uv: jnp.ndarray
    max_hits: int = pytree.static_field(default=4)


@pytree.dataclass
class WhittedScene:
    """World-space scene for the whitted/direct-lighting pipeline.

    ``geom`` reuses the path tracer's SceneArrays (so all intersection
    backends work unchanged); the extra tables carry what that pipeline
    needs beyond it: per-triangle vertex attributes for smooth shading and
    the PBR/Glass/Phong material model (``cuda/MaterialData.h`` parity).
    """
    geom: SceneArrays
    # Per-triangle vertex attributes [T, 16]:
    # n0 xyz, n1 xyz, n2 xyz, uv0, uv1, uv2 (2 each), pad.
    vtx_attr: jnp.ndarray
    # Materials.
    base_color: jnp.ndarray     # [M, 4] rgba factor
    metallic: jnp.ndarray       # [M]
    roughness: jnp.ndarray      # [M]
    emissive: jnp.ndarray       # [M, 3]
    kind: jnp.ndarray           # [M] i32 (KIND_*)
    alpha_mode: jnp.ndarray     # [M] i32
    alpha_cutoff: jnp.ndarray   # [M]
    ior: jnp.ndarray            # [M] (glass)
    phong_ks: jnp.ndarray       # [M, 3] specular color (phong/metal)
    phong_exp: jnp.ndarray      # [M]
    phong_kr: jnp.ndarray       # [M, 3] reflectivity
    # CheckerPhong second parameter set (MaterialData.h CheckerPhong):
    # Kd2 xyz, Ks2 xyz, Kr2 xyz, phong_exp2, inv_checker_size u, v.
    # Set 1 is the regular base_color/phong_* tables; a KIND_CHECKER
    # material swaps to this set on even checker cells.
    checker2: jnp.ndarray       # [M, 12]
    tex_id: jnp.ndarray         # [M] i32, -1 = none
    tex_uvx: jnp.ndarray        # [M, 6] UV affine rows (m00 m01 ou m10
                                # m11 ov): KHR_texture_transform / the
                                # reference's texture offset/rotation/
                                # scale (cuda/LocalShading.h:52-66)
    ntex_id: jnp.ndarray        # [M] i32 normal-map texture, -1 = none
    ntex_scale: jnp.ndarray     # [M] normal-map strength (glTF scale)
    mrtex_id: jnp.ndarray       # [M] i32 metallic-roughness texture
                                # (G=roughness, B=metallic), -1 = none
    etex_id: jnp.ndarray        # [M] i32 emissive texture, -1 = none
    # Per-triangle UV-space tangent [T, 3] for normal mapping (flat per
    # triangle — the reference derives dpdu at the hit from the same
    # vertex UVs, cuda/LocalGeometry.h; divergence: no per-vertex
    # tangent interpolation, geometrically equivalent for flat UVs).
    tri_tangent: jnp.ndarray
    # Lights (cuda/Light.h parity: Point + Ambient).
    light_pos: jnp.ndarray      # [L, 3]
    light_color: jnp.ndarray    # [L, 3] (intensity-scaled)
    ambient: jnp.ndarray        # [3]
    # Textures: tuple of [h, w, 4] float arrays (static length pytree).
    textures: tuple
    # Per-texture (wrapS, wrapT) GL enums from the glTF ``samplers`` array
    # (the reference stores these per texture via ``Scene::addSampler`` and
    # samples through them in cuda/whitted.cu). Static — the sampler loop
    # in ``whitted._sample_textures`` is unrolled per texture anyway.
    # 10497=REPEAT (default), 33071=CLAMP_TO_EDGE, 33648=MIRRORED_REPEAT.
    tex_wrap: tuple = pytree.static_field(default=())
    # Static capability flags (not traced): let the renderer skip whole
    # sampling passes for scenes that lack the channel. Conservative
    # default True — masked math stays correct either way.
    has_normal_maps: bool = pytree.static_field(default=True)
    has_mr_tex: bool = pytree.static_field(default=True)
    has_emissive_tex: bool = pytree.static_field(default=True)
    # First perspective camera declared by the asset, as
    # (eye, lookat, up, fov_y_degrees) host tuples — the reference
    # loads glTF cameras into its Camera the same way
    # (``sutil/Scene.cpp:166-191``; divergence: the reference leaves
    # lookat at the Camera default, here it is eye + the node's world
    # -Z view direction). Empty tuple = none declared.
    camera: tuple = pytree.static_field(default=())
    # Fractional shadow-occlusion split (AlphaOccluders) for scenes
    # with textured alpha-mask/blend materials; None = every occluder
    # is boolean and the plain occlusion sweep serves shadows.
    alpha_occ: AlphaOccluders | None = None

    def world_bounds(self):
        """(lo, hi) world-space scene AABB as numpy [3] arrays."""
        v = np.asarray(self.geom.tri_v0)[np.asarray(self.geom.tri_valid)]
        return v.min(axis=0), v.max(axis=0)


def _default_whitted_tables(n_mats: int):
    return dict(
        base_color=np.tile(np.array([0.8, 0.8, 0.8, 1.0], np.float32),
                           (n_mats, 1)),
        metallic=np.zeros(n_mats, np.float32),
        roughness=np.full(n_mats, 0.5, np.float32),
        emissive=np.zeros((n_mats, 3), np.float32),
        kind=np.full(n_mats, KIND_PBR, np.int32),
        alpha_mode=np.zeros(n_mats, np.int32),
        alpha_cutoff=np.full(n_mats, 0.5, np.float32),
        ior=np.full(n_mats, 1.5, np.float32),
        phong_ks=np.zeros((n_mats, 3), np.float32),
        phong_exp=np.full(n_mats, 32.0, np.float32),
        phong_kr=np.zeros((n_mats, 3), np.float32),
        checker2=np.tile(np.array([0.3] * 3 + [0.0] * 6 + [32.0, 1.0, 1.0],
                                  np.float32), (n_mats, 1)),
        tex_id=np.full(n_mats, -1, np.int32),
        tex_uvx=np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                        (n_mats, 1)),
        ntex_id=np.full(n_mats, -1, np.int32),
        ntex_scale=np.ones(n_mats, np.float32),
        mrtex_id=np.full(n_mats, -1, np.int32),
        etex_id=np.full(n_mats, -1, np.int32),
    )


class _Gltf:
    """Parsed glTF document with buffer/accessor resolution."""

    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            head = f.read(4)
            f.seek(0)
            if head == b"glTF":  # GLB container
                data = f.read()
                magic, version, _ = pystruct.unpack_from("<III", data, 0)
                assert version == 2, f"GLB version {version}"
                off = 12
                self.doc = None
                self.bin_chunk = b""
                while off < len(data):
                    clen, ctype = pystruct.unpack_from("<II", data, off)
                    chunk = data[off + 8: off + 8 + clen]
                    if ctype == 0x4E4F534A:  # JSON
                        self.doc = json.loads(chunk.decode())
                    elif ctype == 0x004E4942:  # BIN
                        self.bin_chunk = chunk
                    off += 8 + clen
                assert self.doc is not None, "GLB missing JSON chunk"
            else:
                self.doc = json.load(f)
                self.bin_chunk = b""
        self._buffers = {}

    def buffer(self, idx: int) -> bytes:
        if idx in self._buffers:
            return self._buffers[idx]
        b = self.doc["buffers"][idx]
        uri = b.get("uri")
        if uri is None:
            data = self.bin_chunk
        elif uri.startswith("data:"):
            data = base64.b64decode(uri.split(",", 1)[1])
        else:
            with open(os.path.join(self.base_dir, uri), "rb") as f:
                data = f.read()
        self._buffers[idx] = data
        return data

    def _bufferview_items(self, bv_idx: int, byte_off: int, n: int,
                          dtype, ncomp: int) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize * ncomp
        bv = self.doc["bufferViews"][bv_idx]
        data = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + byte_off
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            return np.frombuffer(data, dtype, n * ncomp, start).reshape(
                n, ncomp)
        out = np.empty((n, ncomp), dtype)
        for i in range(n):
            out[i] = np.frombuffer(data, dtype, ncomp, start + i * stride)
        return out

    def accessor(self, idx: int) -> np.ndarray:
        a = self.doc["accessors"][idx]
        n = a["count"]
        ncomp = _NCOMP[a["type"]]
        dtype = _CTYPE[a["componentType"]]
        if "bufferView" in a:
            out = self._bufferview_items(a["bufferView"],
                                         a.get("byteOffset", 0), n,
                                         dtype, ncomp)
        else:
            # Spec: accessors without a bufferView read as zeros (the
            # base of a sparse accessor, commonly).
            out = np.zeros((n, ncomp), dtype)
        sp = a.get("sparse")
        if sp:
            # Sparse accessor (glTF 2.0 core): replace `count` items of
            # the base at the given indices — tinygltf parity
            # (``sutil::Scene`` consumes them through tinygltf).
            sn = sp["count"]
            si = sp["indices"]
            sv = sp["values"]
            ids = self._bufferview_items(
                si["bufferView"], si.get("byteOffset", 0), sn,
                _CTYPE[si["componentType"]], 1).reshape(-1).astype(np.int64)
            vals = self._bufferview_items(
                sv["bufferView"], sv.get("byteOffset", 0), sn, dtype,
                ncomp)
            out = out.copy()
            out[ids] = vals
        if a.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
            if np.iinfo(dtype).min < 0:
                # Signed normalized: max(c / imax, -1) per glTF 2.0
                # §3.6.2.2 (-128 would otherwise decode to -1.0079).
                out = np.maximum(out, -1.0)
        return np.ascontiguousarray(out)


def _gpu_instance_matrices(g, ext: dict, parent: np.ndarray):
    """``EXT_mesh_gpu_instancing`` -> per-instance world matrices.

    The extension carries per-instance TRANSLATION/ROTATION/SCALE
    accessors on a mesh node (the interchange format real instanced
    assets use — forests, cities — instead of thousands of nodes); the
    instance transform composes as nodeWorld @ T @ R @ S per element
    (spec: the node's own TRS applies first, then each instance's).
    Rotation accessors may be normalized int8/int16 per the spec;
    floats pass through."""
    attrs = ext.get("attributes", {})
    if not attrs:
        return []

    def acc(name, width):
        if name not in attrs:
            return None
        a = g.accessor(attrs[name]).reshape(-1, width)
        if a.dtype in (np.int8, np.int16):
            # KHR normalized signed: max(x / (2^(b-1) - 1), -1).
            a = np.maximum(
                a.astype(np.float32)
                / np.float32(np.iinfo(a.dtype).max), -1.0)
        return a.astype(np.float32)

    tr = acc("TRANSLATION", 3)
    rot = acc("ROTATION", 4)
    sc = acc("SCALE", 3)
    n = max(x.shape[0] for x in (tr, rot, sc) if x is not None)
    out = []
    for i in range(n):
        m = ml.mat4_identity()
        if sc is not None:
            m = ml.mat4_scale(sc[i]) @ m
        if rot is not None:
            x, y, z, w = rot[i]            # glTF stores xyzw
            m = ml.quat_to_mat4([w, x, y, z]) @ m
        if tr is not None:
            m = ml.mat4_translate(tr[i]) @ m
        out.append(parent @ m)
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = ml.mat4_identity()
    if "scale" in node:
        m = ml.mat4_scale(node["scale"]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]  # glTF stores xyzw
        m = ml.quat_to_mat4([w, x, y, z]) @ m
    if "translation" in node:
        m = ml.mat4_translate(node["translation"]) @ m
    return m


def _decode_image_bytes(blob: bytes) -> np.ndarray:
    """Sniff + decode an in-memory image (PNG/JPEG/PPM) to uint8
    [h, w, 3 or 4] — PNG alpha is preserved (base-color ``.w`` drives
    the reference's alpha-mode anyhit programs, ``cuda/whitted.cu:
    100-138``).

    JPEG is glTF-core-mandatory; the reference gets it from tinygltf's
    stb_image (``sutil/Scene.cpp:267-550``) — here ``tpu_pt.jpeg``."""
    from .. import film, jpeg
    if blob[:8] == b"\x89PNG\r\n\x1a\n":
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".png") as f:
            f.write(blob)
            f.flush()
            return film.read_png_rgba(f.name)
    if blob[:2] == b"\xff\xd8":
        return jpeg.decode_jpeg(blob)
    if blob[:2] in (b"P6", b"P3"):
        import tempfile
        with tempfile.NamedTemporaryFile(suffix=".ppm") as f:
            f.write(blob)
            f.flush()
            return film.read_ppm(f.name)
    raise ValueError("unsupported image format (PNG/JPEG/PPM supported)")


def _decode_image(g: _Gltf, img: dict) -> np.ndarray:
    """Image -> float [h, w, 4]. PNG/JPEG everywhere (glTF core);
    external-file PPM too (the reference textures from PPM via
    ``sutil::loadTexture`` / ``PPMLoader``)."""
    if "uri" in img and not img["uri"].startswith("data:"):
        with open(os.path.join(g.base_dir, img["uri"]), "rb") as f:
            blob = f.read()
    elif "uri" in img:
        blob = base64.b64decode(img["uri"].split(",", 1)[1])
    else:
        bv = g.doc["bufferViews"][img["bufferView"]]
        data = g.buffer(bv["buffer"])
        off = bv.get("byteOffset", 0)
        blob = data[off: off + bv["byteLength"]]
    px = _decode_image_bytes(blob)
    rgba = np.ones((*px.shape[:2], 4), np.float32)
    rgba[..., :px.shape[2]] = px.astype(np.float32) / 255.0
    return rgba


# Device bytes per flattened triangle: SceneArrays v0/e1/e2/normal,
# valid and mat_id (53 B), vtx_attr (64 B), tri_tangent (12 B), the NEE
# occluder index (4 B) and the LBVH (2T - 1 nodes of 24 f32 and three
# i32 each, ~216 B).
_BYTES_PER_FLAT_TRI = 349

# Share of the device's memory the flattened triangle tables may take;
# the rest holds the wavefront state and the compiled frame's buffers.
_FLAT_MEMORY_SHARE = 0.5


def _device_bytes_limit() -> int:
    """Memory this process's first device lets it allocate (a device
    of another process reports no stats). A device that reports no
    limit (the CPU) counts the host's physical memory."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    if "bytes_limit" in stats:
        return int(stats["bytes_limit"])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def default_max_flat_tris() -> int:
    """Flattened-triangle bound derived from the device's memory."""
    return int(_device_bytes_limit() * _FLAT_MEMORY_SHARE
               // _BYTES_PER_FLAT_TRI)


def load_gltf(path: str, default_lights: bool = True,
              max_flat_tris: int | None = None) -> WhittedScene:
    """Load a .gltf/.glb file into a WhittedScene.

    Instances flatten to world space (module docstring).
    ``max_flat_tris`` bounds the flattened triangle count (default
    :func:`default_max_flat_tris`, from the device's memory); a scene
    whose instancing expands past the bound raises ValueError naming the
    amplification instead of exhausting memory."""
    if max_flat_tris is None:
        max_flat_tris = default_max_flat_tris()
    g = _Gltf(path)
    doc = g.doc
    mesh_uses: dict = {}      # mesh idx -> instance count (guardrail)

    tris_v = []        # [T, 3, 3] world-space triangle vertices
    tris_n = []        # [T, 3, 3] world-space vertex normals
    tris_uv = []       # [T, 3, 2]
    tri_mat = []       # [T]

    flat_count = [0]

    def _flat_guard(extra: int):
        """Enforce the instancing bound BEFORE transforming the next
        primitive (triangle counts come from accessor metadata, so the
        pathological scene is rejected without materializing it —
        raising only after walk() would OOM first)."""
        flat_count[0] += extra
        if flat_count[0] <= max_flat_tris:
            return
        n_inst = sum(mesh_uses.values())
        worst = max(mesh_uses.values(), default=1)
        raise ValueError(
            f"{os.path.basename(path)}: instance flattening expands to "
            f">= {flat_count[0]:,} world-space triangles "
            f"(~{flat_count[0] * _BYTES_PER_FLAT_TRI / 1e9:.1f} GB of "
            f"tables; {n_inst} mesh instances over {len(mesh_uses)} "
            f"meshes so far, most-instanced mesh used {worst}x) — past "
            f"the {max_flat_tris:,}-triangle bound derived from the "
            f"device's memory. tpu_pt flattens instances (scene/gltf.py "
            f"module docstring), so memory scales O(instances x mesh "
            f"size); load_gltf(max_flat_tris=...) sets another bound.")

    # Per-mesh decode cache: instanced meshes (the forest case — one
    # tree node-referenced hundreds of times) decode their accessors
    # ONCE; each instance only pays the world transform. This is the
    # shared-mesh half of the reference's IAS (``Scene.cpp:1134-1213``)
    # — the flatten (below) is the deliberate world-space half.
    mesh_cache: dict = {}

    def _decoded_mesh(mesh_idx: int):
        if mesh_idx in mesh_cache:
            return mesh_cache[mesh_idx]
        prims_out = []
        for prim in doc["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue  # triangles only
            attrs = prim["attributes"]
            pos = g.accessor(attrs["POSITION"]).astype(np.float32)
            if "indices" in prim:
                idx = g.accessor(prim["indices"]).reshape(-1).astype(
                    np.int64)
            else:
                idx = np.arange(pos.shape[0], dtype=np.int64)
            idx = idx.reshape(-1, 3)
            nrm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                   if "NORMAL" in attrs else None)
            uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs
                  else np.zeros((pos.shape[0], 2), np.float32))
            prims_out.append((pos, idx, nrm, uv,
                              prim.get("material", 0)))
        mesh_cache[mesh_idx] = prims_out
        return prims_out

    def emit_mesh(mesh_idx: int, xform: np.ndarray):
        for pos, idx, nrm, uv, mat in _decoded_mesh(mesh_idx):
            _flat_guard(idx.shape[0])
            world_pos = ml.transform_points(xform, pos)
            tv = world_pos[idx]                      # [t, 3, 3]
            if nrm is None:
                e1 = tv[:, 1] - tv[:, 0]
                e2 = tv[:, 2] - tv[:, 0]
                gn = np.cross(e1, e2)
                gn /= np.maximum(np.linalg.norm(gn, axis=-1,
                                                keepdims=True), 1e-30)
                tn = np.repeat(gn[:, None, :], 3, axis=1)
            else:
                tn = ml.transform_normals(xform, nrm)[idx]
            tris_v.append(tv)
            tris_n.append(tn)
            tris_uv.append(uv[idx])
            tri_mat.append(np.full(tv.shape[0], mat, np.int64))

    lights_pos, lights_color = [], []
    cameras = []
    ambient = np.array([0.1, 0.1, 0.1], np.float32)

    inst_records: list = []   # (mesh idx, world 4x4) in walk order

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        xform = parent @ _node_matrix(node)
        if "mesh" in node:
            gpu_ext = node.get("extensions", {}).get(
                "EXT_mesh_gpu_instancing")
            if gpu_ext:
                mats = _gpu_instance_matrices(g, gpu_ext, xform)
            else:
                mats = [xform.copy()]
            mesh_uses[node["mesh"]] = (mesh_uses.get(node["mesh"], 0)
                                       + len(mats))
            for m in mats:
                inst_records.append((node["mesh"], m))
        if "camera" in node:
            cameras.append((node["camera"], xform.copy()))
        light_ref = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_ref is not None:
            light = doc["extensions"]["KHR_lights_punctual"]["lights"][
                light_ref]
            color = np.asarray(light.get("color", [1, 1, 1]), np.float32)
            intensity = float(light.get("intensity", 1.0))
            if light.get("type") == "point":
                lights_pos.append(xform[:3, 3].copy())
                lights_color.append(color * intensity)
        for child in node.get("children", []):
            walk(child, xform)

    scene_idx = doc.get("scene", 0)
    roots = doc["scenes"][scene_idx]["nodes"] if doc.get("scenes") else \
        list(range(len(doc.get("nodes", []))))
    for r in roots:
        walk(r, ml.mat4_identity())

    for mesh_idx, xform in inst_records:
        emit_mesh(mesh_idx, xform)

    assert tris_v, f"no triangle geometry in {path}"
    tv = np.concatenate(tris_v)
    tn = np.concatenate(tris_n)
    tuv = np.concatenate(tris_uv)
    tmat = np.concatenate(tri_mat)

    # --- materials --------------------------------------------------------
    gmats = doc.get("materials", [{}])
    if not gmats:
        gmats = [{}]
    n_m = max(len(gmats), int(tmat.max()) + 1)
    tables = _default_whitted_tables(n_m)
    textures = []
    tex_wraps = []
    tex_cache = {}

    def _load_tex(info):
        """Texture info -> texture slot, deduped by (image, sampler)."""
        tex = doc["textures"][info["index"]]
        src = tex["source"]
        samp = tex.get("sampler", -1)
        key = (src, samp)
        if key not in tex_cache:
            wrap_s = wrap_t = 10497                  # REPEAT default
            if samp >= 0:
                s = doc.get("samplers", [])[samp]
                wrap_s = s.get("wrapS", 10497)
                wrap_t = s.get("wrapT", 10497)
            tex_cache[key] = len(textures)
            textures.append(jnp.asarray(
                _decode_image(g, doc["images"][src])))
            tex_wraps.append((wrap_s, wrap_t))
        return tex_cache[key]

    for i, m in enumerate(gmats):
        pbr = m.get("pbrMetallicRoughness", {})
        tables["base_color"][i] = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        tables["metallic"][i] = pbr.get("metallicFactor", 1.0)
        tables["roughness"][i] = pbr.get("roughnessFactor", 1.0)
        tables["emissive"][i] = np.asarray(
            m.get("emissiveFactor", [0, 0, 0]), np.float32)
        mode = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK,
                "BLEND": ALPHA_BLEND}[m.get("alphaMode", "OPAQUE")]
        tables["alpha_mode"][i] = mode
        tables["alpha_cutoff"][i] = m.get("alphaCutoff", 0.5)
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            tables["tex_id"][i] = _load_tex(bct)
            xf = bct.get("extensions", {}).get("KHR_texture_transform")
            if xf:
                ox, oy = xf.get("offset", [0.0, 0.0])
                sx, sy = xf.get("scale", [1.0, 1.0])
                r = xf.get("rotation", 0.0)
                cr, sr = np.cos(r), np.sin(r)
                # uv' = T * R * S * [u, v, 1] (KHR_texture_transform
                # spec; matches the reference's texcoord transform in
                # cuda/LocalShading.h).
                tables["tex_uvx"][i] = [sx * cr, sy * sr, ox,
                                        -sx * sr, sy * cr, oy]
        mrt = pbr.get("metallicRoughnessTexture")
        if mrt is not None:
            # G=roughness, B=metallic, linear (MaterialData.h:83).
            tables["mrtex_id"][i] = _load_tex(mrt)
        et = m.get("emissiveTexture")
        if et is not None:
            tables["etex_id"][i] = _load_tex(et)    # sRGB, x factor
        nt = m.get("normalTexture")
        if nt is not None:
            # Tangent-space normal map (whitted.cu normal mapping
            # parity); stored linearly, decoded at sample time with
            # srgb=False.
            tables["ntex_id"][i] = _load_tex(nt)
            tables["ntex_scale"][i] = nt.get("scale", 1.0)

    # --- flatten into SceneArrays (path-tracer-compatible geometry) -------
    n_t = tv.shape[0]
    verts = tv.reshape(-1, 3)
    idx = np.arange(n_t * 3, dtype=np.int64).reshape(-1, 3)
    pt_mats = []
    for i in range(n_m):
        pt_mats.append(dict(
            diffuse=tuple(tables["base_color"][i, :3]),
            emission=tuple(tables["emissive"][i]),
            roughness=float(tables["roughness"][i]),
            metallic=float(tables["metallic"][i]),
            ior=float(tables["ior"][i]),
            bsdf=BSDF_REFRACTION if tables["kind"][i] == KIND_GLASS
            else BSDF_DIFFUSE,
        ))
    geom, host = build_scene_arrays(verts, idx, tmat, pt_mats,
                                    light=default_cornell_light(),
                                    return_host=True)

    # Pad per-tri attributes to the padded triangle count.
    t_pad = geom.num_tris_padded
    vtx_attr = np.zeros((t_pad, 16), np.float32)
    vtx_attr[:n_t, 0:9] = tn.reshape(n_t, 9)
    vtx_attr[:n_t, 9:15] = tuv.reshape(n_t, 6)

    # Per-triangle UV-space tangent (dP/du) for normal mapping: solve
    # [e1; e2] = [duv1; duv2] @ [T; B] per triangle; degenerate UVs get
    # an arbitrary edge-aligned tangent (orthonormalized at shade time).
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    duv1 = tuv[:, 1] - tuv[:, 0]
    duv2 = tuv[:, 2] - tuv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, det, 1.0)
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) / inv_det[:, None]
    tangent = np.where(ok[:, None], tangent, e1)
    tri_tangent = np.zeros((t_pad, 3), np.float32)
    tri_tangent[:n_t] = tangent

    # First perspective camera (sutil::Scene::processGLTFNode parity,
    # ``Scene.cpp:166-191``): eye = node world origin, up = worldized
    # +Y, fov from yfov; the view direction is the node's world -Z
    # (glTF convention), focal distance scaled to the scene extent so
    # trackball orbits behave.
    cam_tuple = ()
    ext_lo, ext_hi = verts.min(axis=0), verts.max(axis=0)

    gcams = doc.get("cameras", [])
    for cam_idx, xform in cameras:
        if not 0 <= cam_idx < len(gcams):
            continue                    # dangling reference: skip node
        gc = gcams[cam_idx]
        if gc.get("type") != "perspective":
            continue
        eye = xform[:3, 3].astype(np.float32)
        fwd = -xform[:3, 2]
        n_f = np.linalg.norm(fwd)
        fwd = (fwd / n_f if n_f > 0 else np.array([0, 0, -1.0])).astype(
            np.float32)
        up_v = xform[:3, 1].astype(np.float32)
        fov = float(np.degrees(gc.get("perspective", {}).get(
            "yfov", np.radians(45.0))))
        lo, hi = ext_lo, ext_hi
        focal = max(1.0, 0.5 * float(np.linalg.norm(hi - lo)))
        cam_tuple = (tuple(float(x) for x in eye),
                     tuple(float(x) for x in eye + fwd * focal),
                     tuple(float(x) for x in up_v), fov)
        break

    if not lights_pos and default_lights:
        # The reference app sets two default point lights when the scene
        # has none (whitted-pipeline host setup).
        lo, hi = ext_lo, ext_hi
        c = 0.5 * (lo + hi)
        ext = float(np.linalg.norm(hi - lo))
        lights_pos = [c + np.array([0.6, 1.0, 0.4]) * ext,
                      c + np.array([-0.5, 0.8, -0.6]) * ext]
        lights_color = [np.array([0.8, 0.8, 0.8], np.float32),
                        np.array([0.4, 0.4, 0.4], np.float32)]

    if lights_pos:
        # The occluder subset computed inside build_scene_arrays used
        # only the (path-tracer) area-light quad as segment endpoints;
        # whitted shadow segments end at the POINT lights, which can sit
        # outside the scene AABB (a light below a ground plane makes the
        # plane a real occluder). Recompute with both endpoint sets so
        # ONE subset is valid for both pipelines.
        from .arrays import _host_light, nee_occluder_index
        refr = host["mat_bsdf"][host["mat_id"]] == BSDF_REFRACTION
        occ_index, n_occ = nee_occluder_index(
            host["v0"], host["e1"], host["e2"], host["valid"], refr,
            _host_light(default_cornell_light()),
            extra_endpoints=np.asarray(lights_pos, np.float32))
        geom = geom.replace(occ_index=jnp.asarray(occ_index),
                            num_occluders=n_occ)

    from ..intersect.lbvh import with_bvh
    geom = with_bvh(geom, host=host)

    # --- fractional shadow occlusion split (whitted.cu:113-138) -----------
    # Textured non-opaque materials transmit shadow rays fractionally in
    # the reference's __anyhit__occlusion; split their triangles out of
    # the boolean occlusion geometry once at load (see AlphaOccluders).
    alpha_mat_mask = ((tables["alpha_mode"] != ALPHA_OPAQUE)
                      & (tables["tex_id"] >= 0))
    tri_alpha = alpha_mat_mask[np.clip(tmat, 0, n_m - 1)]
    occ_geom = alpha_geom = alpha_uv = None
    if tri_alpha.any():
        def _sub_geom(sel):
            sverts = tv[sel].reshape(-1, 3)
            sidx = np.arange(sverts.shape[0],
                             dtype=np.int64).reshape(-1, 3)
            return build_scene_arrays(sverts, sidx, tmat[sel], pt_mats,
                                      light=default_cornell_light(),
                                      return_host=True)
        occ_geom, occ_host = _sub_geom(~tri_alpha)
        if lights_pos:
            from .arrays import _host_light, nee_occluder_index
            o_refr = occ_host["mat_bsdf"][occ_host["mat_id"]] \
                == BSDF_REFRACTION
            o_idx, o_n = nee_occluder_index(
                occ_host["v0"], occ_host["e1"], occ_host["e2"],
                occ_host["valid"], o_refr,
                _host_light(default_cornell_light()),
                extra_endpoints=np.asarray(lights_pos, np.float32))
            occ_geom = occ_geom.replace(occ_index=jnp.asarray(o_idx),
                                        num_occluders=o_n)
        occ_geom = with_bvh(occ_geom, host=occ_host)
        alpha_geom, _ = _sub_geom(tri_alpha)
        n_a = int(tri_alpha.sum())
        alpha_uv = np.zeros((alpha_geom.num_tris_padded, 6), np.float32)
        alpha_uv[:n_a] = tuv[tri_alpha].reshape(n_a, 6)

    # Analytic primitives from the document's application-specific
    # ``extras`` (valid glTF 2.0: extras carry arbitrary JSON). The
    # reference binds sphere / sphere-shell / parallelogram intersection
    # programs into its whitted SBT from hardcoded sample setup
    # (``sutil/Scene.cpp:1368-1450``, ``cuda/geometry.cu:38-144``,
    # ``cuda/sphere.cu:37-97``); here the same capability is reachable
    # from the asset itself:
    #   "extras": {"tpu_pt_primitives": [
    #     {"type": "sphere", "center": [x,y,z], "radius": r,
    #      "material": <glTF material index>}, ...]}
    # Primitive hits shade with their analytic normal and carry the glTF
    # material; KIND_GLASS primitives pass shadow rays (the refractive
    # non-occluding convention both pipelines share).
    extra_prims = doc.get("extras", {}).get("tpu_pt_primitives", [])
    if extra_prims:
        from ..intersect import primitives as _prims
        kind_map = {"sphere": _prims.PRIM_SPHERE,
                    "parallelogram": _prims.PRIM_PARALLELOGRAM,
                    "sphere_shell": _prims.PRIM_SPHERE_SHELL}
        specs = []
        for p in extra_prims:
            d = dict(kind=kind_map[p["type"]],
                     mat=int(p.get("material", 0)))
            if p["type"] == "sphere":
                d.update(center=p["center"], radius=p["radius"])
            elif p["type"] == "sphere_shell":
                d.update(center=p["center"], radius1=p["radius1"],
                         radius2=p["radius2"])
            else:
                d.update(anchor=p["anchor"], v1=p["v1"], v2=p["v2"])
            specs.append(d)
        # occludes: glass primitives pass light (reference convention).
        fake_bsdf = np.where(tables["kind"] == KIND_GLASS,
                             BSDF_REFRACTION, BSDF_DIFFUSE)
        the_prims = _prims.make_primitives(specs, mat_bsdf=fake_bsdf)
        geom = geom.replace(prims=the_prims)
        if occ_geom is not None:    # prims occlude boolean-ly
            occ_geom = occ_geom.replace(prims=the_prims)

    # Swept-sphere curves from the document extras — the mirror of
    # ``tpu_pt_primitives`` for the reference's four round-curve types
    # (``cuda/GeometryData.h:95-127``; shading normals ``cuda/curve.h:
    # 312-443``):
    #   "extras": {"tpu_pt_curves": [
    #     {"basis": "linear" | "quadratic_bspline" | "cubic_bspline" |
    #      "catmullrom", "points": [[x,y,z], ...],
    #      "radii": r | [r, ...], "material": <glTF material index>}]}
    # Curve hits shade with the exact swept-sphere normal (they carry no
    # vertex attributes, so the whitted shader takes its analytic-normal
    # branch); KIND_GLASS curves pass shadow rays. NOTE the scale
    # ceiling: ``intersect_curves`` sweeps ALL rays against ALL S x 8
    # tessellated pieces per bounce (``intersect/curves.py``) — fine for
    # decorative strands, wrong for 10k-segment hair assets.
    extra_curves = doc.get("extras", {}).get("tpu_pt_curves", [])
    if extra_curves:
        from ..intersect.curves import expand_curve_spec, make_curves
        fake_bsdf = np.where(tables["kind"] == KIND_GLASS,
                             BSDF_REFRACTION, BSDF_DIFFUSE)
        segs = []
        for c in extra_curves:
            segs.extend(expand_curve_spec(c, int(c.get("material", 0))))
        the_curves = make_curves(segs, mat_bsdf=fake_bsdf)
        geom = geom.replace(curves=the_curves)
        if occ_geom is not None:    # curves occlude boolean-ly
            occ_geom = occ_geom.replace(curves=the_curves)

    return WhittedScene(
        geom=geom,
        vtx_attr=jnp.asarray(vtx_attr),
        base_color=jnp.asarray(tables["base_color"]),
        metallic=jnp.asarray(tables["metallic"]),
        roughness=jnp.asarray(tables["roughness"]),
        emissive=jnp.asarray(tables["emissive"]),
        kind=jnp.asarray(tables["kind"]),
        alpha_mode=jnp.asarray(tables["alpha_mode"]),
        alpha_cutoff=jnp.asarray(tables["alpha_cutoff"]),
        ior=jnp.asarray(tables["ior"]),
        phong_ks=jnp.asarray(tables["phong_ks"]),
        phong_exp=jnp.asarray(tables["phong_exp"]),
        phong_kr=jnp.asarray(tables["phong_kr"]),
        checker2=jnp.asarray(tables["checker2"]),
        tex_id=jnp.asarray(tables["tex_id"]),
        tex_uvx=jnp.asarray(tables["tex_uvx"]),
        ntex_id=jnp.asarray(tables["ntex_id"]),
        ntex_scale=jnp.asarray(tables["ntex_scale"]),
        mrtex_id=jnp.asarray(tables["mrtex_id"]),
        etex_id=jnp.asarray(tables["etex_id"]),
        tri_tangent=jnp.asarray(tri_tangent),
        light_pos=jnp.asarray(np.asarray(lights_pos, np.float32).reshape(
            -1, 3)),
        light_color=jnp.asarray(np.asarray(lights_color,
                                           np.float32).reshape(-1, 3)),
        ambient=jnp.asarray(ambient),
        textures=tuple(textures),
        tex_wrap=tuple(tex_wraps),
        has_normal_maps=bool((tables["ntex_id"] >= 0).any()),
        has_mr_tex=bool((tables["mrtex_id"] >= 0).any()),
        has_emissive_tex=bool((tables["etex_id"] >= 0).any()),
        camera=cam_tuple,
        alpha_occ=None if occ_geom is None else AlphaOccluders(
            occ_geom=occ_geom, geom=alpha_geom,
            uv=jnp.asarray(alpha_uv),
            # Each alpha triangle can be hit at most once per segment,
            # so n_alpha marches are exact; the knob caps the unrolled
            # march for alpha-heavy scenes (foliage) — hits past the
            # cap go unaccounted (their <= 1 factors are skipped), a
            # small bias toward brighter shadows.
            max_hits=min(int(tri_alpha.sum()),
                         int(os.environ.get("TPT_ALPHA_OCC_K", "8")
                             or 8))),
    )
