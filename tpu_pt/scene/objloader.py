"""Wavefront OBJ + MTL loader with name-based BSDF classification.

Capability parity with ``TinyObjWrapper`` (``PathTracer_Optix/
TinyObjWrapper.{h,cpp}``): triangulating OBJ parse, per-face material indices,
flattened index buffer, and material conversion including the reference's
BSDF-classification-by-material-name rule (``TinyObjWrapper.cpp:153-164``):
a name containing "Refractive" -> refraction, "Metallic" -> metallic,
anything else -> diffuse.

This is the pure-Python implementation; ``tpu_pt.native`` provides a C++
fast path with identical output (used automatically for large meshes).
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp
import numpy as np

from .arrays import (BSDF_DIFFUSE, BSDF_METALLIC, BSDF_REFRACTION,
                     SceneArrays, build_scene_arrays, AreaLight,
                     default_cornell_light)


@dataclasses.dataclass
class Material:
    """Host-side material (parity: ``TinyObjWrapper.h:33-40`` Material)."""
    name: str = ""
    diffuse: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0
    ior: float = 1.0
    bsdf: int = BSDF_DIFFUSE

    def as_dict(self) -> dict:
        return dict(diffuse=self.diffuse, emission=self.emission,
                    roughness=self.roughness, metallic=self.metallic,
                    ior=self.ior, bsdf=self.bsdf)


def classify_bsdf(name: str) -> int:
    """Name-substring BSDF classification (``TinyObjWrapper.cpp:153-164``)."""
    if "Refractive" in name:
        return BSDF_REFRACTION
    if "Metallic" in name:
        return BSDF_METALLIC
    return BSDF_DIFFUSE


def parse_mtl(path: str) -> dict[str, Material]:
    """Parse a .mtl file. Supports Kd, Ke, Ni, Pr (roughness), Pm (metallic)."""
    mats: dict[str, Material] = {}
    cur: Material | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                name = " ".join(parts[1:])
                cur = Material(name=name, bsdf=classify_bsdf(name))
                mats[name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == "Ni" and len(parts) >= 2:
                cur.ior = float(parts[1])
            elif key == "Pr" and len(parts) >= 2:
                cur.roughness = float(parts[1])
            elif key == "Pm" and len(parts) >= 2:
                cur.metallic = float(parts[1])
    return mats


class ObjMesh:
    """Parsed OBJ: vertices [V,3], triangles [T,3], per-tri material ids [T].

    API mirrors ``TinyObjWrapper`` getters (``TinyObjWrapper.h:80-93``).
    """

    def __init__(self):
        self.vertices = np.zeros((0, 3), np.float32)
        self.indices = np.zeros((0, 3), np.int64)
        self.mat_indices = np.zeros((0,), np.int64)
        self.materials: list[Material] = []

    # -- TinyObjWrapper-parity getters ------------------------------------
    def get_vertices_float(self) -> np.ndarray:
        """Vertices as [V, 4] with w = 1 (``TinyObjWrapper.cpp:200-221``)."""
        v4 = np.ones((self.vertices.shape[0], 4), np.float32)
        v4[:, :3] = self.vertices
        return v4

    def get_index_buffer(self) -> np.ndarray:
        return self.indices.reshape(-1)

    def get_material_indices(self) -> np.ndarray:
        return self.mat_indices

    def get_materials(self) -> list[Material]:
        return self.materials

    def get_num_materials(self) -> int:
        return len(self.materials)


def load_obj(path: str, use_native: bool | None = None) -> ObjMesh:
    """Parse an OBJ file; polygons are fan-triangulated (tinyobj
    ``triangulate=true`` parity, ``TinyObjWrapper.cpp:43``).

    Uses the native C++ parser (``tpu_pt.native``) when available (set
    ``use_native=False`` or env ``TPU_PT_NO_NATIVE=1`` to force the pure-
    Python path); both produce identical output (tested).
    """
    if use_native is None:
        use_native = os.environ.get("TPU_PT_NO_NATIVE", "") != "1"
    if use_native:
        try:
            from .. import native
            if native.available():
                return _mesh_from_native(path)
        except Exception:
            pass  # fall back to the Python parser
    return _load_obj_python(path)


def _mesh_from_native(path: str) -> ObjMesh:
    from .. import native
    verts, idx, mat_ids, mats = native.load_obj_native(path)
    mesh = ObjMesh()
    mesh.vertices = verts
    mesh.indices = idx
    materials = []
    for m in mats:
        materials.append(Material(
            name=m["name"], diffuse=m["diffuse"], emission=m["emission"],
            roughness=m["roughness"], metallic=m["metallic"], ior=m["ior"],
            bsdf=classify_bsdf(m["name"])))
    if not materials:
        materials = [Material(name="default")]
    mesh.materials = materials
    mesh.mat_indices = np.clip(mat_ids, 0, len(materials) - 1)
    return mesh


def _load_obj_python(path: str) -> ObjMesh:
    mesh = ObjMesh()
    verts: list[tuple] = []
    tris: list[tuple] = []
    tri_mats: list[int] = []
    mat_lookup: dict[str, int] = {}
    materials: list[Material] = []
    cur_mat = -1
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif key == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    vi = tok.split("/")[0]
                    i = int(vi)
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    tri_mats.append(cur_mat)
            elif key == "usemtl":
                name = " ".join(parts[1:])
                if name not in mat_lookup:
                    # Forward reference to a material not in the mtl file:
                    # create a default with the classified BSDF.
                    mat_lookup[name] = len(materials)
                    materials.append(
                        Material(name=name, bsdf=classify_bsdf(name)))
                cur_mat = mat_lookup[name]
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                for name, mat in parse_mtl(mtl_path).items():
                    if name in mat_lookup:
                        materials[mat_lookup[name]] = mat
                    else:
                        mat_lookup[name] = len(materials)
                        materials.append(mat)

    if not materials:
        materials = [Material(name="default")]
    mesh.vertices = np.asarray(verts, np.float32).reshape(-1, 3)
    mesh.indices = np.asarray(tris, np.int64).reshape(-1, 3)
    mesh.mat_indices = np.clip(
        np.asarray(tri_mats, np.int64), 0, len(materials) - 1)
    mesh.materials = materials
    return mesh


def detect_area_light(mesh: ObjMesh) -> AreaLight | None:
    """Derive an AreaLight from the scene's emissive quad, if one exists.

    The reference hardcodes the Cornell light (``PathTracerMain.cpp:154-158``)
    independent of scene content; we detect a 2-triangle emissive rectangle so
    arbitrary OBJ scenes get correct NEE. Returns None when the emissive
    geometry is not a single quad.
    """
    emissive_ids = [i for i, m in enumerate(mesh.materials)
                    if float(np.linalg.norm(m.emission)) > 0.0]
    if not emissive_ids:
        return None
    sel = np.isin(mesh.mat_indices, emissive_ids)
    tri = mesh.indices[sel]
    if tri.shape[0] != 2:
        return None
    vids = np.unique(tri.reshape(-1))
    if vids.shape[0] != 4:
        return None
    pts = mesh.vertices[vids]
    # Pick corner = first point; v1, v2 = edges to its two nearest neighbors
    # among points that are not the diagonal opposite.
    c = pts[0]
    d = np.linalg.norm(pts[1:] - c, axis=1)
    far = 1 + int(np.argmax(d))
    others = [i for i in range(1, 4) if i != far]
    v1 = pts[others[0]] - c
    v2 = pts[others[1]] - c
    n = np.cross(v1, v2)
    nl = np.linalg.norm(n)
    if nl == 0:
        return None
    n = n / nl
    # Orient the light normal toward the scene (NEE's LnDl = -dot(normal, L)
    # needs the normal facing the shaded points): flip it if it points away
    # from the scene centroid. For the Cornell ceiling light this recovers
    # the reference's downward normal (``PathTracerMain.cpp:158``).
    centroid = mesh.vertices.mean(axis=0)
    light_center = c + 0.5 * (v1 + v2)
    if float(np.dot(n, centroid - light_center)) < 0.0:
        n = -n
    mat = mesh.materials[emissive_ids[0]]
    # Host (numpy) leaves: build_scene_arrays moves them to device and
    # uses the host values for occluder analysis without a D2H pull.
    return AreaLight(corner=np.asarray(c, np.float32),
                     v1=np.asarray(v1, np.float32),
                     v2=np.asarray(v2, np.float32),
                     normal=np.asarray(n, np.float32),
                     emission=np.asarray(mat.emission, np.float32))


def load_scene(path: str, light: AreaLight | None = None,
               auto_light: bool = True,
               build_bvh: bool = True) -> SceneArrays:
    """OBJ (or glTF/GLB) file -> device-ready SceneArrays (LBVH attached).

    glTF scenes route through :mod:`tpu_pt.scene.gltf`; the path tracer
    consumes their geometry + PBR-derived materials directly."""
    if path.lower().endswith(".json"):
        from .scenejson import load_scene_json
        return load_scene_json(path, light=light, auto_light=auto_light,
                               build_bvh=build_bvh)
    if path.lower().endswith((".gltf", ".glb")):
        from .gltf import load_gltf
        ws = load_gltf(path)
        scene = ws.geom
        if light is not None:
            scene = scene.replace(light=light)
        elif auto_light and ws.light_pos.shape[0] > 0:
            # Path tracing needs an area light for NEE; synthesize a small
            # downward quad at the glTF point light's position.
            pos = np.asarray(ws.light_pos)[0]
            col = np.asarray(ws.light_color)[0]
            v = np.asarray(scene.tri_v0)[np.asarray(scene.tri_valid)]
            size = 0.05 * float(np.linalg.norm(v.max(0) - v.min(0)))
            area = max(size * size, 1e-6)
            scene = scene.replace(light=AreaLight(
                corner=jnp.asarray(pos - [size / 2, 0, size / 2],
                                   jnp.float32),
                v1=jnp.asarray([size, 0.0, 0.0], jnp.float32),
                v2=jnp.asarray([0.0, 0.0, size], jnp.float32),
                normal=jnp.asarray([0.0, -1.0, 0.0], jnp.float32),
                # Point intensity -> area radiance over the quad.
                emission=jnp.asarray(col / area, jnp.float32)))
        return scene
    mesh = load_obj(path)
    if light is None and auto_light:
        light = detect_area_light(mesh)
    if light is None:
        light = default_cornell_light()
    verts, idx, mids = mesh.vertices, mesh.indices, mesh.mat_indices
    scene, host = build_scene_arrays(
        verts, idx, mids,
        [m.as_dict() for m in mesh.materials], light=light,
        return_host=True)
    if build_bvh:
        from ..intersect.lbvh import with_bvh
        scene = with_bvh(scene, host=host)
    return scene
