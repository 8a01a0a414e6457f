"""Instanced glTF assets: node instances and ``EXT_mesh_gpu_instancing``
flatten to world space at load, bounded by the memory-derived guardrail."""

import base64
import json

import numpy as np
import pytest

import tpu_pt


def _cube():
    v = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                  for z in (0, 1)], np.float32) - 0.5
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)
    return v, f


def _write_instanced_city(tmp_path, n_inst=12, indexed=True):
    """Tiny glTF: one 12-tri cube mesh instanced n times on a grid,
    with NORMAL attributes so smooth-normal interpolation runs."""
    cv, cf = _cube()
    nrm = cv / np.maximum(np.linalg.norm(cv, axis=1, keepdims=True),
                          1e-9)
    pos_b = cv.astype(np.float32).tobytes()
    nrm_b = nrm.astype(np.float32).tobytes()
    idx_b = cf.astype(np.uint16).tobytes()
    blob = pos_b + nrm_b + idx_b
    nodes = []
    rng = np.random.default_rng(5)
    for i in range(n_inst):
        ang = float(rng.random() * 6)
        s = float(0.6 + rng.random())
        c, sn = np.cos(ang), np.sin(ang)
        r = np.array([[c, 0, sn], [0, 1, 0], [-sn, 0, c]]) * s
        m = np.eye(4)
        m[:3, :3] = r
        m[:3, 3] = [(i % 4) * 3.0 - 4.5, 0.0, (i // 4) * 3.0 - 3.0]
        nodes.append(dict(mesh=0,
                          matrix=[float(x) for x in m.T.reshape(-1)]))
    doc = dict(
        asset=dict(version="2.0"), scene=0,
        scenes=[dict(nodes=list(range(n_inst)))],
        nodes=nodes,
        meshes=[dict(primitives=[dict(
            attributes=dict(POSITION=0, NORMAL=1), indices=2,
            material=0)])],
        materials=[dict(pbrMetallicRoughness=dict(
            baseColorFactor=[0.7, 0.6, 0.5, 1.0], metallicFactor=0.0,
            roughnessFactor=0.8))],
        accessors=[
            dict(bufferView=0, componentType=5126, count=8, type="VEC3",
                 min=cv.min(0).tolist(), max=cv.max(0).tolist()),
            dict(bufferView=1, componentType=5126, count=8, type="VEC3"),
            dict(bufferView=2, componentType=5123, count=cf.size,
                 type="SCALAR"),
        ],
        bufferViews=[
            dict(buffer=0, byteOffset=0, byteLength=len(pos_b)),
            dict(buffer=0, byteOffset=len(pos_b), byteLength=len(nrm_b)),
            dict(buffer=0, byteOffset=len(pos_b) + len(nrm_b),
                 byteLength=len(idx_b)),
        ],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
    )
    path = tmp_path / "city.gltf"
    path.write_text(json.dumps(doc))
    return str(path)


def test_path_tracer_load_scene_never_rescues(tmp_path, monkeypatch):
    """``tpu_pt.load_scene`` (the path tracer's loader) flattens glTF
    instances under the guardrail derived from the device's memory: with
    a device limit too small for the flattened tables, the load raises
    the guardrail error instead of exhausting memory."""
    from tpu_pt.scene import gltf
    path = _write_instanced_city(tmp_path)
    monkeypatch.setattr(gltf, "_device_bytes_limit",
                        lambda: 20 * gltf._BYTES_PER_FLAT_TRI)
    assert gltf.default_max_flat_tris() == 10
    with pytest.raises(ValueError, match="instance flattening"):
        tpu_pt.load_scene(path)


def _write_gpu_instanced(tmp_path, n=40):
    """glTF using EXT_mesh_gpu_instancing: one triangle, n instances
    with per-instance TRANSLATION + ROTATION + SCALE accessors."""
    rng = np.random.default_rng(9)
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tr = (rng.random((n, 3)).astype(np.float32) * 20 - 10)
    ang = rng.random(n).astype(np.float32) * np.pi
    rot = np.stack([np.zeros(n, np.float32), np.sin(ang / 2),
                    np.zeros(n, np.float32), np.cos(ang / 2)], 1)  # xyzw
    sc = (0.5 + rng.random((n, 3)).astype(np.float32))
    blob = pos.tobytes() + tr.tobytes() + rot.tobytes() + sc.tobytes()
    off = [0, pos.nbytes, pos.nbytes + tr.nbytes,
           pos.nbytes + tr.nbytes + rot.nbytes]
    doc = dict(
        asset=dict(version="2.0"), scene=0,
        scenes=[dict(nodes=[0])],
        nodes=[dict(mesh=0, extensions=dict(EXT_mesh_gpu_instancing=dict(
            attributes=dict(TRANSLATION=1, ROTATION=2, SCALE=3))))],
        meshes=[dict(primitives=[dict(attributes=dict(POSITION=0))])],
        accessors=[
            dict(bufferView=0, componentType=5126, count=3, type="VEC3"),
            dict(bufferView=1, componentType=5126, count=n, type="VEC3"),
            dict(bufferView=2, componentType=5126, count=n, type="VEC4"),
            dict(bufferView=3, componentType=5126, count=n, type="VEC3"),
        ],
        bufferViews=[
            dict(buffer=0, byteOffset=off[0], byteLength=pos.nbytes),
            dict(buffer=0, byteOffset=off[1], byteLength=tr.nbytes),
            dict(buffer=0, byteOffset=off[2], byteLength=rot.nbytes),
            dict(buffer=0, byteOffset=off[3], byteLength=sc.nbytes),
        ],
        buffers=[dict(byteLength=len(blob),
                      uri="data:application/octet-stream;base64,"
                          + base64.b64encode(blob).decode())],
        extensionsUsed=["EXT_mesh_gpu_instancing"],
    )
    path = tmp_path / "gpu_inst.gltf"
    path.write_text(json.dumps(doc))
    return str(path), tr, ang, sc


def test_ext_mesh_gpu_instancing(tmp_path):
    """EXT_mesh_gpu_instancing expands into instance records that the
    loader flattens: n world triangles at the composed T*R*S
    placements."""
    from tpu_pt.scene.gltf import load_gltf
    path, tr, ang, sc = _write_gpu_instanced(tmp_path, n=40)
    ws = load_gltf(path)
    assert int(np.asarray(ws.geom.tri_valid).sum()) == 40
    # Each flattened v0 is the instance's T * R * S applied to (0,0,0)
    # = the translation itself.
    v0 = np.asarray(ws.geom.tri_v0)[:40]
    np.testing.assert_allclose(np.sort(v0[:, 0]), np.sort(tr[:, 0]),
                               atol=1e-5)
    # The edges carry the rotation and scale: e1 = R S (1, 0, 0).
    e1 = np.asarray(ws.geom.tri_e1)[:40]
    order = np.argsort(v0[:, 0])
    k = np.argsort(tr[:, 0])
    want = np.stack([np.cos(ang) * sc[:, 0], np.zeros_like(ang),
                     -np.sin(ang) * sc[:, 0]], 1)
    np.testing.assert_allclose(e1[order], want[k], atol=1e-5)
