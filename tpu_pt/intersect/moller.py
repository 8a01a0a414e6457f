"""Batched ray-triangle intersection (Möller-Trumbore) in pure jnp.

The plain replacement for the reference's hardware BVH traversal
(``optixTraverse``, ``pathTracerPrograms.cu:600-613``) at small scene sizes,
and the reference the other backends are tested against: a dense
all-rays × all-triangles test, chunked so intermediates stay bounded. The
Pallas kernel in ``tpu_pt.intersect.pallas_dense`` is the tuned version of
the same algorithm; ``tpu_pt.intersect.lbvh`` scales it to large meshes.

Rays and results use the component-SoA ``V3`` layout (``tpu_pt.vec3``);
the [R, B] ray-block x tri-block intermediates are built from [R, 1] x
[1, B] broadcasts per component, so nothing reduces over a size-3 axis.

Triangles are two-sided (OptiX default, no backface culling) and the
occlusion variant implements the reference's "refractive surfaces do not
occlude" rule (``pathTracerPrograms.cu:672-681``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from .. import pytree

from ..scene.arrays import SceneArrays, BSDF_REFRACTION
from ..vec3 import V3

DET_EPS = 1e-9
T_FAR = 1e16


@pytree.dataclass
class Hit:
    """Closest-hit result, with the winning triangle's geometric normal
    and material id resolved by the intersector."""
    t: jnp.ndarray        # [N] f32, T_FAR on miss
    tri: jnp.ndarray      # [N] i32, 0 on miss
    hit: jnp.ndarray      # [N] bool
    normal: V3            # geometric normal (N_0) components [N], 0 on miss
    mat: jnp.ndarray      # [N] i32 material id, 0 on miss
    u: jnp.ndarray        # [N] f32 barycentric u at the hit (0 on miss)
    v: jnp.ndarray        # [N] f32 barycentric v at the hit (0 on miss)


def _fit_tri_block(requested: int, n_tri: int) -> int:
    """Largest block size <= requested that divides n_tri (n_tri is always a
    multiple of TRI_PAD=128, so 128 always works)."""
    b = min(requested, n_tri)
    while n_tri % b:
        b -= 128 if b > 128 else b - 1 or 1
        if b <= 1:
            return 1
    return b


def _col(a: jnp.ndarray) -> jnp.ndarray:
    return a[:, None]


def _mt_block(o: V3, d: V3, v0, e1, e2, tmin, tmax):
    """Möller-Trumbore: [R] ray block vs [B] tri block -> (t, valid) [R, B].

    o, d: V3 of [R]; v0/e1/e2: [B, 3] triangle slices (host layout).
    """
    ox, oy, oz = _col(o.x), _col(o.y), _col(o.z)
    dx, dy, dz = _col(d.x), _col(d.y), _col(d.z)
    v0x, v0y, v0z = v0[None, :, 0], v0[None, :, 1], v0[None, :, 2]
    e1x, e1y, e1z = e1[None, :, 0], e1[None, :, 1], e1[None, :, 2]
    e2x, e2y, e2z = e2[None, :, 0], e2[None, :, 1], e2[None, :, 2]

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) > DET_EPS
    inv_det = 1.0 / jnp.where(ok, det, 1.0)

    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det

    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, valid, u, v


def _closest_chunk(o: V3, d: V3, scene: SceneArrays, tmin, tmax,
                   tri_block: int):
    """Closest hit for one ray chunk (V3 of [R]) against the whole scene."""
    n_tri = scene.tri_v0.shape[0]
    n_blocks = n_tri // tri_block
    r = o.x.shape[0]

    def body(carry, bi):
        best_t, best_i, best_n, best_m, best_u, best_v = carry
        s = bi * tri_block
        sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s, tri_block)
        t, valid, u, v = _mt_block(o, d, sl(scene.tri_v0),
                                   sl(scene.tri_e1), sl(scene.tri_e2),
                                   tmin, tmax)
        valid = valid & sl(scene.tri_valid)[None, :]
        t = jnp.where(valid, t, T_FAR)
        blk_t = jnp.min(t, axis=-1)
        blk_arg = jnp.argmin(t, axis=-1).astype(jnp.int32)
        blk_i = blk_arg + s
        # Select the argmin triangle's normal/material with a mask
        # matmul.
        lane = jax.lax.broadcasted_iota(jnp.int32, (r, tri_block), 1)
        mask_b = lane == blk_arg[:, None]
        mask = mask_b.astype(jnp.float32)
        blk_u = jnp.sum(jnp.where(mask_b, u, 0.0), axis=-1)
        blk_v = jnp.sum(jnp.where(mask_b, v, 0.0), axis=-1)
        nm = jnp.concatenate(
            [sl(scene.tri_normal),
             sl(scene.mat_id).astype(jnp.float32)[:, None]], axis=1)
        # HIGHEST precision: with a 0/1 mask the matmul is then an exact
        # select (a default-precision f32 matmul may round the values to
        # bf16 or TF32).
        blk_nm = jnp.matmul(mask, nm,
                            precision=jax.lax.Precision.HIGHEST)  # [R, 4]
        better = blk_t < best_t
        best_t = jnp.where(better, blk_t, best_t)
        best_i = jnp.where(better, blk_i, best_i)
        best_n = jnp.where(better[:, None], blk_nm[:, 0:3], best_n)
        best_m = jnp.where(better, blk_nm[:, 3].astype(jnp.int32), best_m)
        best_u = jnp.where(better, blk_u, best_u)
        best_v = jnp.where(better, blk_v, best_v)
        return (best_t, best_i, best_n, best_m, best_u, best_v), None

    init = (jnp.full((r,), T_FAR, jnp.float32), jnp.zeros((r,), jnp.int32),
            jnp.zeros((r, 3), jnp.float32), jnp.zeros((r,), jnp.int32),
            jnp.zeros((r,), jnp.float32), jnp.zeros((r,), jnp.float32))
    (best_t, best_i, best_n, best_m, best_u, best_v), _ = jax.lax.scan(
        body, init, jnp.arange(n_blocks))
    return best_t, best_i, best_n, best_m, best_u, best_v


def _pad_rays(o: V3, d: V3, chunk: int):
    n = o.x.shape[0]
    pad = (-n) % chunk
    if pad:
        z = jnp.zeros((pad,), jnp.float32)
        o = V3(*(jnp.concatenate([c, z]) for c in o))
        d = V3(*(jnp.concatenate([c, z]) for c in d))
    return o, d, n, (n + pad) // chunk


def intersect_closest(scene: SceneArrays, origins: V3, dirs: V3,
                      tmin: float = 0.01, tmax: float = T_FAR,
                      ray_chunk: int = 8192, tri_block: int = 512) -> Hit:
    """Closest-hit over a flat ray wavefront. origins/dirs: V3 of [N]
    (or [N, 3] arrays, coerced)."""
    from ..vec3 import as_v3
    origins = as_v3(origins)
    dirs = as_v3(dirs)
    n_tri = scene.tri_v0.shape[0]
    tri_block = _fit_tri_block(tri_block, n_tri)
    ray_chunk = min(ray_chunk, origins.x.shape[0])
    o, d, n, c = _pad_rays(origins, dirs, ray_chunk)

    def chunk_fn(args):
        oc, dc = args
        return _closest_chunk(oc, dc, scene, tmin, tmax, tri_block)

    o_c = jax.tree.map(lambda a: a.reshape(c, ray_chunk), o)
    d_c = jax.tree.map(lambda a: a.reshape(c, ray_chunk), d)
    if c == 1:
        best_t, best_i, best_n, best_m, best_u, best_v = chunk_fn(
            (jax.tree.map(lambda a: a[0], o_c),
             jax.tree.map(lambda a: a[0], d_c)))
    else:
        best_t, best_i, best_n, best_m, best_u, best_v = jax.lax.map(
            chunk_fn, (o_c, d_c))
        best_t = best_t.reshape(-1)
        best_i = best_i.reshape(-1)
        best_n = best_n.reshape(-1, 3)
        best_m = best_m.reshape(-1)
        best_u = best_u.reshape(-1)
        best_v = best_v.reshape(-1)
    best_t = best_t[:n]
    return Hit(t=best_t, tri=best_i[:n], hit=best_t < T_FAR,
               normal=V3.from_array(best_n[:n]), mat=best_m[:n],
               u=best_u[:n], v=best_v[:n])


def intersect_occluded(scene: SceneArrays, origins: V3, dirs: V3,
                       tmax: jnp.ndarray, tmin: float = 0.01,
                       ray_chunk: int = 8192, tri_block: int = 512,
                       quirk_first_hit: bool = False) -> jnp.ndarray:
    """Shadow-ray occlusion with per-ray tmax. Returns occluded [N] bool.

    Reference semantics (``traceOcclusion``, ``pathTracerPrograms.cu:651-684``):
    refractive surfaces never occlude. Default mode: occluded iff ANY
    non-refractive surface lies in (tmin, tmax). ``quirk_first_hit=True``
    reproduces the reference's literal TERMINATE_ON_FIRST_HIT behavior
    (approximated as: test the closest surface only).
    """
    from ..vec3 import as_v3
    origins = as_v3(origins)
    dirs = as_v3(dirs)
    tri_refr = scene.mat_bsdf[scene.mat_id] == BSDF_REFRACTION  # [T]

    if quirk_first_hit:
        h = intersect_closest(scene, origins, dirs, tmin=tmin, tmax=T_FAR,
                              ray_chunk=ray_chunk, tri_block=tri_block)
        in_range = h.hit & (h.t < tmax)
        return in_range & (scene.mat_bsdf[h.mat] != BSDF_REFRACTION)

    n_tri = scene.tri_v0.shape[0]
    tri_block = _fit_tri_block(tri_block, n_tri)
    ray_chunk = min(ray_chunk, origins.x.shape[0])
    o, d, n, c = _pad_rays(origins, dirs, ray_chunk)
    pad = c * ray_chunk - n
    if pad:
        tmax = jnp.concatenate([tmax, jnp.zeros((pad,), tmax.dtype)])

    def chunk_fn(args):
        oc, dc, tm = args
        n_blocks = n_tri // tri_block

        def body(occ, bi):
            s = bi * tri_block
            sl = lambda a: jax.lax.dynamic_slice_in_dim(a, s, tri_block)
            t, valid, _, _ = _mt_block(oc, dc, sl(scene.tri_v0),
                                       sl(scene.tri_e1), sl(scene.tri_e2),
                                       tmin, T_FAR)
            valid = (valid & sl(scene.tri_valid)[None, :]
                     & ~sl(tri_refr)[None, :] & (t < tm[:, None]))
            return occ | jnp.any(valid, axis=-1), None

        occ, _ = jax.lax.scan(body, jnp.zeros((oc.x.shape[0],), bool),
                              jnp.arange(n_blocks))
        return occ

    o_c = jax.tree.map(lambda a: a.reshape(c, ray_chunk), o)
    d_c = jax.tree.map(lambda a: a.reshape(c, ray_chunk), d)
    t_c = tmax.reshape(c, ray_chunk)
    if c == 1:
        occ = chunk_fn((jax.tree.map(lambda a: a[0], o_c),
                        jax.tree.map(lambda a: a[0], d_c), t_c[0]))
    else:
        occ = jax.lax.map(chunk_fn, (o_c, d_c, t_c)).reshape(-1)
    return occ[:n]
