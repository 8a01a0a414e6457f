"""Dense ray-triangle intersection as one Pallas kernel for NVIDIA GPUs.

The tuned form of ``tpu_pt.intersect.moller`` for small scenes, written
for the Triton route of Pallas (``backend="triton"``). One program owns
``BLOCK_R`` rays, held in registers for the whole sweep; a loop inside
the program walks the scene's triangles ``BLOCK_T`` at a time and keeps
only the running (t, id) -- and (u, v) when asked -- per ray. The
triangle table is a few tens of KB for the scenes that take this path,
so every program reads it from L1/L2; the [rays x triangles] candidate
matrix never leaves registers. Nothing crosses programs, so closest hit
needs no second reduction pass.

The per-pair test is a plane + edge-function form (Baldwin-Weber style):
``t`` from the triangle's plane, the barycentrics as affine functions of
the hit point. The cross products move into :func:`pack_tris`, computed
once per scene. ``moller`` keeps the independent Möller-Trumbore formula,
so the two cross-check each other; their ``t`` agree to plane-distance
cancellation noise, not bitwise.

Divisions are IEEE round-to-nearest (``div.rn.f32``): Triton's ``/``
would compile to the approximate ``div.full.f32``. There are no matrix
products, so TF32 never arises.

The normal, material id and barycentrics of the winner are gathered
after the kernel from the winning triangle id (``jnp.take``).

Semantics match ``moller.intersect_closest`` / ``intersect_occluded``:
two-sided triangles, and refractive surfaces do not occlude
(``pathTracerPrograms.cu:672-681``).

Kernels compile only for a GPU. ``interpret=True`` runs them in the
Pallas interpreter on any backend, which is how the tests run them on
the CPU; without it, a backend other than GPU raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..scene.arrays import SceneArrays, BSDF_REFRACTION
from ..vec3 import V3, as_v3
from .moller import Hit, T_FAR

# Rays per program, triangles per sweep step, and the Triton launch
# shape. Powers of two (Triton's block rule).
BLOCK_R = 128
BLOCK_T = 8
NUM_WARPS = 4
NUM_STAGES = 1

# Rows of the packed triangle table (see ``pack_tris``).
_NX, _NY, _NZ, _D0 = 0, 1, 2, 3
_WUX, _WUY, _WUZ, _CU = 4, 5, 6, 7
_WVX, _WVY, _WVZ, _CV = 8, 9, 10, 11
_VALID, _REFR = 12, 13
TRI_ROWS = 16
_BIG_ID = 2 ** 30


def _pad_to(n: int, m: int) -> int:
    return max(m, -(-n // m) * m)


def pack_tris(scene: SceneArrays, rows=None) -> jnp.ndarray:
    """Scene triangles -> [TRI_ROWS, T_pad] kernel table.

    For ``P = v0 + u*e1 + v*e2``: ``u = wu . P + cu`` with ``wu = (e2 x n)
    / ((e2 x n) . e1)`` (``wv`` symmetric), and ``t = (d0 - n . o) / (n .
    d)`` with the unit geometric normal ``n`` and ``d0 = n . v0``.
    Rows: n xyz, d0, wu xyz, cu, wv xyz, cv, valid, refractive, 0, 0.

    ``rows`` (int32 [K]) packs only those triangles, in that order; the
    kernel then reports positions in ``rows``. Columns are zero-padded to
    a ``BLOCK_T`` multiple (valid = 0 never hits)."""
    v0, e1, e2, n = scene.tri_v0, scene.tri_e1, scene.tri_e2, scene.tri_normal
    valid = scene.tri_valid.astype(jnp.float32)
    refr = (scene.mat_bsdf[scene.mat_id] == BSDF_REFRACTION).astype(
        jnp.float32)
    if rows is not None:
        v0, e1, e2, n, valid, refr = (
            a[rows] for a in (v0, e1, e2, n, valid, refr))

    def guarded_div(num, den):
        return num / jnp.where(jnp.abs(den) > 1e-20, den, 1.0)[:, None]

    cu_dir = jnp.cross(e2, n)
    wu = guarded_div(cu_dir, jnp.sum(cu_dir * e1, axis=1))
    cv_dir = jnp.cross(e1, n)
    wv = guarded_div(cv_dir, jnp.sum(cv_dir * e2, axis=1))
    d0 = jnp.sum(n * v0, axis=1)
    cu = -jnp.sum(wu * v0, axis=1)
    cv = -jnp.sum(wv * v0, axis=1)
    zero = jnp.zeros_like(d0)
    packed = jnp.stack([n[:, 0], n[:, 1], n[:, 2], d0,
                        wu[:, 0], wu[:, 1], wu[:, 2], cu,
                        wv[:, 0], wv[:, 1], wv[:, 2], cv,
                        valid, refr, zero, zero], axis=0)
    t = packed.shape[1]
    return jnp.pad(packed, ((0, 0), (0, _pad_to(t, BLOCK_T) - t)))


def _div(a, b, interpret: bool):
    if interpret:
        return a / b
    return plgpu.elementwise_inline_asm(
        "div.rn.f32 $0, $1, $2;", args=[a, b], constraints="=r,r,r",
        pack=1, result_shape_dtypes=[jax.ShapeDtypeStruct(a.shape,
                                                          a.dtype)])[0]


def _pair_test(ray, tris_ref, s, block_t, tmin, interpret):
    """Rays [BR] x triangles ``s:s+block_t`` -> (t, hit, u, v), [BR, BT]."""
    ox, oy, oz, dx, dy, dz = (c[:, None] for c in ray)

    def row(r):
        return tris_ref[r, pl.ds(s, block_t)][None, :]

    nx, ny, nz = row(_NX), row(_NY), row(_NZ)
    ndotd = nx * dx + ny * dy + nz * dz
    num = row(_D0) - (nx * ox + ny * oy + nz * oz)
    t = _div(jnp.broadcast_to(num, ndotd.shape), ndotd, interpret)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    u = row(_WUX) * px + row(_WUY) * py + row(_WUZ) * pz + row(_CU)
    v = row(_WVX) * px + row(_WVY) * py + row(_WVZ) * pz + row(_CV)
    # NaN (0/0 on degenerate rows) fails every comparison.
    hit = ((u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
           & (row(_VALID) > 0.5))
    return t, hit, u, v


def _closest_kernel(ox, oy, oz, dx, dy, dz, tris_ref, *out_refs, n_blocks,
                    block_t, tmin, tmax, want_uv, interpret):
    ray = tuple(r[...] for r in (ox, oy, oz, dx, dy, dz))
    br = ray[0].shape[0]
    lane = jax.lax.broadcasted_iota(jnp.int32, (br, block_t), 1)

    def body(b, carry):
        s = pl.multiple_of(b * block_t, block_t)
        t, hit, u, v = _pair_test(ray, tris_ref, s, block_t, tmin, interpret)
        t = jnp.where(hit & (t < tmax), t, T_FAR)
        blk_t = jnp.min(t, axis=1)
        # First lane attaining the minimum (moller's argmin tie rule).
        first = t == blk_t[:, None]
        blk_arg = jnp.min(jnp.where(first, lane, _BIG_ID), axis=1)
        better = blk_t < carry[0]
        out = [jnp.where(better, blk_t, carry[0]),
               jnp.where(better, blk_arg + s, carry[1])]
        if want_uv:
            win = lane == blk_arg[:, None]
            out += [jnp.where(better, jnp.sum(jnp.where(win, u, 0.0), 1),
                              carry[2]),
                    jnp.where(better, jnp.sum(jnp.where(win, v, 0.0), 1),
                              carry[3])]
        return tuple(out)

    zf = jnp.zeros((br,), jnp.float32)
    init = (jnp.full((br,), T_FAR, jnp.float32), jnp.zeros((br,), jnp.int32))
    if want_uv:
        init += (zf, zf)
    res = jax.lax.fori_loop(0, n_blocks, body, init)
    for ref, val in zip(out_refs, res):
        ref[...] = val


def _occluded_kernel(ox, oy, oz, dx, dy, dz, tmax_ref, tris_ref, occ_ref, *,
                     n_blocks, block_t, tmin, interpret):
    ray = tuple(r[...] for r in (ox, oy, oz, dx, dy, dz))
    tmax = tmax_ref[...][:, None]
    br = ray[0].shape[0]

    def cond(carry):
        b, occ = carry
        # Stop once every ray of the program is blocked.
        return (b < n_blocks) & (jnp.min(occ) == 0)

    def body(carry):
        b, occ = carry
        s = pl.multiple_of(b * block_t, block_t)
        t, hit, _, _ = _pair_test(ray, tris_ref, s, block_t, tmin, interpret)
        refr = tris_ref[_REFR, pl.ds(s, block_t)][None, :]
        blocks = hit & (t < tmax) & (refr < 0.5)
        return b + 1, jnp.maximum(occ, jnp.max(blocks.astype(jnp.int32), 1))

    _, occ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), jnp.zeros((br,), jnp.int32)))
    occ_ref[...] = occ


def _check_backend(interpret: bool):
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "pallas_dense kernels compile only for a GPU (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run them "
            "in the Pallas interpreter")


def _ray_rows(origins: V3, dirs: V3, n_pad: int, extras=()):
    n = origins.x.shape[0]
    cols = (*origins, *dirs, *extras)
    return [jnp.pad(c, (0, n_pad - n)) for c in cols]


def _call(kernel, rows, tris, outs, interpret):
    n_pad = rows[0].shape[0]
    spec = pl.BlockSpec((BLOCK_R,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), dt) for dt in outs],
        grid=(n_pad // BLOCK_R,),
        in_specs=[spec] * len(rows) + [
            pl.BlockSpec(tris.shape, lambda i: (0, 0))],
        out_specs=[spec] * len(outs),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name=kernel.func.__name__.lstrip("_"),
    )(*rows, tris)


def closest_rows(tris: jnp.ndarray, origins: V3, dirs: V3,
                 tmin: float = 0.01, tmax: float = T_FAR,
                 want_uv: bool = False, interpret: bool = False):
    """Closest hit against a packed table: (t, col[, u, v]) per ray.

    ``t`` is T_FAR and ``col`` 0 on a miss; ``col`` indexes the table's
    columns."""
    _check_backend(interpret)
    n = origins.x.shape[0]
    rows = _ray_rows(origins, dirs, _pad_to(n, BLOCK_R))
    kernel = functools.partial(
        _closest_kernel, n_blocks=tris.shape[1] // BLOCK_T, block_t=BLOCK_T,
        tmin=float(tmin), tmax=float(tmax), want_uv=want_uv,
        interpret=interpret)
    outs = [jnp.float32, jnp.int32] + [jnp.float32] * (2 * want_uv)
    return tuple(o[:n] for o in _call(kernel, rows, tris, outs, interpret))


def occluded_rows(tris: jnp.ndarray, origins: V3, dirs: V3,
                  tmax: jnp.ndarray, tmin: float = 0.01,
                  interpret: bool = False) -> jnp.ndarray:
    """Any-hit against a packed table within (tmin, tmax) -> bool [N]."""
    _check_backend(interpret)
    n = origins.x.shape[0]
    rows = _ray_rows(origins, dirs, _pad_to(n, BLOCK_R), extras=(tmax,))
    kernel = functools.partial(
        _occluded_kernel, n_blocks=tris.shape[1] // BLOCK_T,
        block_t=BLOCK_T, tmin=float(tmin), interpret=interpret)
    (occ,) = _call(kernel, rows, tris, [jnp.int32], interpret)
    return occ[:n] > 0


def intersect_closest(scene: SceneArrays, origins: V3, dirs: V3,
                      tmin: float = 0.01, tmax: float = T_FAR,
                      want_uv: bool = True, interpret: bool = False) -> Hit:
    """Closest hit over a flat wavefront; drop-in for the jnp backend.

    ``want_uv=False`` (the OBJ path tracer) skips the barycentric carry;
    ``Hit.u``/``Hit.v`` then read as zeros."""
    origins, dirs = as_v3(origins), as_v3(dirs)
    res = closest_rows(pack_tris(scene), origins, dirs, tmin, tmax,
                       want_uv=want_uv, interpret=interpret)
    t, tri = res[0], res[1]
    hit = t < T_FAR
    zero = jnp.zeros_like(t)
    nrm = jnp.take(scene.tri_normal, tri, axis=0)
    normal = V3(*(jnp.where(hit, nrm[:, k], 0.0) for k in range(3)))
    mat = jnp.where(hit, jnp.take(scene.mat_id, tri), 0)
    u, v = (res[2], res[3]) if want_uv else (zero, zero)
    return Hit(t=t, tri=tri, hit=hit, normal=normal, mat=mat, u=u, v=v)


def intersect_occluded(scene: SceneArrays, origins: V3, dirs: V3,
                       tmax: jnp.ndarray, tmin: float = 0.01,
                       quirk_first_hit: bool = False,
                       interpret: bool = False) -> jnp.ndarray:
    """Any-hit occlusion with per-ray tmax; refractive surfaces pass light.

    When the scene carries its NEE occluder analysis
    (``scene/arrays.nee_occluder_index``), only those triangles are swept:
    the others can occlude no surface-to-light segment."""
    origins, dirs = as_v3(origins), as_v3(dirs)
    if quirk_first_hit:
        h = intersect_closest(scene, origins, dirs, tmin=tmin, tmax=T_FAR,
                              want_uv=False, interpret=interpret)
        in_range = h.hit & (h.t < tmax)
        return in_range & (scene.mat_bsdf[h.mat] != BSDF_REFRACTION)
    rows = None
    if scene.occ_index is not None and scene.num_occluders >= 0:
        if scene.num_occluders == 0:
            return jnp.zeros(origins.x.shape, bool)
        rows = scene.occ_index[:scene.num_occluders]
    return occluded_rows(pack_tris(scene, rows), origins, dirs, tmax, tmin,
                         interpret=interpret)
