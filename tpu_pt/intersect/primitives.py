"""Analytic primitive intersectors: sphere, sphere shell, parallelogram.

Parity with the reference's custom-primitive intersection programs
(``cuda/geometry.cu:38-144``, ``cuda/sphere.cu:37-97``) and the
``GeometryData`` tagged union (``cuda/GeometryData.h:55-127``): a small
array of analytic primitives intersected wavefront-wide in a few dense
ops — the wavefront analog of OptiX custom-primitive AABBs + intersection
programs. Combined with triangle hits by min-t (see ``combine_hits``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from .. import pytree

from .. import vec3 as v3
from ..vec3 import V3, as_v3
from .moller import Hit, T_FAR

# Primitive kinds (GeometryData union parity).
PRIM_SPHERE = 0
PRIM_PARALLELOGRAM = 1
PRIM_SPHERE_SHELL = 2


@pytree.dataclass
class Primitives:
    """SoA analytic primitives.

    ``kind`` is static (a Python tuple) — the per-primitive dispatch is a
    trace-time loop, mirroring how each OptiX custom primitive binds its
    own intersection program via the SBT.

    params layout per kind:
      SPHERE:         center xyz, radius
      PARALLELOGRAM:  anchor xyz, v1 xyz, v2 xyz (plane extent basis)
      SPHERE_SHELL:   center xyz, radius1 (inner), radius2 (outer)
    """
    kind: tuple = pytree.static_field()  # per-prim PRIM_* ints
    params: jnp.ndarray = None   # [P, 12] f32
    mat: jnp.ndarray = None      # [P] i32
    # Per-prim "can occlude an NEE shadow ray" flags (static): refractive
    # primitives pass light, matching the reference's occlusion program
    # skipping refractive hits (``pathTracerPrograms.cu:672-681``).
    # Empty = all occlude.
    occludes: tuple = pytree.static_field(default=())

    @property
    def count(self) -> int:
        return len(self.kind)


def make_primitives(prims: list[dict],
                    mat_bsdf: np.ndarray | None = None) -> Primitives:
    """Build from dicts: {kind, mat, center/radius/... per kind}.

    ``mat_bsdf`` (host [M] ints) marks refractive materials so their
    primitives are excluded from NEE occlusion at build time."""
    p = len(prims)
    kind = []
    params = np.zeros((p, 12), np.float32)
    mat = np.zeros(p, np.int32)
    for i, d in enumerate(prims):
        kind.append(int(d["kind"]))
        mat[i] = d.get("mat", 0)
        if d["kind"] == PRIM_SPHERE:
            params[i, 0:3] = d["center"]
            params[i, 3] = d["radius"]
        elif d["kind"] == PRIM_PARALLELOGRAM:
            params[i, 0:3] = d["anchor"]
            params[i, 3:6] = d["v1"]
            params[i, 6:9] = d["v2"]
        elif d["kind"] == PRIM_SPHERE_SHELL:
            params[i, 0:3] = d["center"]
            params[i, 3] = d["radius1"]
            params[i, 4] = d["radius2"]
        else:
            raise ValueError(f"unknown primitive kind {d['kind']}")
    if mat_bsdf is not None:
        from ..scene.arrays import BSDF_REFRACTION
        occludes = tuple(bool(np.asarray(mat_bsdf)[m] != BSDF_REFRACTION)
                         for m in mat)
    else:
        occludes = tuple(True for _ in kind)
    return Primitives(kind=tuple(kind), params=jnp.asarray(params),
                      mat=jnp.asarray(mat), occludes=occludes)


def _sphere_t(o: V3, d: V3, c: V3, r, tmin, tmax):
    """Nearest sphere intersection in range; (t, normal). sphere.cu:37-97."""
    oc = o - c
    a = v3.dot(d, d)
    b = 2.0 * v3.dot(oc, d)
    cc = v3.dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    ok = disc > 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    inv2a = 1.0 / jnp.maximum(2.0 * a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t0_in = (t0 > tmin) & (t0 < tmax)
    t1_in = (t1 > tmin) & (t1 < tmax)
    t = jnp.where(t0_in, t0, jnp.where(t1_in, t1, T_FAR))
    t = jnp.where(ok, t, T_FAR)
    p = o + d * t
    n = (p - c) * (1.0 / jnp.maximum(r, 1e-30))
    return t, n


def _shell_t(o: V3, d: V3, c: V3, r1, r2, tmin, tmax):
    """Sphere shell: nearest of outer-entry / inner surface / outer-exit
    (geometry.cu:67-144 semantics: hollow sphere with two radii)."""
    t_in, n_in = _sphere_t(o, d, c, r1, tmin, tmax)
    t_out, n_out = _sphere_t(o, d, c, r2, tmin, tmax)
    t = jnp.minimum(t_in, t_out)
    n = v3.where(t_in <= t_out, n_in, n_out)
    return t, n


def _parallelogram_t(o: V3, d: V3, anchor: V3, v1: V3, v2: V3, tmin, tmax):
    """Parallelogram plane intersect + UV bounds (geometry.cu:38-66)."""
    n = v3.cross(v1, v2)
    nl2 = v3.dot(n, n)
    n_unit = v3.normalize(n)
    dt = v3.dot(d, n_unit)
    t = (v3.dot(anchor - o, n_unit)) / jnp.where(jnp.abs(dt) > 1e-12, dt,
                                                 1e30)
    p = o + d * t
    vi = p - anchor
    # Barycentric coords via dual basis.
    inv = 1.0 / jnp.maximum(nl2, 1e-30)
    a1 = v3.dot(v3.cross(vi, v2), n) * inv
    a2 = v3.dot(v3.cross(v1, vi), n) * inv
    ok = ((jnp.abs(dt) > 1e-12) & (t > tmin) & (t < tmax)
          & (a1 >= 0.0) & (a1 <= 1.0) & (a2 >= 0.0) & (a2 <= 1.0))
    return jnp.where(ok, t, T_FAR), n_unit


def intersect_primitives(prims: Primitives, origins, dirs,
                         tmin: float = 0.01, tmax: float = T_FAR,
                         index_offset: int = 0) -> Hit:
    """Closest hit over all analytic primitives (dense loop; P is small).

    ``index_offset`` biases ``Hit.tri`` so primitive ids live past the
    triangle id range when combined with a mesh hit (consumers can tell
    the two apart: id >= num_tris_padded means primitive)."""
    o = as_v3(origins)
    d = as_v3(dirs)
    n_rays = o.x.shape[0]
    best_t = jnp.full((n_rays,), T_FAR, jnp.float32)
    best_n = V3.zeros((n_rays,))
    best_i = jnp.zeros((n_rays,), jnp.int32)
    best_m = jnp.zeros((n_rays,), jnp.int32)

    for i in range(prims.count):
        q = prims.params[i]
        kindi = prims.kind[i]
        if kindi == PRIM_SPHERE:
            t, n = _sphere_t(o, d, V3.of(q[0], q[1], q[2]), q[3], tmin, tmax)
        elif kindi == PRIM_SPHERE_SHELL:
            t, n = _shell_t(o, d, V3.of(q[0], q[1], q[2]), q[3], q[4],
                            tmin, tmax)
        else:
            t, n = _parallelogram_t(o, d, V3.of(q[0], q[1], q[2]),
                                    V3.of(q[3], q[4], q[5]),
                                    V3.of(q[6], q[7], q[8]), tmin, tmax)
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_n = v3.where(better, n, best_n)
        best_i = jnp.where(better, index_offset + i, best_i)
        best_m = jnp.where(better, prims.mat[i], best_m)

    ok = best_t < T_FAR
    return Hit(t=best_t, tri=best_i, hit=ok, normal=best_n, mat=best_m,
               u=jnp.zeros((n_rays,), jnp.float32),
               v=jnp.zeros((n_rays,), jnp.float32))


def occluded_primitives(prims: Primitives, origins, dirs, tmax,
                        tmin: float = 0.01) -> jnp.ndarray:
    """Any-hit over the occluding primitives for NEE shadow segments.

    Refractive primitives never occlude (``occludes`` flag; reference
    convention ``pathTracerPrograms.cu:672-681``). ``tmax`` is per-lane
    (l_dist - eps)."""
    o = as_v3(origins)
    d = as_v3(dirs)
    n_rays = o.x.shape[0]
    occ = jnp.zeros((n_rays,), bool)
    for i in range(prims.count):
        if prims.occludes and not prims.occludes[i]:
            continue
        q = prims.params[i]
        kindi = prims.kind[i]
        if kindi == PRIM_SPHERE:
            t, _ = _sphere_t(o, d, V3.of(q[0], q[1], q[2]), q[3], tmin, tmax)
        elif kindi == PRIM_SPHERE_SHELL:
            t, _ = _shell_t(o, d, V3.of(q[0], q[1], q[2]), q[3], q[4],
                            tmin, tmax)
        else:
            t, _ = _parallelogram_t(o, d, V3.of(q[0], q[1], q[2]),
                                    V3.of(q[3], q[4], q[5]),
                                    V3.of(q[6], q[7], q[8]), tmin, tmax)
        occ = occ | (t < tmax)
    return occ


def combine_hits(a: Hit, b: Hit) -> Hit:
    """Min-t combination of two closest-hit results."""
    take_b = b.t < a.t
    return Hit(
        t=jnp.where(take_b, b.t, a.t),
        tri=jnp.where(take_b, b.tri, a.tri),
        hit=a.hit | b.hit,
        normal=v3.where(take_b, b.normal, a.normal),
        mat=jnp.where(take_b, b.mat, a.mat),
        u=jnp.where(take_b, b.u, a.u),
        v=jnp.where(take_b, b.v, a.v),
    )
