"""Swept-sphere curve primitives: linear, quadratic/cubic B-spline,
Catmull-Rom.

Parity with the reference's curve support (``cuda/GeometryData.h:55-127``
lists the four round-curve types; ``cuda/curve.h:312-443`` evaluates the
segment polynomial and its surface normal). OptiX intersects curves with
hardware/built-in programs; the equivalent here is dense and
batched:

- Every segment type is converted once to a power-basis polynomial
  ``c(u) = k3 u^3 + k2 u^2 + k1 u + k0`` over xyz+radius (the reference's
  per-type evaluator classes collapse to one), so evaluation is a Horner
  scheme over [S] segments.
- Intersection tessellates each segment into ``PIECES`` rounded cones
  (sphere swept along a line with linearly varying radius) and tests all
  rays against all pieces with the closed-form rounded-cone quadratic —
  the same dense all-pairs shape as the triangle and analytic-primitive
  paths. Pieces have spherical joints/caps, so chained segments stay
  watertight.
- The normal at the winning piece is then refined with the exact
  swept-sphere surface-normal formula of ``curve.h:333-443`` (type 2,
  "bona fide"): project the hit point onto the curve frame at u, then
  ``n = (|c'|^2 - <c'', o1>) o1 - (r' r) c'``.

Returns the shared ``Hit`` SoA so ``combine_hits`` merges curve hits with
triangles and analytic primitives by min-t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree

from .. import vec3 as v3
from ..vec3 import V3, as_v3
from .moller import Hit, T_FAR

# Curve kinds (GeometryData round-curve union parity).
CURVE_LINEAR = 0
CURVE_QUADRATIC_BSPLINE = 1
CURVE_CUBIC_BSPLINE = 2
CURVE_CATMULLROM = 3

PIECES = 8          # rounded-cone pieces per segment
_EPS = 1e-12

# Basis name -> (CURVE_* kind, control points per segment). A strand of
# n points yields n - (cps - 1) sliding-window segments — the standard
# curve-array vertex indexing the reference's four curve types use
# (``cuda/GeometryData.h:95-127``). Shared by every loader that accepts
# curve declarations (scene JSON, glTF extras).
CURVE_BASES = {
    "linear": (CURVE_LINEAR, 2),
    "quadratic_bspline": (CURVE_QUADRATIC_BSPLINE, 3),
    "cubic_bspline": (CURVE_CUBIC_BSPLINE, 4),
    "catmullrom": (CURVE_CATMULLROM, 4),
}


def expand_curve_spec(spec: dict, mat: int) -> list[dict]:
    """One loader curve declaration -> per-segment dicts for make_curves.

    ``spec`` carries ``basis`` (default cubic_bspline), ``points``
    ([n, 3]) and ``radii`` (scalar or [n]); validation errors name the
    offending field. Returns sliding-window segment dicts
    {kind, points, radii, mat}."""
    basis = spec.get("basis", "cubic_bspline")
    if basis not in CURVE_BASES:
        raise ValueError(f"unknown curve basis {basis!r}")
    ckind, cps = CURVE_BASES[basis]
    pts = np.asarray(spec["points"], np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < cps:
        raise ValueError(f"curve needs >= {cps} [x,y,z] points for {basis}")
    radii = spec.get("radii", 0.1)
    if np.ndim(radii) == 0:
        radii = np.full((pts.shape[0],), float(radii), np.float32)
    else:
        radii = np.asarray(radii, np.float32)
    if radii.shape[0] != pts.shape[0]:
        raise ValueError("curve radii must match points")
    return [dict(kind=ckind, points=pts[s:s + cps], radii=radii[s:s + cps],
                 mat=mat)
            for s in range(pts.shape[0] - (cps - 1))]


@pytree.dataclass
class CurveSegments:
    """SoA curve segments in power basis: k0..k3 are [S, 4] (xyz, radius)."""
    k0: jnp.ndarray
    k1: jnp.ndarray
    k2: jnp.ndarray
    k3: jnp.ndarray
    mat: jnp.ndarray     # [S] i32
    # Per-segment "can occlude an NEE shadow ray" flags (static):
    # refractive curves pass light, matching the occlusion convention of
    # the primitives and the reference (``pathTracerPrograms.cu:672-681``).
    # Empty = all occlude.
    occludes: tuple = pytree.static_field(default=())

    @property
    def count(self) -> int:
        return self.k0.shape[0]


def _to_power_basis(kind: int, q: np.ndarray):
    """Control points [S, n, 4] -> power-basis coefficients (4 x [S, 4])."""
    z = np.zeros_like(q[:, 0])
    if kind == CURVE_LINEAR:
        return q[:, 0], q[:, 1] - q[:, 0], z, z
    if kind == CURVE_QUADRATIC_BSPLINE:
        q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]
        return (q0 + q1) / 2, q1 - q0, (q0 - 2 * q1 + q2) / 2, z
    if kind == CURVE_CUBIC_BSPLINE:
        q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        return ((q0 + 4 * q1 + q2) / 6, (q2 - q0) / 2,
                (q0 - 2 * q1 + q2) / 2, (-q0 + 3 * q1 - 3 * q2 + q3) / 6)
    assert kind == CURVE_CATMULLROM, kind
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return (q1, (q2 - q0) / 2, q0 - 2.5 * q1 + 2 * q2 - 0.5 * q3,
            1.5 * (q1 - q2) + 0.5 * (q3 - q0))


def make_curves(segments: list[dict],
                mat_bsdf: np.ndarray | None = None) -> CurveSegments:
    """Build from dicts {kind, points [n, 3], radii [n], mat}.

    ``mat_bsdf`` (host [M] ints) marks refractive materials so their
    segments are excluded from NEE occlusion at build time (same contract
    as ``primitives.make_primitives``)."""
    ks = [[], [], [], []]
    mat = []
    for d in segments:
        pts = np.asarray(d["points"], np.float32)
        rad = np.asarray(d["radii"], np.float32)
        q = np.concatenate([pts, rad[:, None]], axis=1)[None]  # [1, n, 4]
        for i, k in enumerate(_to_power_basis(int(d["kind"]), q)):
            ks[i].append(k[0])
        mat.append(d.get("mat", 0))
    if mat_bsdf is not None:
        from ..scene.arrays import BSDF_REFRACTION
        occludes = tuple(bool(np.asarray(mat_bsdf)[m] != BSDF_REFRACTION)
                         for m in mat)
    else:
        occludes = tuple(True for _ in mat)
    return CurveSegments(
        k0=jnp.asarray(np.stack(ks[0])), k1=jnp.asarray(np.stack(ks[1])),
        k2=jnp.asarray(np.stack(ks[2])), k3=jnp.asarray(np.stack(ks[3])),
        mat=jnp.asarray(np.asarray(mat, np.int32)), occludes=occludes)


def _eval4(c: CurveSegments, s: int, u):
    """position4 via Horner; u may be scalar or [N]."""
    k0, k1 = c.k0[s], c.k1[s]
    k2, k3 = c.k2[s], c.k3[s]
    return ((k3[None] * u[..., None] + k2[None]) * u[..., None]
            + k1[None]) * u[..., None] + k0[None]


def _horner4(k0, k1, k2, k3, u):
    """Batched position4: k* [..., 4] with matching leading dims on u."""
    u = u[..., None]
    return ((k3 * u + k2) * u + k1) * u + k0


def _piece_table(k0, k1, k2, k3):
    """Tessellate segments into rounded-cone pieces, batched.

    ``k*`` are [S, 4] power-basis rows; returns a dict of [S * PIECES]
    piece arrays (endpoint positions/radii, start parameter, segment id)
    consumed by the ``lax.scan`` intersection loops. One traced Horner
    evaluation replaces the per-segment/per-piece Python unrolling that
    made XLA compile minutes-long (64 inlined cone solves per call)."""
    s_cnt = k0.shape[0]
    us = jnp.asarray(np.linspace(0.0, 1.0, PIECES + 1, dtype=np.float32))
    ends = _horner4(k0[:, None, :], k1[:, None, :], k2[:, None, :],
                    k3[:, None, :], us[None, :])            # [S, P+1, 4]
    pa = ends[:, :-1, :].reshape(s_cnt * PIECES, 4)
    pb = ends[:, 1:, :].reshape(s_cnt * PIECES, 4)
    seg = jnp.repeat(jnp.arange(s_cnt, dtype=jnp.int32), PIECES)
    u0 = jnp.tile(us[:-1], s_cnt)
    return dict(pa=pa, pb=pb, seg=seg, u0=u0)


def _vel4(c: CurveSegments, s: int, u):
    k1, k2, k3 = c.k1[s], c.k2[s], c.k3[s]
    return (3 * k3[None] * u[..., None] + 2 * k2[None]) * u[..., None] \
        + k1[None]


def _acc3(c: CurveSegments, s: int, u):
    k2, k3 = c.k2[s], c.k3[s]
    return 6 * k3[None, :3] * u[..., None] + 2 * k2[None, :3]


def _rounded_cone_t(o: V3, d: V3, pa, pb, ra, rb, tmin, tmax):
    """Closed-form ray vs rounded cone (sphere swept pa->pb, radius
    ra->rb). Returns (t with T_FAR misses, y/d2 axis parameter in [0,1]).
    Body + spherical end caps; two-sided like every other intersector."""
    a = V3.of(pa[0], pa[1], pa[2])
    b = V3.of(pb[0], pb[1], pb[2])
    ba = b - a
    oa = o - a
    ob = o - b
    rr = ra - rb
    m0 = v3.dot(ba, ba)
    m1 = v3.dot(ba, oa)
    m2 = v3.dot(ba, d)
    m3 = v3.dot(d, oa)
    m5 = v3.dot(oa, oa)
    m6 = v3.dot(ob, d)
    m7 = v3.dot(ob, ob)
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    sq = jnp.sqrt(jnp.maximum(h, 0.0))
    k2s = jnp.where(jnp.abs(k2) > _EPS, k2, 1.0)
    t_body = (-sq - k1) / k2s
    y = m1 - ra * rr + t_body * m2
    body_ok = (h > 0.0) & (jnp.abs(k2) > _EPS) & (y > 0.0) & (y < d2)
    t_body = jnp.where(body_ok, t_body, T_FAR)

    def cap(mm3, mm5, r):
        hc = mm3 * mm3 - mm5 + r * r
        sqc = jnp.sqrt(jnp.maximum(hc, 0.0))
        tc = -mm3 - sqc
        return jnp.where(hc > 0.0, tc, T_FAR)

    t_a = cap(m3, m5, ra)
    t_b = cap(m6, m7, rb)
    t = jnp.minimum(t_body, jnp.minimum(t_a, t_b))
    t = jnp.where((t > tmin) & (t < tmax), t, T_FAR)
    s_axis = jnp.clip(jnp.where(t == t_body, y / jnp.maximum(d2, _EPS),
                                jnp.where(t == t_a, 0.0, 1.0)), 0.0, 1.0)
    return t, s_axis


def _surface_normal_k(k0, k1, k2, k3, u, ps: V3):
    """Exact swept-sphere normal (``curve.h:333-443``, type 2) from
    per-lane power-basis rows ``k*`` [N, 4] at parameter ``u`` [N]."""
    p4 = _horner4(k0, k1, k2, k3, u)
    p = V3(p4[..., 0], p4[..., 1], p4[..., 2])
    r = p4[..., 3]
    uc = u[..., None]
    d4 = (3 * k3 * uc + 2 * k2) * uc + k1
    d = V3(d4[..., 0], d4[..., 1], d4[..., 2])
    dr = d4[..., 3]
    dd = v3.dot(d, d)
    o1 = ps - p
    o1 = o1 - d * (v3.dot(o1, d) / jnp.maximum(dd, _EPS))
    o1 = o1 * (r / jnp.maximum(v3.length(o1), _EPS))
    a3 = 6 * k3[..., :3] * uc + 2 * k2[..., :3]
    acc = V3(a3[..., 0], a3[..., 1], a3[..., 2])
    ddc = dd - v3.dot(acc, o1)
    return v3.normalize(o1 * ddc - d * (dr * r))


def _surface_normal(c: CurveSegments, s: int, u, ps: V3):
    """Per-segment wrapper over ``_surface_normal_k`` (tests)."""
    b = jnp.broadcast_to
    shape = u.shape + (4,)
    return _surface_normal_k(b(c.k0[s], shape), b(c.k1[s], shape),
                             b(c.k2[s], shape), b(c.k3[s], shape), u, ps)


def intersect_curves(curves: CurveSegments, origins, dirs,
                     tmin: float = 0.01, tmax: float = T_FAR,
                     index_offset: int = 0) -> Hit:
    """Closest hit over all curve segments for a flat ray wavefront.

    One ``lax.scan`` over the tessellated piece table (segment-major,
    piece-minor — the order fixes strict-`<` ties) keeps the compiled
    graph size independent of the segment count; the winning segment's
    exact normal is evaluated once per lane from gathered power-basis
    rows (the segment table is tiny, so the gather is a handful of
    rows)."""
    o = as_v3(origins)
    d = as_v3(dirs)
    n = o.x.shape[0]
    du = jnp.float32(1.0 / PIECES)
    pieces = _piece_table(curves.k0, curves.k1, curves.k2, curves.k3)

    def body(carry, piece):
        best_t, best_u, best_seg = carry
        pa, pb = piece["pa"], piece["pb"]
        t, ax = _rounded_cone_t(o, d, pa[:3], pb[:3], pa[3], pb[3],
                                tmin, tmax)
        u = piece["u0"] + ax * du
        better = t < best_t
        return (jnp.where(better, t, best_t),
                jnp.where(better, u, best_u),
                jnp.where(better, piece["seg"], best_seg)), None

    init = (jnp.full((n,), T_FAR, jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.zeros((n,), jnp.int32))
    (best_t, best_u, best_seg), _ = jax.lax.scan(body, init, pieces)
    hit = best_t < T_FAR
    ps = o + d * best_t
    seg = jnp.where(hit, best_seg, 0)
    normal = _surface_normal_k(
        jnp.take(curves.k0, seg, axis=0), jnp.take(curves.k1, seg, axis=0),
        jnp.take(curves.k2, seg, axis=0), jnp.take(curves.k3, seg, axis=0),
        best_u, ps)
    normal = v3.where(hit, normal, V3.zeros((n,)))
    mat = jnp.where(hit, jnp.take(curves.mat, seg), 0)
    return Hit(t=best_t, tri=best_seg + index_offset, hit=hit,
               normal=normal, mat=mat,
               u=best_u, v=jnp.zeros((n,), jnp.float32))


def occluded_curves(curves: CurveSegments, origins, dirs, tmax,
                    tmin: float = 0.01) -> jnp.ndarray:
    """Any-hit occlusion over the occluding (non-refractive) segments.

    Same semantics as ``primitives.occluded_primitives``: a per-ray tmax
    bounds the light distance; segments whose ``occludes`` flag is False
    pass light (static build-time selection, so pass-through segments
    cost nothing)."""
    o = as_v3(origins)
    d = as_v3(dirs)
    n = o.x.shape[0]
    if curves.occludes:
        keep = np.asarray([bool(f) for f in curves.occludes])
    else:
        keep = np.ones((curves.count,), bool)
    if not keep.any():
        return jnp.zeros((n,), bool)
    idx = np.nonzero(keep)[0]
    pieces = _piece_table(curves.k0[idx], curves.k1[idx],
                          curves.k2[idx], curves.k3[idx])

    def body(occ, piece):
        pa, pb = piece["pa"], piece["pb"]
        t, _ = _rounded_cone_t(o, d, pa[:3], pb[:3], pa[3], pb[3],
                               tmin, T_FAR)
        return occ | (t < tmax), None

    occ, _ = jax.lax.scan(body, jnp.zeros((n,), bool), pieces)
    return occ
