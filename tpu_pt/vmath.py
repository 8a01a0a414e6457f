"""Vector math on stacked ``[..., 3]`` float32 arrays.

The replacement for the reference's CUDA header math
(``sutil/vec_math.h``, ``PathTracer_Optix/pathTracerPrograms.cu:54-85`` ONB,
``cuda/helpers.h:107-137`` refract). Everything here is shape-polymorphic,
jit-safe, and branch-free so it vectorizes over whole ray wavefronts
instead of per-thread scalar code.
"""

from __future__ import annotations

import jax.numpy as jnp

Vec3 = jnp.ndarray  # [..., 3]

EPS = 1e-12


def vec3(x, y, z) -> Vec3:
    """Stack three scalars/arrays into a [..., 3] vector."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def dot(a: Vec3, b: Vec3) -> jnp.ndarray:
    """Dot product over the last axis, keeping no dims: [..., 3] -> [...]."""
    return jnp.sum(a * b, axis=-1)


def cross(a: Vec3, b: Vec3) -> Vec3:
    return jnp.cross(a, b)


def length(a: Vec3) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: Vec3) -> Vec3:
    """Normalize; zero vectors map to zero (safe for masked lanes)."""
    n2 = dot(a, a)
    inv = jnp.where(n2 > EPS, jnp.float32(1.0) / jnp.sqrt(n2), 0.0)
    return a * inv[..., None]


def lerp(a, b, t):
    return a + (b - a) * t


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Mirror reflection of direction ``i`` about normal ``n``.

    Matches ``sutil/vec_math.h`` ``reflect(i, n) = i - 2*n*dot(n, i)``.
    """
    return i - 2.0 * dot(n, i)[..., None] * n


def faceforward(n: Vec3, i: Vec3, nref: Vec3) -> Vec3:
    """Flip ``n`` so it faces the hemisphere of ``i`` w.r.t. ``nref``.

    Matches ``sutil/vec_math.h`` ``faceforward``: ``n * copysign(1, dot(i, nref))``.
    """
    s = jnp.where(dot(i, nref) >= 0.0, 1.0, -1.0)
    return n * s[..., None]


def safe_divide(a, b):
    """a / b with 0 where b == 0 (reference ``safeDivide``,
    ``pathTracerPrograms.cu:265-284``)."""
    b = jnp.asarray(b)
    return jnp.where(b == 0.0, 0.0, a / jnp.where(b == 0.0, 1.0, b))


def luminance(rgb: Vec3) -> jnp.ndarray:
    """NTSC luminance weights (0.30, 0.59, 0.11), ``cuda/helpers.h:76-80``."""
    w = jnp.asarray([0.30, 0.59, 0.11], jnp.float32)
    return dot(rgb, w)


def onb_from_normal(n: Vec3) -> tuple[Vec3, Vec3, Vec3]:
    """Build the reference's orthonormal basis (tangent, binormal, normal).

    Branch structure mirrors ``OrthonormalBasis`` in
    ``pathTracerPrograms.cu:54-75``: binormal from the larger of |n.x|,|n.z|,
    vectorized with ``where`` instead of divergent branches.
    """
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = jnp.abs(nx) > jnp.abs(nz)
    b = jnp.where(
        use_x[..., None],
        vec3(-ny, nx, jnp.zeros_like(nx)),
        vec3(jnp.zeros_like(nx), -nz, ny),
    )
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def onb_transform(local: Vec3, t: Vec3, b: Vec3, n: Vec3) -> Vec3:
    """Local (x,y,z) -> world: x*t + y*b + z*n (``inverse_transform``,
    ``pathTracerPrograms.cu:77-80``)."""
    return (local[..., 0:1] * t + local[..., 1:2] * b + local[..., 2:3] * n)


def refract(i: Vec3, n: Vec3, ior) -> tuple[Vec3, jnp.ndarray]:
    """Refract direction ``i`` at interface normal ``n`` with relative ``ior``.

    Semantics of ``cuda/helpers.h:107-137``: handles rays entering or exiting
    (``dot(i, n) > 0`` means exiting -> eta=ior, flipped interface normal).
    Returns (refracted_dir, did_refract); on total internal reflection the
    direction is zero and did_refract is False.
    """
    ior = jnp.asarray(ior, jnp.float32)
    neg_ndotv = dot(i, n)
    exiting = neg_ndotv > 0.0
    eta = jnp.where(exiting, ior, 1.0 / ior)
    nn = jnp.where(exiting[..., None], -n, n)
    cos_i = jnp.where(exiting, -neg_ndotv, neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    k_safe = jnp.maximum(k, 0.0)
    r = eta[..., None] * i - (eta * cos_i + jnp.sqrt(k_safe))[..., None] * nn
    r = normalize(r)
    return jnp.where(ok[..., None], r, 0.0), ok
