"""Component-SoA 3-vectors: the hot-path layout of the wavefront.

``V3`` stores x, y, z as three independent ``[N]`` arrays instead of one
``[N, 3]`` array: every dot/normalize/cross is then a full-width
elementwise op over contiguous rows, with no reduction over a size-3
minor axis and no strided access.

``V3`` is a NamedTuple, hence automatically a pytree (scan carries,
shard_map, donation all work). Geometry vectors AND RGB colors use it on
the hot path; conversion to ``[..., 3]`` happens only at module boundaries
(film accumulation, host IO).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class V3(NamedTuple):
    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic (V3 op V3, V3 op scalar-array) -------------------------
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, V3):
            return V3(self.x / o.x, self.y / o.y, self.z / o.z)
        return V3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    # -- conversions -------------------------------------------------------
    @staticmethod
    def from_array(a: jnp.ndarray) -> "V3":
        """[..., 3] -> V3 of [...]."""
        return V3(a[..., 0], a[..., 1], a[..., 2])

    @staticmethod
    def of(x, y, z) -> "V3":
        return V3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                  jnp.asarray(z, jnp.float32))

    @staticmethod
    def full(shape, vals) -> "V3":
        """Broadcast a constant 3-tuple to V3 of the given shape."""
        return V3(jnp.full(shape, vals[0], jnp.float32),
                  jnp.full(shape, vals[1], jnp.float32),
                  jnp.full(shape, vals[2], jnp.float32))

    @staticmethod
    def zeros(shape) -> "V3":
        z = jnp.zeros(shape, jnp.float32)
        return V3(z, z, z)

    @staticmethod
    def ones(shape) -> "V3":
        o = jnp.ones(shape, jnp.float32)
        return V3(o, o, o)

    def to_array(self) -> jnp.ndarray:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    def astype(self, dt) -> "V3":
        return V3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))


def as_v3(x) -> V3:
    """Coerce a V3 or an [..., 3] array to V3 (public-API convenience)."""
    if isinstance(x, V3):
        return x
    return V3.from_array(jnp.asarray(x, jnp.float32))


def dot(a: V3, b: V3) -> jnp.ndarray:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def length(a: V3) -> jnp.ndarray:
    return jnp.sqrt(jnp.maximum(dot(a, a), 0.0))


def normalize(a: V3) -> V3:
    n2 = dot(a, a)
    inv = jnp.where(n2 > 1e-12, jax.lax.rsqrt(jnp.maximum(n2, 1e-30)), 0.0)
    return a * inv


def lerp(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def where(mask, a: V3, b: V3) -> V3:
    return V3(jnp.where(mask, a.x, b.x), jnp.where(mask, a.y, b.y),
              jnp.where(mask, a.z, b.z))


def reflect(i: V3, n: V3) -> V3:
    """i - 2*dot(n, i)*n (``sutil/vec_math.h`` reflect)."""
    return i - n * (2.0 * dot(n, i))


def faceforward(n: V3, i: V3, nref: V3) -> V3:
    """n * copysign(1, dot(i, nref)) (``sutil/vec_math.h`` faceforward)."""
    s = jnp.where(dot(i, nref) >= 0.0, 1.0, -1.0)
    return n * s


def luminance(rgb: V3) -> jnp.ndarray:
    """NTSC weights (0.30, 0.59, 0.11), ``cuda/helpers.h:76-80``."""
    return rgb.x * 0.30 + rgb.y * 0.59 + rgb.z * 0.11


def safe_divide(a: V3, b) -> V3:
    zero = b == 0.0
    inv = jnp.where(zero, 0.0, 1.0 / jnp.where(zero, 1.0, b))
    return a * inv


def onb_from_normal(n: V3) -> tuple[V3, V3, V3]:
    """Reference ONB (``pathTracerPrograms.cu:54-75``), branch-free."""
    use_x = jnp.abs(n.x) > jnp.abs(n.z)
    zeros = jnp.zeros_like(n.x)
    b = where(use_x, V3(-n.y, n.x, zeros), V3(zeros, -n.z, n.y))
    b = normalize(b)
    t = cross(b, n)
    return t, b, n


def onb_transform(local: V3, t: V3, b: V3, n: V3) -> V3:
    """Local (x,y,z) -> world: x*t + y*b + z*n."""
    return t * local.x + b * local.y + n * local.z


def refract(i: V3, n: V3, ior) -> tuple[V3, jnp.ndarray]:
    """``cuda/helpers.h:107-137`` semantics (see vmath.refract)."""
    ior = jnp.asarray(ior, jnp.float32)
    neg_ndotv = dot(i, n)
    exiting = neg_ndotv > 0.0
    eta = jnp.where(exiting, ior, 1.0 / ior)
    nn = where(exiting, -n, n)
    cos_i = jnp.where(exiting, -neg_ndotv, neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    r = i * eta - nn * (eta * cos_i + jnp.sqrt(jnp.maximum(k, 0.0)))
    r = normalize(r)
    return where(ok, r, V3.zeros(ok.shape)), ok
