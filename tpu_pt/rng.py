"""Counter-based RNG for bitwise-reproducible wavefront rendering.

The reference threads a stateful 24-bit LCG through the ray payload
(``cuda/random.h:49-67``) seeded with ``tea<4>(pixel, frame)``
(``random.h:31-46``). A serial per-ray RNG is hostile to a wavefront
design (state would have to ride the scan carry and draws would serialize),
so we replace it with a *counter-based* generator: every uniform draw is a
pure hash of ``(pixel, sample, frame, stream)``. Renders become bitwise
reproducible regardless of bounce order, compaction, or device sharding —
this is the intentional divergence documented in SURVEY.md §7 hard-part 3.

Generator: PCG4D (Jarzynski & Olano, "Hash Functions for GPU Rendering",
JCGT 2020) — 4 lanes of 32-bit state, high quality, ~20 integer VPU ops per
4 uniforms. Floats are produced with 24-bit resolution in [0, 1), matching
the reference LCG's 24-bit output granularity (``random.h:54,66``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_U32 = jnp.uint32
# 1/2^24, float32-exact; uniforms are in [0, 1).
_INV_2_24 = 5.9604644775390625e-08
_INV_2_24_ARR = None


def _inv_2_24() -> jnp.ndarray:
    """The 2^-24 scale as a CONCRETE f32 device array, created lazily.

    Lazily: a module-scope ``jnp.float32(...)`` initializes the XLA
    backend at import time, which breaks ``jax.distributed.initialize``
    in multi-host workers. Concrete (not a Python literal): the literal
    changed XLA fusion enough to cost 1-ulp cross-sharding bitwise
    equality (test_tile_sharding_bitwise_with_scan_scheduler caught it).
    ``ensure_compile_time_eval``: without it, a first call that happens
    INSIDE a jit trace caches a DynamicJaxprTracer, which every later
    trace then closes over — XLA lifts the stale tracer as a phantom
    executable parameter and execution dies with "supplied N buffers
    but compiled program expected N+1" on the SECOND config rendered in
    a process (order-dependent, so it looked flaky)."""
    global _INV_2_24_ARR
    if _INV_2_24_ARR is None:
        import jax
        with jax.ensure_compile_time_eval():
            _INV_2_24_ARR = jnp.float32(_INV_2_24)
    return _INV_2_24_ARR


def pcg4d(a, b, c, d):
    """PCG4D hash: four uint32 counters -> four decorrelated uint32 outputs."""
    x = jnp.asarray(a).astype(_U32)
    y = jnp.asarray(b).astype(_U32)
    z = jnp.asarray(c).astype(_U32)
    w = jnp.asarray(d).astype(_U32)

    x = x * _U32(1664525) + _U32(1013904223)
    y = y * _U32(1664525) + _U32(1013904223)
    z = z * _U32(1664525) + _U32(1013904223)
    w = w * _U32(1664525) + _U32(1013904223)

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z

    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    w = w ^ (w >> 16)

    x = x + y * w
    y = y + z * x
    z = z + x * y
    w = w + y * z
    return x, y, z, w


def _to_unit_float(u: jnp.ndarray) -> jnp.ndarray:
    """uint32 -> float32 in [0, 1) with 24-bit resolution."""
    return (u >> _U32(8)).astype(jnp.float32) * _inv_2_24()


def uniform4(pixel, sample, frame, stream):
    """Four independent uniforms in [0,1) for counter (pixel, sample, frame, stream).

    All arguments broadcast; ``stream`` enumerates draw sites (jitter, BSDF,
    light sample, RR, ...) so each site gets an independent sequence.
    """
    x, y, z, w = pcg4d(pixel, sample, frame, stream)
    return (_to_unit_float(x), _to_unit_float(y),
            _to_unit_float(z), _to_unit_float(w))


def uniform2(pixel, sample, frame, stream):
    x, y, z, w = pcg4d(pixel, sample, frame, stream)
    del z, w
    return _to_unit_float(x), _to_unit_float(y)


# Stream-id layout for one render pass. Per bounce we need at most 6 draws
# (2 BSDF + 1 refraction-choice + 2 light-sample + 1 RR) = two pcg4d calls.
STREAM_JITTER = 0          # camera sub-pixel jitter (2 draws)
STREAM_BOUNCE_A = 1        # per-depth d: stream = STREAM_BOUNCE_A + 2*d (4 draws)
STREAM_BOUNCE_B = 2        # per-depth d: stream = STREAM_BOUNCE_B + 2*d (4 draws)


def bounce_streams(depth):
    """Stream ids for the two pcg4d calls at a given bounce depth."""
    return STREAM_BOUNCE_A + 2 * depth, STREAM_BOUNCE_B + 2 * depth
