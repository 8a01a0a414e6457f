"""Per-pixel path debugging — the reference's printf-at-pixel tooling.

The reference debugs paths with pixel-targeted device printf macros
(``cuda/util.h:34-47``) and a commented DoneReason dump in raygen
(``pathTracerPrograms.cu:786-801``). The wavefront equivalent traces one
(pixel, sample) path through the *same* ``_bounce`` transition the
renderer runs (counter RNG makes the replay exact) and returns one record
per bounce instead of printing from device code.
"""

from __future__ import annotations

import numpy as np

from . import rng
from . import vec3 as v3
from .config import RenderConfig
from .intersect import get_intersectors
from .render import (CameraArrays, DONE_REASON_NAMES, _bounce, camera_rays)
from .scene.arrays import SceneArrays


def _v3_tuple(a, i=0):
    return (float(np.asarray(a.x)[i]), float(np.asarray(a.y)[i]),
            float(np.asarray(a.z)[i]))


def trace_pixel(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                x: int, y: int, sample: int = 0,
                frame: int = 0) -> list[dict]:
    """Replay one sample's path at pixel (x, y) bounce by bounce.

    Returns a list of per-bounce records: depth, ray origin/direction,
    hit (t, tri, mat), attenuation after the hit, radiance contribution
    added this bounce, and the DoneReason name when the path ends. The
    records reproduce exactly what the renderer's wavefront computed for
    this (pixel, sample, frame) — bitwise, thanks to the counter RNG.
    """
    import jax
    import jax.numpy as jnp

    closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=False)
    pix = jnp.asarray([y * cfg.width + x], jnp.uint32)
    samp = jnp.asarray([sample], jnp.uint32)
    frame_u = jnp.uint32(frame)

    jx, jy = rng.uniform2(pix, samp, frame_u, rng.STREAM_JITTER)
    origin, direction = camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)
    atten = v3.V3.ones((1,))

    # One jit specialization serves every depth (depth rides in as data),
    # so the replay compiles once.
    @jax.jit
    def bounce(origin, direction, atten, depth):
        return _bounce(scene, cfg, closest_fn, occluded_fn, pix, samp,
                       frame_u, origin, direction, atten, depth)

    records: list[dict] = []
    for depth in range(cfg.max_depth + 1):
        step = bounce(origin, direction, atten,
                      jnp.asarray([depth], jnp.uint32))
        done = bool(np.asarray(step["done"])[0])
        rec = dict(
            depth=depth,
            origin=_v3_tuple(origin),
            direction=_v3_tuple(direction),
            contrib=_v3_tuple(step["contrib"]),
            atten=_v3_tuple(step["atten_new"]),
            done=done,
            reason=DONE_REASON_NAMES[int(np.asarray(step["reason"])[0])]
            if done else "NOT_DONE",
        )
        records.append(rec)
        if done:
            break
        origin = step["new_origin"]
        direction = step["new_dir"]
        atten = step["atten_cont"]
    return records


def validate_frame(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                   frame_idx: int = 0, accum=None):
    """Render one frame under ``checkify`` — the OptiX validation-mode-ALL
    analog (``PathTracerMain.cpp:248-253``).

    The reference turns on `OPTIX_DEVICE_CONTEXT_VALIDATION_MODE_ALL` plus
    a level-4 log callback to catch API misuse at runtime; the JAX-native
    equivalent instruments the traced computation itself: NaN/Inf
    production and out-of-bounds indexing anywhere in the frame raise a
    ``JaxRuntimeError`` with the failing check's location instead of
    silently corrupting the image. Debug/CI tool — the instrumented frame
    is slower; never use it in the render loop.

    Returns (new_accum, frame_u8, stats) like ``render_frame``.
    """
    import jax
    import jax.numpy as jnp
    from jax.experimental import checkify

    from . import film
    from .render import init_accum, render_wavefront

    if accum is None:
        accum = init_accum(cfg)

    def frame_fn(accum):
        n = cfg.width * cfg.height
        radiance, stats = render_wavefront(scene, cam, cfg, 0, n,
                                           jnp.uint32(frame_idx))
        frame_img = radiance.reshape(cfg.height, cfg.width, 3)
        new_accum = film.accumulate(accum, frame_img,
                                    jnp.uint32(frame_idx))
        return new_accum, film.make_color(new_accum), stats

    checked = jax.jit(checkify.checkify(
        frame_fn, errors=checkify.float_checks | checkify.index_checks))
    err, out = checked(accum)
    err.throw()
    return out


def format_trace(records: list[dict]) -> str:
    """Human-readable dump, one line per bounce (the printf analog)."""
    lines = []
    for r in records:
        o, d, c = r["origin"], r["direction"], r["contrib"]
        lines.append(
            f"d{r['depth']}: o=({o[0]:.2f},{o[1]:.2f},{o[2]:.2f}) "
            f"dir=({d[0]:.3f},{d[1]:.3f},{d[2]:.3f}) "
            f"contrib=({c[0]:.4f},{c[1]:.4f},{c[2]:.4f}) "
            f"{r['reason'] if r['done'] else ''}".rstrip())
    return "\n".join(lines)


def validate_whitted_frame(ws, cam, cfg: RenderConfig, frame_idx: int = 0,
                           accum=None):
    """``validate_frame`` for the whitted pipeline: one frame under
    checkify float/index checks. Returns (accum, frame_u8, stats)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import checkify

    from . import film
    from .render import init_accum
    from .whitted import render_whitted_wavefront

    if accum is None:
        accum = init_accum(cfg)

    def frame_fn(accum):
        n = cfg.width * cfg.height
        radiance, stats = render_whitted_wavefront(ws, cam, cfg, 0, n,
                                                   jnp.uint32(frame_idx))
        frame_img = radiance.reshape(cfg.height, cfg.width, 3)
        new_accum = film.accumulate(accum, frame_img, jnp.uint32(frame_idx))
        return new_accum, film.make_color(new_accum), stats

    checked = jax.jit(checkify.checkify(
        frame_fn, errors=checkify.float_checks | checkify.index_checks))
    err, out = checked(accum)
    err.throw()
    return out
