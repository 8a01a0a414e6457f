"""Intersection backends.

``get_intersectors`` picks the backend per config:
- ``bruteforce``: chunked jnp Möller-Trumbore (any device; the reference)
- ``pallas``: the dense Pallas kernel of the same test (GPU only,
  ``pallas_dense``)
- ``bvh``: LBVH build + traversal for large meshes
- ``auto``: ``bvh`` once the triangle count crosses the device's
  crossover, else ``pallas`` on a GPU and ``bruteforce`` elsewhere.
"""

from __future__ import annotations

from functools import partial

import jax

from ..config import RenderConfig
from ..scene.arrays import SceneArrays
from .moller import Hit, intersect_closest, intersect_occluded

__all__ = ["Hit", "intersect_closest", "intersect_occluded",
           "get_intersectors"]

# Padded triangle counts above which the LBVH beats the dense sweep.
# GPU: the Pallas kernel against the LBVH, whole frames on an H100
# (PERF.md): the kernel wins at 32,640 padded triangles (0.65x the
# LBVH's frame time), loses at 64,512 (1.07x); log-interpolated, they
# meet near 59k. CPU: the jnp sweep against the LBVH.
GPU_BVH_CROSSOVER_TRIS = 57344
BVH_CROSSOVER_TRIS = 4096


def _resolve(scene: SceneArrays, cfg: RenderConfig) -> str:
    if cfg.intersector != "auto":
        return cfg.intersector
    on_gpu = jax.default_backend() == "gpu"
    crossover = GPU_BVH_CROSSOVER_TRIS if on_gpu else BVH_CROSSOVER_TRIS
    if scene.num_tris_padded > crossover and scene.bvh is not None:
        return "bvh"
    return "pallas" if on_gpu else "bruteforce"


def _with_primitives(scene: SceneArrays, cfg: RenderConfig, closest_fn,
                     occluded_fn):
    """Bind analytic primitives into the pipeline (min-t combine).

    The SBT-bound custom-primitive intersection programs of the reference
    (``sutil/Scene.cpp:1368-1450`` + ``cuda/geometry.cu``/``sphere.cu``)
    become a dense post-pass over the few primitives, combined with the
    triangle hit by min-t. Primitive ids are offset past the padded
    triangle range so consumers can tell them apart."""
    from functools import wraps
    from .primitives import (combine_hits, intersect_primitives,
                             occluded_primitives)
    prims = scene.prims
    offset = scene.num_tris_padded

    @wraps(closest_fn)
    def closest2(o, d):
        ph = intersect_primitives(prims, o, d, tmin=cfg.t_min,
                                  tmax=cfg.t_max, index_offset=offset)
        return combine_hits(closest_fn(o, d), ph)

    def occluded2(o, d, tmax):
        return (occluded_fn(o, d, tmax)
                | occluded_primitives(prims, o, d, tmax, tmin=cfg.t_min))

    return closest2, occluded2


def _with_curves(scene: SceneArrays, cfg: RenderConfig, closest_fn,
                 occluded_fn):
    """Bind swept-sphere curves into the pipeline (min-t combine).

    The reference carries its four round-curve types as first-class
    geometry (``cuda/GeometryData.h:95-127``) with exact swept-sphere
    surface normals in shading (``cuda/curve.h:312-443``); here the
    tessellated rounded-cone intersector + exact post-hoc normals of
    ``intersect.curves`` join the hit stream exactly like the analytic
    primitives. Curve ids live past the primitive ids."""
    from functools import wraps
    from .curves import intersect_curves, occluded_curves
    from .primitives import combine_hits
    curves = scene.curves
    offset = scene.num_tris_padded + (
        scene.prims.count if scene.prims is not None else 0)

    @wraps(closest_fn)
    def closest2(o, d):
        ch = intersect_curves(curves, o, d, tmin=cfg.t_min,
                              tmax=cfg.t_max, index_offset=offset)
        return combine_hits(closest_fn(o, d), ch)

    def occluded2(o, d, tmax):
        return (occluded_fn(o, d, tmax)
                | occluded_curves(curves, o, d, tmax, tmin=cfg.t_min))

    return closest2, occluded2


def get_intersectors(scene: SceneArrays, cfg: RenderConfig,
                     want_uv: bool = True):
    """Returns (closest_fn(o, d) -> Hit, occluded_fn(o, d, tmax) -> bool).

    ``want_uv=False`` lets the Pallas backend skip the barycentric carry
    (the OBJ path tracer shades flat normals only; the whitted pipeline
    needs u/v for vertex-attribute interpolation)."""
    if scene.curves is not None and scene.curves.count:
        base = scene.replace(curves=None)
        closest_fn, occluded_fn = get_intersectors(base, cfg,
                                                   want_uv=want_uv)
        return _with_curves(scene, cfg, closest_fn, occluded_fn)
    if scene.prims is not None and scene.prims.count:
        base = scene.replace(prims=None)
        closest_fn, occluded_fn = get_intersectors(base, cfg,
                                                   want_uv=want_uv)
        return _with_primitives(scene, cfg, closest_fn, occluded_fn)
    backend = _resolve(scene, cfg)

    if backend == "pallas":
        from . import pallas_dense
        closest = partial(pallas_dense.intersect_closest, scene,
                          tmin=cfg.t_min, tmax=cfg.t_max, want_uv=want_uv)
        occluded = partial(pallas_dense.intersect_occluded, scene,
                           tmin=cfg.t_min,
                           quirk_first_hit=cfg.quirks.occlusion_first_hit_only)
        return closest, occluded

    if backend == "bvh":
        from . import lbvh
        closest = partial(lbvh.intersect_closest, scene,
                          tmin=cfg.t_min, tmax=cfg.t_max)
        occluded = partial(lbvh.intersect_occluded, scene,
                           tmin=cfg.t_min,
                           quirk_first_hit=cfg.quirks.occlusion_first_hit_only)
        return closest, occluded

    assert backend == "bruteforce", backend
    closest = partial(intersect_closest, scene, tmin=cfg.t_min,
                      tmax=cfg.t_max, ray_chunk=cfg.ray_chunk,
                      tri_block=cfg.tri_block)

    def occluded(o, d, tmax):
        return intersect_occluded(
            scene, o, d, tmax, tmin=cfg.t_min, ray_chunk=cfg.ray_chunk,
            tri_block=cfg.tri_block,
            quirk_first_hit=cfg.quirks.occlusion_first_hit_only)

    return closest, occluded
