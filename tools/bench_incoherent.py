#!/usr/bin/env python3
"""Incoherent-wavefront intersection microbench (big scene), one GPU.

The renderer's own wavefronts are camera-coherent; externally supplied
batches (e.g. a user tracing arbitrary rays through
``get_intersectors``) are not. This bench builds the worst case —
surface-point origins with uniform-sphere directions — and times the
closest-hit and occlusion paths the renderer would pick for the scene.
Without a GPU it exits nonzero.

Knobs: INC_RAYS (262144), INC_SCENE (assets/big_mesh.obj), INC_REPS (3),
INC_UV (1; 0 = no barycentrics, the path tracer's binding).
Prints one JSON line per path.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import jax.numpy as jnp
    import tpu_pt
    from tpu_pt.vec3 import V3
    from tpu_pt.intersect import _resolve, get_intersectors
    from tpu_pt.profiling import card_line, device_info, require_gpu

    require_gpu("bench_incoherent.py")

    obj = os.environ.get("INC_SCENE",
                         os.path.join(REPO, "assets", "big_mesh.obj"))
    scene = tpu_pt.load_scene(obj)
    n = int(os.environ.get("INC_RAYS", 262144))
    reps = int(os.environ.get("INC_REPS", 3))

    # Surface-ish origins: random points inside the scene AABB, uniform
    # sphere directions — no tile shares a direction cone.
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    # Scene AABB from the triangle VERTICES (pack_tris columns 0:3 are
    # the plane normals — using those confined all origins to a ~unit
    # cube at the corner, a far more origin-coherent workload than the
    # worst case this bench claims to measure).
    valid = scene.tri_valid > 0
    corners = jnp.concatenate(
        [scene.tri_v0, scene.tri_v0 + scene.tri_e1,
         scene.tri_v0 + scene.tri_e2], axis=0)
    vmask = jnp.concatenate([valid, valid, valid])[:, None]
    lo = jnp.min(jnp.where(vmask, corners, jnp.inf), axis=0)
    hi = jnp.max(jnp.where(vmask, corners, -jnp.inf), axis=0)
    p = jax.random.uniform(k1, (n, 3)) * (hi - lo) + lo
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    origins = V3(p[:, 0], p[:, 1], p[:, 2])
    dirs = V3(d[:, 0], d[:, 1], d[:, 2])
    tmax = jnp.full((n,), 1e4, jnp.float32)

    want_uv = os.environ.get("INC_UV", "1") == "1"
    cfg = tpu_pt.RenderConfig()
    closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=want_uv)
    closest = jax.jit(closest_fn)
    occluded = jax.jit(occluded_fn)

    for name, fn, arg in (("closest", closest, (origins, dirs)),
                          ("occluded", occluded, (origins, dirs, tmax))):
        jax.block_until_ready(fn(*arg))
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*arg)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / reps
        print(json.dumps({
            "metric": f"incoherent {name}, {n} rays, "
                      f"{scene.num_tris_padded} padded tris",
            "value": n / dt / 1e6,
            "unit": "Mrays/s",
            "ms": dt * 1e3,
            "intersector": _resolve(scene, cfg),
            "want_uv": want_uv,
            "device": device_info(),
            "card": card_line(),
        }))


if __name__ == "__main__":
    main()
