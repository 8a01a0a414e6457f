#!/usr/bin/env python3
"""Multi-device benchmark: 4K frame tile-sharded over a device mesh.

BASELINE.json config 5 ("4K frame tile-sharded over a mesh with psum
sample accumulation"). Renders the mixed-BSDF Cornell at 3840x2160,
row-tile-sharded over the ``tile`` mesh axis with samples split over the
``spp`` axis and psum-combined (tpu_pt/dist.py), on every GPU of the
host; on one card this is a (1, 1) mesh — the full sharded code path,
one shard. Without a GPU it exits nonzero.

Knobs: DIST_W/DIST_H (3840x2160; DIST_SIZE sets both), DIST_SPP (4),
DIST_FRAMES (2), DIST_TILE/DIST_SPP_SHARDS (mesh factors).
Prints one JSON line like bench.py.
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import tpu_pt
    from tpu_pt import dist
    from tpu_pt.profiling import card_line, device_info, require_gpu
    from tpu_pt.render import CameraArrays

    require_gpu("bench_dist.py")
    obj = os.path.join(REPO, "assets", "cornell_box_mixed.obj")
    scene = tpu_pt.load_scene(obj)

    size = os.environ.get("DIST_SIZE")
    w = int(os.environ.get("DIST_W", size or 3840))
    h = int(os.environ.get("DIST_H", size or 2160))
    spp = int(os.environ.get("DIST_SPP", 4))
    frames = int(os.environ.get("DIST_FRAMES", 2))
    n_tile = os.environ.get("DIST_TILE")
    n_spp = os.environ.get("DIST_SPP_SHARDS")
    mesh = dist.device_mesh(int(n_tile) if n_tile else None,
                            int(n_spp) if n_spp else None)
    # Sharded spp must divide evenly; height must split into row tiles.
    spp = max(spp, mesh.shape["spp"])
    spp -= spp % mesh.shape["spp"]
    if h % mesh.shape["tile"]:
        h += mesh.shape["tile"] - h % mesh.shape["tile"]

    cfg = tpu_pt.RenderConfig(width=w, height=h, spp=spp, max_depth=8,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    step = dist.make_sharded_renderer(scene, cfg, mesh)
    accum = dist.init_accum_sharded(cfg, mesh)

    t_c0 = time.perf_counter()
    accum, img, stats = jax.block_until_ready(step(cam, 0, accum))
    first_frame_s = time.perf_counter() - t_c0     # compile included

    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, stats = step(cam, f, accum)
        frame_stats.append(stats)
    jax.block_until_ready((accum, img))
    dt = time.perf_counter() - t0

    total_rays = sum(float(s.rays_traced) + float(s.shadow_rays)
                     for s in frame_stats)
    mrays = total_rays / dt / 1e6
    payload = {
        "metric": f"Mrays/s, {w}x{h} Cornell tile-sharded over "
                  f"{mesh.shape['tile']}x{mesh.shape['spp']} (tile, spp) "
                  f"mesh, 8 bounces, {spp} spp, IS+NEE on",
        "value": mrays,
        "unit": "Mrays/s",
        "device": device_info(),
        "card": card_line(),
        "ms_per_frame": dt / frames * 1e3,
        "rays_per_frame": total_rays / frames,
        "first_frame_s": first_frame_s,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
