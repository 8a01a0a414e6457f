#!/usr/bin/env python3
"""Whitted-pipeline benchmark on one GPU.

Renders pbr_test.glb and prints one JSON line with Mrays/s from the
renderer's own telemetry (alive radiance rays + shadow rays — honest
about the early-exit depth loop). Without a GPU it exits nonzero.

Knobs: BENCH_W_SIZE (512), BENCH_W_SPP (8), BENCH_W_DEPTH (8),
BENCH_W_FRAMES (4), BENCH_W_SCENE, BENCH_W_SCHED (pixelq).
"""

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    scene_path = os.environ.get(
        "BENCH_W_SCENE", os.path.join(REPO, "assets", "pbr_test.glb"))
    if not os.path.exists(scene_path):
        # The generator imports tpu_pt: hold its JAX to the CPU, so this
        # process stays the card's only user.
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_gltf_assets.py")],
                       check=True, env={**os.environ, "JAX_PLATFORMS": "cpu"})

    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.profiling import card_line, device_info, require_gpu
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    from tpu_pt.render import CameraArrays, init_accum
    from tpu_pt.camera import Camera

    require_gpu("bench_whitted.py")
    ws = load_gltf(scene_path)

    size = int(os.environ.get("BENCH_W_SIZE", 512))
    spp = int(os.environ.get("BENCH_W_SPP", 8))
    depth = int(os.environ.get("BENCH_W_DEPTH", 8))
    frames = int(os.environ.get("BENCH_W_FRAMES", 4))
    sched = os.environ.get("BENCH_W_SCHED", "pixelq")
    cfg = tpu_pt.RenderConfig(width=size, height=size, spp=spp,
                              max_depth=depth, scheduler=sched,
                              background=(0.1, 0.15, 0.25))
    camera = Camera(eye=np.array([6.0, 4.5, 7.0], np.float32),
                    lookat=np.array([0.0, 0.8, 0.0], np.float32),
                    fov_y=40.0, aspect=1.0)
    cam = CameraArrays.from_camera(camera)

    accum = init_accum(cfg)
    accum, img, stats = jax.block_until_ready(
        render_whitted_frame(ws, cam, cfg, 0, accum))

    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, stats = render_whitted_frame(ws, cam, cfg, f, accum)
        frame_stats.append(stats)
    jax.block_until_ready((accum, img))
    dt = time.perf_counter() - t0

    total_rays = sum(float(s.rays_traced) + float(s.shadow_rays)
                     for s in frame_stats)
    mrays = total_rays / dt / 1e6
    scene_name = os.path.splitext(os.path.basename(scene_path))[0]
    payload = {
        "metric": f"whitted Mrays/s, {size}x{size} {scene_name}, "
                  f"depth {depth}, {spp} spp",
        "value": mrays,
        "unit": "Mrays/s",
        "device": device_info(),
        "card": card_line(),
        "ms_per_frame": dt / frames * 1e3,
        "rays_per_frame": int(total_rays / frames),
        "iters_per_frame": round(float(
            frame_stats[-1].wavefront_iterations), 1),
        "scheduler": sched,
    }
    print(json.dumps(payload))


if __name__ == "__main__":
    main()
