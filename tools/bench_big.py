#!/usr/bin/env python3
"""Big-scene benchmark: Mrays/s on the ~100k-tri displaced sphere.

Exercises the LBVH path (BASELINE.json config 4 geometry) on one GPU;
without a GPU it exits nonzero. Prints one JSON line like bench.py;
knobs via env: BIG_SIZE (512), BIG_SPP (4), BIG_FRAMES (2), BIG_DEPTH
(8), BIG_SCENE (assets/big_mesh.obj, generated when missing).
"""

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    obj = os.environ.get("BIG_SCENE",
                         os.path.join(REPO, "assets", "big_mesh.obj"))
    if not os.path.exists(obj):
        import subprocess
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_assets.py"),
                        "--big"], check=True,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    import jax
    import tpu_pt
    from tpu_pt.profiling import card_line, device_info, require_gpu
    from tpu_pt.render import CameraArrays, render_frame, init_accum

    require_gpu("bench_big.py")
    scene = tpu_pt.load_scene(obj)

    size = int(os.environ.get("BIG_SIZE", 512))
    spp = int(os.environ.get("BIG_SPP", 4))
    frames = int(os.environ.get("BIG_FRAMES", 2))
    depth = int(os.environ.get("BIG_DEPTH", 8))
    cfg = tpu_pt.RenderConfig(width=size, height=size, spp=spp,
                              max_depth=depth,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())

    accum = init_accum(cfg)
    t_c0 = time.perf_counter()
    accum, img, stats = jax.block_until_ready(
        render_frame(scene, cam, cfg, 0, accum))
    first_frame_s = time.perf_counter() - t_c0     # compile included

    # Sum ray counts of the TIMED frames (RR varies per frame; frame 0's
    # count would be systematically wrong for frames 1..N). Stats stay
    # on-device until the clock stops.
    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, stats = render_frame(scene, cam, cfg, f, accum)
        frame_stats.append(stats)
    jax.block_until_ready((accum, img))
    dt = time.perf_counter() - t0

    total_rays = sum(float(s.rays_traced) + float(s.shadow_rays)
                     for s in frame_stats)
    rays_per_frame = total_rays / frames
    mrays = total_rays / dt / 1e6
    payload = {
        "metric": f"Mrays/s, {size}x{size} big scene "
                  f"({scene.num_tris_padded} padded tris), {depth} bounces, "
                  f"{spp} spp, IS+NEE on",
        "value": mrays,
        "unit": "Mrays/s",
        "device": device_info(),
        "card": card_line(),
        "ms_per_frame": dt / frames * 1e3,
        "rays_per_frame": rays_per_frame,
        "first_frame_s": first_frame_s,
        # Wavefront telemetry (rounds include every ladder stage; divide
        # rays_per_frame by rounds x initial lanes for a rough occupancy).
        "rounds_per_frame": round(sum(
            float(s.wavefront_iterations) for s in frame_stats) / frames, 1),
        "initial_lanes": _initial_lanes(cfg, size * size),
    }
    print(json.dumps(payload))


def _initial_lanes(cfg, n_pixels: int) -> int:
    # Mirrors _render_pixelq's sizing (render.py) for telemetry only.
    chunk = max(1, min(cfg.spp, cfg.samples_per_item))
    total_items = n_pixels * ((cfg.spp + chunk - 1) // chunk)
    ipl = int(os.environ.get("TPT_ITEMS_PER_LANE", 8))
    return min(cfg.lanes, max(4096, total_items // ipl), total_items)


if __name__ == "__main__":
    main()
