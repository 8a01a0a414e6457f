#!/usr/bin/env python3
"""Headline benchmark: Mrays/s and ms per frame on the Cornell box.

Renders the mixed-BSDF Cornell scene at 1024x1024, 16 spp, 8-bounce max
depth, importance sampling + NEE on, pixelq scheduler, on one GPU. Ray
counts come from the renderer's own telemetry: radiance rays actually
alive per bounce plus NEE shadow rays — masked-out lanes are not
counted. Without a GPU it exits nonzero.

    python bench.py [--intersector auto|pallas|bruteforce|bvh]
                    [--scene PATH] [--size N] [--spp N] [--depth N]
                    [--frames N] [--scheduler pixelq|regen|scan]

Prints ONE JSON line: metric, value (Mrays/s), ms_per_frame,
rays_per_frame, first_frame_s (compile included), the resolved intersector and the device
(platform, device_kind, count, card name and power limit).
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default=os.path.join(
        REPO, "assets", "cornell_box_mixed.obj"))
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--scheduler", default="pixelq",
                    choices=["pixelq", "regen", "scan"])
    ap.add_argument("--intersector", default="auto",
                    choices=["auto", "pallas", "bruteforce", "bvh"])
    args = ap.parse_args(argv)

    from tpu_pt.profiling import card_line, device_info, require_gpu
    require_gpu("bench.py")
    if not os.path.exists(args.scene):
        # numpy-only generator; JAX held to the CPU in the child so this
        # process stays the card's only user.
        subprocess.run([sys.executable,
                        os.path.join(REPO, "tools", "make_assets.py"),
                        "--big"], check=True, stdout=subprocess.DEVNULL,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})

    import jax
    import tpu_pt
    from tpu_pt.intersect import _resolve
    from tpu_pt.render import CameraArrays, render_frame, init_accum

    scene = tpu_pt.load_scene(args.scene)
    cfg = tpu_pt.RenderConfig(width=args.size, height=args.size,
                              spp=args.spp, max_depth=args.depth,
                              scheduler=args.scheduler,
                              intersector=args.intersector,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())

    accum = init_accum(cfg)
    t0 = time.perf_counter()
    accum, img, stats = jax.block_until_ready(
        render_frame(scene, cam, cfg, 0, accum))
    first_frame_s = time.perf_counter() - t0      # compile included

    # Time frames 1..N and sum THEIR ray counts (the RNG is frame-keyed,
    # so Russian roulette — and the ray count — varies per frame). Stats
    # stay on the device until the clock stops.
    frame_stats = []
    t0 = time.perf_counter()
    for f in range(1, args.frames + 1):
        accum, img, stats = render_frame(scene, cam, cfg, f, accum)
        frame_stats.append(stats)
    jax.block_until_ready((accum, img))
    dt = time.perf_counter() - t0

    total_rays = sum(float(s.rays_traced) + float(s.shadow_rays)
                     for s in frame_stats)
    print(json.dumps({
        "metric": f"Mrays/s, {args.size}x{args.size} "
                  f"{os.path.basename(args.scene)}, {args.depth} bounces, "
                  f"{args.spp} spp, IS+NEE on, {args.scheduler}",
        "value": total_rays / dt / 1e6,
        "unit": "Mrays/s",
        "ms_per_frame": dt / args.frames * 1e3,
        "rays_per_frame": total_rays / args.frames,
        "frames": args.frames,
        "first_frame_s": first_frame_s,
        "intersector": _resolve(scene, cfg),
        "device": device_info(),
        "card": card_line(),
    }))


if __name__ == "__main__":
    main()
