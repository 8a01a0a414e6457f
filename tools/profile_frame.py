#!/usr/bin/env python3
"""Per-op device profile of one rendered frame (sutil::displayStats's
kernel-level analog, ``sutil/sutil.cpp:735-774``).

Renders one warm frame under ``jax.profiler.trace`` and prints the top
device ops by total time. Works for the path tracer (OBJ) and any scene
the CLI accepts.

Usage:
  python tools/profile_frame.py [scene.obj] [--width N] [--height N]
                                [--spp N] [--depth N] [--top N]
"""

import argparse
import collections
import glob
import gzip
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?",
                    default=os.path.join(REPO, "assets",
                                         "cornell_box_mixed.obj"))
    ap.add_argument("--width", type=int, default=1024)
    ap.add_argument("--height", type=int, default=1024)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.render import CameraArrays, render_frame, init_accum

    whitted = args.scene.endswith((".gltf", ".glb"))
    if whitted:
        # glTF scenes profile the whitted pipeline (bench_whitted's
        # camera/config family) — the round-3 VERDICT's missing profile.
        from tpu_pt.camera import Camera
        from tpu_pt.scene.gltf import load_gltf
        from tpu_pt.whitted import render_whitted_frame as render_fn
        scene = load_gltf(args.scene)
        cam = CameraArrays.from_camera(Camera(
            eye=np.array([6.0, 4.5, 7.0], np.float32),
            lookat=np.array([0.0, 0.8, 0.0], np.float32), fov_y=40.0))
        cfg = tpu_pt.RenderConfig(width=args.width, height=args.height,
                                  spp=args.spp, max_depth=args.depth,
                                  background=(0.1, 0.15, 0.25))
    else:
        scene = tpu_pt.load_scene(args.scene)
        render_fn = render_frame
        cfg = tpu_pt.RenderConfig(width=args.width, height=args.height,
                                  spp=args.spp, max_depth=args.depth,
                                  use_direct_lighting=True,
                                  use_importance_sampling=True)
        cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    accum = init_accum(cfg)
    accum, img, _ = jax.block_until_ready(
        render_fn(scene, cam, cfg, 0, accum))

    tracedir = tempfile.mkdtemp(prefix="tpt_trace_")
    with jax.profiler.trace(tracedir):
        accum, img, _ = jax.block_until_ready(
            render_fn(scene, cam, cfg, 1, accum))

    paths = sorted(glob.glob(os.path.join(
        tracedir, "plugins/profile/*/*.trace.json.gz")))
    if not paths:
        print("no trace written (profiler unsupported on this backend?)",
              file=sys.stderr)
        return 1
    with gzip.open(paths[-1]) as f:
        d = json.load(f)
    ev = d["traceEvents"]
    pids = {e["pid"]: e["args"].get("name", "") for e in ev
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    devpids = {p for p, n in pids.items() if "GPU" in n}
    dur = collections.Counter()
    cnt = collections.Counter()
    for e in ev:
        if e.get("ph") == "X" and e.get("pid") in devpids:
            dur[e.get("name", "?")] += e.get("dur", 0)
            cnt[e.get("name", "?")] += 1
    if not dur:
        print("no device events in trace (CPU backend traces lack a "
              "device timeline)", file=sys.stderr)
        return 1
    frame = next((us for nm, us in dur.items()
                  if nm.startswith(("jit_render_frame",
                                    "jit_render_whitted_frame"))), None)
    if frame:
        print(f"frame total: {frame / 1e3:9.2f} ms")
    # Family totals: every op groups under its name stem (`fusion.283`
    # -> `fusion`, `pallas_closest_c.336` -> `pallas_closest_c`), so
    # the closest/occlusion/XLA split of a frame is one line each
    # even when the chained slabs emit dozens of per-slab kernels.
    fam = collections.Counter()
    for nm, us in dur.items():
        if nm.startswith("jit_") or nm.startswith("while"):
            continue
        fam[nm.rsplit(".", 1)[0]] += us
    print("-- families --")
    for nm, us in fam.most_common(12):
        pct = f" ({us / frame * 100:4.1f}%)" if frame else ""
        print(f"{us / 1e3:10.2f}  {nm[:60]}{pct}")
    print(f"{'total ms':>10}  {'calls':>6}  op")
    for nm, us in dur.most_common(args.top):
        if nm.startswith("jit_") or nm.startswith("while"):
            continue
        pct = f" ({us / frame * 100:4.1f}%)" if frame else ""
        print(f"{us / 1e3:10.2f}  {cnt[nm]:6d}  {nm[:70]}{pct}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
