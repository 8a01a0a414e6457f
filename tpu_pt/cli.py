"""Command-line interface: offline rendering, benchmarking, viewing.

A real flag system replacing the reference's compile-time constants
(``PathTracerMain.cpp:41-59`` — resolution, spp, depth, and even the OBJ
path were hardcoded; the TODO at :41 asks for exactly this). Also prints
the reference's end-of-run statistics (total samples / avg ms / total ms,
``PathTracerMain.cpp:738-740``) plus the framework's richer telemetry.

Usage examples:
    python -m tpu_pt.cli render scene.obj -o out.png --spp 128 --frames 4
    python -m tpu_pt.cli render scene.obj --depth 8 --no-direct-lighting
    python -m tpu_pt.cli render --resume ckpt.npz --frames 16
    python -m tpu_pt.cli view scene.obj            # interactive viewer
    python -m tpu_pt.cli bench scene.obj
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", nargs="?", help="OBJ scene path")
    p.add_argument("-o", "--output", default="render.png",
                   help="output image (.png, .ppm, or .exr linear HDR)")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=128,
                   help="samples per pixel per frame (reference default 128)")
    p.add_argument("--frames", type=int, default=1,
                   help="progressive frames to accumulate")
    p.add_argument("--depth", type=int, default=4,
                   help="max bounce depth 1-28 (reference default 4)")
    p.add_argument("--direct-lighting", action="store_true", default=False,
                   help="enable NEE direct lighting (reference key '0')")
    p.add_argument("--no-direct-lighting", dest="direct_lighting",
                   action="store_false")
    p.add_argument("--importance-sampling", action="store_true",
                   default=False,
                   help="cosine-weighted sampling (reference key '1')")
    p.add_argument("--no-importance-sampling", dest="importance_sampling",
                   action="store_false")
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "bruteforce", "pallas", "bvh"])
    p.add_argument("--scheduler", default="pixelq",
                   choices=["pixelq", "regen", "scan"])
    p.add_argument("--reference-quirks", action="store_true",
                   help="replicate the reference renderer's known bugs "
                        "(fixed 0.2 metal roughness, first-hit occlusion)")
    p.add_argument("--eye", type=float, nargs=3, default=None)
    p.add_argument("--lookat", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=None,
                   help="vertical FOV degrees (default 35, or the glTF "
                        "asset's own camera when it declares one)")
    p.add_argument("--checkpoint", default=None,
                   help="write render state here after finishing")
    p.add_argument("--resume", default=None,
                   help="resume from a checkpoint (.npz)")
    p.add_argument("--stats", action="store_true",
                   help="print per-frame telemetry")
    p.add_argument("--validate", action="store_true",
                   help="render under checkify NaN/Inf/OOB checks (the "
                        "reference's OptiX validation-mode-ALL; slower)")
    p.add_argument("--pipeline", default="auto",
                   choices=["auto", "pathtrace", "whitted"],
                   help="auto: path tracer for .obj, whitted direct "
                        "lighting for .gltf/.glb")
    p.add_argument("--background", type=float, nargs=3,
                   default=[0.0, 0.0, 0.0])


def _build(args):
    import tpu_pt
    from tpu_pt.config import Quirks
    from tpu_pt.render import CameraArrays

    if args.resume:
        from tpu_pt.checkpoint import load_checkpoint
        accum, frame_idx, cfg, camera = load_checkpoint(args.resume)
        if not args.scene:
            raise SystemExit("--resume still needs the scene OBJ path")
        scene = tpu_pt.load_scene(args.scene)
        return scene, camera, cfg, accum, frame_idx

    if not args.scene:
        raise SystemExit("scene OBJ path required (or --resume)")
    scene = tpu_pt.load_scene(args.scene)
    quirks = Quirks.reference() if args.reference_quirks else Quirks()
    cfg = tpu_pt.RenderConfig(
        width=args.width, height=args.height, spp=args.spp,
        max_depth=args.depth, use_direct_lighting=args.direct_lighting,
        use_importance_sampling=args.importance_sampling,
        intersector=args.intersector, scheduler=args.scheduler,
        quirks=quirks)
    camera = tpu_pt.cornell_default_camera(aspect=args.width / args.height)
    if args.eye is not None:
        camera.eye = np.asarray(args.eye, np.float32)
    if args.lookat is not None:
        camera.lookat = np.asarray(args.lookat, np.float32)
    if args.fov is not None:
        camera.fov_y = args.fov
    accum = tpu_pt.init_accum(cfg)
    return scene, camera, cfg, accum, 0


def _pipeline_for(args) -> str:
    if args.pipeline != "auto":
        return args.pipeline
    if args.scene and args.scene.lower().endswith((".gltf", ".glb")):
        return "whitted"
    return "pathtrace"


def _render_whitted_cli(args) -> int:
    """Whitted-pipeline render with the full flag set: --stats,
    --checkpoint/--resume, --validate and --reference-quirks are
    first-class here exactly as on the path-tracer path."""
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.config import Quirks
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    from tpu_pt.render import CameraArrays, init_accum, image_to_host
    from tpu_pt.camera import Camera

    ws = load_gltf(args.scene)
    frame_start = 0
    if args.resume:
        from tpu_pt.checkpoint import load_checkpoint
        accum, frame_start, cfg, camera = load_checkpoint(args.resume)
    else:
        quirks = Quirks.reference() if args.reference_quirks else Quirks()
        cfg = tpu_pt.RenderConfig(
            width=args.width, height=args.height, spp=args.spp,
            max_depth=args.depth, background=tuple(args.background),
            intersector=args.intersector, quirks=quirks)
        if ws.camera:
            # The asset's own perspective camera (sutil::Scene loads
            # glTF cameras the same way, Scene.cpp:166-191).
            eye, lookat, up, fov = ws.camera
            camera = Camera(eye=np.asarray(eye, np.float32),
                            lookat=np.asarray(lookat, np.float32),
                            up=np.asarray(up, np.float32),
                            fov_y=fov, aspect=args.width / args.height)
        else:
            # Default camera: frame the scene's world bounds.
            lo, hi = ws.world_bounds()
            c = 0.5 * (lo + hi)
            ext = float(np.linalg.norm(hi - lo))
            camera = Camera(eye=c + np.array([0.7, 0.5, 0.9]) * ext,
                            lookat=c,
                            fov_y=args.fov if args.fov is not None
                            else 35.0,
                            aspect=args.width / args.height)
        if args.eye is not None:
            camera.eye = np.asarray(args.eye, np.float32)
        if args.lookat is not None:
            camera.lookat = np.asarray(args.lookat, np.float32)
        if args.fov is not None:
            camera.fov_y = args.fov    # explicit --fov beats the asset's
        accum = init_accum(cfg)
    cam = CameraArrays.from_camera(camera)

    render = render_whitted_frame
    if args.validate:
        from tpu_pt.debug import validate_whitted_frame

        def render(ws, cam, cfg, f, accum):  # noqa: F811
            return validate_whitted_frame(ws, cam, cfg, f, accum)

    img = None
    total_ms = 0.0
    for k in range(args.frames):
        f = frame_start + k
        t0 = time.perf_counter()
        accum, img, stats = render(ws, cam, cfg, f, accum)
        jax.block_until_ready(img)
        ms = (time.perf_counter() - t0) * 1e3
        total_ms += ms
        line = f"\rFrame Render Time: {ms:.0f}ms"
        if args.stats:
            rays = float(stats.rays_traced) + float(stats.shadow_rays)
            hist = np.asarray(stats.done_histogram).astype(int)
            line += (f"  [{rays / (ms / 1e3) / 1e6:.1f} Mrays/s, "
                     f"iters {float(stats.wavefront_iterations):.0f}, "
                     f"done(miss/depth/absorbed)={hist[0]}/{hist[1]}/"
                     f"{hist[2]}]")
        print(line, end="", flush=True)
    print()
    print(f"Total Samples: {cfg.spp * args.frames * cfg.width * cfg.height}")
    print(f"Average Frame Time: {total_ms / max(args.frames, 1):.1f}ms")
    _write_image(args.output, image_to_host(img), accum)
    print(f"wrote {args.output}")
    if args.checkpoint:
        from tpu_pt.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, accum, frame_start + args.frames,
                        cfg, camera)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


def _write_image(path, host_img_u8, accum=None):
    """Route by extension: .ppm / .exr (linear HDR from the accumulation
    buffer, tinyexr-parity) / .png (default)."""
    from tpu_pt import film
    import numpy as np

    if path.endswith(".ppm"):
        film.write_ppm(path, host_img_u8)
    elif path.endswith(".exr"):
        if accum is None:
            raise ValueError("EXR output needs the HDR accumulation buffer")
        film.write_exr(path, np.asarray(accum)[::-1], compression="zip")
    else:
        film.write_png(path, host_img_u8)


def cmd_render(args) -> int:
    import jax
    import tpu_pt
    from tpu_pt import film
    from tpu_pt.render import CameraArrays, render_frame, image_to_host

    if _pipeline_for(args) == "whitted":
        return _render_whitted_cli(args)

    scene, camera, cfg, accum, frame_start = _build(args)
    cam = CameraArrays.from_camera(camera)

    if args.validate:
        from tpu_pt.debug import validate_frame

        def render_frame(scene, cam, cfg, f, accum):  # noqa: F811
            return validate_frame(scene, cam, cfg, f, accum)

    total_ms = 0.0
    img = None
    for k in range(args.frames):
        f = frame_start + k
        t0 = time.perf_counter()
        accum, img, stats = render_frame(scene, cam, cfg, f, accum)
        jax.block_until_ready(img)
        ms = (time.perf_counter() - t0) * 1e3
        total_ms += ms
        line = f"\rFrame Render Time: {ms:.0f}ms"
        if args.stats:
            rays = float(stats.rays_traced) + float(stats.shadow_rays)
            hist = np.asarray(stats.done_histogram).astype(int)
            line += (f"  [{rays / (ms / 1e3) / 1e6:.1f} Mrays/s, "
                     f"iters {float(stats.wavefront_iterations):.0f}, "
                     f"done(miss/depth/rr/light)={hist[0]}/{hist[1]}/"
                     f"{hist[2]}/{hist[3]}]")
        print(line, end="", flush=True)
    print()

    # End-of-run totals (PathTracerMain.cpp:738-740 parity).
    frames = args.frames
    print(f"Total Samples: {cfg.spp * frames * cfg.width * cfg.height}")
    print(f"Average Frame Time: {total_ms / max(frames, 1):.1f}ms")
    print(f"Total Render Time: {total_ms:.0f}ms")

    _write_image(args.output, image_to_host(img), accum)
    print(f"wrote {args.output}")

    if args.checkpoint:
        from tpu_pt.checkpoint import save_checkpoint
        save_checkpoint(args.checkpoint, accum, frame_start + frames, cfg,
                        camera)
        print(f"checkpoint -> {args.checkpoint}")
    return 0


def bench_argv(args) -> list[str]:
    """``bench.py`` arguments for the CLI's flags. Only flags changed from
    the CLI's defaults pass on, so a bare ``tpu-pt bench`` measures
    bench.py's headline configuration."""
    argv = ["--scheduler", args.scheduler, "--intersector", args.intersector]
    if args.scene:
        argv += ["--scene", os.path.abspath(args.scene)]
    if args.width != 512:                   # non-default CLI width
        argv += ["--size", str(args.width)]
    for flag, value, default in (("--spp", args.spp, 128),
                                 ("--depth", args.depth, 4),
                                 ("--frames", args.frames, 1)):
        if value != default:
            argv += [flag, str(value)]
    return argv


def cmd_bench(args) -> int:
    """Run the headline benchmark (the repo-root ``bench.py``)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench
    bench.main(bench_argv(args))
    return 0


def cmd_view(args) -> int:
    from tpu_pt.viewer import run_viewer
    scene_path = args.scene
    if not scene_path:
        raise SystemExit("scene OBJ path required")
    return run_viewer(scene_path, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_pt", description=__doc__)
    sub = ap.add_subparsers(dest="command", required=True)

    p_render = sub.add_parser("render", help="offline progressive render")
    _add_render_args(p_render)
    p_render.set_defaults(fn=cmd_render)

    p_view = sub.add_parser("view", help="interactive terminal viewer")
    _add_render_args(p_view)
    p_view.add_argument("--http", type=int, default=0, metavar="PORT",
                        help="also serve frames as PNG over HTTP (a "
                             "browser page auto-refreshes; for remote/"
                             "SSH hosts where ANSI half-blocks aren't "
                             "enough; 0 = off)")
    p_view.add_argument("--http-host", default="127.0.0.1",
                        help="bind address for --http (default "
                             "loopback; set 0.0.0.0 deliberately to "
                             "expose beyond the host)")
    p_view.set_defaults(fn=cmd_view)

    p_bench = sub.add_parser("bench", help="run the headline benchmark")
    _add_render_args(p_bench)
    p_bench.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
