#!/usr/bin/env python3
"""Generate golden images for the regression suite.

The reference ships five mode-demonstration PNGs as de-facto acceptance
artifacts (``README.md:24-47``: importance sampling off/on, +direct
lighting, 3-bounce, 16-bounce). This regenerates our equivalents at a
pinned configuration; tests re-render at the same settings and assert
per-pixel RMSE. Goldens are rendered on CPU for platform stability.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

GOLDEN_DIR = os.path.join(REPO, "tests", "goldens")

# (name, overrides) — mirrors the reference's five README modes.
MODES = [
    ("no-importance-no-direct", dict(use_importance_sampling=False,
                                     use_direct_lighting=False)),
    ("importance-no-direct", dict(use_importance_sampling=True,
                                  use_direct_lighting=False)),
    ("importance-with-direct", dict(use_importance_sampling=True,
                                    use_direct_lighting=True)),
    ("3-bounce", dict(use_importance_sampling=True,
                      use_direct_lighting=True, max_depth=3)),
    ("16-bounce", dict(use_importance_sampling=True,
                       use_direct_lighting=True, max_depth=16)),
]

BASE = dict(width=128, height=128, spp=32, max_depth=4,
            intersector="bruteforce", scheduler="regen")
FRAMES = 1


def render_mode(scene, cam, overrides):
    import tpu_pt
    from tpu_pt.render import render_frame, init_accum
    cfg = tpu_pt.RenderConfig(**{**BASE, **overrides})
    accum = init_accum(cfg)
    img = None
    for f in range(FRAMES):
        accum, img, _ = render_frame(scene, cam, cfg, f, accum)
    return img


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import tpu_pt
    from tpu_pt import film
    from tpu_pt.render import CameraArrays

    os.makedirs(GOLDEN_DIR, exist_ok=True)
    scene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                           "cornell_box_mixed.obj"))
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    for name, overrides in MODES:
        img = render_mode(scene, cam, overrides)
        path = os.path.join(GOLDEN_DIR, f"{name}.png")
        film.write_png(path, tpu_pt.image_to_host(img))
        print("wrote", path)

    # Analytic-primitives golden (scene JSON: glass sphere shell + metal
    # sphere + parallelogram bound into the pipeline; the reference's
    # custom-primitive showcase, cuda/geometry.cu + sphere.cu).
    pscene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                            "cornell_prims.json"))
    img = render_mode(pscene, cam, dict(use_importance_sampling=True,
                                        use_direct_lighting=True))
    path = os.path.join(GOLDEN_DIR, "primitives.png")
    film.write_png(path, tpu_pt.image_to_host(img))
    print("wrote", path)

    # Swept-sphere curves golden (scene JSON: all four reference curve
    # bases rendered in the Cornell box; cuda/GeometryData.h:95-127 +
    # curve.h:312-443 exact normals).
    cscene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                            "cornell_curves.json"))
    img = render_mode(cscene, cam, dict(use_importance_sampling=True,
                                        use_direct_lighting=True))
    path = os.path.join(GOLDEN_DIR, "curves.png")
    film.write_png(path, tpu_pt.image_to_host(img))
    print("wrote", path)

    # Whitted-pipeline golden.
    import numpy as np
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    from tpu_pt.render import init_accum
    from tpu_pt.camera import Camera
    ws = load_gltf(os.path.join(REPO, "assets", "pbr_test.gltf"))
    camera = Camera(eye=np.array([6.0, 4.5, 7.0], np.float32),
                    lookat=np.array([0.0, 0.8, 0.0], np.float32),
                    fov_y=40.0)
    wcam = CameraArrays.from_camera(camera)
    cfg = tpu_pt.RenderConfig(width=128, height=128, spp=8, max_depth=8,
                              background=(0.1, 0.15, 0.25),
                              intersector="bruteforce")
    accum = init_accum(cfg)
    img = None
    for f in range(2):
        accum, img, _ = render_whitted_frame(ws, wcam, cfg, f, accum)
    film.write_png(os.path.join(GOLDEN_DIR, "whitted-pbr.png"),
                   tpu_pt.image_to_host(img))
    print("wrote whitted-pbr.png")

    # glTF-extras primitives + curves through the whitted pipeline
    # (Scene.cpp:1368-1450 SBT binding of the custom-primitive and curve
    # programs, declared from the asset itself).
    ws2 = load_gltf(os.path.join(REPO, "assets", "pbr_prims.gltf"))
    accum = init_accum(cfg)
    img = None
    for f in range(2):
        accum, img, _ = render_whitted_frame(ws2, wcam, cfg, f, accum)
    film.write_png(os.path.join(GOLDEN_DIR, "whitted-prims-curves.png"),
                   tpu_pt.image_to_host(img))
    print("wrote whitted-prims-curves.png")

    # Fractional alpha shadow occlusion golden (__anyhit__occlusion
    # parity, cuda/whitted.cu:113-138): blend/mask quads cast
    # fractional shadows, the untextured blend quad a full one.
    film.write_png(os.path.join(GOLDEN_DIR, "whitted-alpha-shadow.png"),
                   tpu_pt.image_to_host(render_whitted_alpha()))
    print("wrote whitted-alpha-shadow.png")


def render_whitted_alpha():
    """Deterministic alpha_shadow.gltf render (shared with the golden
    test): low camera so the shadow bands are unobstructed."""
    import numpy as np
    import tpu_pt
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    from tpu_pt.render import CameraArrays, init_accum
    from tpu_pt.camera import Camera
    ws = load_gltf(os.path.join(REPO, "assets", "alpha_shadow.gltf"))
    cam = CameraArrays.from_camera(Camera(
        eye=np.array([2.0, 6.0, 13.0], np.float32),
        lookat=np.array([0.0, 0.5, 0.0], np.float32), fov_y=45.0))
    cfg = tpu_pt.RenderConfig(width=160, height=120, spp=8, max_depth=6,
                              background=(0.05, 0.07, 0.12),
                              intersector="bruteforce")
    accum = init_accum(cfg)
    img = None
    for f in range(2):
        accum, img, _ = render_whitted_frame(ws, cam, cfg, f, accum)
    return img


if __name__ == "__main__":
    main()
