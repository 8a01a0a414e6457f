#!/usr/bin/env python3
"""Convergence report: RMSE vs accumulated samples for each feature mode.

Quantifies the reference README's qualitative A/B story (importance
sampling on/off, direct lighting on/off — ``README.md:24-47`` golden
PNGs) as measured convergence curves: every mode's progressive render is
compared against ITS OWN high-spp converged reference (modes differ in
estimator bias — uniform-hemisphere mode lacks the cosine/pdf weight by
reference-faithful design — so cross-mode RMSE would conflate bias with
variance).

Asserted at the end: at equal sample count IS+NEE converges clearly
faster than either NEE-less mode (measured ~1.7x lower RMSE at 256
samples, 256^2 mixed Cornell). Cosine-IS alone measures ≈ uniform in
whole-image sRGB RMSE at these sample counts — its variance advantage
concentrates where the cosine factor varies (grazing geometry), and the
metallic/refractive BSDFs bypass hemisphere sampling entirely — so no
IS-vs-uniform ordering is asserted, just reported.

Run: python tools/convergence.py   (CONV_* env knobs shrink it)
Knobs: CONV_SIZE (256), CONV_REF_FRAMES (64), CONV_FRAMES (16),
CONV_SPP (16). Prints one JSON line per mode + a summary line.
"""

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.render import CameraArrays, render_frame, init_accum

    backend = jax.default_backend()
    scene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                           "cornell_box_mixed.obj"))
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())

    size = int(os.environ.get("CONV_SIZE", 256))
    spp = int(os.environ.get("CONV_SPP", 16))
    ref_frames = int(os.environ.get("CONV_REF_FRAMES", 64))
    frames = int(os.environ.get("CONV_FRAMES", 16))

    modes = [
        ("IS+NEE", True, True),
        ("IS", True, False),
        ("neither", False, False),
    ]

    from tpu_pt import film

    def rmse(a, b):
        # Tonemapped-sRGB space (the displayed image, and the space of
        # the golden-image tests / the <1% accuracy target): linear-HDR
        # RMSE is dominated by heavy-tailed firefly outliers that no
        # practical spp removes (RR from bounce 0 is reference-faithful).
        qa = np.asarray(film.make_color(a), np.float32) / 255.0
        qb = np.asarray(film.make_color(b), np.float32) / 255.0
        return float(np.sqrt(np.mean((qa - qb) ** 2)))

    final = {}
    for name, imp, dl in modes:
        cfg = tpu_pt.RenderConfig(width=size, height=size, spp=spp,
                                  max_depth=8, use_direct_lighting=dl,
                                  use_importance_sampling=imp)
        # Converged reference for this mode: same estimator, many more
        # frames (disjoint RNG — frame index keys the counter RNG, and
        # reference frames start beyond the test range).
        ref_accum = init_accum(cfg)
        for f in range(frames, frames + ref_frames):
            ref_accum, _, _ = render_frame(scene, cam, cfg, f, ref_accum)
        ref = np.asarray(jax.block_until_ready(ref_accum))

        accum = init_accum(cfg)
        curve = []
        for f in range(frames):
            accum, _, _ = render_frame(scene, cam, cfg, f, accum)
            if (f + 1) in (1, 2, 4, 8, frames):
                curve.append(((f + 1) * spp,
                              round(rmse(accum, ref), 5)))
        final[name] = curve[-1][1]
        print(json.dumps({
            "mode": name,
            "rmse_vs_spp": curve,
            "ref_spp": ref_frames * spp,
            "size": size,
        }))

    # NEE is the decisive variance reduction on this scene (the
    # reference demonstrates it with side-by-side golden PNGs).
    ordered = (final["IS+NEE"] < 0.8 * final["IS"]
               and final["IS+NEE"] < 0.8 * final["neither"])
    print(json.dumps({"summary": "converged RMSE by mode", **final,
                      "nee_speedup_holds": bool(ordered)}))
    if not ordered:
        sys.exit(1)


if __name__ == "__main__":
    main()
