#!/usr/bin/env python3
"""End-to-end check of the renderer on one NVIDIA GPU.

Runs the system's main paths through their public entry points, compares
each with the repository's plain reference, prints one line per check
and stops at the first failure with a nonzero exit. The last line of a
passing run is ``{"ok": true, "device": {...}}``.

    python chip_smoke.py          # phases (a)-(f) on one card
    python chip_smoke.py --multi  # phase (g) only, on four cards

Phases:
  (a) device: the default backend is a GPU.
  (b) the dense Pallas kernel against ``moller`` on ~1M wavefront rays.
  (c) golden images (tools/make_goldens.py, rendered on the CPU).
  (d) the Cornell headline (1024^2, 16 spp, 8 bounces, IS+NEE), the
      reference's own launch shape, and a (1, 1) mesh against plain.
  (e) the 100k-triangle mesh through the LBVH, against ``moller``.
  (f) the whitted pipeline (pbr_test.glb, the flattened forest) and the
      exactness of its one-hot selects and texture unit.
  (g) --multi: sharded renders on (4, 1) and (2, 2) meshes against one
      card.

Without a GPU it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# Phase (b)/(e) agreement bounds: the kernel's plane + edge-function
# test and moller's Möller-Trumbore formula differ in rounding, so rays
# grazing a shared edge may pick either neighbour.
HIT_AGREE = 0.9999
ID_AGREE = 0.999
# Where the ids agree, the two hit points lie within T_TOL scene units of
# each other along the surface normal (|dt * cos|): each formula's t
# error is a plane-distance rounding (~1e-4 at Cornell's 550-unit
# coordinates) divided by the cosine of the incidence angle, so along
# grazing rays the raw |dt| exceeds it (reported as max_dt).
T_TOL = 1e-3
# Phase (e): the same Möller-Trumbore formula in both programs, but the
# 100k mesh's ~2-unit triangles seen from ~800 units away make its cross
# products cancel to ~1e-5 relative, and the two programs contract
# different products into FMAs (measured 1.5e-3 on the CPU).
T_TOL_LARGE = 4e-3
# Barycentrics of the same hit: their error is the in-plane share of the
# hit point's error, so along grazing rays it grows like dt does; bounded
# as |du * cos|, |dv * cos| (raw max_duv reported beside it).
UV_TOL = 1e-3
OCC_AGREE = 0.9999
GOLDEN_RMSE = 0.01    # tests/test_goldens.py
# Sharded renders trace the same (pixel, sample) set as one card. Without
# an spp axis each path runs the same arithmetic, so the accumulator
# agrees to REL_TILE of the image's peak per pixel (phases d, f, g; the
# bitwise verdict is printed beside it). The spp mesh's psum reorders
# the sample mean, hence the looser RMSE_SPP.
REL_TILE = 1e-5
RMSE_SPP = 1e-3


class PhaseFailed(Exception):
    pass


def report(phase, what, ok, wall=None, compile_s=None, **values):
    parts = [f"[{phase}] {'PASS' if ok else 'FAIL'} {what}"]
    parts += [f"{k}={v}" for k, v in values.items()]
    if wall is not None:
        parts.append(f"wall_s={wall:.3f}")
    if compile_s is not None:
        parts.append(f"compile_s={compile_s:.3f}")
    print(" ".join(parts), flush=True)
    if not ok:
        raise PhaseFailed(f"{phase}: {what}")


def timed(fn, *args):
    """(result, seconds) with the device work finished."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def compiled(fn, *args, static=()):
    """AOT-compile ``fn`` for ``args``: (callable, compile seconds)."""
    import jax
    t0 = time.perf_counter()
    exe = jax.jit(fn, static_argnums=static).lower(*args).compile()
    return exe, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# (b) dense kernel against the reference


def wavefront_rays(scene, width, height):
    """Camera rays plus their first bounce: 2 * width * height rays."""
    import jax.numpy as jnp
    import tpu_pt
    from tpu_pt import rng, render
    from tpu_pt.intersect import moller
    from tpu_pt.render import CameraArrays, camera_rays
    from tpu_pt.vec3 import V3
    import tpu_pt.vec3 as v3

    cam = CameraArrays.from_camera(
        tpu_pt.cornell_default_camera(aspect=width / height))
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    jx, jy = rng.uniform2(pix, 0, 0, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, width, height, jx, jy)
    hit = moller.intersect_closest(scene, o, d)
    z = rng.uniform4(pix, 0, 0, rng.STREAM_BOUNCE_A)[:3]
    cfg = tpu_pt.RenderConfig(use_importance_sampling=True)
    sh = render._shade_hit(scene, cfg, o, d, hit, z)
    o2 = v3.where(hit.hit, sh["new_origin"], o)
    d2 = v3.where(hit.hit, sh["new_dir"], d)
    cat = lambda a, b: V3(*(jnp.concatenate([x, y])  # noqa: E731
                            for x, y in zip(a, b)))
    return cat(o, o2), cat(d, d2)


def shadow_rays(scene, o, d, h):
    """NEE segments from the hits to light samples, traced where the
    renderer traces them (``render._nee``); elsewhere tmax is 0."""
    import jax.numpy as jnp
    from tpu_pt import rng
    from tpu_pt.scene.arrays import BSDF_REFRACTION
    from tpu_pt.vec3 import V3
    import tpu_pt.vec3 as v3
    n = h.t.shape[0]
    ids = jnp.arange(n, dtype=jnp.uint32)
    lz1, lz2 = rng.uniform2(ids, 0, 0, rng.STREAM_BOUNCE_B)
    L = scene.light
    p = o + d * jnp.where(h.hit, h.t, 0.0)
    lp = V3(*(L.corner[k] + L.v1[k] * lz1 + L.v2[k] * lz2 for k in range(3)))
    to_l = lp - p
    dist = v3.length(to_l)
    ldir = v3.normalize(to_l)
    nrm = v3.faceforward(h.normal, -d, h.normal)
    lnorm = V3(*(L.normal[k] for k in range(3)))
    eligible = (h.hit & (scene.mat_bsdf[h.mat] != BSDF_REFRACTION)
                & (v3.dot(nrm, ldir) > 0.0) & (-v3.dot(lnorm, ldir) > 0.0))
    return p, ldir, jnp.where(eligible, dist - 0.01, 0.0)


def compare_hits(a, b, d, uv=False):
    """Agreement of two Hit batches along directions ``d``: dict of the
    phase (b) metrics, with the barycentrics' when ``uv``."""
    import numpy as np
    import tpu_pt.vec3 as v3
    ha, hb = np.asarray(a.hit), np.asarray(b.hit)
    ia, ib = np.asarray(a.tri), np.asarray(b.tri)
    same = ha & hb & (ia == ib)
    dt = np.abs(np.asarray(a.t) - np.asarray(b.t))[same]
    cos = np.abs(np.asarray(v3.dot(b.normal, d)))[same]
    both = ha | hb
    m = dict(hit_agree=float((ha == hb).mean()),
             id_agree=float(((ia == ib) | ~both).mean()),
             max_dt_normal=float((dt * cos).max(initial=0.0)),
             max_dt=float(dt.max(initial=0.0)),
             share_dt_over_tol=float((dt > T_TOL).mean()) if dt.size
             else 0.0)
    if uv:
        duv = np.maximum(np.abs(np.asarray(a.u) - np.asarray(b.u)),
                         np.abs(np.asarray(a.v) - np.asarray(b.v)))[same]
        m.update(max_duv_normal=float((duv * cos).max(initial=0.0)),
                 max_duv=float(duv.max(initial=0.0)))
    return m


def hits_ok(m):
    return (m["hit_agree"] >= HIT_AGREE and m["id_agree"] >= ID_AGREE
            and m["max_dt_normal"] <= T_TOL
            and m.get("max_duv_normal", 0.0) <= UV_TOL)


def phase_kernel():
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.intersect import moller, pallas_dense

    for name in ("cornell_box_mixed", "cornell_box_monkey"):
        scene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                               name + ".obj"))
        o, d = wavefront_rays(scene, 1024, 512)
        n = o.x.shape[0]
        kc, c_k = compiled(lambda s, o, d: pallas_dense.intersect_closest(
            s, o, d, want_uv=True), scene, o, d)
        rc, c_r = compiled(lambda s, o, d: moller.intersect_closest(
            s, o, d), scene, o, d)
        hk, w_k = timed(kc, scene, o, d)
        hk, w_k = timed(kc, scene, o, d)
        hr, w_r = timed(rc, scene, o, d)
        hr, w_r = timed(rc, scene, o, d)
        m = compare_hits(hk, hr, d, uv=True)
        report("b", f"closest kernel vs moller {name} ({scene.num_tris} "
               f"tris)", hits_ok(m), wall=w_k, compile_s=c_k, rays=n,
               tol=f"hit>={HIT_AGREE},id>={ID_AGREE},dt*cos<={T_TOL},"
                   f"duv*cos<={UV_TOL}",
               moller_wall_s=f"{w_r:.3f}", moller_compile_s=f"{c_r:.3f}",
               **m)

        so, sd, st = shadow_rays(scene, o, d, hr)
        ko, c_ko = compiled(lambda s, o, d, t: pallas_dense.
                            intersect_occluded(s, o, d, t), scene, so, sd, st)
        ro, c_ro = compiled(lambda s, o, d, t: moller.intersect_occluded(
            s, o, d, t), scene, so, sd, st)
        occ_k, w_ko = timed(ko, scene, so, sd, st)
        occ_k, w_ko = timed(ko, scene, so, sd, st)
        occ_r, w_ro = timed(ro, scene, so, sd, st)
        occ_r, w_ro = timed(ro, scene, so, sd, st)
        agree = float((np.asarray(occ_k) == np.asarray(occ_r)).mean())
        report("b", f"occluded kernel vs moller {name}", agree >= OCC_AGREE,
               wall=w_ko, compile_s=c_ko, rays=n, occ_agree=agree,
               occluded_share=float(np.asarray(occ_r).mean()),
               tol=f"occ>={OCC_AGREE}", moller_wall_s=f"{w_ro:.3f}",
               moller_compile_s=f"{c_ro:.3f}")
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (c) golden images


def _golden_err(img, name):
    import numpy as np
    import tpu_pt
    from tpu_pt import film
    golden = film.read_png(os.path.join(REPO, "tests", "goldens",
                                        name + ".png")).astype(np.float32)
    ours = tpu_pt.image_to_host(img).astype(np.float32)
    return film.rmse(ours / 255.0, golden / 255.0)


def phase_goldens():
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt.camera import Camera
    from tpu_pt.render import CameraArrays, init_accum
    from tpu_pt.scene.gltf import load_gltf
    from tpu_pt.whitted import render_whitted_frame
    sys.path.insert(0, os.path.join(REPO, "tools"))
    import make_goldens as mg

    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    mixed = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                           "cornell_box_mixed.obj"))
    jobs = [(name, lambda o=o: mg.render_mode(mixed, cam, o))
            for name, o in mg.MODES]
    lit = dict(use_importance_sampling=True, use_direct_lighting=True)
    for name, js in (("primitives", "cornell_prims.json"),
                     ("curves", "cornell_curves.json")):
        scene = tpu_pt.load_scene(os.path.join(REPO, "assets", js))
        jobs.append((name, lambda s=scene: mg.render_mode(s, cam, lit)))

    wcam = CameraArrays.from_camera(Camera(
        eye=np.array([6.0, 4.5, 7.0], np.float32),
        lookat=np.array([0.0, 0.8, 0.0], np.float32), fov_y=40.0))
    wcfg = tpu_pt.RenderConfig(width=128, height=128, spp=8, max_depth=8,
                               background=(0.1, 0.15, 0.25),
                               intersector="bruteforce")

    def whitted(asset, intersector="bruteforce"):
        ws = load_gltf(os.path.join(REPO, "assets", asset))
        cfg = wcfg.with_(intersector=intersector)
        accum = init_accum(cfg)
        for f in range(2):
            accum, img, _ = render_whitted_frame(ws, wcam, cfg, f, accum)
        return img

    wjobs = [("whitted-pbr", "pbr_test.gltf"),
             ("whitted-prims-curves", "pbr_prims.gltf")]
    jobs += [(name, lambda a=asset: whitted(a)) for name, asset in wjobs]
    jobs.append(("whitted-alpha-shadow", mg.render_whitted_alpha))
    for name, job in jobs:
        img, wall = timed(job)
        err = _golden_err(img, name)
        report("c", f"golden {name} (pinned bruteforce)",
               err < GOLDEN_RMSE, wall=wall, rmse=f"{err:.5f}",
               tol=GOLDEN_RMSE)
    # The same path-tracer and whitted modes through the default
    # intersector (the Pallas kernel on a GPU; whitted with its u/v).
    auto = [(name, lambda o=o: mg.render_mode(
        mixed, cam, {**o, "intersector": "auto"})) for name, o in mg.MODES]
    auto += [(name, lambda a=asset: whitted(a, "auto"))
             for name, asset in wjobs]
    for name, job in auto:
        img, wall = timed(job)
        err = _golden_err(img, name)
        report("c", f"golden {name} (auto intersector)",
               err < GOLDEN_RMSE, wall=wall, rmse=f"{err:.5f}",
               tol=GOLDEN_RMSE)
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (d) headline, reference launch shape, (1, 1) mesh


def render_timed(scene, cam, cfg, frames, render_fn=None):
    """Compile, warm, then time ``frames`` frames of a progressive render.

    Returns (executable, frame 0's accumulator on the host, last image,
    per-frame stats, compile s, timed s)."""
    import jax
    import numpy as np
    from tpu_pt.render import init_accum, render_frame
    render_fn = render_fn or render_frame
    accum = init_accum(cfg)
    exe, c_s = compiled(lambda s, c, f, a: render_fn(s, c, cfg, f, a),
                        scene, cam, 0, accum)
    accum, img, st = jax.block_until_ready(exe(scene, cam, 0, accum))
    first = np.asarray(accum)
    stats = []
    t0 = time.perf_counter()
    for f in range(1, frames + 1):
        accum, img, st = exe(scene, cam, f, accum)
        stats.append(st)
    jax.block_until_ready((accum, img))
    return exe, first, img, stats, c_s, time.perf_counter() - t0


def compare_accum(acc, ref):
    """Agreement of two float accumulators [H, W, 3]: bitwise verdict,
    largest per-pixel difference relative to the reference's peak, RMSE,
    and the shares of pixels that differ at all and by more than
    REL_TILE of the peak."""
    import numpy as np
    acc, ref = np.asarray(acc), np.asarray(ref)
    scale = max(float(np.max(np.abs(ref))), 1e-30)
    px = np.max(np.abs(acc - ref), axis=-1)
    return dict(bitwise=bool(np.array_equal(acc, ref)),
                max_rel=float(px.max() / scale),
                rmse=float(np.sqrt(np.mean((acc - ref) ** 2))),
                share_px_differ=float((px > 0).mean()),
                share_px_over_rel=float((px > REL_TILE * scale).mean()))


def throughput(stats, seconds):
    import numpy as np
    rays = sum(float(s.rays_traced) + float(s.shadow_rays) for s in stats)
    not_done = sum(float(np.asarray(s.done_histogram)[4]) for s in stats)
    return dict(ms_per_frame=f"{seconds / len(stats) * 1e3:.3f}",
                mrays_per_s=f"{rays / seconds / 1e6:.3f}",
                rays_per_frame=int(rays / len(stats)),
                not_done=int(not_done))


def headline_scene():
    import tpu_pt
    from tpu_pt.render import CameraArrays
    scene = tpu_pt.load_scene(os.path.join(REPO, "assets",
                                           "cornell_box_mixed.obj"))
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    return scene, cam


HEADLINE = dict(width=1024, height=1024, spp=16, max_depth=8,
                use_direct_lighting=True, use_importance_sampling=True,
                scheduler="pixelq")


def phase_headline(card):
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt import dist
    from tpu_pt.intersect import _resolve
    from tpu_pt.render import init_accum, render_frame

    scene, cam = headline_scene()
    cfg = tpu_pt.RenderConfig(**HEADLINE)
    backend = _resolve(scene, cfg)
    exe, first, img, stats, c_s, secs = render_timed(scene, cam, cfg, 3)
    m = throughput(stats, secs)
    finite = bool(np.isfinite(np.asarray(img, np.float32)).all())
    report("d", f"headline Cornell mixed 1024^2 16spp 8 bounces IS+NEE "
           f"pixelq intersector={backend}",
           m["not_done"] == 0 and finite, wall=secs, compile_s=c_s,
           frames=3, card=f'"{card}"', **m)
    again = np.asarray(exe(scene, cam, 0, init_accum(cfg))[0])
    report("d", "headline frame 0 rendered twice, accumulator bitwise",
           bool(np.array_equal(first, again)), **compare_accum(again, first))

    ref = tpu_pt.RenderConfig()          # PathTracerMain.cpp:42-59
    *_, stats, c_s, secs = render_timed(scene, cam, ref, 1)
    m = throughput(stats, secs)
    report("d", "reference launch shape 512^2 128spp depth 4",
           m["not_done"] == 0, wall=secs, compile_s=c_s, **m)

    small = tpu_pt.RenderConfig(width=256, height=256, spp=4, max_depth=6,
                                use_direct_lighting=True,
                                use_importance_sampling=True)
    t0 = time.perf_counter()
    acc_p, _, _ = render_frame(scene, cam, small, 0, init_accum(small))
    mesh = dist.device_mesh(1, 1, devices=jax.devices()[:1])
    step = dist.make_sharded_renderer(scene, small, mesh)
    acc_s, _, _ = step(cam, 0, dist.init_accum_sharded(small, mesh))
    jax.block_until_ready((acc_p, acc_s))
    m = compare_accum(acc_s, acc_p)
    report("d", "path tracer (1,1) mesh vs plain, accumulator",
           m["max_rel"] <= REL_TILE, wall=time.perf_counter() - t0,
           tol=f"max_rel<={REL_TILE}", **m)
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (e) large scene


def phase_large():
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt import rng
    from tpu_pt.intersect import _resolve, lbvh, moller
    from tpu_pt.render import CameraArrays, camera_rays

    path = os.path.join(REPO, "assets", "big_mesh.obj")
    t0 = time.perf_counter()
    scene = tpu_pt.load_scene(path)
    load_s = time.perf_counter() - t0
    cam = CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    cfg = tpu_pt.RenderConfig(width=512, height=512, spp=4, max_depth=8,
                              use_direct_lighting=True,
                              use_importance_sampling=True)
    backend = _resolve(scene, cfg)
    *_, stats, c_s, secs = render_timed(scene, cam, cfg, 2)
    m = throughput(stats, secs)
    report("e", f"100k mesh ({scene.num_tris} tris) 512^2 4spp 8 bounces "
           f"intersector={backend}", backend == "bvh" and m["not_done"] == 0,
           wall=secs, compile_s=c_s, load_s=f"{load_s:.3f}", **m)

    import jax.numpy as jnp
    pix = jnp.arange(256 * 256, dtype=jnp.uint32)
    jx, jy = rng.uniform2(pix, 0, 0, rng.STREAM_JITTER)
    o, d = camera_rays(cam, pix, 256, 256, jx, jy)
    hb, w_b = timed(jax.jit(lambda s, o, d: lbvh.intersect_closest(s, o, d)),
                    scene, o, d)
    hr, w_r = timed(jax.jit(lambda s, o, d: moller.intersect_closest(
        s, o, d)), scene, o, d)
    mm = compare_hits(hb, hr, d)
    report("e", "LBVH vs moller closest, 65536 camera rays",
           hits_ok(mm) and mm["max_dt"] <= T_TOL_LARGE, wall=w_b,
           moller_wall_s=f"{w_r:.3f}",
           tol=f"hit>={HIT_AGREE},id>={ID_AGREE},dt*cos<={T_TOL},"
               f"dt<={T_TOL_LARGE}", **mm)
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (f) whitted pipeline


def _whitted_cam(ws, aspect=1.0):
    import numpy as np
    from tpu_pt.camera import Camera
    from tpu_pt.render import CameraArrays
    if ws.camera:
        eye, lookat, up, fov = ws.camera
        return CameraArrays.from_camera(Camera(
            eye=np.asarray(eye, np.float32),
            lookat=np.asarray(lookat, np.float32),
            up=np.asarray(up, np.float32), fov_y=fov, aspect=aspect))
    lo, hi = ws.world_bounds()
    c = 0.5 * (lo + hi)
    ext = float(np.linalg.norm(hi - lo))
    return CameraArrays.from_camera(Camera(
        eye=(c + np.array([0.7, 0.5, 0.9]) * ext).astype(np.float32),
        lookat=c.astype(np.float32), fov_y=35.0, aspect=aspect))


def phase_whitted():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import tpu_pt
    from tpu_pt import dist, render, whitted
    from tpu_pt.intersect import _resolve
    from tpu_pt.render import init_accum
    from tpu_pt.scene.gltf import load_gltf

    pbr = load_gltf(os.path.join(REPO, "assets", "pbr_test.glb"))
    for name, ws, cfg in (
            ("pbr_test.glb 512^2 8spp", pbr,
             tpu_pt.RenderConfig(width=512, height=512, spp=8, max_depth=8,
                                 background=(0.1, 0.15, 0.25))),
            ("forest.gltf (flattened) 512^2 2spp",
             load_gltf(os.path.join(REPO, "assets", "forest.gltf")),
             tpu_pt.RenderConfig(width=512, height=512, spp=2, max_depth=4,
                                 background=(0.5, 0.7, 0.9)))):
        cam = _whitted_cam(ws)
        backend = _resolve(ws.geom, cfg)
        _, _, img, stats, c_s, secs = render_timed(
            ws, cam, cfg, 2, render_fn=whitted.render_whitted_frame)
        m = throughput(stats, secs)
        m.pop("not_done")
        arr = np.asarray(img)
        ok = arr.shape == (cfg.height, cfg.width, 3) and arr.std() > 1.0
        report("f", f"whitted {name} ({ws.geom.num_tris} tris) "
               f"intersector={backend}", ok, wall=secs, compile_s=c_s, **m)

    # One-hot selects: exact row selects on this card.
    key = jax.random.PRNGKey(0)
    scene, _ = headline_scene()
    ids = jax.random.randint(key, (1 << 20,), 0, scene.num_materials)
    got = render._lookup_materials(scene, ids)
    tbl = render._material_table(scene)[ids]
    want = [tbl[:, 0], tbl[:, 3], tbl[:, 6], tbl[:, 7], tbl[:, 8]]
    have = [got["diffuse"].x, got["emission"].x, got["roughness"],
            got["metallic"], got["ior"]]
    same = all(bool(jnp.array_equal(a, b)) for a, b in zip(have, want))
    report("f", "render._lookup_materials == table[ids], bitwise", same,
           lanes=1 << 20)
    for rows in (pbr.vtx_attr.shape[0], 20000):
        t = jax.random.normal(key, (rows, 19), jnp.float32)
        i = jax.random.randint(key, (1 << 16,), 0, rows)
        same = bool(jnp.array_equal(whitted._select_rows(t, i), t[i]))
        report("f", f"whitted._select_rows == table[ids], bitwise, "
               f"{rows} rows", same, lanes=1 << 16)
    wid = jax.random.randint(key, (1 << 16,), 0, pbr.base_color.shape[0])
    props = whitted._lookup_wmat(pbr, wid)
    same = bool(jnp.array_equal(props["base"], pbr.base_color[wid]))
    report("f", "whitted._lookup_wmat == table[ids], bitwise", same)
    u, v = jax.random.uniform(key, (2, 1 << 16), minval=-1.5, maxval=2.5)
    texels = whitted._sample_all_textures(pbr, u, v)
    err = 0.0
    for k in range(len(pbr.textures)):
        tid = jnp.full(u.shape, k, jnp.int32)
        m_rgb, m_a = whitted._tex_lookup(texels, tid, srgb=False)
        g_rgb, g_a = whitted._sample_textures(pbr, tid, u, v, srgb=False)
        err = max(err, float(jnp.max(jnp.abs(m_rgb.to_array()
                                             - g_rgb.to_array()))),
                  float(jnp.max(jnp.abs(m_a - g_a))))
    report("f", "texture unit vs 4-tap gather (fp association)",
           err <= 3e-5, max_err=err, tol=3e-5,
           textures=len(pbr.textures))

    # The one-hot select path against the gather path, whole frames.
    cfg = tpu_pt.RenderConfig(width=256, height=256, spp=2, max_depth=6,
                              background=(0.1, 0.15, 0.25))
    cam = _whitted_cam(pbr)
    from tpu_pt import film
    rads, imgs = [], []
    for mode in ("1", "0"):
        os.environ["TPT_WSELECT"] = mode
        rad = np.asarray(jax.jit(
            lambda ws, c: whitted.render_whitted_wavefront(
                ws, c, cfg, 0, 256 * 256, 0)[0])(pbr, cam))
        rads.append(rad)
        imgs.append(np.asarray(film.make_color(rad.reshape(256, 256, 3))))
        jax.clear_caches()
    os.environ.pop("TPT_WSELECT")
    report("f", "whitted frame: one-hot select vs gather, sRGB image "
           "bitwise", bool(np.array_equal(imgs[0], imgs[1])),
           radiance_max_abs_diff=float(np.max(np.abs(rads[0] - rads[1]))))
    acc_p, _, _ = whitted.render_whitted_frame(pbr, cam, cfg, 0,
                                               init_accum(cfg))
    mesh = dist.device_mesh(1, 1, devices=jax.devices()[:1])
    step = dist.make_sharded_renderer(pbr, cfg, mesh)
    acc_s, _, _ = step(cam, 0, dist.init_accum_sharded(cfg, mesh))
    m = compare_accum(acc_s, acc_p)
    report("f", "whitted (1,1) mesh vs plain, accumulator",
           m["max_rel"] <= REL_TILE, tol=f"max_rel<={REL_TILE}", **m)
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (g) four cards


def phase_multi():
    import jax
    import numpy as np
    import tpu_pt
    from tpu_pt import dist
    from tpu_pt.render import init_accum, render_frame, render_wavefront

    devs = jax.devices()
    report("g", "four devices", len(devs) == 4, count=len(devs))
    scene, cam = headline_scene()
    cfg = tpu_pt.RenderConfig(**HEADLINE)
    t0 = time.perf_counter()
    plain, _, _ = jax.block_until_ready(
        render_frame(scene, cam, cfg, 0, init_accum(cfg)))
    plain = np.asarray(plain)
    plain_s = time.perf_counter() - t0
    # Tile 1 of the (4, 1) mesh rendered on one card by a program of the
    # tile's own shapes: tells a sharding effect from a shape effect.
    rows = cfg.height // 4
    tile1 = np.asarray(jax.jit(
        lambda s, c: render_wavefront(s, c, cfg, rows * cfg.width,
                                      rows * cfg.width, 0)[0])(scene, cam))
    tile1 = tile1.reshape(rows, cfg.width, 3)
    for n_tile, n_spp in ((4, 1), (2, 2)):
        mesh = dist.device_mesh(n_tile, n_spp, devices=devs)
        step = dist.make_sharded_renderer(scene, cfg, mesh)
        t0 = time.perf_counter()
        acc, img, st = jax.block_until_ready(
            step(cam, 0, dist.init_accum_sharded(cfg, mesh)))
        first = time.perf_counter() - t0
        acc_np = np.asarray(acc)
        acc2, _, st2 = step(cam, 1, acc)
        t0 = time.perf_counter()
        acc2, _, st2 = jax.block_until_ready(step(cam, 2, acc2))
        steady = time.perf_counter() - t0
        m = compare_accum(acc_np, plain)
        rays = float(st2.rays_traced) + float(st2.shadow_rays)
        if n_spp == 1:
            ok, tol = m["max_rel"] <= REL_TILE, f"max_rel<={REL_TILE}"
            m["tile1_vs_same_shape_one_card_bitwise"] = bool(
                np.array_equal(acc_np[rows:2 * rows], tile1))
        else:
            ok, tol = m["rmse"] <= RMSE_SPP, f"rmse<={RMSE_SPP}"
        report("g", f"headline on ({n_tile},{n_spp}) mesh vs one card",
               ok, wall=steady, compile_s=first, tol=tol,
               ms_per_frame=f"{steady * 1e3:.3f}",
               mrays_per_s=f"{rays / steady / 1e6:.3f}",
               one_card_first_frame_s=f"{plain_s:.3f}", **m)


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card phase (g)")
    args = ap.parse_args(argv)

    import jax
    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: no GPU (JAX backend is {backend!r})",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from tpu_pt.profiling import card_line
    except ImportError as e:
        print(f"chip_smoke: the tpu_pt package is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    report("a", "device", True, platform=dev.platform,
           kind=f'"{dev.device_kind}"', count=len(jax.devices()))
    card = card_line()
    print(card, flush=True)
    t_start = time.perf_counter()
    try:
        if args.multi:
            phase_multi()
        else:
            # The asset generator is numpy-only and runs with JAX held to
            # the CPU, so this process stays the card's only user.
            subprocess.run([sys.executable,
                            os.path.join(REPO, "tools", "make_assets.py"),
                            "--big"], check=True, stdout=subprocess.DEVNULL,
                           env={**os.environ, "JAX_PLATFORMS": "cpu"})
            phase_kernel()
            phase_goldens()
            phase_headline(card)
            phase_large()
            phase_whitted()
    except PhaseFailed as e:
        print(f"chip_smoke: failed at {e}", file=sys.stderr)
        return 1
    print(f"total_s={time.perf_counter() - t_start:.1f}", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
