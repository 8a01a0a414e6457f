"""Wavefront path-trace core.

This is the wavefront inversion of the reference's OptiX megakernel
(``__raygen__rg`` / ``__miss__ms`` / ``__closesthit__diffuse__ch``,
``pathTracerPrograms.cu:707-1031``): instead of one divergent thread per
pixel, the whole frame is a fixed-shape ray-SoA wavefront in the
component-V3 layout (``tpu_pt.vec3`` — geometry AND color channels as
separate [N] arrays so nothing reduces over a padded size-3 axis); BSDF
dispatch is vectorized selects keyed by the intersector-returned material id
(replacing the SBT-record-per-material mechanism, ``PathTracerMain.cpp:
544-627``); the 19-register payload ABI (``pathTracer.h:38-68``) becomes
the loop-carried pytree; termination is masked lanes + Russian roulette,
with radiance estimates matching the reference's accumulation identities
bounce for bounce.

Two schedulers produce images equal up to fp-add reordering (counter-based
RNG decouples sample values from execution order):

- ``scan``: ``lax.scan`` over bounces inside a scan over samples — the
  direct analog of the reference's nested spp/bounce loops. Lane occupancy
  decays as paths terminate (measured ~18% on the Cornell box).
- ``regen``: a persistent wavefront with a global work queue — lanes claim
  the next (pixel, sample) item the moment their path terminates, keeping
  occupancy near 100%.
- ``pixelq`` (default): same persistent wavefront, but items are whole
  pixels (a lane runs its pixel's spp samples back to back) and finished
  pixels flush into lane-local slot buffers drained by a single
  end-of-frame scatter — removing the per-round scatter-adds of
  ``regen``.

RNG is counter-based (``tpu_pt.rng``), so results are reproducible and
independent of sharding — the documented divergence from the reference's
payload-threaded LCG.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from . import pytree

from . import bsdf, rng
from . import vec3 as v3
from .vec3 import V3
from .config import RenderConfig
from .intersect import get_intersectors
from .scene.arrays import BSDF_METALLIC, BSDF_REFRACTION, SceneArrays

# DoneReason parity (``pathTracer.h:11-17``).
MISS = 0
MAX_DEPTH = 1
RUSSIAN_ROULETTE = 2
LIGHT_HIT = 3
NOT_DONE = 4
NUM_DONE_REASONS = 5
DONE_REASON_NAMES = ("MISS", "MAX_DEPTH", "RUSSIAN_ROULETTE", "LIGHT_HIT",
                     "NOT_DONE")

# Dead wavefront lanes and ineligible shadow rays are "parked": origin far
# outside any scene, so every BVH box test fails and traversal spends
# nothing on them (dense sweeps test them regardless).
PARK_COORD = 3.0e7


@pytree.dataclass
class CameraArrays:
    """Device-side camera: eye + (non-orthonormal) UVW frame
    (``PathTraceParams`` camera fields, ``pathTracer.h:96-99``)."""
    eye: jnp.ndarray  # [3]
    u: jnp.ndarray    # [3]
    v: jnp.ndarray    # [3]
    w: jnp.ndarray    # [3]

    @classmethod
    def from_camera(cls, camera) -> "CameraArrays":
        u, v, w = camera.uvw_frame()
        return cls(eye=jnp.asarray(camera.eye, jnp.float32),
                   u=jnp.asarray(u, jnp.float32),
                   v=jnp.asarray(v, jnp.float32),
                   w=jnp.asarray(w, jnp.float32))


@pytree.dataclass
class RenderStats:
    """Per-frame telemetry (SURVEY.md §5.5): ray counts for Mrays/s and the
    path-termination histogram (the reference's DoneReason debug channel)."""
    rays_traced: jnp.ndarray       # scalar f32: radiance rays actually alive
    shadow_rays: jnp.ndarray       # scalar f32: NEE occlusion rays
    done_histogram: jnp.ndarray    # [5] f32, indexed by DoneReason
    wavefront_iterations: jnp.ndarray  # scalar f32: trace rounds executed


def camera_rays(cam: CameraArrays, pixel_ids: jnp.ndarray, width: int,
                height: int, jx: jnp.ndarray, jy: jnp.ndarray):
    """Primary rays for flat pixel ids (y*width + x), jittered in-pixel.

    Matches ``__raygen__rg`` ray setup (``pathTracerPrograms.cu:730-738``):
    d = 2*(pix + jitter)/extent - 1; dir = normalize(d.x*U + d.y*V + W).
    Row 0 is the image bottom (OptiX/GL convention); PNG writers flip.
    Returns (origin V3, direction V3).
    """
    x = (pixel_ids % width).astype(jnp.float32)
    y = (pixel_ids // width).astype(jnp.float32)
    dx = 2.0 * ((x + jx) / width) - 1.0
    dy = 2.0 * ((y + jy) / height) - 1.0
    u, v, w = cam.u, cam.v, cam.w
    direction = v3.normalize(V3(
        dx * u[0] + dy * v[0] + w[0],
        dx * u[1] + dy * v[1] + w[1],
        dx * u[2] + dy * v[2] + w[2],
    ))
    ones = jnp.ones_like(direction.x)
    origin = V3(cam.eye[0] * ones, cam.eye[1] * ones, cam.eye[2] * ones)
    return origin, direction


def _material_table(scene: SceneArrays) -> jnp.ndarray:
    """Stacked per-material properties [M, 12] for one-hot lookup."""
    return jnp.concatenate([
        scene.mat_diffuse,                                     # 0:3
        scene.mat_emission,                                    # 3:6
        scene.mat_roughness[:, None],                          # 6
        scene.mat_metallic[:, None],                           # 7
        scene.mat_ior[:, None],                                # 8
        scene.mat_bsdf.astype(jnp.float32)[:, None],           # 9
        scene.mat_is_emissive.astype(jnp.float32)[:, None],    # 10
        jnp.zeros((scene.num_materials, 1), jnp.float32),      # 11 pad
    ], axis=1)


def _lookup_materials(scene: SceneArrays, mat_ids: jnp.ndarray):
    """Per-lane material properties via one one-hot matmul over the
    stacked [M, 12] table (``table[ids]`` as a row select)."""
    table = _material_table(scene)
    m = table.shape[0]
    onehot = (mat_ids[:, None] == jnp.arange(m, dtype=mat_ids.dtype)[None, :]
              ).astype(jnp.float32)
    # HIGHEST precision: one-hot x table is then an exact row select
    # (a default-precision f32 matmul may round the values to bf16 or
    # TF32).
    props = jnp.matmul(onehot, table,
                       precision=jax.lax.Precision.HIGHEST)     # [N, 12]
    return dict(diffuse=V3(props[:, 0], props[:, 1], props[:, 2]),
                emission=V3(props[:, 3], props[:, 4], props[:, 5]),
                roughness=props[:, 6], metallic=props[:, 7],
                ior=props[:, 8],
                bsdf_type=props[:, 9].astype(jnp.int32),
                is_emissive=props[:, 10] > 0.5)


def _shade_hit(scene: SceneArrays, cfg: RenderConfig, origin: V3,
               direction: V3, hit, z):
    """Closest-hit shading for the whole wavefront (vectorized
    ``__closesthit__diffuse__ch``, ``pathTracerPrograms.cu:866-983``).

    ``z`` is a (z1, z2, z3) tuple of uniforms. Returns the per-lane BSDF
    transition; callers mask by hit."""
    props = _lookup_materials(scene, hit.mat)
    diffuse = props["diffuse"]
    ior = props["ior"]
    bsdf_type = props["bsdf_type"]
    if cfg.quirks.fixed_metal_roughness:
        roughness = jnp.full(hit.mat.shape, 0.2, jnp.float32)
    else:
        roughness = props["roughness"]

    n0 = hit.normal
    n = v3.faceforward(n0, -direction, n0)
    p = origin + direction * hit.t

    z1, z2, z3 = z

    # --- diffuse: hemisphere sample about N in the reference ONB (cu:907-930)
    dir_diffuse = bsdf.sample_hemisphere_world(
        n, z1, z2, cfg.use_importance_sampling)

    # --- metallic: GGX half-vector reflect + conductor Fresnel (cu:931-952)
    h = bsdf.sample_ggx(z1, z2, roughness, n)
    dir_metal = v3.reflect(direction, h)
    org_metal = p + dir_metal * 1e-4
    cos_t = jnp.maximum(v3.dot(h, -direction), 0.0)
    eta, k = bsdf.metal_eta_k(cos_t.shape)
    f_cond = bsdf.fresnel_conductor(cos_t, eta, k)
    mult_metal = f_cond * diffuse

    # --- refraction: dielectric Fresnel choose reflect/refract (cu:954-981)
    d_norm = v3.normalize(direction)
    cos_i = v3.dot(-d_norm, n0)
    fr = bsdf.fr_dielectric(cos_i, 1.0, ior)
    refr_dir, did_refract = v3.refract(d_norm, n0, ior)
    refl_dir = v3.reflect(d_norm, n0)
    choose_reflect = (z3 < fr) | ~did_refract
    dir_refr = v3.where(choose_reflect, refl_dir, refr_dir)
    org_refr = p + dir_refr * 1e-3

    is_metal = bsdf_type == BSDF_METALLIC
    is_refr = bsdf_type == BSDF_REFRACTION
    new_dir = v3.where(is_refr, dir_refr,
                       v3.where(is_metal, dir_metal, dir_diffuse))
    new_org = v3.where(is_refr, org_refr,
                       v3.where(is_metal, org_metal, p))
    atten_mult = v3.where(is_refr | ~is_metal, diffuse, mult_metal)

    return dict(new_origin=new_org, new_dir=new_dir, atten_mult=atten_mult,
                n=n, p=p, emission=props["emission"],
                is_emissive=props["is_emissive"], bsdf_type=bsdf_type)


def _nee(scene: SceneArrays, cfg: RenderConfig, occluded_fn, shade, hit_mask,
         lz1, lz2):
    """Next-event-estimation direct lighting from the area light
    (``pathTracerPrograms.cu:1003-1026``). Returns (radiance_add V3,
    shadow_ray_mask [N])."""
    light = scene.light
    p = shade["p"]
    n = shade["n"]
    corner = V3.of(light.corner[0], light.corner[1], light.corner[2])
    lv1 = V3.of(light.v1[0], light.v1[1], light.v1[2])
    lv2 = V3.of(light.v2[0], light.v2[1], light.v2[2])
    lnorm = V3.of(light.normal[0], light.normal[1], light.normal[2])
    light_pos = corner + lv1 * lz1 + lv2 * lz2
    to_l = light_pos - p
    l_dist = v3.length(to_l)
    l_dir = v3.normalize(to_l)
    n_dl = v3.dot(n, l_dir)
    ln_dl = -v3.dot(lnorm, l_dir)

    eligible = (hit_mask & (shade["bsdf_type"] != BSDF_REFRACTION)
                & (n_dl > 0.0) & (ln_dl > 0.0))

    # Occlusion rays only matter on eligible lanes; park the rest far
    # outside the scene (a zero direction would pass every BVH box test —
    # tnear = -inf — and generate traversal work; a parked ray fails all
    # of them).
    park = V3(jnp.full(eligible.shape, PARK_COORD),
              jnp.full(eligible.shape, PARK_COORD),
              jnp.full(eligible.shape, PARK_COORD))
    occ_org = v3.where(eligible, p, park)
    away = V3(jnp.full(eligible.shape, 0.5773503),
              jnp.full(eligible.shape, 0.5773503),
              jnp.full(eligible.shape, 0.5773503))
    occ_dir = v3.where(eligible, l_dir, away)
    occ_tmax = jnp.where(eligible, l_dist - 0.01, 0.0)
    occluded = occluded_fn(occ_org, occ_dir, occ_tmax)

    area = v3.length(v3.cross(lv1, lv2))
    weight = n_dl * ln_dl * area / (jnp.pi * jnp.maximum(l_dist, 1e-6) ** 2)
    w = jnp.where(eligible & ~occluded, weight, 0.0)
    emission = V3.of(light.emission[0], light.emission[1], light.emission[2])
    return emission * w, eligible


def _bounce(scene: SceneArrays, cfg: RenderConfig, closest_fn, occluded_fn,
            pixel_ids, sample_idx, frame_idx, origin: V3, direction: V3,
            atten: V3, depth):
    """One trace + shade round for the whole wavefront.

    ``sample_idx`` and ``depth`` may be scalars (scan scheduler) or per-lane
    arrays (regen scheduler); everything broadcasts. Returns the per-lane
    transition: radiance contribution, next ray, termination + DoneReason.
    """
    depth_u = jnp.asarray(depth, jnp.uint32)
    sa = jnp.uint32(rng.STREAM_BOUNCE_A) + 2 * depth_u
    sb = jnp.uint32(rng.STREAM_BOUNCE_B) + 2 * depth_u
    z1, z2, z3, _ = rng.uniform4(pixel_ids, sample_idx, frame_idx, sa)
    lz1, lz2, z_rr, _ = rng.uniform4(pixel_ids, sample_idx, frame_idx, sb)

    hit = closest_fn(origin, direction)
    hit_mask = hit.hit

    shade = _shade_hit(scene, cfg, origin, direction, hit, (z1, z2, z3))

    # Emission channel: only at depth 0 (cu:898-901); miss writes 0.
    emit_mask = hit_mask & (depth == 0) & shade["is_emissive"]
    emitted = shade["emission"] * jnp.where(emit_mask, 1.0, 0.0)

    # Radiance channel: miss -> background (cu:841), light hit -> emission
    # (cu:992-996), else 0; NEE adds direct light.
    bgx, bgy, bgz = cfg.background
    light_hit = hit_mask & shade["is_emissive"]
    miss_f = jnp.where(hit_mask, 0.0, 1.0)
    radiance = V3(miss_f * bgx, miss_f * bgy, miss_f * bgz)
    radiance = v3.where(light_hit, shade["emission"], radiance)
    shadow_mask = jnp.zeros(hit_mask.shape, bool)
    if cfg.use_direct_lighting:
        nee_radiance, shadow_mask = _nee(scene, cfg, occluded_fn, shade,
                                         hit_mask, lz1, lz2)
        radiance = radiance + nee_radiance

    # Attenuation multiplies by the hit BSDF color BEFORE the radiance
    # weight (the reference's CH-then-raygen ordering).
    atten_new = v3.where(hit_mask, atten * shade["atten_mult"], atten)
    contrib = emitted + radiance * atten_new

    # Russian roulette on perceived brightness (cu:763-773).
    p_rr = v3.luminance(atten_new)
    rr_kill = z_rr > p_rr
    at_max = depth >= cfg.max_depth
    done = ~hit_mask | light_hit | rr_kill | at_max

    # DoneReason precedence parity (cu:768-771): MAX_DEPTH beats RR beats
    # MISS/LIGHT_HIT.
    base_reason = jnp.where(~hit_mask, MISS,
                            jnp.where(light_hit, LIGHT_HIT, NOT_DONE))
    reason = jnp.where(at_max, MAX_DEPTH,
                       jnp.where(rr_kill, RUSSIAN_ROULETTE, base_reason))

    # RR compensation applies only to surviving paths (cu:773 safeDivide).
    atten_cont = v3.safe_divide(atten_new, p_rr)
    return dict(contrib=contrib, atten_new=atten_new, atten_cont=atten_cont,
                new_origin=shade["new_origin"], new_dir=shade["new_dir"],
                done=done, reason=reason, shadow_mask=shadow_mask)


def _render_scan(scene, cam, cfg, pixel_start, n, frame_idx, sample_offset,
                 closest_fn, occluded_fn):
    """Reference-shaped scheduler: scan over samples x scan over bounces."""
    pixel_ids = jnp.asarray(pixel_start, jnp.uint32) + jnp.arange(
        n, dtype=jnp.uint32)
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)

    def one_sample(sample_idx):
        jx, jy = rng.uniform2(pixel_ids, sample_idx, frame_idx,
                              rng.STREAM_JITTER)
        origin, direction = camera_rays(cam, pixel_ids, cfg.width,
                                        cfg.height, jx, jy)

        def bounce_body(carry, depth):
            (origin, direction, atten, alive, result, reason,
             n_rays, n_shadow) = carry
            step = _bounce(scene, cfg, closest_fn, occluded_fn, pixel_ids,
                           sample_idx, frame_idx, origin, direction, atten,
                           depth)
            alive_f = jnp.where(alive, 1.0, 0.0)
            result = result + step["contrib"] * alive_f
            reason = jnp.where(alive & step["done"], step["reason"], reason)
            alive_next = alive & ~step["done"]
            atten = v3.where(alive_next, step["atten_cont"],
                             step["atten_new"])
            origin = v3.where(alive_next, step["new_origin"], origin)
            direction = v3.where(alive_next, step["new_dir"], direction)
            n_rays = n_rays + jnp.sum(alive_f)
            n_shadow = n_shadow + jnp.sum(
                jnp.where(alive & step["shadow_mask"], 1.0, 0.0))
            return (origin, direction, atten, alive_next, result, reason,
                    n_rays, n_shadow), None

        init = (origin, direction, V3.ones((n,)), jnp.ones((n,), bool),
                V3.zeros((n,)), jnp.full((n,), NOT_DONE, jnp.int32),
                jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
        depths = jnp.arange(cfg.max_depth + 1, dtype=jnp.uint32)
        (_, _, _, _, result, reason, n_rays, n_shadow), _ = jax.lax.scan(
            bounce_body, init, depths)

        hist = jnp.zeros((NUM_DONE_REASONS,), jnp.float32).at[reason].add(1.0)
        return result, n_rays, n_shadow, hist

    def spp_body(carry, sample_idx):
        acc, n_rays, n_shadow, hist = carry
        r, nr, ns, h = one_sample(sample_idx)
        return (acc + r, n_rays + nr, n_shadow + ns, hist + h), None

    init = (V3.zeros((n,)), jnp.zeros((), jnp.float32),
            jnp.zeros((), jnp.float32),
            jnp.zeros((NUM_DONE_REASONS,), jnp.float32))
    samples = jnp.arange(cfg.spp, dtype=jnp.uint32) + jnp.asarray(
        sample_offset, jnp.uint32)
    (acc, n_rays, n_shadow, hist), _ = jax.lax.scan(spp_body, init, samples)

    iters = jnp.asarray(cfg.spp * (cfg.max_depth + 1), jnp.float32)
    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist, wavefront_iterations=iters)
    return (acc * (1.0 / cfg.spp)).to_array(), stats


def _render_regen(scene, cam, cfg, pixel_start, n, frame_idx, sample_offset,
                  closest_fn, occluded_fn):
    """Persistent-wavefront scheduler with a global work queue.

    The (pixel, sample) grid is a queue of ``n_pixels * spp`` path items;
    every lane holds one item and claims the next unissued item the moment
    its path terminates (ticket = exclusive cumsum over finished lanes).
    Decoupling lanes from pixels is what kills the tail: pixel-local
    regeneration would leave the wavefront bounded by the unluckiest pixel
    (e.g. glass-sphere pixels run to max depth every sample). Occupancy
    stays near 100% until the queue drains; this replaces the reference's
    SER thread reordering (``optixReorder``, ``pathTracerPrograms.cu:
    615-617``) as the occupancy mechanism.

    The wavefront width is capped at ``cfg.lanes`` (per-lane bookkeeping —
    scatter-adds especially — grows with the width); larger frames stream
    their items through the fixed wavefront.

    Radiance sums per pixel contain exactly the same terms as the scan
    scheduler (counter RNG), but same-pixel samples may interleave their
    float adds, so images match to fp-add reordering (~1 ulp), not bitwise.
    """
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)
    offset = jnp.asarray(sample_offset, jnp.uint32)
    pixel_start = jnp.asarray(pixel_start, jnp.uint32)
    total_items = n * cfg.spp
    assert total_items < 2 ** 32, "uint32 work-queue limit"
    total = jnp.uint32(total_items)
    n_lanes = min(cfg.lanes, total_items)

    def item_rays(g):
        """Camera ray for work item g (pixel slot g % n, sample g // n)."""
        j = g % n
        s = g // n + offset
        pix = pixel_start + j
        jx, jy = rng.uniform2(pix, s, frame_idx, rng.STREAM_JITTER)
        o, d = camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)
        return o, d

    g0 = jnp.arange(n_lanes, dtype=jnp.uint32)
    origin0, dir0 = item_rays(g0)

    state0 = dict(
        g=g0,
        origin=origin0, direction=dir0,
        atten=V3.ones((n_lanes,)),
        depth=jnp.zeros((n_lanes,), jnp.uint32),
        active=g0 < total,
        next_g=jnp.uint32(min(n_lanes, total_items)),
        result=V3.zeros((n,)),
        n_rays=jnp.zeros((), jnp.float32),
        n_shadow=jnp.zeros((), jnp.float32),
        hist=jnp.zeros((NUM_DONE_REASONS,), jnp.float32),
        iters=jnp.zeros((), jnp.float32),
    )

    def cond(s):
        return jnp.any(s["active"])

    k_steps = max(1, int(cfg.bounces_per_round))

    def body(s):
        active = s["active"]
        j = s["g"] % n
        sample = s["g"] // n + offset
        pix = pixel_start + j

        # Run up to ``bounces_per_round`` trace steps with the round's
        # contributions accumulated in registers; lanes whose path dies
        # mid-round idle until the round ends. One scatter per round
        # instead of per bounce.
        alive = active
        origin, direction = s["origin"], s["direction"]
        atten, depth = s["atten"], s["depth"]
        pending = V3.zeros((n_lanes,))
        hist = s["hist"]
        n_rays, n_shadow = s["n_rays"], s["n_shadow"]
        for _ in range(k_steps):
            step = _bounce(scene, cfg, closest_fn, occluded_fn, pix, sample,
                           frame_idx, origin, direction, atten, depth)
            alive_f = jnp.where(alive, 1.0, 0.0)
            pending = pending + step["contrib"] * alive_f
            done = step["done"]
            # Histogram via masked sums, not a scatter.
            fin_f = jnp.where(alive & done, 1.0, 0.0)
            hist = hist + jnp.stack(
                [jnp.sum(fin_f * jnp.where(step["reason"] == r, 1.0, 0.0))
                 for r in range(NUM_DONE_REASONS)])
            n_rays = n_rays + jnp.sum(alive_f)
            n_shadow = n_shadow + jnp.sum(
                jnp.where(alive & step["shadow_mask"], 1.0, 0.0))
            cont = alive & ~done
            origin = v3.where(cont, step["new_origin"], origin)
            direction = v3.where(cont, step["new_dir"], direction)
            atten = v3.where(cont, step["atten_cont"], atten)
            depth = jnp.where(cont, depth + 1, depth)
            alive = cont

        # Three component scatter-adds.
        result = V3(s["result"].x.at[j].add(pending.x),
                    s["result"].y.at[j].add(pending.y),
                    s["result"].z.at[j].add(pending.z))

        # Claim the next queue items: finished lane k gets ticket
        # next_g + (number of finished lanes before k).
        finished = active & ~alive
        fin_u = finished.astype(jnp.uint32)
        rank = jnp.cumsum(fin_u) - fin_u
        new_g = s["next_g"] + rank
        has_new = finished & (new_g < total)
        next_g = s["next_g"] + jnp.sum(fin_u)

        o_new, d_new = item_rays(jnp.where(has_new, new_g, 0))
        # Retired lanes park their rays (see PARK_COORD above).
        park = V3.full((n_lanes,), (PARK_COORD,) * 3)
        away = V3.full((n_lanes,), (0.5773503,) * 3)
        origin = v3.where(has_new, o_new, v3.where(alive, origin, park))
        direction = v3.where(has_new, d_new,
                             v3.where(alive, direction, away))
        atten = v3.where(has_new, V3.ones((n_lanes,)), atten)
        depth = jnp.where(has_new, 0, depth)
        g = jnp.where(has_new, new_g, s["g"])
        active_next = alive | has_new

        return dict(
            g=g, origin=origin, direction=direction, atten=atten,
            depth=depth, active=active_next, next_g=next_g, result=result,
            n_rays=n_rays, n_shadow=n_shadow,
            hist=hist, iters=s["iters"] + float(k_steps),
        )

    out = jax.lax.while_loop(cond, body, state0)
    stats = RenderStats(rays_traced=out["n_rays"],
                        shadow_rays=out["n_shadow"],
                        done_histogram=out["hist"],
                        wavefront_iterations=out["iters"])
    return (out["result"] * (1.0 / cfg.spp)).to_array(), stats


def _render_pixelq(scene, cam, cfg, pixel_start, n, frame_idx, sample_offset,
                   closest_fn, occluded_fn, bounce_fn=None):
    """Persistent wavefront with a pixel-granular work queue and lane-local
    flush slots — the scatter-free scheduler.

    ``bounce_fn`` swaps the per-round transition (default: the path
    tracer's ``_bounce``) so other integrators — the whitted pipeline —
    reuse this scheduler. It receives ``(pix, sample, origin, direction,
    atten, depth)`` and returns ``_bounce``'s step dict.

    ``_render_regen`` scatter-adds every lane's radiance every round. Here
    a work item is a run
    of ``cfg.samples_per_item`` consecutive samples of one pixel: a lane
    traces them back to back, accumulating radiance in loop-carried
    registers, and on the item's last sample writes (pixel, rgb) into one
    of its private flush slots — a vectorized select over the [S, L] slot
    buffers, no scatter. The only scatter is one batched slot drain after
    the queue empties, cutting scatter updates per frame from rounds x
    lanes (~37M at 1024^2 x 16spp) to ~items (~2M).

    Occupancy behaves like ``_render_regen`` (lanes claim the next pixel
    the moment theirs completes; tickets via exclusive cumsum) with a
    slightly longer tail: the final wave is bounded by the unluckiest
    still-running pixel rather than the unluckiest sample.

    Slot overflow (a lane finishing more pixels than it has slots) is
    handled correctly, not dropped: the lane retires holding its last
    pixel's radiance in registers, and the drain scatters those alongside
    the slots. With S sized ~2x the mean pixels-per-lane, overflow is a
    rare tail event (the queue self-balances — lanes that drew cheap
    pixels finish more of them), so the retire path costs ~nothing.
    """
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)
    offset = jnp.asarray(sample_offset, jnp.uint32)
    pixel_start = jnp.asarray(pixel_start, jnp.uint32)
    # An item is ``chunk`` consecutive samples of one pixel. Whole-pixel
    # items (chunk=spp) minimize flush traffic but make the frame tail as
    # long as the unluckiest pixel (spp x max_depth rounds of mostly-idle
    # wavefront); chunking caps the tail while keeping flushes rare.
    chunk = max(1, min(cfg.spp, cfg.samples_per_item))
    n_chunks = (cfg.spp + chunk - 1) // chunk
    total_items = n * n_chunks
    total = jnp.uint32(total_items)
    # Cap the wavefront so each lane averages several items: with fewer,
    # the queue stops regenerating and the frame tail is the unluckiest
    # ITEM's full trace count at near-empty occupancy; wider, the slot
    # buffers and the drain sort grow. The 4096 floor keeps tiny renders
    # wide enough to fill the device. Items per lane default per
    # integrator and scene size: the whitted step's per-round cost on
    # small scenes is mostly width-proportional dense passes (texture
    # and attribute selects, shading), which favours a narrower
    # wavefront (TPT_ITEMS_PER_LANE overrides; the defaults are not yet
    # measured on the GPU).
    big_scene = scene is not None and scene.tri_v0.shape[0] > 8192
    ipl_default = ((4 if big_scene else 16) if bounce_fn is not None
                   else 8)
    n_lanes = min(cfg.lanes,
                  max(4096, total_items // int(
                      os.environ.get("TPT_ITEMS_PER_LANE", ipl_default))),
                  total_items)
    spp = jnp.uint32(cfg.spp)
    # Width LADDER: the while_loop's width is static, so once the queue
    # drains, the tail (the unluckiest still-running items) pays
    # full-width cost per round. TPT_LADDER lists width divisors: when
    # the live-lane count falls to the next stage's width, the loop
    # exits, survivors compact into a narrower loop (fresh flush
    # buffers; the finished buffers join the final drain), and tracing
    # continues. Radiance is item-keyed (counter RNG), so images are
    # bitwise identical at any ladder. Each stage retraces the bounce
    # step at its width — more compile, same numerics. On by default for
    # the whitted step, whose short paths leave a long drained-queue
    # tail; off for the path tracer.
    ladder_default = "1,8" if bounce_fn is not None else "1"
    divisors = [int(x) for x in os.environ.get(
        "TPT_LADDER", ladder_default).split(",") if x.strip()]
    widths = []
    for dv in sorted(set(max(1, d) for d in divisors)):
        w = max(4096, n_lanes // dv)
        w -= w % 256 if w > 4096 else 0
        if (not widths or w < widths[-1]) and w <= n_lanes:
            widths.append(w)
    if not widths or widths[0] != n_lanes:
        widths.insert(0, n_lanes)

    def stage_slots(w, prev_w=None):
        # Mean flushes/lane is items/lanes; the queue self-balances
        # (lanes that draw cheap items finish more of them), so a small
        # margin suffices — and overflow is correct anyway (the lane
        # retires holding its DONE item in uf/pending; items it would
        # have claimed go to lanes that still have slots, so no sample
        # is lost at ANY margin, and the counter RNG keys radiance by
        # (pixel, sample), so the image is bitwise identical too).
        # Drain updates scale with n_slots, so margin is pure overhead
        # bought as insurance for item-cost-skewed scenes. Ladder stages
        # after the first can only flush the previous stage's <= prev_w
        # in-flight items (a lane goes idle only once the queue is
        # empty, so stage boundaries happen with every item claimed), so
        # their buffers size to prev_w / w + slack instead of
        # total_items / w.
        margin = int(os.environ.get("TPT_SLOT_MARGIN", 2))
        if prev_w is None:
            per_lane = (total_items + w - 1) // w
        else:
            per_lane = prev_w // w + 2
        return max(4, min(64, per_lane + margin))

    # Empty slots carry filler ids past the real items, so the drain's
    # sort-by-id pushes them behind every real item row (see the drain
    # below). Unique fillers keep the sort key total-ordered; each
    # stage's buffers get a disjoint filler range.
    def stage_buffers(w, filler_base, prev_w=None):
        s = stage_slots(w, prev_w)
        empty_ids = (filler_base
                     + jnp.arange(s * w, dtype=jnp.int32)).reshape(s, w)
        uf_empty = filler_base + s * w + jnp.arange(w, dtype=jnp.int32)
        return empty_ids, uf_empty, filler_base + s * w + w

    def item_pixel(g):
        return g % n, (g // n) * chunk                # (pixel slot, sample0)

    def item_rays(j, sample):
        pix = pixel_start + j
        jx, jy = rng.uniform2(pix, sample + offset, frame_idx,
                              rng.STREAM_JITTER)
        return camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)

    g0 = jnp.arange(n_lanes, dtype=jnp.uint32)
    j0, sample0 = item_pixel(g0)
    origin0, dir0 = item_rays(j0, sample0)

    empty_ids0, uf_empty0, filler_next = stage_buffers(n_lanes, total_items)
    state0 = dict(
        g=g0, sample=sample0,
        origin=origin0, direction=dir0,
        atten=V3.ones((n_lanes,)),
        depth=jnp.zeros((n_lanes,), jnp.uint32),
        pending=V3.zeros((n_lanes,)),
        cnt=jnp.zeros((n_lanes,), jnp.uint32),
        slot_g=empty_ids0,
        slot_rgb=V3.zeros((stage_slots(n_lanes), n_lanes)),
        uf_g=uf_empty0,
        active=g0 < total,
        next_g=jnp.uint32(n_lanes),
        n_rays=jnp.zeros((), jnp.float32),
        n_shadow=jnp.zeros((), jnp.float32),
        hist=jnp.zeros((NUM_DONE_REASONS,), jnp.float32),
        iters=jnp.zeros((), jnp.float32),
    )

    def body(s):
        active = s["active"]
        n_lanes = s["g"].shape[0]              # stage width (static)
        n_slots = s["slot_g"].shape[0]
        slot_iota = jnp.arange(n_slots, dtype=jnp.uint32)[:, None]
        g, sample = s["g"], s["sample"]
        j, chunk0 = item_pixel(g)
        pix = pixel_start + j
        if bounce_fn is not None:
            step = bounce_fn(pix, sample + offset, s["origin"],
                             s["direction"], s["atten"], s["depth"])
        else:
            step = _bounce(scene, cfg, closest_fn, occluded_fn, pix,
                           sample + offset, frame_idx, s["origin"],
                           s["direction"], s["atten"], s["depth"])
        active_f = jnp.where(active, 1.0, 0.0)
        pending = s["pending"] + step["contrib"] * active_f

        done = step["done"]
        path_done = active & done
        fin_f = jnp.where(path_done, 1.0, 0.0)
        hist = s["hist"] + jnp.stack(
            [jnp.sum(fin_f * jnp.where(step["reason"] == r, 1.0, 0.0))
             for r in range(NUM_DONE_REASONS)])

        item_end = jnp.minimum(chunk0 + chunk, spp)
        more_samples = path_done & (sample + 1 < item_end)
        pixel_done = path_done & (sample + 1 >= item_end)

        # Flush finished pixels into this lane's next free slot: a masked
        # select over the [S, L] buffers, not a scatter. The slot records
        # the finished ITEM id (globally unique — each item is claimed
        # and flushed exactly once), which the drain exploits.
        flushing = pixel_done & (s["cnt"] < n_slots)
        at_slot = flushing[None, :] & (slot_iota == s["cnt"][None, :])
        slot_g = jnp.where(at_slot, g.astype(jnp.int32)[None, :],
                           s["slot_g"])
        slot_rgb = V3(jnp.where(at_slot, pending.x[None, :], s["slot_rgb"].x),
                      jnp.where(at_slot, pending.y[None, :], s["slot_rgb"].y),
                      jnp.where(at_slot, pending.z[None, :], s["slot_rgb"].z))
        cnt = s["cnt"] + flushing.astype(jnp.uint32)
        # Out of slots: retire the lane, radiance stays in ``pending`` and
        # ``uf_g`` records the item for the final drain.
        overflow = pixel_done & ~flushing
        uf_g = jnp.where(overflow, g.astype(jnp.int32), s["uf_g"])

        # Claim the next queue pixels (flushed lanes only).
        fin_u = flushing.astype(jnp.uint32)
        rank = jnp.cumsum(fin_u) - fin_u
        new_g = s["next_g"] + rank
        has_new = flushing & (new_g < total)
        next_g = s["next_g"] + jnp.sum(fin_u)

        cont = active & ~done
        respawn = more_samples | has_new
        g_next = jnp.where(has_new, new_g, g)
        new_j, new_s0 = item_pixel(g_next)
        j_next = jnp.where(has_new, new_j, j)
        sample_next = jnp.where(more_samples, sample + 1,
                                jnp.where(has_new, new_s0, sample))
        o_new, d_new = item_rays(jnp.where(respawn, j_next, 0),
                                 jnp.where(respawn, sample_next, 0))
        # Retired lanes park their rays (see PARK_COORD): without this
        # they would re-trace their stale last ray every remaining round.
        park = V3.full((n_lanes,), (PARK_COORD,) * 3)
        away = V3.full((n_lanes,), (0.5773503,) * 3)
        origin = v3.where(cont, step["new_origin"],
                          v3.where(respawn, o_new, park))
        direction = v3.where(cont, step["new_dir"],
                             v3.where(respawn, d_new, away))
        atten = v3.where(cont, step["atten_cont"],
                         v3.where(respawn, V3.ones((n_lanes,)), s["atten"]))
        depth = jnp.where(cont, s["depth"] + 1, 0)
        pending = v3.where(pixel_done & ~overflow, V3.zeros((n_lanes,)),
                           pending)
        active_next = cont | respawn

        out_s = dict(
            g=g_next, sample=sample_next, origin=origin, direction=direction,
            atten=atten, depth=depth, pending=pending, cnt=cnt,
            slot_g=slot_g, slot_rgb=slot_rgb, uf_g=uf_g,
            active=active_next, next_g=next_g,
            n_rays=s["n_rays"] + jnp.sum(active_f),
            # Integrators with several lights return a per-lane shadow-ray
            # COUNT; the path tracer's single area light is a mask.
            n_shadow=s["n_shadow"] + (
                jnp.sum(active_f * step["shadow_count"])
                if "shadow_count" in step else
                jnp.sum(jnp.where(active & step["shadow_mask"], 1.0, 0.0))),
            hist=hist, iters=s["iters"] + 1.0,
        )
        return out_s

    # Per-lane state that survives a ladder compaction (flush buffers do
    # not: each stage drains its own).
    carry_keys = ("g", "sample", "origin", "direction", "atten", "depth",
                  "pending", "active")
    drain_ids = []
    drain_rgb = []
    out = state0
    for si, w in enumerate(widths):
        last = si == len(widths) - 1
        if si > 0:
            # Compact live lanes to the front (stable, so determinism is
            # preserved though not required: radiance is item-keyed) and
            # start the narrower stage with fresh flush buffers. The old
            # buffers — plus overflow-retired radiance still in lane
            # registers — join the final drain; live lanes' uf rows are
            # filler ids, so their in-flight ``pending`` is NOT drained
            # here (it travels with the lane).
            drain_ids += [out["slot_g"].reshape(-1), out["uf_g"]]
            drain_rgb += [(out["slot_rgb"].x.reshape(-1), out["pending"].x),
                          (out["slot_rgb"].y.reshape(-1), out["pending"].y),
                          (out["slot_rgb"].z.reshape(-1), out["pending"].z)]
            perm = jnp.argsort(~out["active"], stable=True)[:w]
            state = {k: jax.tree.map(lambda a: a[perm], out[k])
                     for k in carry_keys}
            empty_ids, uf_empty, filler_next = stage_buffers(
                w, filler_next, prev_w=widths[si - 1])
            state.update(
                cnt=jnp.zeros((w,), jnp.uint32),
                slot_g=empty_ids,
                slot_rgb=V3.zeros((stage_slots(w, widths[si - 1]), w)),
                uf_g=uf_empty,
                next_g=out["next_g"], n_rays=out["n_rays"],
                n_shadow=out["n_shadow"], hist=out["hist"],
                iters=out["iters"])
        else:
            state = out
        if last:
            def cond(s):
                return jnp.any(s["active"])
        else:
            next_w = widths[si + 1]

            def cond(s, _nw=next_w):
                alive = jnp.sum(s["active"].astype(jnp.int32))
                return jnp.any(s["active"]) & (alive > _nw)
        out = jax.lax.while_loop(cond, body, state)

    # Drain: every item id in [0, total_items) appears EXACTLY ONCE
    # across the flush slots and the retired lanes' registers (each item
    # is claimed once and either flushed or retired), and the empty
    # slots' filler ids all sit past total_items — so one ascending
    # multi-operand sort by id puts item k's radiance at row k, and the
    # chunk fold is a [n_chunks, n] reshape-sum (item g covers pixel
    # g % n). No scatter at all: one multi-operand sort does the work
    # of the per-item scatter-add it replaces.
    drain_rgb += [(out["slot_rgb"].x.reshape(-1), out["pending"].x),
                  (out["slot_rgb"].y.reshape(-1), out["pending"].y),
                  (out["slot_rgb"].z.reshape(-1), out["pending"].z)]
    idx = jnp.concatenate(drain_ids + [out["slot_g"].reshape(-1),
                                       out["uf_g"]])
    srt = jax.lax.sort(
        (idx,) + tuple(
            jnp.concatenate([a for pair in drain_rgb[c::3] for a in pair])
            for c in range(3)),
        num_keys=1)
    result = V3(*(srt[c][:total_items].reshape(n_chunks, n).sum(axis=0)
                  for c in (1, 2, 3)))

    stats = RenderStats(rays_traced=out["n_rays"],
                        shadow_rays=out["n_shadow"],
                        done_histogram=out["hist"],
                        wavefront_iterations=out["iters"])
    return (result * (1.0 / cfg.spp)).to_array(), stats


def render_wavefront(scene: SceneArrays, cam: CameraArrays,
                     cfg: RenderConfig, pixel_start, n_pixels: int,
                     frame_idx,
                     sample_offset=0) -> tuple[jnp.ndarray, RenderStats]:
    """Estimate mean radiance over ``cfg.spp`` samples for ``n_pixels``
    consecutive pixels starting at flat index ``pixel_start``.

    Returns (radiance [n_pixels, 3] float32, RenderStats). This is the
    jittable heart of the framework — everything above it (accumulation,
    tonemap, sharding, viewer) composes around it. The contiguous-range
    pixel interface (rather than an id array) keeps the hot loop free of
    per-lane gathers; ``sample_offset`` shifts the counter-RNG sample axis
    so spp-sharded devices draw disjoint sample sets.
    """
    closest_fn, occluded_fn = get_intersectors(scene, cfg,
                                               want_uv=False)
    impl = {"scan": _render_scan, "regen": _render_regen,
            "pixelq": _render_pixelq}[cfg.scheduler]
    return impl(scene, cam, cfg, pixel_start, n_pixels, frame_idx,
                sample_offset, closest_fn, occluded_fn)


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("accum",))
def render_frame(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                 frame_idx, accum):
    """Progressive frame step: trace, average, fold into the accumulator.

    Equivalent of one ``optixLaunch`` + device-side accumulation
    (``LaunchCurrentFrame``, ``PathTracerMain.cpp:184-210`` +
    ``pathTracerPrograms.cu:803-815``). ``accum`` is [H, W, 3] float32 and is
    donated. Returns (new_accum, srgb_u8 [H, W, 3], stats).
    """
    from . import film

    n = cfg.width * cfg.height
    radiance, stats = render_wavefront(scene, cam, cfg, 0, n, frame_idx)
    frame_img = radiance.reshape(cfg.height, cfg.width, 3)
    new_accum = film.accumulate(accum, frame_img, frame_idx)
    frame_u8 = film.make_color(new_accum)
    return new_accum, frame_u8, stats


def init_accum(cfg: RenderConfig) -> jnp.ndarray:
    """Fresh accumulation buffer (the reference's free+realloc reset,
    ``PathTracerMain.cpp:166-182``)."""
    return jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)


def image_to_host(frame_u8: jnp.ndarray) -> np.ndarray:
    """Device frame -> numpy, flipped to top-down row order for image files."""
    return np.asarray(frame_u8)[::-1]
