"""Whitted-style direct-lighting renderer (the reference's second pipeline).

Parity target: the SDK pipeline compiled into ``sutil_7_sdk`` —
``__raygen__pinhole`` / ``__closesthit__radiance`` (``cuda/whitted.cu:
44-289``) plus the legacy recursive shaders (``cuda/shading.cu``): PBR
metallic-roughness direct lighting with GGX specular (Schlick Fresnel,
Smith joint visibility — formulas from ``whitted_cuda.h:48-70``), point +
ambient lights with shadow rays, smooth (interpolated) normals, base-color
textures, alpha-mask/blend, emissive factors, and whitted-style recursive
reflection/refraction for Phong-metal and Glass materials up to
``MAX_TRACE_DEPTH`` = 8 (``whitted.h:42``).

Wavefront form: recursion becomes a per-lane depth carry driven by the
path tracer's pixelq work-queue scheduler (``render._render_pixelq``);
branching continuations (alpha blend, glass reflect/refract) are resolved
per lane — blend/refraction continue the straight/refracted path,
Fresnel-weighted reflections continue for reflective materials — so each
lane follows one whitted branch per bounce with the branch weights folded
into the attenuation.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import vec3 as v3
from .vec3 import V3
from .config import RenderConfig
from .intersect import get_intersectors
from .render import CameraArrays, RenderStats, camera_rays, PARK_COORD
from .scene.gltf import (WhittedScene, KIND_GLASS, KIND_PBR, KIND_PHONG,
                         KIND_CHECKER, ALPHA_BLEND, ALPHA_MASK)
from . import rng

MAX_TRACE_DEPTH = 8  # whitted.h:42


def _make_occlusion(ws: WhittedScene, cfg: RenderConfig):
    """Shadow-ray transmission function ``(o, d, tmax) -> [N] f32``.

    The reference's occlusion pipeline (``whitted_cuda.h:127-159`` +
    ``__anyhit__occlusion``, ``whitted.cu:113-138``) starts a pending
    attenuation at 1.0, multiplies it by ``1 - tex_alpha`` at every
    textured non-opaque hit (MASK hits below cutoff pass untouched),
    and commits only if the ray escapes — an opaque hit leaves it
    uncommitted, i.e. 0. Order along the ray doesn't matter for that
    product, so the wavefront shape is: ONE boolean sweep over the opaque
    subset (`alpha_occ.occ_geom`), times a short closest-hit march
    over the (tiny) alpha-triangle subset accumulating per-hit
    factors. Scenes without textured alpha materials take the plain
    boolean sweep — bitwise identical to the pre-split renderer
    (the 0/1 attenuation multiplies ``n_dot_l`` exactly).
    """
    ao = ws.alpha_occ
    if ao is None:
        _, occluded_fn = get_intersectors(ws.geom, cfg)
        return lambda o, d, tmax: jnp.where(occluded_fn(o, d, tmax),
                                            0.0, 1.0)
    _, occ_opaque = get_intersectors(ao.occ_geom, cfg)
    closest_alpha, _ = get_intersectors(ao.geom, cfg, want_uv=True)

    def occ_att(o, d, tmax):
        trans = jnp.where(occ_opaque(o, d, tmax), 0.0, 1.0)
        t_base = jnp.zeros_like(tmax)
        for _ in range(ao.max_hits):
            oo = o + d * t_base
            h = closest_alpha(oo, d)
            seg = h.hit & (t_base + h.t < tmax)
            # Hit UV: barycentric over the subset's per-vertex UVs,
            # then the material's UV affine — the exact transform the
            # radiance path applies before texture fetches.
            rows = _select_rows(ao.uv, h.tri)
            w0 = 1.0 - h.u - h.v
            uu = rows[:, 0] * w0 + rows[:, 2] * h.u + rows[:, 4] * h.v
            vv = rows[:, 1] * w0 + rows[:, 3] * h.u + rows[:, 5] * h.v
            props = _lookup_wmat(ws, h.mat)
            uvx = props["tex_uvx"]
            uu, vv = (uvx[:, 0] * uu + uvx[:, 1] * vv + uvx[:, 2],
                      uvx[:, 3] * uu + uvx[:, 4] * vv + uvx[:, 5])
            # The anyhit samples ONLY the base-color texture's alpha
            # channel — no factor alpha, no sRGB (whitted.cu:117-119).
            _, a = _sample_textures(ws, props["tex_id"], uu, vv,
                                    srgb=False)
            mask_pass = ((props["alpha_mode"] == ALPHA_MASK)
                         & (a < props["alpha_cutoff"]))
            f = jnp.where(mask_pass, 1.0, 1.0 - a)
            trans = trans * jnp.where(seg, f, 1.0)
            # Advance past the hit; the intersector's tmin excludes an
            # epsilon ball so the same triangle is never re-hit.
            t_base = jnp.where(seg, t_base + h.t, t_base)
        return trans

    return occ_att


def _wmat_table(ws: WhittedScene) -> jnp.ndarray:
    """Stacked whitted material table [M, 40] for one-hot lookup."""
    m = ws.base_color.shape[0]
    f = lambda a: jnp.asarray(a, jnp.float32)          # noqa: E731
    return jnp.concatenate([
        f(ws.base_color),                              # 0:4
        f(ws.metallic)[:, None],                       # 4
        f(ws.roughness)[:, None],                      # 5
        f(ws.emissive),                                # 6:9
        f(ws.kind)[:, None],                           # 9
        f(ws.alpha_mode)[:, None],                     # 10
        f(ws.alpha_cutoff)[:, None],                   # 11
        f(ws.ior)[:, None],                            # 12
        f(ws.tex_id)[:, None],                         # 13
        f(ws.ntex_id)[:, None],                        # 14
        f(ws.ntex_scale)[:, None],                     # 15
        f(ws.mrtex_id)[:, None],                       # 16
        f(ws.etex_id)[:, None],                        # 17
        f(ws.tex_uvx),                                 # 18:24
        f(ws.phong_kr),                                # 24:27
        f(ws.checker2),                                # 27:39
        jnp.zeros((m, 1), jnp.float32),                # 39 pad
    ], axis=1)


def _lookup_wmat(ws: WhittedScene, mat_ids: jnp.ndarray) -> dict:
    """All per-material properties in ONE one-hot matmul.

    The reference dispatches materials via SBT records; here a one-hot
    [N, M] x [M, 40] HIGHEST-precision matmul is an exact row select of
    the stacked table — the same technique as
    ``render._lookup_materials``."""
    table = _wmat_table(ws)
    m = table.shape[0]
    onehot = (mat_ids[:, None] == jnp.arange(m, dtype=mat_ids.dtype)[None, :]
              ).astype(jnp.float32)
    p = jnp.matmul(onehot, table, precision=jax.lax.Precision.HIGHEST)
    return dict(
        base=p[:, 0:4],
        metallic=p[:, 4], roughness=p[:, 5],
        emissive=p[:, 6:9],
        kind=p[:, 9].astype(jnp.int32),
        alpha_mode=p[:, 10].astype(jnp.int32),
        alpha_cutoff=p[:, 11], ior=p[:, 12],
        tex_id=p[:, 13].astype(jnp.int32),
        ntex_id=p[:, 14].astype(jnp.int32),
        ntex_scale=p[:, 15],
        mrtex_id=p[:, 16].astype(jnp.int32),
        etex_id=p[:, 17].astype(jnp.int32),
        tex_uvx=p[:, 18:24],
        phong_kr=p[:, 24:27],
        checker2=p[:, 27:39],
    )


def _split3(tbl: jnp.ndarray):
    """Dekker-style 3-part bf16 split of an f32 table: 8+8+8 significand
    bits reconstruct all 24, so one-hot x part matmuls recombine to the
    exact f32 rows. ``optimization_barrier`` pins each f32->bf16->f32
    round-trip against ``--xla_allow_excess_precision`` eliding it."""
    parts, rem = [], tbl
    for _ in range(3):
        p = jax.lax.optimization_barrier(rem.astype(jnp.bfloat16))
        rem = rem - p.astype(jnp.float32)
        parts.append(p)
    return parts


_DIRECT_SELECT_MAX = 4096   # single-level one-hot width bound
_LO_BLOCK = 64              # two-level low-half width (hi one-hot vs
                            # [N, LO*W] slab traffic balance)


def _select_rows(tbl: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
    """Exact one-hot row select ``tbl[ids]`` as matmuls.

    Computes ``table[ids]`` with bf16-split matmuls (bf16 operands, f32
    accumulation), exact to the gather for every value
    down to bf16's exponent floor (each product is 0/1 times a bf16
    part; each row sum has one nonzero term; residual parts below
    ~1.2e-38 flush, bounding the absolute error by one f32 subnormal
    ulp — geometry attributes never live there).
    Small tables run one [N, T] one-hot; larger ones split ids
    as (hi, lo) over a [H, LO, W] reshape — hi via matmul, lo via a
    masked reduce."""
    t, w = tbl.shape
    n = ids.shape[0]
    if t <= _DIRECT_SELECT_MAX:
        # ONE bf16 pass over the three Dekker parts CONCATENATED
        # column-wise: the [N, T] one-hot operand is read once instead
        # of three times.
        oh = (ids[:, None] == jnp.arange(t, dtype=ids.dtype)[None, :]
              ).astype(jnp.bfloat16)
        parts = jnp.concatenate(_split3(tbl), axis=1)          # [T, 3w]
        sel = jnp.matmul(oh, parts,
                         preferred_element_type=jnp.float32)   # [N, 3w]
        return sel[:, 0:w] + sel[:, w:2 * w] + sel[:, 2 * w:3 * w]
    lo_b = _LO_BLOCK
    h = (t + lo_b - 1) // lo_b
    if h * lo_b != t:
        tbl = jnp.pad(tbl, ((0, h * lo_b - t), (0, 0)))
    hi = ids.astype(jnp.int32) // lo_b
    lo = ids.astype(jnp.int32) % lo_b
    oh_hi = (hi[:, None] == jnp.arange(h, dtype=jnp.int32)[None, :]
             ).astype(jnp.bfloat16)
    slab = jnp.zeros((n, lo_b * w), jnp.float32)
    for p in _split3(tbl.reshape(h, lo_b * w)):
        slab = slab + jnp.matmul(oh_hi, p,
                                 preferred_element_type=jnp.float32)
    slab = slab.reshape(n, lo_b, w)
    oh_lo = (lo[:, None] == jnp.arange(lo_b, dtype=jnp.int32)[None, :]
             ).astype(jnp.float32)
    return jnp.sum(slab * oh_lo[:, :, None], axis=1)


def _tri_rows(ws: WhittedScene, hit):
    """Per-triangle attribute row for the hit tris: vtx_attr[:, 0:16] ++
    tri_tangent[:, 16:19], ONE one-hot select for both consumers.
    ``TPT_WSELECT=0`` ablates back to the gather (chip_smoke.py compares
    the two on the GPU)."""
    tbl = jnp.concatenate([ws.vtx_attr, ws.tri_tangent], axis=1)
    if os.environ.get("TPT_WSELECT", "1") == "0":
        return tbl[jnp.clip(hit.tri, 0, tbl.shape[0] - 1)]
    return _select_rows(tbl, hit.tri)


def _interp_attrs_rows(rows, hit):
    """Smooth normal + UV from barycentrics (LocalGeometry.h parity)."""
    w0 = 1.0 - hit.u - hit.v
    n = V3(rows[:, 0] * w0 + rows[:, 3] * hit.u + rows[:, 6] * hit.v,
           rows[:, 1] * w0 + rows[:, 4] * hit.u + rows[:, 7] * hit.v,
           rows[:, 2] * w0 + rows[:, 5] * hit.u + rows[:, 8] * hit.v)
    n = v3.normalize(n)
    uu = rows[:, 9] * w0 + rows[:, 11] * hit.u + rows[:, 13] * hit.v
    vv = rows[:, 10] * w0 + rows[:, 12] * hit.u + rows[:, 14] * hit.v
    return n, uu, vv


def _interp_attrs(ws: WhittedScene, hit):
    """Gather-shaped variant kept for the A/B test (the hot path goes
    through ``_tri_rows`` + ``_interp_attrs_rows``)."""
    return _interp_attrs_rows(ws.vtx_attr[hit.tri], hit)


_WRAP_REPEAT, _WRAP_CLAMP, _WRAP_MIRROR = 10497, 33071, 33648


def _wrap_coord(u, mode: int):
    """glTF sampler wrap to [0, 1] (GL semantics; Scene::addSampler parity)."""
    if mode == _WRAP_CLAMP:
        return jnp.clip(u, 0.0, 1.0)
    if mode == _WRAP_MIRROR:
        return 1.0 - jnp.abs(u % 2.0 - 1.0)
    return u % 1.0                                   # REPEAT (default)


def _bilinear_gather(tex, uu, vv, wrap_s: int, wrap_t: int):
    """4-tap edge-clamped bilinear ``tex[y, x]`` gather -> [N, 4].

    The single source of the gather-shaped sampling math, shared by the
    ablation baseline (``_sample_textures``) and the oversized-texture
    fallback of the matmul pass — wrap/clamp semantics can only be fixed
    in one place."""
    h, w = tex.shape[0], tex.shape[1]
    x = _wrap_coord(uu, wrap_s) * (w - 1)
    y = _wrap_coord(vv, wrap_t) * (h - 1)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, w - 1)
    y1 = jnp.minimum(y0 + 1, h - 1)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x1] * fx * (1 - fy)
            + tex[y1, x0] * (1 - fx) * fy + tex[y1, x1] * fx * fy)


def _sample_textures(ws: WhittedScene, tex_id, uu, vv, srgb=True):
    """Bilinear texture fetch honoring per-texture sampler wrap modes.

    Textures have distinct static shapes, so each is sampled for its own
    lanes and combined by mask (texture counts are small). ``srgb=False``
    skips the sRGB->linear decode (normal maps are stored linearly).

    This is the gather-shaped baseline (16 ``tex[y, x]`` gathers per
    bounce on a 3-texture PBR scene). The hot path samples every
    texture ONCE per bounce as a matmul instead
    (``_sample_all_textures``); ``TPT_WTEX=0`` ablates back to this."""
    out = V3.ones(tex_id.shape)
    alpha = jnp.ones(tex_id.shape, jnp.float32)
    for k, tex in enumerate(ws.textures):
        wrap_s, wrap_t = (ws.tex_wrap[k] if k < len(ws.tex_wrap)
                          else (_WRAP_REPEAT, _WRAP_REPEAT))
        c = _bilinear_gather(tex, uu, vv, wrap_s, wrap_t)
        # sRGB -> linear on RGB (whitted::linearize, gamma 2.2).
        rgb_lin = (jnp.power(jnp.maximum(c[:, :3], 1e-9), 2.2) if srgb
                   else c[:, :3])
        mask = tex_id == k
        out = v3.where(mask, V3(rgb_lin[:, 0], rgb_lin[:, 1], rgb_lin[:, 2]),
                       out)
        alpha = jnp.where(mask, c[:, 3], alpha)
    return out, alpha


# Texel cap for the matmul bilinear pass: the matmul streams the WHOLE
# texture per bounce, so very large images (past ~512
# rows x 512 cols) fall back to the 4-tap gather for that texture only
# (still sampled once per bounce, shared by all four consumers).
_WTEX_MAX_TEXELS = 1 << 18


def _bilinear_rows(x, n: int):
    """[N] continuous texel coords in [0, n-1] -> [N, n] two-tap weight
    rows: row i carries (1-frac) at floor(x) and frac at min(floor+1,
    n-1) — an UNNORMALIZED one-hot whose matmul against the texture IS
    the bilinear interpolation along that axis (weights at a shared
    index add, so the edge-clamp case degrades to nearest exactly like
    the gather math)."""
    x0 = jnp.floor(x).astype(jnp.int32)
    x1 = jnp.minimum(x0 + 1, n - 1)
    fx = x - x0
    i = jnp.arange(n, dtype=jnp.int32)[None, :]
    return (jnp.where(i == x0[:, None], 1.0 - fx[:, None], 0.0)
            + jnp.where(i == x1[:, None], fx[:, None], 0.0))


def _sample_all_textures(ws: WhittedScene, uu, vv):
    """RAW (undecoded) RGBA of EVERY texture at (uu, vv): list of [N, 4].

    The texture unit as dense matrix work: instead of 4 ``tex[y, x]``
    gathers per texture per consumer, bilinear filtering becomes
    matmuls. Per (shape,
    wrap) group of textures, build the [N, H] row-weight and [N, W]
    column-weight matrices once (``_bilinear_rows``), then

        texels = sum_w (A @ T)[n, w, :] * B[n, w]

    — ONE [N, 3H] x [3H, W*4*K] bf16 matmul (f32 accumulation)
    (integer-valued 255*texel table tiled against the Dekker-split
    weight rows; every product exact, sum f32) interpolates along y
    for ALL K textures of the group at once, and a [N, K, W, 4]
    weighted reduce finishes x.
    Since the up-to-four texture consumers of a bounce (base color,
    normal map, metallic-roughness, emissive) all sample at the SAME
    UV, this runs ONCE per bounce and each consumer is a masked select
    (``_tex_lookup``). Products are f32-exact, so results match the
    gather path to fp association (goldens hold at their 1%% RMSE
    budget; ``TPT_WTEX=0`` renders the gather baseline for A/B)."""
    n = uu.shape[0]
    groups: dict = {}
    for k, tex in enumerate(ws.textures):
        h, w = tex.shape[0], tex.shape[1]
        wrap = (ws.tex_wrap[k] if k < len(ws.tex_wrap)
                else (_WRAP_REPEAT, _WRAP_REPEAT))
        groups.setdefault((h, w, wrap), []).append(k)
    texels = [None] * len(ws.textures)
    for (h, w, (wrap_s, wrap_t)), ks in groups.items():
        if h * w > _WTEX_MAX_TEXELS:
            # Oversized: per-texture 4-tap gather, still once per bounce.
            for k in ks:
                texels[k] = _bilinear_gather(ws.textures[k], uu, vv,
                                             wrap_s, wrap_t)
            continue
        a = _bilinear_rows(_wrap_coord(vv, wrap_t) * (h - 1), h)
        b = _bilinear_rows(_wrap_coord(uu, wrap_s) * (w - 1), w)
        k_g = len(ks)
        # Column layout [k, w, c] (texture-major).
        tbl = jnp.concatenate(
            [ws.textures[k].reshape(h, w * 4) for k in ks], axis=1)
        # Texels are u8-origin (every loader decodes images as n/255,
        # scene/gltf._decode_image), so 255 * texel is an INTEGER
        # 0..255 — exactly representable in bf16. One bf16 table part
        # x a 3-part Dekker split of the f32 weight rows gives exact
        # products in three bf16 passes; the 1/255 repair costs one f32
        # rounding.
        t255 = jax.lax.optimization_barrier(
            (tbl * 255.0).astype(jnp.bfloat16))
        # ONE matmul instead of three: the part sum IS a contraction —
        # concatenate the three weight parts column-wise ([N, 3H]) and
        # tile the (scene-constant, hoisted) table vertically.
        a3 = jnp.concatenate(_split3(a), axis=1)
        t3 = jnp.concatenate([t255, t255, t255], axis=0)
        s = jnp.matmul(a3, t3, preferred_element_type=jnp.float32)
        c = jnp.sum(s.reshape(n, k_g, w, 4) * b[:, None, :, None],
                    axis=2) * jnp.float32(1.0 / 255.0)    # [N, K, 4]
        for j, k in enumerate(ks):
            texels[k] = c[:, j]
    return texels


def _tex_lookup(texels, tex_id, srgb=True):
    """Masked per-lane select over the per-bounce texel table; sRGB
    decode once on the survivor (``whitted::linearize``, gamma 2.2)."""
    out = jnp.ones((tex_id.shape[0], 4), jnp.float32)
    for k, c in enumerate(texels):
        out = jnp.where((tex_id == k)[:, None], c, out)
    rgb = out[:, :3]
    if srgb:
        rgb = jnp.power(jnp.maximum(rgb, 1e-9), 2.2)
    return V3(rgb[:, 0], rgb[:, 1], rgb[:, 2]), out[:, 3]


def _schlick(spec: V3, v_dot_h):
    """whitted_cuda.h:48-51."""
    p = jnp.power(jnp.maximum(1.0 - v_dot_h, 0.0), 5.0)
    return spec + (V3.ones(v_dot_h.shape) - spec) * p


def _vis(n_dot_l, n_dot_v, alpha):
    """Smith joint visibility, whitted_cuda.h:53-61."""
    a2 = alpha * alpha
    ggx0 = n_dot_l * jnp.sqrt(n_dot_v * n_dot_v * (1.0 - a2) + a2)
    ggx1 = n_dot_v * jnp.sqrt(n_dot_l * n_dot_l * (1.0 - a2) + a2)
    return 2.0 * n_dot_l * n_dot_v / jnp.maximum(ggx0 + ggx1, 1e-9)


def _ggx_d(n_dot_h, alpha):
    """GGX NDF, whitted_cuda.h:64-70."""
    a2 = alpha * alpha
    x = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (jnp.pi * x * x)


def _make_whitted_step(ws: WhittedScene, cfg: RenderConfig, closest_fn,
                       occ_att_fn, frame_idx, depth_cap: int):
    """Per-round whitted transition, shaped like ``render._bounce``'s
    step dict so the shared pixelq scheduler can drive it.

    The returned ``step(pix, sample_idx, origin, direction, atten,
    depth)`` assumes every lane is live — the calling scheduler masks
    dead lanes. ``shadow_count`` is a per-lane ray COUNT (whitted traces
    one shadow ray per light, ``whitted.cu:246-263``). ``occ_att_fn``
    returns the fractional shadow transmission (``_make_occlusion``)."""
    n_lights = ws.light_pos.shape[0]
    frame_idx = jnp.asarray(frame_idx, jnp.uint32)

    def step(pix, sample_idx, origin, direction, atten, depth):
        hit = closest_fn(origin, direction)
        hmask = hit.hit

        props = _lookup_wmat(ws, hit.mat)             # one matmul
        base = props["base"]
        kind = props["kind"]
        metallic = props["metallic"]
        roughness = props["roughness"]
        emissive = props["emissive"]
        alpha_mode = props["alpha_mode"]
        alpha_cutoff = props["alpha_cutoff"]
        ior = props["ior"]
        tex_id = props["tex_id"]

        tri_rows = _tri_rows(ws, hit)                 # one select
        ns, uu, vv = _interp_attrs_rows(tri_rows, hit)
        # Analytic primitives (ids past the padded tri range,
        # ``intersect_primitives`` index_offset contract) have no vertex
        # attributes: shade with the intersector's analytic normal
        # (``cuda/sphere.cu:37-97`` / ``geometry.cu:38-144`` parity)
        # and UV (0, 0).
        prim_lane = hit.tri >= ws.vtx_attr.shape[0]
        ns = v3.where(prim_lane, hit.normal, ns)
        uu = jnp.where(prim_lane, 0.0, uu)
        vv = jnp.where(prim_lane, 0.0, vv)
        # Flip the shading normal toward the ray (whitted.cu:221-223).
        flip = v3.dot(ns, direction) > 0.0
        ns = v3.where(flip, -ns, ns)

        if ws.textures:
            # Per-material UV affine (offset/rotation/scale — reference
            # texcoord transforms, cuda/LocalShading.h; glTF
            # KHR_texture_transform) — applied before EVERY texture
            # fetch, normal maps included.
            uvx = props["tex_uvx"]
            uu, vv = (uvx[:, 0] * uu + uvx[:, 1] * vv + uvx[:, 2],
                      uvx[:, 3] * uu + uvx[:, 4] * vv + uvx[:, 5])
        # The four texture consumers below (normal map, base color,
        # metallic-roughness, emissive) all sample at this bounce's
        # final UV: evaluate EVERY texture once and let each
        # consumer mask-select its slot (TPT_WTEX=0 ablates to the
        # per-consumer gather baseline).
        texels = (_sample_all_textures(ws, uu, vv)
                  if ws.textures
                  and os.environ.get("TPT_WTEX", "1") != "0" else None)

        def sample_tex(ids, srgb=True):
            if texels is None:
                return _sample_textures(ws, ids, uu, vv, srgb=srgb)
            return _tex_lookup(texels, ids, srgb=srgb)
        if ws.textures and ws.has_normal_maps:
            # Tangent-space normal mapping (whitted.cu:226-244 parity):
            # TBN from the triangle's UV tangent orthonormalized against
            # the shading normal; degenerate tangents fall back to an
            # ONB axis.
            n_id = props["ntex_id"]
            tan = V3(tri_rows[:, 16], tri_rows[:, 17], tri_rows[:, 18])
            tan = tan - ns * v3.dot(ns, tan)
            t_len2 = v3.dot(tan, tan)
            onb_t, _, _ = v3.onb_from_normal(ns)
            tan = v3.where(t_len2 > 1e-12,
                           tan * jax.lax.rsqrt(jnp.maximum(t_len2, 1e-12)),
                           onb_t)
            bit = v3.cross(ns, tan)
            nm, _ = sample_tex(n_id, srgb=False)
            n_scale = props["ntex_scale"]
            tx = (nm.x * 2.0 - 1.0) * n_scale
            ty = (nm.y * 2.0 - 1.0) * n_scale
            tz = nm.z * 2.0 - 1.0
            perturbed = v3.normalize(tan * tx + bit * ty + ns * tz)
            ns = v3.where(hmask & (n_id >= 0), perturbed, ns)

        base_rgb = V3(base[:, 0], base[:, 1], base[:, 2])
        base_a = base[:, 3]
        emissive_rgb = V3(emissive[:, 0], emissive[:, 1], emissive[:, 2])

        # CheckerPhong (shading.cu:169-206): even checker cells swap to
        # the material's second parameter set; set 1 is the regular
        # tables. Applies before texturing (checker materials are
        # procedural).
        c2 = props["checker2"]
        tcx = jnp.floor(uu * c2[:, 10]).astype(jnp.int32)
        tcy = jnp.floor(vv * c2[:, 11]).astype(jnp.int32)
        use2 = hmask & (kind == KIND_CHECKER) & (((tcx + tcy) & 1) == 0)
        base_rgb = v3.where(use2, V3(c2[:, 0], c2[:, 1], c2[:, 2]),
                            base_rgb)
        if ws.textures:
            tex_rgb, tex_a = sample_tex(tex_id)
            base_rgb = base_rgb * tex_rgb
            base_a = base_a * tex_a
        if ws.textures and ws.has_mr_tex:
            # Metallic-roughness texture: G = roughness, B = metallic,
            # linear, multiplied with the factors (MaterialData.h:83).
            mr_id = props["mrtex_id"]
            mr, _ = sample_tex(mr_id, srgb=False)
            has_mr = mr_id >= 0
            roughness = jnp.where(has_mr, roughness * mr.y, roughness)
            metallic = jnp.where(has_mr, metallic * mr.z, metallic)
        if ws.textures and ws.has_emissive_tex:
            # Emissive texture (sRGB) times the emissive factor
            # (MaterialData.h:129).
            e_id = props["etex_id"]
            em, _ = sample_tex(e_id)
            emissive_rgb = v3.where(e_id >= 0, emissive_rgb * em,
                                    emissive_rgb)

        # Alpha mask: treat sub-cutoff hits as pass-through continuations.
        masked_out = hmask & (alpha_mode == ALPHA_MASK) & (base_a <
                                                           alpha_cutoff)

        p = origin + direction * hit.t
        vdir = v3.normalize(-direction)

        f0 = 0.04
        diff_color = base_rgb * ((1.0 - f0) * (1.0 - metallic))
        spec_color = v3.lerp(V3.full(metallic.shape, (f0, f0, f0)),
                             base_rgb, metallic)
        a_r = roughness * roughness

        result = emissive_rgb
        shadow_count = jnp.zeros(hmask.shape, jnp.float32)

        # Per-light shading terms first, then ONE batched occlusion
        # call over all lights' shadow segments ([L*N] lanes): every
        # light sweeps the same occluder table, so L separate kernel
        # launches per bounce were pure fixed cost. The occlusion
        # result is a fractional transmission (alpha occluders pass
        # partial light, _make_occlusion); opaque-only scenes return
        # exact 0/1 so batching stays bitwise-neutral. Ineligible
        # lanes park their rays far outside the scene — a zero
        # direction would pass every BVH box test (tnear = -inf) and
        # generate traversal work (as in render._nee).
        park = V3.full(hmask.shape, (PARK_COORD,) * 3)
        away = V3.full(hmask.shape, (0.5773503,) * 3)
        lights = []
        for li in range(n_lights):
            lpos = V3.of(ws.light_pos[li, 0], ws.light_pos[li, 1],
                         ws.light_pos[li, 2])
            to_l = lpos - p
            l_dist = v3.length(to_l)
            ldir = v3.normalize(to_l)
            n_dot_l = v3.dot(ns, ldir)
            n_dot_v = v3.dot(ns, vdir)
            lit = hmask & (n_dot_l > 0.0) & (n_dot_v > 0.0)
            lights.append(dict(
                ldir=ldir, lit=lit, n_dot_l=n_dot_l, n_dot_v=n_dot_v,
                occ_org=v3.where(lit, p, park),
                occ_dir=v3.where(lit, ldir, away),
                occ_tmax=jnp.where(lit, l_dist - 0.001, 0.0)))
        if n_lights > 1:
            cat = jnp.concatenate
            occ_o = V3(cat([ld["occ_org"].x for ld in lights]),
                       cat([ld["occ_org"].y for ld in lights]),
                       cat([ld["occ_org"].z for ld in lights]))
            occ_d = V3(cat([ld["occ_dir"].x for ld in lights]),
                       cat([ld["occ_dir"].y for ld in lights]),
                       cat([ld["occ_dir"].z for ld in lights]))
            occ_t = cat([ld["occ_tmax"] for ld in lights])
            att_all = occ_att_fn(occ_o, occ_d, occ_t)
            n_l = hmask.shape[0]
            for li, ld in enumerate(lights):
                ld["att"] = att_all[li * n_l:(li + 1) * n_l]
        elif n_lights:
            lights[0]["att"] = occ_att_fn(lights[0]["occ_org"],
                                          lights[0]["occ_dir"],
                                          lights[0]["occ_tmax"])

        for li, ld in enumerate(lights):
            lcol = ws.light_color[li]
            ldir, lit = ld["ldir"], ld["lit"]
            hvec = v3.normalize(ldir + vdir)
            n_dot_h = v3.dot(ns, hvec)
            v_dot_h = v3.dot(vdir, hvec)
            shadow_count = shadow_count + jnp.where(lit, 1.0, 0.0)
            f = _schlick(spec_color, v_dot_h)
            g_vis = _vis(jnp.maximum(ld["n_dot_l"], 1e-6),
                         jnp.maximum(ld["n_dot_v"], 1e-6), a_r)
            d = _ggx_d(n_dot_h, a_r)
            brdf = (V3.ones(lit.shape) - f) * diff_color * (1.0 / jnp.pi) \
                + f * (g_vis * d)
            # light color x attenuation x N.L (whitted.cu:246-263 —
            # the reference multiplies the fractional occlusion
            # attenuation into the light term).
            w = jnp.where(lit, ld["n_dot_l"] * ld["att"], 0.0)
            result = result + brdf * (V3.of(lcol[0], lcol[1], lcol[2]) * w)

        # Ambient light (Light::Ambient, whitted.cu:264-267).
        result = result + base_rgb * V3.of(ws.ambient[0], ws.ambient[1],
                                           ws.ambient[2])

        # Continuations.
        is_glass = kind == KIND_GLASS
        refl_dir = v3.reflect(v3.normalize(direction), ns)
        sa, _ = rng.bounce_streams(jnp.asarray(depth, jnp.uint32))
        z1, _, _, _ = rng.uniform4(pix, sample_idx, frame_idx, sa)
        from .bsdf import fr_dielectric
        cos_i = v3.dot(vdir, ns)
        fres = fr_dielectric(cos_i, 1.0, ior)
        refr_dir, ok_refr = v3.refract(v3.normalize(direction), ns, ior)
        glass_reflect = (z1 < fres) | ~ok_refr
        glass_dir = v3.where(glass_reflect, refl_dir, refr_dir)

        # Phong-metal reflections: Kr-weighted mirror (shading.cu metal).
        # Checker cells carry their own Kr (shading.cu:190-199).
        kr = props["phong_kr"]
        kr_v = V3(kr[:, 0], kr[:, 1], kr[:, 2])
        kr_v = v3.where(use2, V3(c2[:, 6], c2[:, 7], c2[:, 8]), kr_v)
        phong_kind = (kind == KIND_PHONG) | (kind == KIND_CHECKER)
        phong_refl = hmask & phong_kind & (v3.luminance(kr_v) > 0.0)

        # Alpha blend: result scales by alpha; (1-alpha) continues straight
        # (whitted.cu:268-287).
        blend = hmask & (alpha_mode == ALPHA_BLEND) & ~masked_out
        result = v3.where(blend, result * base_a, result)

        cont_glass = hmask & is_glass
        cont = cont_glass | phong_refl | blend | masked_out
        new_dir = v3.where(cont_glass, glass_dir,
                           v3.where(phong_refl, refl_dir, direction))
        new_origin = p + new_dir * 1e-3
        cont_weight = v3.where(
            masked_out, V3.ones(hmask.shape),
            v3.where(blend, V3.ones(hmask.shape) * (1.0 - base_a),
                     v3.where(cont_glass, base_rgb, kr_v)))
        # Masked-out lanes contribute nothing at this hit.
        result = v3.where(masked_out, V3.zeros(hmask.shape), result)

        contrib = result * atten
        contrib = v3.where(hmask, contrib, V3.zeros(hmask.shape))
        # Miss: background color once per path.
        miss = ~hit.hit
        bg = cfg.background
        contrib = v3.where(miss, V3.full(miss.shape, bg) * atten, contrib)

        # Termination reasons reuse DoneReason slots: 0 = miss,
        # 1 = depth-capped, 2 = absorbed (opaque direct-lit hit —
        # whitted's normal termination; the path tracer's RR slot).
        capped = hmask & cont & ~(depth + 1 < depth_cap)
        done = ~(hmask & cont & (depth + 1 < depth_cap))
        reason = jnp.where(miss, 0, jnp.where(capped, 1, 2))
        return dict(contrib=contrib, new_origin=new_origin,
                    new_dir=new_dir, atten_cont=atten * cont_weight,
                    done=done, reason=reason, shadow_count=shadow_count)

    return step


def render_whitted_wavefront(ws: WhittedScene, cam: CameraArrays,
                             cfg: RenderConfig, pixel_start, n_pixels: int,
                             frame_idx, sample_offset=0):
    """Direct-lighting estimate over cfg.spp jittered samples per pixel.

    Returns (radiance [N, 3], RenderStats). Material properties come
    from one one-hot matmul lookup per bounce instead of per-table gathers,
    and the default scheduler is the path tracer's pixelq work queue
    (``render._render_pixelq``): whitted paths mostly die at the first
    opaque hit, so a full-width depth loop re-traces ~63% dead lanes by
    exit depth — the queue replaces finished (pixel, sample-chunk) items
    the round they retire. ``cfg.scheduler != "pixelq"`` keeps the wide
    ``while_loop`` (exits as soon as no lane continues). Stats histogram
    indices reuse DoneReason slots: [miss, depth-capped, absorbed
    (opaque direct-lit hit — whitted's normal termination), 0, 0]."""
    geom = ws.geom
    closest_fn, occluded_fn = get_intersectors(geom, cfg)
    occ_att_fn = _make_occlusion(ws, cfg)
    depth_cap = min(cfg.max_depth, MAX_TRACE_DEPTH)
    step_fn = _make_whitted_step(ws, cfg, closest_fn, occ_att_fn,
                                 frame_idx, depth_cap)

    if cfg.scheduler == "pixelq":
        from .render import _render_pixelq
        return _render_pixelq(geom, cam, cfg, pixel_start, n_pixels,
                              frame_idx, sample_offset, closest_fn,
                              occluded_fn, bounce_fn=step_fn)

    frame_u = jnp.asarray(frame_idx, jnp.uint32)
    pixel_ids = jnp.asarray(pixel_start, jnp.uint32) + jnp.arange(
        n_pixels, dtype=jnp.uint32)

    def one_sample(sample_idx, st):
        jx, jy = rng.uniform2(pixel_ids, sample_idx, frame_u,
                              rng.STREAM_JITTER)
        origin, direction = camera_rays(cam, pixel_ids, cfg.width,
                                        cfg.height, jx, jy)

        def cond(carry):
            _, _, _, alive, _, depth, _ = carry
            return (depth < depth_cap) & jnp.any(alive)

        def body(carry):
            origin, direction, atten, alive, acc, depth, st = carry
            s = step_fn(pixel_ids, sample_idx, origin, direction, atten,
                        depth)
            contrib = v3.where(alive, s["contrib"], V3.zeros((n_pixels,)))
            alive_f = jnp.where(alive, 1.0, 0.0)
            fin = alive & s["done"]
            st["rays"] += jnp.sum(alive_f)
            st["shadow_rays"] += jnp.sum(alive_f * s["shadow_count"])
            st["iters"] += 1.0
            st["miss"] += jnp.sum(
                jnp.where(fin & (s["reason"] == 0), 1.0, 0.0))
            st["capped"] += jnp.sum(
                jnp.where(fin & (s["reason"] == 1), 1.0, 0.0))
            st["absorbed"] += jnp.sum(
                jnp.where(fin & (s["reason"] == 2), 1.0, 0.0))
            return (s["new_origin"], s["new_dir"], s["atten_cont"],
                    alive & ~s["done"], acc + contrib, depth + 1, st)

        init = (origin, direction, V3.ones((n_pixels,)),
                jnp.ones((n_pixels,), bool), V3.zeros((n_pixels,)),
                jnp.uint32(0), st)
        out = jax.lax.while_loop(cond, body, init)
        return out[4], out[6]

    def spp_body(carry, sample_idx):
        acc, st = carry
        smp, st = one_sample(sample_idx, st)
        return (acc + smp, st), None

    samples = jnp.arange(cfg.spp, dtype=jnp.uint32) + jnp.asarray(
        sample_offset, jnp.uint32)
    st0 = dict(rays=jnp.float32(0), shadow_rays=jnp.float32(0),
               iters=jnp.float32(0), miss=jnp.float32(0),
               capped=jnp.float32(0), absorbed=jnp.float32(0))
    (acc, st), _ = jax.lax.scan(spp_body, (V3.zeros((n_pixels,)), st0),
                                samples)
    hist = jnp.stack([st["miss"], st["capped"], st["absorbed"],
                      jnp.float32(0), jnp.float32(0)])
    stats = RenderStats(rays_traced=st["rays"],
                        shadow_rays=st["shadow_rays"],
                        done_histogram=hist,
                        wavefront_iterations=st["iters"])
    return (acc * (1.0 / cfg.spp)).to_array(), stats


@partial(jax.jit, static_argnames=("cfg",), donate_argnames=("accum",))
def render_whitted_frame(ws: WhittedScene, cam: CameraArrays,
                         cfg: RenderConfig, frame_idx, accum):
    """Progressive whitted frame (raygen accumulation parity,
    ``whitted.cu:44-98``). Returns (accum, image_u8, RenderStats) —
    the same interface as ``render.render_frame``."""
    from . import film

    n = cfg.width * cfg.height
    radiance, stats = render_whitted_wavefront(ws, cam, cfg, 0, n,
                                               frame_idx)
    frame_img = radiance.reshape(cfg.height, cfg.width, 3)
    new_accum = film.accumulate(accum, frame_img, frame_idx)
    return new_accum, film.make_color(new_accum), stats
