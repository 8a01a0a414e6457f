"""LBVH: on-device linear BVH build + stackless wavefront traversal.

The replacement for the reference's hardware GAS
(``optixAccelBuild``, ``PathTracerMain.cpp:260-398``): a binary radix tree
over Morton-sorted triangle centroids (Karras, "Maximally Parallel
Construction of BVHs...", HPG 2012 — every step is a vectorized O(n) pass,
so the build runs under jit on the accelerator), flattened to arrays and
traversed with a *stackless skip-link* walk: each node stores its first
child and the node to visit when the subtree is skipped, so a ray's
traversal state is a single cursor — the whole wavefront advances one node
per loop iteration with masked lanes, no per-ray stacks.

Node layout ([M = 2n-1] arrays): internal nodes 0..n-2, leaves n-1..2n-2
(leaf j holds Morton-sorted triangle j). ``left`` = first child for
internal nodes; ``skip`` = next node after skipping the subtree; ``tri`` =
original triangle id for leaves (-1 for internal).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from .. import pytree

from ..scene.arrays import SceneArrays, BSDF_REFRACTION
from .. import vec3 as v3m
from ..vec3 import V3
from .moller import Hit, T_FAR, DET_EPS

END = np.int32(-1)
_MORTON_BITS = 10  # per axis -> 30-bit codes


@pytree.dataclass
class BVH:
    """Flattened skip-link BVH.

    The full traversal payload of a node — box, links, and (for leaves) the
    triangle itself with its shading attributes — is packed into ONE
    row-gatherable [M, 24] f32 array so each traversal step costs a single
    row gather (five separate table lookups per step would cost five
    dependent memory round trips). Columns: 0-2 bmin, 3-5 bmax, 6 left, 7 skip,
    8-10 v0, 11-13 e1, 14-16 e2, 17 refractive, 18-20 normal, 21 mat id,
    22 tri id (-1 internal), 23 pad. Links/ids ride as f32 (exact below
    2^24 — 8M-triangle scenes). ``left``/``skip``/``tri`` are kept as i32
    duplicates for tests and host-side inspection.
    """
    nodes: jnp.ndarray     # [M, 24] f32
    left: jnp.ndarray      # [M] i32 (first child; -1 for leaves)
    skip: jnp.ndarray      # [M] i32 (next node when subtree skipped; -1=end)
    tri: jnp.ndarray       # [M] i32 (triangle id for leaves; -1 internal)

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]


def _expand_bits(v: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = (v * jnp.uint32(0x00010001)) & jnp.uint32(0xFF0000FF)
    v = (v * jnp.uint32(0x00000101)) & jnp.uint32(0x0F00F00F)
    v = (v * jnp.uint32(0x00000011)) & jnp.uint32(0xC30C30C3)
    v = (v * jnp.uint32(0x00000005)) & jnp.uint32(0x49249249)
    return v


def morton3d(p01: jnp.ndarray) -> jnp.ndarray:
    """[..., 3] coordinates in [0,1] -> 30-bit Morton codes (uint32)."""
    scale = jnp.float32((1 << _MORTON_BITS) - 1)
    q = jnp.clip(p01 * scale, 0.0, scale).astype(jnp.uint32)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))


def build_lbvh(scene: SceneArrays) -> BVH:
    """Device-side LBVH over the scene's valid triangles.

    Padding triangles get degenerate (inverted) boxes that never pass the
    slab test, so they are carried harmlessly as extra leaves.
    """
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = v0.shape[0]
    assert n >= 2, "LBVH needs at least 2 triangles"

    p1 = v0 + e1
    p2 = v0 + e2
    tri_min = jnp.minimum(v0, jnp.minimum(p1, p2))
    tri_max = jnp.maximum(v0, jnp.maximum(p1, p2))
    # Padding tris: collapse to a far-away point so they sort to one end and
    # their leaf boxes (inverted below) never hit.
    valid = scene.tri_valid
    big = jnp.float32(3e30)
    tri_min = jnp.where(valid[:, None], tri_min, big)
    tri_max = jnp.where(valid[:, None], tri_max, -big)

    centroid = 0.5 * (tri_min + tri_max)
    c_for_bounds = jnp.where(valid[:, None], centroid, jnp.nan)
    lo = jnp.nanmin(c_for_bounds, axis=0)
    hi = jnp.nanmax(c_for_bounds, axis=0)
    extent = jnp.maximum(hi - lo, 1e-9)
    unit = (centroid - lo) / extent
    unit = jnp.where(valid[:, None], unit, 1.0)  # padding sorts last

    codes = morton3d(unit)
    order = jnp.argsort(codes, stable=True).astype(jnp.int32)
    codes = codes[order]

    # --- Karras radix-tree topology --------------------------------------
    idx = jnp.arange(n, dtype=jnp.int32)

    def delta(i, j):
        """Common-prefix length of keys i, j (index-augmented for ties);
        -1 out of range. i, j: int32 arrays."""
        in_range = (j >= 0) & (j <= n - 1)
        j_c = jnp.clip(j, 0, n - 1)
        ci = codes[jnp.clip(i, 0, n - 1)]
        cj = codes[j_c]
        x = ci ^ cj
        d = jax.lax.clz(x)
        # Tie-break equal codes by index bits (adds 32).
        tie = jax.lax.clz((i.astype(jnp.uint32) ^ j_c.astype(jnp.uint32)))
        d = jnp.where(x == 0, 32 + tie, d)
        return jnp.where(in_range, d.astype(jnp.int32), -1)

    import math
    i = idx[: n - 1]  # internal node ids
    d = jnp.sign(delta(i, i + 1) - delta(i, i - 1)).astype(jnp.int32)
    delta_min = delta(i, i - d)

    n_dbl = max(2, math.ceil(math.log2(max(n, 2))) + 2)

    # Find range length upper bound by doubling.
    def lmax_body(_, lmax):
        cond = delta(i, i + lmax * d) > delta_min
        return jnp.where(cond, lmax * 2, lmax)

    lmax = jax.lax.fori_loop(0, n_dbl + 1, lmax_body, jnp.full_like(i, 2))

    # Binary search the exact other end j = i + l*d. Step sequence
    # lmax/2, lmax/4, ..., 1, then 0 — each step applied exactly once.
    def l_body(k, carry):
        l, t = carry
        live = t > 0
        cond = delta(i, i + (l + t) * d) > delta_min
        l = jnp.where(live & cond, l + t, l)
        return l, jnp.where(live, t // 2, 0)

    l, _ = jax.lax.fori_loop(0, n_dbl + 3, l_body,
                             (jnp.zeros_like(i), lmax // 2))
    j = i + l * d

    # Binary search the split position (ceil-halving step sequence).
    delta_node = delta(i, j)

    def s_body(k, carry):
        s, t = carry
        live = t > 0
        cond = delta(i, i + (s + t) * d) > delta_node
        s = jnp.where(live & cond, s + t, s)
        return s, jnp.where(t > 1, (t + 1) // 2, 0)

    s, _ = jax.lax.fori_loop(0, n_dbl + 3, s_body,
                             (jnp.zeros_like(i), (l + 1) // 2))
    gamma = i + s * d + jnp.minimum(d, 0)

    lo_ij = jnp.minimum(i, j)
    hi_ij = jnp.maximum(i, j)
    leaf_base = n - 1
    left_child = jnp.where(lo_ij == gamma, leaf_base + gamma, gamma)
    right_child = jnp.where(hi_ij == gamma + 1, leaf_base + gamma + 1,
                            gamma + 1)

    m = 2 * n - 1
    parent = jnp.full((m,), END, jnp.int32)
    parent = parent.at[left_child].set(i)
    parent = parent.at[right_child].set(i)
    is_left = jnp.zeros((m,), bool).at[left_child].set(True)

    # --- bottom-up AABBs (fixpoint sweep over tree depth) ----------------
    bbox_min = jnp.full((m, 3), big, jnp.float32)
    bbox_max = jnp.full((m, 3), -big, jnp.float32)
    bbox_min = bbox_min.at[leaf_base:].set(tri_min[order])
    bbox_max = bbox_max.at[leaf_base:].set(tri_max[order])

    def box_body(state):
        bmin, bmax, changed, it = state
        new_min = jnp.minimum(bmin[left_child], bmin[right_child])
        new_max = jnp.maximum(bmax[left_child], bmax[right_child])
        changed = (jnp.any(new_min != bmin[: n - 1])
                   | jnp.any(new_max != bmax[: n - 1]))
        bmin = bmin.at[: n - 1].set(new_min)
        bmax = bmax.at[: n - 1].set(new_max)
        return bmin, bmax, changed, it + 1

    def box_cond(state):
        _, _, changed, it = state
        return changed & (it < m)

    bbox_min, bbox_max, _, _ = jax.lax.while_loop(
        box_cond, box_body, (bbox_min, bbox_max, jnp.bool_(True),
                             jnp.int32(0)))

    # --- skip links (top-down fixpoint) -----------------------------------
    sibling = jnp.full((m,), END, jnp.int32)
    sibling = sibling.at[left_child].set(right_child)

    skip = jnp.full((m,), END, jnp.int32)

    def skip_body(state):
        skip, changed, it = state
        par = parent
        # skip(v) = sibling(v) if v is a left child else skip(parent(v)).
        from_parent = jnp.where(par >= 0, skip[jnp.maximum(par, 0)], END)
        new = jnp.where(is_left, sibling, from_parent)
        new = new.at[0].set(END)  # root (node 0) has no parent
        changed = jnp.any(new != skip)
        return new, changed, it + 1

    skip, _, _ = jax.lax.while_loop(
        lambda st: st[1] & (st[2] < m),
        skip_body, (skip, jnp.bool_(True), jnp.int32(0)))

    left = jnp.concatenate([left_child, jnp.full((n,), END, jnp.int32)])
    tri = jnp.concatenate([jnp.full((n - 1,), END, jnp.int32), order])

    # --- pack the single-gather node payload ------------------------------
    zeros_leaf = jnp.zeros((n - 1,), jnp.float32)

    def leafcat(leaf_vals):
        return jnp.concatenate([zeros_leaf, leaf_vals])

    refr = (scene.mat_bsdf[scene.mat_id] == BSDF_REFRACTION
            ).astype(jnp.float32)
    cols = [
        bbox_min[:, 0], bbox_min[:, 1], bbox_min[:, 2],
        bbox_max[:, 0], bbox_max[:, 1], bbox_max[:, 2],
        left.astype(jnp.float32), skip.astype(jnp.float32),
        leafcat(v0[order][:, 0]), leafcat(v0[order][:, 1]),
        leafcat(v0[order][:, 2]),
        leafcat(e1[order][:, 0]), leafcat(e1[order][:, 1]),
        leafcat(e1[order][:, 2]),
        leafcat(e2[order][:, 0]), leafcat(e2[order][:, 1]),
        leafcat(e2[order][:, 2]),
        leafcat(refr[order]),
        leafcat(scene.tri_normal[order][:, 0]),
        leafcat(scene.tri_normal[order][:, 1]),
        leafcat(scene.tri_normal[order][:, 2]),
        leafcat(scene.mat_id[order].astype(jnp.float32)),
        tri.astype(jnp.float32),
        jnp.zeros((m,), jnp.float32),
    ]
    nodes = jnp.stack(cols, axis=1)

    return BVH(nodes=nodes, left=left, skip=skip, tri=tri)


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _traverse(bvh: BVH, origins: V3, dirs: V3, tmin, tmax, mode: str,
              tmax_per_ray=None):
    """Wavefront skip-link walk. mode: 'closest' | 'occluded'.

    One [N, 24] row gather per step supplies box, links, AND the leaf
    triangle + its shading attributes; all math is component-SoA.
    """
    n_rays = origins.x.shape[0]

    def inv(c):
        return jnp.where(jnp.abs(c) > 1e-20, 1.0 / c,
                         jnp.where(c >= 0, 1e30, -1e30))

    inv_d = V3(inv(dirs.x), inv(dirs.y), inv(dirs.z))
    zero_dir = (dirs.x == 0.0) & (dirs.y == 0.0) & (dirs.z == 0.0)

    occl = mode == "occluded"
    limit = tmax_per_ray if occl else jnp.full((n_rays,), tmax, jnp.float32)

    state0 = dict(
        cursor=jnp.where(zero_dir, END, jnp.zeros((n_rays,), jnp.int32)),
        best_t=jnp.full((n_rays,), T_FAR, jnp.float32),
        best_i=jnp.zeros((n_rays,), jnp.int32),
        best_nm=jnp.zeros((n_rays, 4), jnp.float32),
        best_uv=jnp.zeros((n_rays, 2), jnp.float32),
        found=jnp.zeros((n_rays,), bool),
    )

    def cond(s):
        return jnp.any(s["cursor"] != END)

    def body(s):
        cur = s["cursor"]
        active = cur != END
        rows = bvh.nodes[jnp.maximum(cur, 0)]           # [N, 24] one gather

        # Slab test (explicitly rejecting inverted padding boxes).
        def axis(o, idv, k):
            t0 = (rows[:, k] - o) * idv
            t1 = (rows[:, k + 3] - o) * idv
            return jnp.minimum(t0, t1), jnp.maximum(t0, t1)

        nx0, fx0 = axis(origins.x, inv_d.x, 0)
        ny0, fy0 = axis(origins.y, inv_d.y, 1)
        nz0, fz0 = axis(origins.z, inv_d.z, 2)
        tnear = jnp.maximum(jnp.maximum(nx0, ny0), nz0)
        tfar = jnp.minimum(jnp.minimum(fx0, fy0), fz0)
        box_valid = ((rows[:, 0] <= rows[:, 3]) & (rows[:, 1] <= rows[:, 4])
                     & (rows[:, 2] <= rows[:, 5]))
        prune_t = limit if occl else jnp.minimum(s["best_t"], limit)
        box_hit = (box_valid & (tfar >= jnp.maximum(tnear, tmin))
                   & (tnear < prune_t))

        child = rows[:, 6].astype(jnp.int32)
        nxt = rows[:, 7].astype(jnp.int32)
        tri_id = rows[:, 22].astype(jnp.int32)
        is_leaf = tri_id >= 0

        # Leaf: Möller-Trumbore against the in-row triangle.
        v0 = V3(rows[:, 8], rows[:, 9], rows[:, 10])
        e1 = V3(rows[:, 11], rows[:, 12], rows[:, 13])
        e2 = V3(rows[:, 14], rows[:, 15], rows[:, 16])
        pvec = v3m.cross(dirs, e2)
        det = v3m.dot(e1, pvec)
        ok = jnp.abs(det) > DET_EPS
        inv_det = 1.0 / jnp.where(ok, det, 1.0)
        tvec = origins - v0
        u = v3m.dot(tvec, pvec) * inv_det
        qvec = v3m.cross(tvec, e1)
        v = v3m.dot(dirs, qvec) * inv_det
        t = v3m.dot(e2, qvec) * inv_det
        tri_hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
        t = jnp.where(active & is_leaf & box_hit & tri_hit, t, T_FAR)

        if occl:
            blocking = (t < limit) & (rows[:, 17] < 0.5)
            found = s["found"] | blocking
            best_t, best_i, best_nm, best_uv = (
                s["best_t"], s["best_i"], s["best_nm"], s["best_uv"])
            # Early exit: once occluded, stop traversing this ray.
            next_cursor = jnp.where(
                found, END, jnp.where(~is_leaf & box_hit, child, nxt))
        else:
            better = t < jnp.minimum(s["best_t"], limit)
            best_t = jnp.where(better, t, s["best_t"])
            best_i = jnp.where(better, tri_id, s["best_i"])
            best_nm = jnp.where(better[:, None], rows[:, 18:22],
                                s["best_nm"])
            best_uv = jnp.where(better[:, None],
                                jnp.stack([u, v], axis=1), s["best_uv"])
            found = s["found"] | better
            next_cursor = jnp.where(~is_leaf & box_hit, child, nxt)

        cursor = jnp.where(active, next_cursor, END)
        return dict(cursor=cursor, best_t=best_t, best_i=best_i,
                    best_nm=best_nm, best_uv=best_uv, found=found)

    out = jax.lax.while_loop(cond, body, state0)
    if occl:
        return out["found"]
    return out


def build_lbvh_host(scene: SceneArrays, host: dict | None = None) -> BVH:
    """Host-side LBVH build via the native (C++) builder.

    Same flattened layout as :func:`build_lbvh`; preferred at scene-load
    time because it avoids the device build's jit-compile latency. Pass
    ``host`` (the padded numpy arrays from ``build_scene_arrays(...,
    return_host=True)``) to avoid any device->host readback. Without
    ``host`` the arrays are pulled from the device (CPU backends: free).
    """
    from .. import native
    import numpy as np

    if host is None:
        host = dict(v0=np.asarray(scene.tri_v0),
                    e1=np.asarray(scene.tri_e1),
                    e2=np.asarray(scene.tri_e2),
                    normal=np.asarray(scene.tri_normal),
                    valid=np.asarray(scene.tri_valid),
                    mat_id=np.asarray(scene.mat_id),
                    mat_bsdf=np.asarray(scene.mat_bsdf))
    v0 = host["v0"]
    e1 = host["e1"]
    e2 = host["e2"]
    p1, p2 = v0 + e1, v0 + e2
    tri_min = np.minimum(v0, np.minimum(p1, p2))
    tri_max = np.maximum(v0, np.maximum(p1, p2))
    valid = host["valid"]
    left, skip, tri, bmin, bmax = native.build_lbvh_native(
        tri_min, tri_max, valid)

    n = v0.shape[0]
    m = 2 * n - 1
    refr = (host["mat_bsdf"][host["mat_id"]]
            == BSDF_REFRACTION).astype(np.float32)
    norm = host["normal"]
    mid = host["mat_id"].astype(np.float32)
    nodes = np.zeros((m, 24), np.float32)
    nodes[:, 0:3] = bmin
    nodes[:, 3:6] = bmax
    nodes[:, 6] = left
    nodes[:, 7] = skip
    leaf = tri >= 0
    tr = np.where(leaf, tri, 0)
    nodes[leaf, 8:11] = v0[tr[leaf]]
    nodes[leaf, 11:14] = e1[tr[leaf]]
    nodes[leaf, 14:17] = e2[tr[leaf]]
    nodes[leaf, 17] = refr[tr[leaf]]
    nodes[leaf, 18:21] = norm[tr[leaf]]
    nodes[leaf, 21] = mid[tr[leaf]]
    nodes[:, 22] = tri
    return BVH(nodes=jnp.asarray(nodes), left=jnp.asarray(left),
               skip=jnp.asarray(skip), tri=jnp.asarray(tri))


def with_bvh(scene: SceneArrays, builder: str = "auto",
             host: dict | None = None) -> SceneArrays:
    """Return the scene with its LBVH built and attached (eager, once).

    builder: 'auto' (native C++ if available, else device), 'native',
    or 'device' (the jit Karras build, on the accelerator).
    ``host``: padded numpy scene arrays; lets the native build skip
    device readbacks (see :func:`build_lbvh_host`).
    """
    if builder == "auto":
        from .. import native
        builder = "native" if native.available() else "device"
    if builder == "native":
        return scene.replace(bvh=build_lbvh_host(scene, host=host))
    assert builder == "device", builder
    return scene.replace(bvh=jax.jit(build_lbvh)(scene))


def intersect_closest(scene: SceneArrays, origins: V3, dirs: V3,
                      tmin: float = 0.01, tmax: float = T_FAR,
                      bvh: BVH | None = None) -> Hit:
    if bvh is None:
        bvh = scene.bvh
    assert bvh is not None, "scene has no BVH; build with build_lbvh()"
    from ..vec3 import as_v3
    origins = as_v3(origins)
    dirs = as_v3(dirs)
    out = _traverse(bvh, origins, dirs, tmin, tmax, "closest")
    ok = out["best_t"] < T_FAR
    nm = out["best_nm"]
    uv = out["best_uv"]
    return Hit(t=out["best_t"], tri=jnp.where(ok, out["best_i"], 0), hit=ok,
               normal=V3(nm[:, 0], nm[:, 1], nm[:, 2]),
               mat=jnp.where(ok, nm[:, 3].astype(jnp.int32), 0),
               u=uv[:, 0], v=uv[:, 1])


def intersect_occluded(scene: SceneArrays, origins: V3, dirs: V3, tmax,
                       tmin: float = 0.01,
                       quirk_first_hit: bool = False,
                       bvh: BVH | None = None) -> jnp.ndarray:
    if bvh is None:
        bvh = scene.bvh
    assert bvh is not None, "scene has no BVH; build with build_lbvh()"
    from ..vec3 import as_v3
    origins = as_v3(origins)
    dirs = as_v3(dirs)
    if quirk_first_hit:
        h = intersect_closest(scene, origins, dirs, tmin=tmin, bvh=bvh)
        in_range = h.hit & (h.t < tmax)
        return in_range & (scene.mat_bsdf[h.mat] != BSDF_REFRACTION)
    return _traverse(bvh, origins, dirs, tmin, T_FAR, "occluded",
                     tmax_per_ray=tmax)
