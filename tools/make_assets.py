#!/usr/bin/env python3
"""Generate the test/benchmark scenes (OBJ + MTL) deterministically.

The reference hardcodes a user-local ``CornellBoxWithMonkey.obj``
(``PathTracerMain.cpp:50``) that is not in its repo; these generators produce
equivalent scenes from the classic (public) Cornell box coordinates, with the
emissive quad placed exactly where the reference hardcodes its NEE area light
(corner (343,547,227), v1 (0,0,105), v2 (-130,0,0); ``PathTracerMain.cpp:
154-158``) so geometry and light sampling agree.

Scenes:
- cornell_box.obj           all-diffuse classic box + two blocks
- cornell_box_mixed.obj     tall block Metallic, refractive sphere on the
                            short block (exercises all three BSDFs)
- cornell_box_sphere.obj    + ~2k-tri diffuse sphere (monkey stand-in)
- big_mesh.obj (--big)      ~100k-tri displaced sphere for BVH benchmarks
- mesh_N.obj (--sweep)      4k-64k-tri displaced spheres: the sweep that
                            sets the dense-kernel/LBVH crossover
"""

from __future__ import annotations

import argparse
import json
import math
import os


def quad(f, a, b, c, d):
    """Two CCW triangles for quad a-b-c-d (indices are 1-based absolute)."""
    f.append((a, b, c))
    f.append((a, c, d))


class ObjWriter:
    def __init__(self):
        self.v = []
        self.groups = []  # (mtl_name, faces)

    def add_vert(self, x, y, z) -> int:
        self.v.append((x, y, z))
        return len(self.v)

    def add_quad(self, mtl, p0, p1, p2, p3):
        ids = [self.add_vert(*p) for p in (p0, p1, p2, p3)]
        faces = []
        quad(faces, *ids)
        self.groups.append((mtl, faces))

    def add_tris(self, mtl, verts, tris):
        base = len(self.v)
        for p in verts:
            self.add_vert(*p)
        faces = [(base + a + 1, base + b + 1, base + c + 1)
                 for a, b, c in tris]
        self.groups.append((mtl, faces))

    def write(self, path, mtl_file):
        with open(path, "w") as f:
            f.write(f"mtllib {mtl_file}\n")
            for x, y, z in self.v:
                f.write(f"v {x:.6g} {y:.6g} {z:.6g}\n")
            for mtl, faces in self.groups:
                f.write(f"usemtl {mtl}\n")
                for a, b, c in faces:
                    f.write(f"f {a} {b} {c}\n")


def cornell_shell(w: ObjWriter, light: bool = True,
                  white="WhiteDiffuse", red="RedDiffuse",
                  green="GreenDiffuse"):
    """Classic Cornell box: floor/ceiling/back/left(red)/right(green)."""
    # Floor (y=0)
    w.add_quad(white, (552.8, 0, 0), (0, 0, 0), (0, 0, 559.2),
               (549.6, 0, 559.2))
    # Ceiling (y=548.8)
    w.add_quad(white, (556, 548.8, 0), (556, 548.8, 559.2),
               (0, 548.8, 559.2), (0, 548.8, 0))
    # Back wall (z=559.2)
    w.add_quad(white, (549.6, 0, 559.2), (0, 0, 559.2),
               (0, 548.8, 559.2), (556, 548.8, 559.2))
    # Right wall (x=0) — green
    w.add_quad(green, (0, 0, 559.2), (0, 0, 0), (0, 548.8, 0),
               (0, 548.8, 559.2))
    # Left wall (x~555) — red
    w.add_quad(red, (552.8, 0, 0), (549.6, 0, 559.2),
               (556, 548.8, 559.2), (556, 548.8, 0))
    if light:
        # Emissive quad exactly at the reference's hardcoded NEE light.
        w.add_quad("Light", (343, 547, 227), (343, 547, 332),
                   (213, 547, 332), (213, 547, 227))


def short_block(w: ObjWriter, mtl="WhiteDiffuse"):
    p = [(130, 165, 65), (82, 165, 225), (240, 165, 272), (290, 165, 114),
         (130, 0, 65), (82, 0, 225), (240, 0, 272), (290, 0, 114)]
    _block(w, mtl, p)


def tall_block(w: ObjWriter, mtl="WhiteDiffuse"):
    p = [(423, 330, 247), (265, 330, 296), (314, 330, 456), (472, 330, 406),
         (423, 0, 247), (265, 0, 296), (314, 0, 456), (472, 0, 406)]
    _block(w, mtl, p)


def _block(w: ObjWriter, mtl, p):
    top = p[0], p[1], p[2], p[3]
    w.add_quad(mtl, *top)
    for i in range(4):
        j = (i + 1) % 4
        w.add_quad(mtl, p[i], p[4 + i], p[4 + j], p[j])


def uv_sphere(cx, cy, cz, r, n_lat, n_lon):
    verts, tris = [], []
    for i in range(n_lat + 1):
        th = math.pi * i / n_lat
        for j in range(n_lon):
            ph = 2 * math.pi * j / n_lon
            verts.append((cx + r * math.sin(th) * math.cos(ph),
                          cy + r * math.cos(th),
                          cz + r * math.sin(th) * math.sin(ph)))
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                tris.append((a, b, c))
            if i < n_lat - 1:
                tris.append((b, d, c))
    return verts, tris


def ellipsoid(cx, cy, cz, rx, ry, rz, n_lat, n_lon):
    verts, tris = uv_sphere(0, 0, 0, 1.0, n_lat, n_lon)
    return [(cx + rx * x, cy + ry * y, cz + rz * z)
            for x, y, z in verts], tris


def icosphere(cx, cy, cz, r, subdiv=1):
    """Subdivided icosahedron: the faceted crystal ball of the reference
    renders (flat geometric normals make the facets; 80 tris at level 1)."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    tris = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
            (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
            (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
            (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]

    def norm(v):
        l = math.sqrt(v[0] ** 2 + v[1] ** 2 + v[2] ** 2)
        return (v[0] / l, v[1] / l, v[2] / l)

    verts = [norm(v) for v in verts]
    for _ in range(subdiv):
        mid, new_tris = {}, []

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                va, vb = verts[a], verts[b]
                verts.append(norm(((va[0] + vb[0]) / 2, (va[1] + vb[1]) / 2,
                                   (va[2] + vb[2]) / 2)))
                mid[key] = len(verts) - 1
            return mid[key]

        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                         (ab, bc, ca)]
        tris = new_tris
    return [(cx + r * x, cy + r * y, cz + r * z) for x, y, z in verts], tris


def monkey_head(w: ObjWriter, cx, cy, cz, mtl="MetallicMonkey"):
    """~1.3k-tri blobby primate head (overlapping closed ellipsoids), the
    stand-in for the reference's hardcoded ~1k-tri monkey mesh
    (``CornellBoxWithMonkey.obj``, ``PathTracerMain.cpp:50`` — a
    user-local file not present in the reference repo). Faces -z (the
    camera side)."""
    for verts, tris in [
        ellipsoid(cx, cy, cz, 52, 45, 42, 16, 20),           # cranium
        ellipsoid(cx, cy - 18, cz - 34, 26, 17, 20, 8, 12),  # snout
        ellipsoid(cx - 55, cy + 12, cz, 10, 19, 19, 8, 10),  # left ear
        ellipsoid(cx + 55, cy + 12, cz, 10, 19, 19, 8, 10),  # right ear
        ellipsoid(cx - 22, cy + 12, cz - 32, 14, 12, 12, 6, 8),  # brow L
        ellipsoid(cx + 22, cy + 12, cz - 32, 14, 12, 12, 6, 8),  # brow R
    ]:
        w.add_tris(mtl, verts, tris)


def displaced_sphere(cx, cy, cz, r, n_lat, n_lon):
    """Bumpy sphere — a deterministic stand-in for a scanned mesh."""
    verts, tris = uv_sphere(0, 0, 0, 1.0, n_lat, n_lon)
    out = []
    for x, y, z in verts:
        bump = 1.0 + 0.08 * math.sin(9 * x) * math.sin(7 * y) * math.sin(5 * z)
        out.append((cx + r * bump * x, cy + r * bump * y, cz + r * bump * z))
    return out, tris


MTL = """\
newmtl WhiteDiffuse
Kd 0.73 0.73 0.73
newmtl RedDiffuse
Kd 0.65 0.05 0.05
newmtl GreenDiffuse
Kd 0.12 0.45 0.15
newmtl Light
Kd 0.78 0.78 0.78
Ke 10 10 10
newmtl MetallicBlock
Kd 0.9 0.9 0.9
Pr 0.2
Pm 1.0
newmtl RefractiveSphere
Kd 0.99 0.99 0.99
Ni 1.5
newmtl GreyDiffuse
Kd 0.6 0.6 0.6
newmtl MetallicMonkey
Kd 0.45 0.12 0.55
Pr 0.25
Pm 1.0
newmtl RefractiveCrystal
Kd 0.99 0.99 0.99
Ni 1.5
newmtl WhiteBright
Kd 0.86 0.86 0.86
newmtl RedPrimary
Kd 0.74 0.0 0.0
newmtl GreenPrimary
Kd 0.0 0.66 0.0
"""


# Sphere resolutions of the crossover sweep (2 * N * (N - 1) triangles).
SWEEP_RES = (45, 64, 90, 128, 180)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "assets"))
    ap.add_argument("--big", action="store_true",
                    help="also write big_mesh.obj (~100k tris)")
    ap.add_argument("--sweep", action="store_true",
                    help="also write mesh_N.obj for N in "
                         f"{SWEEP_RES} (4k-64k tris)")
    ap.add_argument("--huge", action="store_true",
                    help="also write huge_mesh.obj (~1M tris)")
    args = ap.parse_args()
    out = os.path.abspath(args.out)
    os.makedirs(out, exist_ok=True)

    with open(os.path.join(out, "cornell.mtl"), "w") as f:
        f.write(MTL)

    w = ObjWriter()
    cornell_shell(w)
    short_block(w)
    tall_block(w)
    w.write(os.path.join(out, "cornell_box.obj"), "cornell.mtl")

    w = ObjWriter()
    cornell_shell(w)
    short_block(w)
    tall_block(w, mtl="MetallicBlock")
    sv, st = uv_sphere(185, 165 + 80, 169, 80, 12, 18)
    w.add_tris("RefractiveSphere", sv, st)
    w.write(os.path.join(out, "cornell_box_mixed.obj"), "cornell.mtl")

    w = ObjWriter()
    cornell_shell(w)
    short_block(w)
    tall_block(w)
    sv, st = uv_sphere(185, 165 + 90, 169, 90, 32, 36)
    w.add_tris("GreyDiffuse", sv, st)
    w.write(os.path.join(out, "cornell_box_sphere.obj"), "cornell.mtl")

    # The reference's default workload, reconstructed: Cornell + monkey
    # on the short block + faceted refractive crystal on the floor
    # (matches the five published renders at /root/reference/*.png;
    # the original OBJ is a user-local file, PathTracerMain.cpp:50).
    # Saturated-primary walls (round-5 accuracy task): the reference's
    # published renders show wall chromaticity purity 1.00 — its walls
    # are PURE primaries, not the classic Cornell albedos — and purer,
    # brighter walls feed more energy into indirect bounces, which is
    # where the round-4 comparison's anchor-relative ratios gapped
    # (docs/reference_comparison/report.md).
    w = ObjWriter()
    cornell_shell(w, white="WhiteBright", red="RedPrimary",
                  green="GreenPrimary")
    short_block(w, "WhiteBright")
    tall_block(w, "WhiteBright")
    monkey_head(w, 185, 218, 169)
    cv, ct = icosphere(300, 88, 120, 88, subdiv=1)
    w.add_tris("RefractiveCrystal", cv, ct)
    w.write(os.path.join(out, "cornell_box_monkey.obj"), "cornell.mtl")

    # Scene JSON with analytic primitives: the reference's custom-primitive
    # showcase (glass sphere shell, cuda/geometry.cu:67-144; metal sphere,
    # sphere.cu; parallelogram, geometry.cu:38-66) inside the Cornell box.
    prims_scene = dict(
        obj="cornell_box.obj",
        materials=[
            dict(name="RefractiveShellGlass", diffuse=[1.0, 1.0, 1.0],
                 ior=1.5),
            dict(name="MetallicPrimSphere", diffuse=[0.9, 0.7, 0.4],
                 roughness=0.15, metallic=1.0),
            dict(name="RedPanel", diffuse=[0.7, 0.12, 0.12]),
        ],
        primitives=[
            dict(type="sphere_shell", center=[190, 320, 169],
                 radius1=55.0, radius2=65.0, material="RefractiveShellGlass"),
            dict(type="sphere", center=[400, 90, 120], radius=60.0,
                 material="MetallicPrimSphere"),
            dict(type="parallelogram", anchor=[120, 230, 420],
                 v1=[130.0, 0.0, -40.0], v2=[0.0, 110.0, 0.0],
                 material="RedPanel"),
        ],
    )
    with open(os.path.join(out, "cornell_prims.json"), "w") as f:
        json.dump(prims_scene, f, indent=1)

    if args.big:
        w = ObjWriter()
        cornell_shell(w)
        sv, st = displaced_sphere(278, 220, 280, 160, 224, 224)
        w.add_tris("GreyDiffuse", sv, st)
        w.write(os.path.join(out, "big_mesh.obj"), "cornell.mtl")

    for n in SWEEP_RES if args.sweep else ():
        w = ObjWriter()
        cornell_shell(w)
        sv, st = displaced_sphere(278, 220, 280, 160, n, n)
        w.add_tris("GreyDiffuse", sv, st)
        w.write(os.path.join(out, f"mesh_{n}.obj"), "cornell.mtl")

    if args.huge:
        w = ObjWriter()
        cornell_shell(w)
        sv, st = displaced_sphere(278, 220, 280, 160, 708, 708)
        w.add_tris("GreyDiffuse", sv, st)
        w.write(os.path.join(out, "huge_mesh.obj"), "cornell.mtl")

    print(f"assets written to {out}")


if __name__ == "__main__":
    main()
