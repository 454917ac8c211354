"""The benchmark's frozen copy of the repository's scene generator
(``tools/make_assets.py``): the mixed-BSDF Cornell box and the displaced
sphere in the Cornell shell, written byte for byte as that tool writes
them, from pure Python with no randomness.

``ensure(scene, directory)`` writes ``<scene>.obj`` and ``cornell.mtl``
into ``directory`` unless they are there, through temporary names renamed
into place, so that runs that start together never read a half-written
file; it returns the OBJ's path.
"""

from __future__ import annotations

import math
import os
import pathlib


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

    def text(self, mtl_file) -> str:
        out = [f"mtllib {mtl_file}\n"]
        out += [f"v {x:.6g} {y:.6g} {z:.6g}\n" for x, y, z in self.v]
        for mtl, faces in self.groups:
            out.append(f"usemtl {mtl}\n")
            out += [f"f {a} {b} {c}\n" for a, b, c in faces]
        return "".join(out)


def cornell_shell(w: ObjWriter, light: bool = True,
                  white="WhiteDiffuse", red="RedDiffuse",
                  green="GreenDiffuse"):
    """Classic Cornell box: floor/ceiling/back/left(red)/right(green)."""
    w.add_quad(white, (552.8, 0, 0), (0, 0, 0), (0, 0, 559.2),
               (549.6, 0, 559.2))
    w.add_quad(white, (556, 548.8, 0), (556, 548.8, 559.2),
               (0, 548.8, 559.2), (0, 548.8, 0))
    w.add_quad(white, (549.6, 0, 559.2), (0, 0, 559.2),
               (0, 548.8, 559.2), (556, 548.8, 559.2))
    w.add_quad(green, (0, 0, 559.2), (0, 0, 0), (0, 548.8, 0),
               (0, 548.8, 559.2))
    w.add_quad(red, (552.8, 0, 0), (549.6, 0, 559.2),
               (556, 548.8, 559.2), (556, 548.8, 0))
    if light:
        # Emissive quad exactly at the reference's hardcoded NEE light.
        w.add_quad("Light", (343, 547, 227), (343, 547, 332),
                   (213, 547, 332), (213, 547, 227))


def _block(w: ObjWriter, mtl, p):
    w.add_quad(mtl, p[0], p[1], p[2], p[3])
    for i in range(4):
        j = (i + 1) % 4
        w.add_quad(mtl, p[i], p[4 + i], p[4 + j], p[j])


def short_block(w: ObjWriter, mtl="WhiteDiffuse"):
    _block(w, mtl, [(130, 165, 65), (82, 165, 225), (240, 165, 272),
                    (290, 165, 114), (130, 0, 65), (82, 0, 225),
                    (240, 0, 272), (290, 0, 114)])


def tall_block(w: ObjWriter, mtl="WhiteDiffuse"):
    _block(w, mtl, [(423, 330, 247), (265, 330, 296), (314, 330, 456),
                    (472, 330, 406), (423, 0, 247), (265, 0, 296),
                    (314, 0, 456), (472, 0, 406)])


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


def displaced_sphere(cx, cy, cz, r, n_lat, n_lon):
    """Bumpy sphere: a deterministic stand-in for a scanned mesh."""
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


def cornell_box_mixed() -> ObjWriter:
    """428 triangles: tall block Metallic, a refractive sphere on the
    short block, the rest diffuse, one area light."""
    w = ObjWriter()
    cornell_shell(w)
    short_block(w)
    tall_block(w, mtl="MetallicBlock")
    sv, st = uv_sphere(185, 165 + 80, 169, 80, 12, 18)
    w.add_tris("RefractiveSphere", sv, st)
    return w


def big_mesh() -> ObjWriter:
    """99,916 triangles: a 224 x 224 displaced sphere in the Cornell shell."""
    w = ObjWriter()
    cornell_shell(w)
    sv, st = displaced_sphere(278, 220, 280, 160, 224, 224)
    w.add_tris("GreyDiffuse", sv, st)
    return w


SCENES = {"cornell_box_mixed": cornell_box_mixed, "big_mesh": big_mesh}


def _write_atomic(path: pathlib.Path, text: str) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def ensure(scene: str, directory) -> pathlib.Path:
    """``directory/<scene>.obj`` (and its ``cornell.mtl``), written once."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    mtl = directory / "cornell.mtl"
    if not mtl.exists():
        _write_atomic(mtl, MTL)
    obj = directory / f"{scene}.obj"
    if not obj.exists():
        _write_atomic(obj, SCENES[scene]().text("cornell.mtl"))
    return obj
