"""The benchmark's frozen copy of the repository's glTF generator
(``tools/make_gltf_assets.py``'s ``build_foliage``, ``build_forest`` and
``build_alpha`` with the meshes and textures they need), written byte for
byte as that tool writes them at its default sizes, from numpy, ``json``
and ``zlib`` alone.

- ``foliage``: a trunk cone and a canopy of six crossed leaf cards
  (``leaf.png``, alpha MASK at 0.5) instanced ``n_trees`` times (300) over
  a 200 x 200 ground plane, one point light;
- ``forest``: a trunk cone and a sphere canopy, both opaque, instanced
  ``n_trees`` times (500) over a 240 x 240 ground plane, one point light;
- ``alpha_shadow``: three quads over a ground plane (textured BLEND,
  textured MASK, untextured BLEND; ``alpha.png``) under one point light.

``ensure(scene, directory, n_trees=None)`` writes ``<scene>.gltf`` (at a
tree count other than the default ``<scene>_<n_trees>.gltf``) and its
texture into ``directory`` unless they are there, through temporary names
renamed into place, and returns the document's path.
"""

from __future__ import annotations

import base64
import json
import math
import os
import pathlib
import struct
import zlib

import numpy as np


# -- meshes ------------------------------------------------------------------------

def sphere(r=1.0, n_lat=16, n_lon=24):
    verts, norms, uvs, idx = [], [], [], []
    for i in range(n_lat + 1):
        th = math.pi * i / n_lat
        for j in range(n_lon + 1):
            ph = 2 * math.pi * j / n_lon
            n = (math.sin(th) * math.cos(ph), math.cos(th),
                 math.sin(th) * math.sin(ph))
            verts.append(tuple(r * c for c in n))
            norms.append(n)
            uvs.append((j / n_lon, i / n_lat))
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * (n_lon + 1) + j
            b = a + n_lon + 1
            idx.extend([a, b, a + 1, a + 1, b, b + 1])
    return (np.array(verts, np.float32), np.array(norms, np.float32),
            np.array(uvs, np.float32), np.array(idx, np.uint16))


def plane(size=10.0):
    s = size / 2
    verts = np.array([(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)], np.float32)
    norms = np.array([(0, 1, 0)] * 4, np.float32)
    uvs = np.array([(0, 0), (4, 0), (4, 4), (0, 4)], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    return verts, norms, uvs, idx


def uquad(size=1.0):
    """Horizontal unit-UV quad facing +Y (u grows along +x)."""
    s = size / 2
    verts = np.array([(-s, 0, -s), (s, 0, -s), (s, 0, s), (-s, 0, s)], np.float32)
    norms = np.array([(0, 1, 0)] * 4, np.float32)
    uvs = np.array([(0, 0), (1, 0), (1, 1), (0, 1)], np.float32)
    idx = np.array([0, 2, 1, 0, 3, 2], np.uint16)
    return verts, norms, uvs, idx


def vquad(size=1.0, y0=0.0):
    """Vertical unit-UV quad in the XZ=0 plane, facing +Z, base at y0."""
    s = size / 2
    verts = np.array([(-s, y0, 0), (s, y0, 0), (s, y0 + size, 0),
                      (-s, y0 + size, 0)], np.float32)
    norms = np.array([(0, 0, 1)] * 4, np.float32)
    uvs = np.array([(0, 1), (1, 1), (1, 0), (0, 0)], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint16)
    return verts, norms, uvs, idx


def crossed_leaves(n_cards=6, size=3.2, y0=3.4):
    """Foliage canopy: n vertical leaf cards crossed around +Y."""
    vs, ns, uvs, idx = [], [], [], []
    base = 0
    for i in range(n_cards):
        a = math.pi * i / n_cards
        c, s = math.cos(a), math.sin(a)
        v, n, uv, ix = vquad(size, y0)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        vs.append(v @ r.T)
        ns.append(n @ r.T)
        uvs.append(uv)
        idx.append(ix.astype(np.int64) + base)
        base += v.shape[0]
    return (np.concatenate(vs), np.concatenate(ns), np.concatenate(uvs),
            np.concatenate(idx).astype(np.uint16))


def cone(r=0.3, h=2.0, n=16):
    """Open cone (trunk): n side triangles + base fan."""
    verts = [(0.0, h, 0.0), (0.0, 0.0, 0.0)]
    for i in range(n):
        a = 2 * math.pi * i / n
        verts.append((r * math.cos(a), 0.0, r * math.sin(a)))
    idx = []
    for i in range(n):
        j = 2 + i
        k = 2 + (i + 1) % n
        idx += [0, k, j]          # side
        idx += [1, j, k]          # base
    v = np.array(verts, np.float32)
    norms = np.zeros_like(v)
    norms[:, 1] = 1.0
    uvs = np.zeros((v.shape[0], 2), np.float32)
    return v, norms, uvs, np.array(idx, np.uint16)


# -- textures ------------------------------------------------------------------------

def png_bytes(img: np.ndarray) -> bytes:
    """An 8-bit RGB or RGBA PNG, as the repository's PNG writer makes it."""
    img = np.ascontiguousarray(np.asarray(img, np.uint8))
    h, w, c = img.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        data = tag + payload
        return (struct.pack(">I", len(payload)) + data
                + struct.pack(">I", zlib.crc32(data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def leaf_png(res=64) -> bytes:
    """Leaf card: green RGB, alpha a centred disc (255 inside radius 0.45,
    0 outside)."""
    img = np.zeros((res, res, 4), np.uint8)
    img[..., 0], img[..., 1], img[..., 2] = 40, 150, 45
    yy, xx = np.mgrid[0:res, 0:res]
    u = (xx + 0.5) / res - 0.5
    v = (yy + 0.5) / res - 0.5
    img[..., 3] = np.where(u * u + v * v < 0.45 ** 2, 255, 0)
    return png_bytes(img)


def alpha_png(res=64) -> bytes:
    """White RGB, alpha 0.2 on the left half (u < 0.5), 0.8 on the right."""
    img = np.full((res, res, 4), 255, np.uint8)
    img[:, : res // 2, 3] = 51
    img[:, res // 2:, 3] = 204
    return png_bytes(img)


# -- documents -----------------------------------------------------------------------

class _Buffer:
    """One embedded buffer, its views and accessors, in the tool's order."""

    def __init__(self):
        self.blob = b""
        self.views, self.accessors = [], []

    def accessor(self, arr, target, ctype, atype) -> int:
        off = len(self.blob)
        self.blob += arr.tobytes()
        while len(self.blob) % 4:
            self.blob += b"\0"
        self.views.append(dict(buffer=0, byteOffset=off, byteLength=arr.nbytes,
                               target=target))
        acc = dict(bufferView=len(self.views) - 1, componentType=ctype,
                   count=arr.shape[0], type=atype)
        if atype == "VEC3":
            acc["min"] = [float(x) for x in arr.min(axis=0)]
            acc["max"] = [float(x) for x in arr.max(axis=0)]
        self.accessors.append(acc)
        return len(self.accessors) - 1

    def primitive(self, mesh) -> dict:
        v, n, uv, idx = mesh
        pos_a = self.accessor(v, 34962, 5126, "VEC3")
        nrm_a = self.accessor(n, 34962, 5126, "VEC3")
        uv_a = self.accessor(uv, 34962, 5126, "VEC2")
        idx_a = self.accessor(idx.reshape(-1, 1), 34963, 5123, "SCALAR")
        return dict(attributes=dict(POSITION=pos_a, NORMAL=nrm_a, TEXCOORD_0=uv_a),
                    indices=idx_a)

    def buffers(self) -> list:
        return [dict(byteLength=len(self.blob),
                     uri="data:application/octet-stream;base64,"
                         + base64.b64encode(self.blob).decode())]


_GROUND = dict(name="Ground", pbrMetallicRoughness=dict(
    baseColorFactor=[0.35, 0.32, 0.25, 1.0], metallicFactor=0.0, roughnessFactor=0.95))
_BARK = dict(name="Bark", pbrMetallicRoughness=dict(
    baseColorFactor=[0.32, 0.2, 0.1, 1.0], metallicFactor=0.0, roughnessFactor=0.9))
_LIGHT = dict(KHR_lights_punctual=dict(lights=[
    dict(type="point", color=[1.0, 0.98, 0.9], intensity=4.0)]))


def _trees(n_trees, seed, spread, scale, child):
    """The ground node, ``n_trees`` tree nodes placed from ``seed`` with a
    child each (``child(tree node index)``), and the scene's root list."""
    rng = np.random.RandomState(seed)
    nodes = [dict(mesh=0, name="ground")]
    tree_nodes = []
    for i in range(n_trees):
        x = float(rng.uniform(-spread, spread))
        z = float(rng.uniform(-spread, spread))
        s = float(rng.uniform(*scale))
        a = float(rng.uniform(0, math.pi))
        nodes.append(dict(mesh=1, name=f"tree{i}", translation=[x, 0.0, z],
                          rotation=[0.0, math.sin(a / 2), 0.0, math.cos(a / 2)],
                          scale=[s, s, s], children=[]))
        tree_nodes.append(len(nodes) - 1)
    for ti in tree_nodes:
        nodes.append(child(ti))
        nodes[ti]["children"] = [len(nodes) - 1]
    return nodes, tree_nodes


def foliage(n_trees=300, seed=11) -> tuple[dict, dict]:
    """(document, {texture file: bytes}) of ``foliage.gltf``."""
    buf = _Buffer()
    prims = [buf.primitive(m) for m in (plane(200.0), cone(0.5, 3.6, 10),
                                        crossed_leaves())]
    meshes = [dict(name=name, primitives=[dict(**p, material=k)])
              for k, (name, p) in enumerate(zip(("ground", "trunk", "leaves"), prims))]
    materials = [_GROUND, _BARK, dict(
        name="Leaves", alphaMode="MASK", alphaCutoff=0.5, doubleSided=True,
        pbrMetallicRoughness=dict(baseColorFactor=[1.0, 1.0, 1.0, 1.0],
                                  baseColorTexture=dict(index=0),
                                  metallicFactor=0.0, roughnessFactor=0.8))]
    nodes, tree_nodes = _trees(n_trees, seed, 90, (0.7, 1.5),
                               lambda ti: dict(mesh=2, name=f"leaves_of_{ti}"))
    nodes.append(dict(name="light", translation=[50.0, 80.0, 30.0],
                      extensions=dict(KHR_lights_punctual=dict(light=0))))
    doc = dict(
        asset=dict(version="2.0", generator="tpu_pt make_gltf_assets"), scene=0,
        scenes=[dict(nodes=[0] + tree_nodes + [len(nodes) - 1])],
        nodes=nodes, meshes=meshes, materials=materials,
        textures=[dict(source=0, sampler=0)],
        samplers=[dict(wrapS=33071, wrapT=33071)],
        images=[dict(uri="leaf.png")],
        buffers=buf.buffers(), bufferViews=buf.views, accessors=buf.accessors,
        extensions=_LIGHT, extensionsUsed=["KHR_lights_punctual"])
    return doc, {"leaf.png": leaf_png()}


def forest(n_trees=500, seed=9) -> tuple[dict, dict]:
    """(document, {}) of ``forest.gltf``."""
    buf = _Buffer()
    prims = [buf.primitive(m) for m in (plane(240.0), cone(0.5, 4.0, 12),
                                        sphere(1.8, 16, 30))]
    meshes = [dict(name=name, primitives=[dict(**p, material=k)])
              for k, (name, p) in enumerate(zip(("ground", "trunk", "canopy"), prims))]
    materials = [_GROUND, _BARK, dict(name="Leaves", pbrMetallicRoughness=dict(
        baseColorFactor=[0.12, 0.4, 0.12, 1.0], metallicFactor=0.0, roughnessFactor=0.8))]
    nodes, tree_nodes = _trees(
        n_trees, seed, 110, (0.6, 1.6),
        lambda ti: dict(mesh=2, name=f"canopy_of_{ti}", translation=[0.0, 4.6, 0.0]))
    nodes.append(dict(name="light", translation=[60.0, 90.0, 40.0],
                      extensions=dict(KHR_lights_punctual=dict(light=0))))
    doc = dict(
        asset=dict(version="2.0", generator="tpu_pt make_gltf_assets"), scene=0,
        scenes=[dict(nodes=[0] + tree_nodes + [len(nodes) - 1])],
        nodes=nodes, meshes=meshes, materials=materials,
        buffers=buf.buffers(), bufferViews=buf.views, accessors=buf.accessors,
        extensions=_LIGHT, extensionsUsed=["KHR_lights_punctual"])
    return doc, {}


def alpha_shadow() -> tuple[dict, dict]:
    """(document, {texture file: bytes}) of ``alpha_shadow.gltf``."""
    buf = _Buffer()
    prims = [buf.primitive(m) for m in (plane(12.0), uquad(2.0))]
    # One mesh per material so instances of the quad can differ.
    meshes = [dict(primitives=[dict(**prims[0 if mat == 0 else 1], material=mat)])
              for mat in range(4)]

    def pbr(base, tex=False):
        p = dict(baseColorFactor=base)
        if tex:
            p["baseColorTexture"] = dict(index=0)
        return dict(p, metallicFactor=0.0, roughnessFactor=0.5)
    materials = [
        dict(name="Ground", pbrMetallicRoughness=dict(
            baseColorFactor=[0.85, 0.85, 0.85, 1.0], metallicFactor=0.0,
            roughnessFactor=0.9)),
        dict(name="BlendTex", alphaMode="BLEND",
             pbrMetallicRoughness=pbr([0.9, 0.9, 1.0, 0.9], True)),
        dict(name="MaskTex", alphaMode="MASK", alphaCutoff=0.5,
             pbrMetallicRoughness=pbr([1.0, 0.9, 0.9, 1.0], True)),
        dict(name="BlendPlain", alphaMode="BLEND",
             pbrMetallicRoughness=pbr([0.2, 0.4, 0.9, 0.35])),
    ]
    nodes = [
        dict(mesh=0, name="ground"),
        dict(mesh=1, translation=[-3.0, 1.5, 0.0], name="blendtex"),
        dict(mesh=1, translation=[-3.0, 0.8, 0.0], name="blendtex2"),
        dict(mesh=2, translation=[0.0, 1.5, 0.0], name="masktex"),
        dict(mesh=3, translation=[3.0, 1.5, 0.0], name="blendplain"),
        dict(name="light", translation=[0.0, 30.0, 0.0],
             extensions=dict(KHR_lights_punctual=dict(light=0))),
    ]
    doc = dict(
        asset=dict(version="2.0", generator="tpu_pt make_gltf_assets"), scene=0,
        scenes=[dict(nodes=list(range(len(nodes))))],
        nodes=nodes, meshes=meshes, materials=materials,
        textures=[dict(source=0)], images=[dict(uri="alpha.png")], samplers=[],
        buffers=buf.buffers(), bufferViews=buf.views, accessors=buf.accessors,
        extensions=dict(KHR_lights_punctual=dict(lights=[
            dict(type="point", color=[1.0, 1.0, 1.0], intensity=5.0)])),
        extensionsUsed=["KHR_lights_punctual"])
    return doc, {"alpha.png": alpha_png()}


SCENES = {"foliage": (foliage, 300), "forest": (forest, 500),
          "alpha_shadow": (alpha_shadow, None)}


def _write_atomic(path: pathlib.Path, data: bytes) -> None:
    tmp = path.with_name(f".{path.name}.{os.getpid()}.tmp")
    tmp.write_bytes(data)
    os.replace(tmp, path)


def ensure(scene: str, directory, n_trees: int | None = None) -> pathlib.Path:
    """``directory/<scene>.gltf`` (``<scene>_<n_trees>.gltf`` at another
    tree count) and its texture, written once."""
    if scene not in SCENES:
        raise SystemExit(f"no glTF scene {scene!r} ({', '.join(SCENES)})")
    build, default_trees = SCENES[scene]
    if n_trees is not None and default_trees is None:
        raise SystemExit(f"glTF scene {scene!r} takes no n_trees")
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    n = default_trees if n_trees is None else int(n_trees)
    name = scene if n == default_trees else f"{scene}_{n}"
    path = directory / f"{name}.gltf"
    if not path.exists():
        doc, files = build() if default_trees is None else build(n)
        for fname, data in files.items():
            if not (directory / fname).exists():
                _write_atomic(directory / fname, data)
        _write_atomic(path, json.dumps(doc).encode())
    return path
