"""A plain reader of glTF 2.0 documents and PNG images for the Whitted
reference, written from the two specifications alone: the JSON document,
base64 ``data:`` and external buffers, accessors, the node hierarchy's
TRS and matrix transforms, PBR metallic-roughness materials, textures and
samplers, and ``KHR_lights_punctual`` point lights. It keeps every mesh
instance as a world transform and leaves flattening to its caller.

What the reference does not cover raises ``NotImplementedError`` naming
the feature: binary ``.glb`` files, sparse accessors, meshes other than
triangle lists, ``EXT_mesh_gpu_instancing``, texture coordinate sets past
0, normal, metallic-roughness and emissive textures,
``KHR_texture_transform`` and every material extension, lights other than
point lights, a scene without lights, and analytic primitives or curves
declared in the document's ``extras``.
"""

from __future__ import annotations

import base64
import json
import math
import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
          5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}
REPEAT = 10497
ALPHA_MODES = ("OPAQUE", "MASK", "BLEND")


# -- PNG -----------------------------------------------------------------------------

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def read_png(data: bytes) -> np.ndarray:
    """A non-interlaced 8-bit PNG (gray, gray and alpha, RGB or RGBA) as
    uint8 [h, w, channels]: the IDAT stream inflated, then each row
    unfiltered by its filter type (0 none, 1 sub, 2 up, 3 average, 4 Paeth)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise NotImplementedError(f"PNG of bit depth {depth}, colour type {color}, "
                                  f"interlace {interlace}")
    raw = zlib.decompress(idat)
    stride = w * channels
    out = np.zeros((h, stride), np.int64)
    prior = [0] * stride
    for y in range(h):
        kind = raw[y * (stride + 1)]
        line = list(raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)])
        for x in range(stride):
            a = line[x - channels] if x >= channels else 0
            b = prior[x]
            c = prior[x - channels] if x >= channels else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            line[x] = (line[x] + pred) & 0xFF
        out[y] = line
        prior = line
    return out.astype(np.uint8).reshape(h, w, channels)


# -- the document ----------------------------------------------------------------------

@dataclass
class Material:
    base_color: tuple                    # RGBA factor
    metallic: float
    roughness: float
    emissive: tuple
    alpha_mode: str                      # OPAQUE, MASK or BLEND
    alpha_cutoff: float
    texture: int = -1                    # base-colour texture, -1 = none


@dataclass
class Texture:
    rgba: np.ndarray                     # float32 [h, w, 4] in [0, 1]
    wrap_s: int = REPEAT
    wrap_t: int = REPEAT


@dataclass
class Document:
    """Every mesh instance as (mesh, world 4x4), the meshes' triangle
    primitives (positions, [t, 3] indices, normals or None, UVs, material),
    the materials and textures, and the point lights (position, colour x
    intensity)."""
    instances: list = field(default_factory=list)
    meshes: list = field(default_factory=list)
    materials: list = field(default_factory=list)
    textures: list = field(default_factory=list)
    lights: list = field(default_factory=list)


def _trs(node: dict) -> np.ndarray:
    """A node's local transform, float64 [4, 4]: T * R * S, or its matrix."""
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    m[:3, :3] = np.diag(node.get("scale", [1.0, 1.0, 1.0]))
    x, y, z, w = node.get("rotation", [0.0, 0.0, 0.0, 1.0])
    n = math.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    rot = np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                    [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                    [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    m[:3, :3] = rot @ m[:3, :3]
    m[:3, 3] = node.get("translation", [0.0, 0.0, 0.0])
    return m


class _Reader:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] == b"glTF":
            raise NotImplementedError("binary glTF (.glb)")
        self.doc = json.loads(data)
        self.dir = os.path.dirname(os.path.abspath(path))
        self._buffers = {}

    def _uri(self, uri: str) -> bytes:
        if uri.startswith("data:"):
            return base64.b64decode(uri.split(",", 1)[1])
        with open(os.path.join(self.dir, uri), "rb") as f:
            return f.read()

    def buffer(self, i: int) -> bytes:
        if i not in self._buffers:
            self._buffers[i] = self._uri(self.doc["buffers"][i]["uri"])
        return self._buffers[i]

    def accessor(self, i: int) -> np.ndarray:
        a = self.doc["accessors"][i]
        if "sparse" in a:
            raise NotImplementedError("sparse accessors")
        dtype, ncomp, n = _CTYPE[a["componentType"]], _NCOMP[a["type"]], a["count"]
        view = self.doc["bufferViews"][a["bufferView"]]
        data = self.buffer(view["buffer"])
        start = view.get("byteOffset", 0) + a.get("byteOffset", 0)
        size = np.dtype(dtype).itemsize * ncomp
        stride = view.get("byteStride", size)
        out = np.stack([np.frombuffer(data, dtype, ncomp, start + k * stride)
                        for k in range(n)]) if stride != size else \
            np.frombuffer(data, dtype, n * ncomp, start).reshape(n, ncomp)
        if a.get("normalized") and dtype != np.float32:
            out = np.maximum(out.astype(np.float64) / np.iinfo(dtype).max, -1.0)
        return out

    def image(self, i: int) -> np.ndarray:
        img = self.doc["images"][i]
        if "uri" not in img:
            view = self.doc["bufferViews"][img["bufferView"]]
            off = view.get("byteOffset", 0)
            blob = self.buffer(view["buffer"])[off:off + view["byteLength"]]
        else:
            blob = self._uri(img["uri"])
        px = read_png(bytes(blob))
        rgba = np.ones((*px.shape[:2], 4), np.float32)
        if px.shape[2] <= 2:                          # gray (and alpha)
            rgba[..., :3] = px[..., :1] / np.float32(255.0)
            rgba[..., 3:3 + px.shape[2] - 1] = px[..., 1:] / np.float32(255.0)
        else:
            rgba[..., :px.shape[2]] = px / np.float32(255.0)
        return rgba


def read(path: str) -> Document:
    """The document at ``path`` (a ``.gltf`` file)."""
    r = _Reader(path)
    doc = r.doc
    extras = doc.get("extras", {})
    for key in ("tpu_pt_primitives", "tpu_pt_curves"):
        if extras.get(key):
            raise NotImplementedError(f"analytic geometry in extras ({key})")
    out = Document()
    for mesh in doc.get("meshes", []):
        prims = []
        for p in mesh["primitives"]:
            if p.get("mode", 4) != 4:
                raise NotImplementedError(f"primitive mode {p['mode']} (triangle lists only)")
            attrs = p["attributes"]
            if any(k.startswith("TEXCOORD_") and k != "TEXCOORD_0" for k in attrs):
                raise NotImplementedError("texture coordinate sets past TEXCOORD_0")
            pos = r.accessor(attrs["POSITION"]).astype(np.float64)
            idx = (r.accessor(p["indices"]).reshape(-1).astype(np.int64) if "indices" in p
                   else np.arange(pos.shape[0]))
            nrm = r.accessor(attrs["NORMAL"]).astype(np.float64) if "NORMAL" in attrs else None
            uv = (r.accessor(attrs["TEXCOORD_0"]).astype(np.float64) if "TEXCOORD_0" in attrs
                  else np.zeros((pos.shape[0], 2)))
            prims.append((pos, idx.reshape(-1, 3), nrm, uv, p.get("material", 0)))
        out.meshes.append(prims)

    textures = {}

    def texture(info: dict) -> int:
        if info.get("texCoord", 0) != 0:
            raise NotImplementedError("texture coordinate sets past TEXCOORD_0")
        if "KHR_texture_transform" in info.get("extensions", {}):
            raise NotImplementedError("KHR_texture_transform")
        tex = doc["textures"][info["index"]]
        key = (tex["source"], tex.get("sampler", -1))
        if key not in textures:
            s = doc["samplers"][key[1]] if key[1] >= 0 else {}
            textures[key] = len(out.textures)
            out.textures.append(Texture(r.image(key[0]), s.get("wrapS", REPEAT),
                                        s.get("wrapT", REPEAT)))
        return textures[key]

    for m in doc.get("materials") or [{}]:
        for key in ("normalTexture", "emissiveTexture", "occlusionTexture"):
            if key in m:
                raise NotImplementedError(key)
        if m.get("extensions"):
            raise NotImplementedError(f"material extensions {sorted(m['extensions'])}")
        pbr = m.get("pbrMetallicRoughness", {})
        if "metallicRoughnessTexture" in pbr:
            raise NotImplementedError("metallicRoughnessTexture")
        out.materials.append(Material(
            base_color=tuple(pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            roughness=float(pbr.get("roughnessFactor", 1.0)),
            emissive=tuple(m.get("emissiveFactor", [0.0, 0.0, 0.0])),
            alpha_mode=m.get("alphaMode", "OPAQUE"),
            alpha_cutoff=float(m.get("alphaCutoff", 0.5)),
            texture=texture(pbr["baseColorTexture"]) if "baseColorTexture" in pbr else -1))
        if out.materials[-1].alpha_mode not in ALPHA_MODES:
            raise ValueError(f"alpha mode {out.materials[-1].alpha_mode!r}")

    lights = doc.get("extensions", {}).get("KHR_lights_punctual", {}).get("lights", [])

    def walk(i: int, parent: np.ndarray) -> None:
        node = doc["nodes"][i]
        world = parent @ _trs(node)
        ext = node.get("extensions", {})
        if "EXT_mesh_gpu_instancing" in ext:
            raise NotImplementedError("EXT_mesh_gpu_instancing")
        if "mesh" in node:
            out.instances.append((node["mesh"], world))
        if "KHR_lights_punctual" in ext:
            light = lights[ext["KHR_lights_punctual"]["light"]]
            if light.get("type") != "point":
                raise NotImplementedError(f"{light.get('type')} lights")
            color = np.asarray(light.get("color", [1.0, 1.0, 1.0]), np.float64)
            out.lights.append((world[:3, 3].copy(), color * float(light.get("intensity", 1.0))))
        for child in node.get("children", []):
            walk(child, world)

    roots = (doc["scenes"][doc.get("scene", 0)]["nodes"] if doc.get("scenes")
             else range(len(doc.get("nodes", []))))
    for i in roots:
        walk(i, np.eye(4))
    if not out.lights:
        raise NotImplementedError("a scene without point lights (the default lights)")
    return out
