"""glTF 2.0 scene loader for the Whitted pipeline (counterpart of
``tpu_pt/scene/gltf.py``; the reference's ``sutil::Scene`` input path,
``sutil/Scene.cpp:125-550``).

Buffers (external files, data: URIs, GLB chunks), strided and sparse
accessors, triangle meshes with POSITION / NORMAL / TEXCOORD_0, node TRS
or matrix hierarchies, ``EXT_mesh_gpu_instancing``, PBR
metallic-roughness materials with PNG textures, ``KHR_texture_transform``,
alpha modes, ``KHR_lights_punctual`` point lights, the first perspective
camera, and analytic primitives and swept-sphere curves declared in the
document's ``extras`` (``tpu_pt_primitives`` / ``tpu_pt_curves``, with glTF
material indices). The host build runs in numpy with the JAX package's
operations, so both loaders hold the same tables.

Geometry contracts (``instancing``):

- ``"flatten"``: instances are transformed into world space at load; one
  table covers the scene (the path tracer's kernels).
- ``"instanced"``: the unique meshes stay in mesh space and the instances
  become an ``intersect.instanced.InstanceTable`` (the two-level kernels
  K9/K10). Memory is O(unique mesh + instances).
- ``"auto"`` (default): instanced for an eligible asset whose flatten
  would pass ``max_flat_tris``, or whose instancing amplifies the unique
  triangles at least ``INST_AUTO_AMP`` times at ``INST_AUTO_MIN`` or
  more flattened triangles; flatten otherwise. The thresholds are the
  JAX package's defaults, so both packages pick the same contract.

The flattened tables carry their LBVH (``intersect.lbvh``), as the JAX
loader's do. Textures are PNG, JPEG or PPM images.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import struct as pystruct

import numpy as np
import torch

from .. import film
from .. import mathlib as ml
from ..intersect import instanced
from .arrays import (BSDF_DIFFUSE, BSDF_REFRACTION, SceneArrays,
                     build_scene_arrays, default_cornell_light,
                     scene_from_numpy)

# Component types (glTF spec).
_CTYPE = {5120: np.int8, 5121: np.uint8, 5122: np.int16, 5123: np.uint16,
          5125: np.uint32, 5126: np.float32}
_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}

# Material kinds (cuda/MaterialData.h tagged union).
KIND_PBR = 0
KIND_GLASS = 1
KIND_PHONG = 2
KIND_CHECKER = 3

# Alpha modes (MaterialData::AlphaMode).
ALPHA_OPAQUE = 0
ALPHA_MASK = 1
ALPHA_BLEND = 2

# Flattened-triangle bound of the "flatten" contract (~1.3 GB of tables in
# the JAX package); a scene whose instancing expands past it raises.
MAX_FLAT_TRIS = 4_000_000
# "auto" picks the instanced contract at this instancing amplification
# and at least this many flattened triangles.
INST_AUTO_AMP = 8.0
INST_AUTO_MIN = 32768
# Most closest-hit steps of the fractional alpha-shadow march.
ALPHA_MARCH_MAX = 8

_PRIM_KINDS = {"sphere": 0, "parallelogram": 1, "sphere_shell": 2}


def _move(x, device):
    return x.to(device) if x is not None else None


@dataclasses.dataclass
class AlphaOccluders:
    """Fractional shadow-ray split (``__anyhit__occlusion``,
    ``cuda/whitted.cu:113-138``; ``tpu_pt.scene.gltf.AlphaOccluders``).

    Textured non-opaque occluders pass a fraction of the light; every
    other surface stops a shadow ray. ``occ_geom`` holds the scene
    without the alpha-class triangles (a boolean sweep), ``geom`` only the
    alpha-class ones, marched closest hit by closest hit at most
    ``max_hits`` times (``whitted._make_occlusion``). ``uv`` [Ta_pad, 6]
    holds the subset's per-vertex UVs. ``occ_inst`` / ``inst`` are the
    subsets' instance tables on instanced scenes, else None."""
    occ_geom: SceneArrays
    geom: SceneArrays
    uv: torch.Tensor
    max_hits: int = 4
    occ_inst: instanced.InstanceTable | None = None
    inst: instanced.InstanceTable | None = None

    def to(self, device) -> "AlphaOccluders":
        return dataclasses.replace(
            self, occ_geom=self.occ_geom.to(device),
            geom=self.geom.to(device), uv=self.uv.to(device),
            occ_inst=_move(self.occ_inst, device),
            inst=_move(self.inst, device))


@dataclasses.dataclass
class WhittedScene:
    """Scene of the Whitted pipeline (``tpu_pt.scene.gltf.WhittedScene``).

    ``geom`` is the path tracer's SceneArrays (every intersector takes
    it); the rest is what Whitted shading needs: per-triangle vertex
    attributes and the PBR / glass / Phong material tables
    (``cuda/MaterialData.h``), textures, point lights and the ambient
    term. With ``inst`` set, ``geom`` and the per-triangle tables hold the
    unique meshes in mesh space."""
    geom: SceneArrays
    # [T, 16]: n0 xyz, n1 xyz, n2 xyz, uv0, uv1, uv2 (2 each), pad.
    vtx_attr: torch.Tensor
    base_color: torch.Tensor    # [M, 4] rgba factor
    metallic: torch.Tensor      # [M]
    roughness: torch.Tensor     # [M]
    emissive: torch.Tensor      # [M, 3]
    kind: torch.Tensor          # [M] i32 (KIND_*)
    alpha_mode: torch.Tensor    # [M] i32
    alpha_cutoff: torch.Tensor  # [M]
    ior: torch.Tensor           # [M] (glass)
    phong_ks: torch.Tensor      # [M, 3]
    phong_exp: torch.Tensor     # [M]
    phong_kr: torch.Tensor      # [M, 3] reflectivity
    # CheckerPhong's second set: Kd2 xyz, Ks2 xyz, Kr2 xyz, phong_exp2,
    # inverse checker size u, v.
    checker2: torch.Tensor      # [M, 12]
    tex_id: torch.Tensor        # [M] i32 base-color texture, -1 = none
    tex_uvx: torch.Tensor       # [M, 6] UV affine (m00 m01 ou m10 m11 ov)
    ntex_id: torch.Tensor       # [M] i32 normal map, -1 = none
    ntex_scale: torch.Tensor    # [M]
    mrtex_id: torch.Tensor      # [M] i32 metallic-roughness, -1 = none
    etex_id: torch.Tensor       # [M] i32 emissive, -1 = none
    tri_tangent: torch.Tensor   # [T, 3] UV-space tangent per triangle
    light_pos: torch.Tensor     # [L, 3] point lights
    light_color: torch.Tensor   # [L, 3] intensity-scaled
    ambient: torch.Tensor       # [3]
    textures: tuple             # [h, w, 4] f32 tensors
    # Per texture (wrapS, wrapT) GL enums: 10497 REPEAT, 33071
    # CLAMP_TO_EDGE, 33648 MIRRORED_REPEAT.
    tex_wrap: tuple = ()
    has_normal_maps: bool = True
    has_mr_tex: bool = True
    has_emissive_tex: bool = True
    # First perspective camera: (eye, lookat, up, fov_y degrees), or ().
    camera: tuple = ()
    alpha_occ: AlphaOccluders | None = None
    inst: instanced.InstanceTable | None = None

    @property
    def device(self) -> torch.device:
        return self.geom.device

    def to(self, device) -> "WhittedScene":
        """A copy with every tensor on ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            if f.name == "textures":
                val = tuple(t.to(device) for t in val)
            elif isinstance(val, (torch.Tensor, SceneArrays, AlphaOccluders,
                                  instanced.InstanceTable)):
                val = val.to(device)
            kw[f.name] = val
        return WhittedScene(**kw)

    def world_bounds(self):
        """(lo, hi) world-space scene box as numpy [3] arrays: the
        triangles' for a flattened scene, the union of the instances'
        world boxes for an instanced one."""
        if self.inst is not None:
            bx = self.inst.boxes[:self.inst.count].cpu().numpy()
            return bx[:, 0:3].min(axis=0), bx[:, 3:6].max(axis=0)
        g = self.geom
        v = g.tri_v0.cpu().numpy()[g.tri_valid.cpu().numpy()]
        return v.min(axis=0), v.max(axis=0)


def _default_whitted_tables(n_mats: int) -> dict:
    return dict(
        base_color=np.tile(np.array([0.8, 0.8, 0.8, 1.0], np.float32),
                           (n_mats, 1)),
        metallic=np.zeros(n_mats, np.float32),
        roughness=np.full(n_mats, 0.5, np.float32),
        emissive=np.zeros((n_mats, 3), np.float32),
        kind=np.full(n_mats, KIND_PBR, np.int32),
        alpha_mode=np.zeros(n_mats, np.int32),
        alpha_cutoff=np.full(n_mats, 0.5, np.float32),
        ior=np.full(n_mats, 1.5, np.float32),
        phong_ks=np.zeros((n_mats, 3), np.float32),
        phong_exp=np.full(n_mats, 32.0, np.float32),
        phong_kr=np.zeros((n_mats, 3), np.float32),
        checker2=np.tile(np.array([0.3] * 3 + [0.0] * 6 + [32.0, 1.0, 1.0],
                                  np.float32), (n_mats, 1)),
        tex_id=np.full(n_mats, -1, np.int32),
        tex_uvx=np.tile(np.array([1, 0, 0, 0, 1, 0], np.float32),
                        (n_mats, 1)),
        ntex_id=np.full(n_mats, -1, np.int32),
        ntex_scale=np.ones(n_mats, np.float32),
        mrtex_id=np.full(n_mats, -1, np.int32),
        etex_id=np.full(n_mats, -1, np.int32),
    )


class _Gltf:
    """Parsed glTF document with buffer and accessor resolution."""

    def __init__(self, path: str):
        self.base_dir = os.path.dirname(os.path.abspath(path))
        with open(path, "rb") as f:
            data = f.read()
        self.bin_chunk = b""
        if data[:4] != b"glTF":
            self.doc = json.loads(data)
            self._buffers = {}
            return
        _, version, _ = pystruct.unpack_from("<III", data, 0)
        if version != 2:
            raise ValueError(f"{path}: GLB version {version}")
        self.doc = None
        off = 12
        while off < len(data):
            clen, ctype = pystruct.unpack_from("<II", data, off)
            chunk = data[off + 8: off + 8 + clen]
            if ctype == 0x4E4F534A:      # JSON
                self.doc = json.loads(chunk.decode())
            elif ctype == 0x004E4942:    # BIN
                self.bin_chunk = chunk
            off += 8 + clen
        if self.doc is None:
            raise ValueError(f"{path}: GLB without a JSON chunk")
        self._buffers = {}

    def buffer(self, idx: int) -> bytes:
        if idx not in self._buffers:
            uri = self.doc["buffers"][idx].get("uri")
            if uri is None:
                data = self.bin_chunk
            elif uri.startswith("data:"):
                data = base64.b64decode(uri.split(",", 1)[1])
            else:
                with open(os.path.join(self.base_dir, uri), "rb") as f:
                    data = f.read()
            self._buffers[idx] = data
        return self._buffers[idx]

    def _bufferview_items(self, bv_idx: int, byte_off: int, n: int,
                          dtype, ncomp: int) -> np.ndarray:
        itemsize = np.dtype(dtype).itemsize * ncomp
        bv = self.doc["bufferViews"][bv_idx]
        data = self.buffer(bv["buffer"])
        start = bv.get("byteOffset", 0) + byte_off
        stride = bv.get("byteStride", itemsize)
        if stride == itemsize:
            return np.frombuffer(data, dtype, n * ncomp, start).reshape(
                n, ncomp)
        out = np.empty((n, ncomp), dtype)
        for i in range(n):
            out[i] = np.frombuffer(data, dtype, ncomp, start + i * stride)
        return out

    def accessor(self, idx: int) -> np.ndarray:
        a = self.doc["accessors"][idx]
        n = a["count"]
        ncomp = _NCOMP[a["type"]]
        dtype = _CTYPE[a["componentType"]]
        if "bufferView" in a:
            out = self._bufferview_items(a["bufferView"],
                                         a.get("byteOffset", 0), n, dtype,
                                         ncomp)
        else:
            # Spec: no bufferView reads as zeros (a sparse accessor's base).
            out = np.zeros((n, ncomp), dtype)
        sp = a.get("sparse")
        if sp:
            si, sv = sp["indices"], sp["values"]
            ids = self._bufferview_items(
                si["bufferView"], si.get("byteOffset", 0), sp["count"],
                _CTYPE[si["componentType"]], 1).reshape(-1).astype(np.int64)
            vals = self._bufferview_items(
                sv["bufferView"], sv.get("byteOffset", 0), sp["count"],
                dtype, ncomp)
            out = out.copy()
            out[ids] = vals
        if a.get("normalized") and dtype != np.float32:
            out = out.astype(np.float32) / np.iinfo(dtype).max
            if np.iinfo(dtype).min < 0:
                # Signed normalized: max(c / imax, -1) (glTF 2.0 3.6.2.2).
                out = np.maximum(out, -1.0)
        return np.ascontiguousarray(out)


def _subset_instance_table(instances, mesh_ranges, sel, tv):
    """Instance table over a triangle subset of the unique meshes (the
    alpha split): the scene's transforms, the subset's cluster ranges
    (subset triangles keep their order, so ranges are exclusive-cumsum
    slices). A mesh whose subset is empty gets a far-point box."""
    sel = np.asarray(sel, bool)
    cum = np.concatenate([[0], np.cumsum(sel)])
    sub_ranges, sub_aabbs = [], []
    for lo, hi in mesh_ranges:
        slo, shi = int(cum[lo]), int(cum[hi])
        sub_ranges.append((slo, shi))
        if shi > slo:
            pts = tv[lo:hi][sel[lo:hi]].reshape(-1, 3)
            sub_aabbs.append((pts.min(axis=0), pts.max(axis=0)))
        else:
            far = np.full(3, 3e37, np.float32)
            sub_aabbs.append((far, far))
    return instanced.build_instance_table(sub_ranges, sub_aabbs, instances)


def _gpu_instance_matrices(g: _Gltf, ext: dict, parent: np.ndarray):
    """``EXT_mesh_gpu_instancing`` -> per-instance world matrices,
    nodeWorld @ T @ R @ S per instance. Rotations may be normalized int8
    or int16. Without TRANSLATION, ROTATION and SCALE (only custom
    instanced attributes) the node is one instance at its own transform;
    accessors of different counts raise."""
    attrs = ext.get("attributes", {})
    if not attrs:
        return []

    def acc(name, width):
        if name not in attrs:
            return None
        a = g.accessor(attrs[name]).reshape(-1, width)
        if a.dtype in (np.int8, np.int16):
            a = np.maximum(a.astype(np.float32)
                           / np.float32(np.iinfo(a.dtype).max), -1.0)
        return a.astype(np.float32)

    tr, rot, sc = acc("TRANSLATION", 3), acc("ROTATION", 4), acc("SCALE", 3)
    counts = {x.shape[0] for x in (tr, rot, sc) if x is not None}
    if not counts:
        return [parent.copy()]
    if len(counts) > 1:
        raise ValueError(f"EXT_mesh_gpu_instancing accessors of different "
                         f"counts {sorted(counts)}")
    out = []
    for i in range(counts.pop()):
        m = ml.mat4_identity()
        if sc is not None:
            m = ml.mat4_scale(sc[i]) @ m
        if rot is not None:
            x, y, z, w = rot[i]            # glTF stores xyzw
            m = ml.quat_to_mat4([w, x, y, z]) @ m
        if tr is not None:
            m = ml.mat4_translate(tr[i]) @ m
        out.append(parent @ m)
    return out


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float32).reshape(4, 4).T
    m = ml.mat4_identity()
    if "scale" in node:
        m = ml.mat4_scale(node["scale"]) @ m
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        m = ml.quat_to_mat4([w, x, y, z]) @ m
    if "translation" in node:
        m = ml.mat4_translate(node["translation"]) @ m
    return m


def _decode_image_bytes(blob: bytes) -> np.ndarray:
    """Sniff and decode an image held in memory (PNG, JPEG or PPM) to
    uint8 [h, w, 3 or 4]; a PNG keeps its alpha (base-color alpha drives
    alpha masking and blending). JPEG is mandatory in glTF core; the
    reference also textures from PPM files."""
    from .. import jpeg
    if blob[:8] == b"\x89PNG\r\n\x1a\n":
        return film.png_rgba(blob)
    if blob[:2] == b"\xff\xd8":
        return jpeg.decode_jpeg(blob)
    if blob[:2] in (b"P6", b"P3"):
        return film.ppm_rgb(blob)
    raise ValueError("unsupported image format (PNG, JPEG or PPM)")


def _decode_image(g: _Gltf, img: dict) -> np.ndarray:
    """Image -> float32 [h, w, 4] in [0, 1]; alpha 1 where the file has
    none."""
    if "uri" in img and not img["uri"].startswith("data:"):
        with open(os.path.join(g.base_dir, img["uri"]), "rb") as f:
            blob = f.read()
    elif "uri" in img:
        blob = base64.b64decode(img["uri"].split(",", 1)[1])
    else:
        bv = g.doc["bufferViews"][img["bufferView"]]
        off = bv.get("byteOffset", 0)
        blob = g.buffer(bv["buffer"])[off: off + bv["byteLength"]]
    px = _decode_image_bytes(bytes(blob))
    rgba = np.ones((*px.shape[:2], 4), np.float32)
    rgba[..., :px.shape[2]] = px.astype(np.float32) / 255.0
    return rgba


def _instancing_eligible(doc, inst_records, mesh_tris):
    """(ok, reason): can the asset keep its instances? Not when it
    declares extras primitives or curves (analytic geometry has no
    mesh-space table), when the instance count or the packed unique-mesh
    rows (counted with the mesh table's padding, ``instanced.table_rows``)
    pass the bounds, or when an instance transform is singular."""
    if doc.get("extras", {}).get("tpu_pt_primitives"):
        return False, "asset declares extras analytic primitives"
    if doc.get("extras", {}).get("tpu_pt_curves"):
        return False, "asset declares extras curves"
    if len(inst_records) > instanced.INST_MAX_INST:
        return False, (f"{len(inst_records)} instances > "
                       f"{instanced.INST_MAX_INST}")
    rows = instanced.table_rows(
        [max(mesh_tris(m), 1) for m in {m for m, _ in inst_records}])
    if rows > instanced.INST_MAX_ROWS:
        return False, (f"unique meshes pack to {rows} rows > "
                       f"{instanced.INST_MAX_ROWS}")
    for _, xf in inst_records:
        if abs(np.linalg.det(np.asarray(xf)[:3, :3])) < 1e-12:
            return False, "singular instance transform"
    return True, None


def load_gltf(path: str, default_lights: bool = True,
              max_flat_tris: int = MAX_FLAT_TRIS, instancing: str = "auto",
              device="cuda") -> WhittedScene:
    """Load a .gltf / .glb file into a WhittedScene on ``device`` (the
    card unless the caller asks for the CPU). ``instancing`` is
    ``"auto"``, ``"flatten"`` or ``"instanced"`` (module docstring);
    ``max_flat_tris`` bounds the flattened triangle count."""
    if instancing not in ("auto", "flatten", "instanced"):
        raise ValueError(f"instancing must be auto|flatten|instanced, "
                         f"got {instancing!r}")
    g = _Gltf(path)
    doc = g.doc
    mesh_cache: dict = {}

    def decoded_mesh(mesh_idx: int):
        """Each mesh's primitives decoded once, shared by its instances."""
        if mesh_idx not in mesh_cache:
            prims = []
            for prim in doc["meshes"][mesh_idx]["primitives"]:
                if prim.get("mode", 4) != 4:
                    continue                     # triangles only
                attrs = prim["attributes"]
                pos = g.accessor(attrs["POSITION"]).astype(np.float32)
                if "indices" in prim:
                    idx = g.accessor(prim["indices"]).reshape(-1).astype(
                        np.int64)
                else:
                    idx = np.arange(pos.shape[0], dtype=np.int64)
                nrm = (g.accessor(attrs["NORMAL"]).astype(np.float32)
                       if "NORMAL" in attrs else None)
                uv = (g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)
                      if "TEXCOORD_0" in attrs
                      else np.zeros((pos.shape[0], 2), np.float32))
                prims.append((pos, idx.reshape(-1, 3), nrm, uv,
                              prim.get("material", 0)))
            mesh_cache[mesh_idx] = prims
        return mesh_cache[mesh_idx]

    def mesh_tris(mesh_idx: int) -> int:
        return sum(p[1].shape[0] for p in decoded_mesh(mesh_idx))

    # --- walk the node hierarchy ------------------------------------------
    inst_records: list = []          # (mesh idx, world 4x4) in walk order
    lights_pos, lights_color, cameras = [], [], []
    ambient = np.array([0.1, 0.1, 0.1], np.float32)

    def walk(node_idx: int, parent: np.ndarray):
        node = doc["nodes"][node_idx]
        xform = parent @ _node_matrix(node)
        if "mesh" in node:
            gpu_ext = node.get("extensions", {}).get(
                "EXT_mesh_gpu_instancing")
            mats = (_gpu_instance_matrices(g, gpu_ext, xform) if gpu_ext
                    else [xform.copy()])
            inst_records.extend((node["mesh"], m) for m in mats)
        if "camera" in node:
            cameras.append((node["camera"], xform.copy()))
        light_ref = node.get("extensions", {}).get(
            "KHR_lights_punctual", {}).get("light")
        if light_ref is not None:
            light = doc["extensions"]["KHR_lights_punctual"]["lights"][
                light_ref]
            color = np.asarray(light.get("color", [1, 1, 1]), np.float32)
            if light.get("type") == "point":
                lights_pos.append(xform[:3, 3].copy())
                lights_color.append(color * float(light.get("intensity",
                                                            1.0)))
        for child in node.get("children", []):
            walk(child, xform)

    roots = (doc["scenes"][doc.get("scene", 0)]["nodes"] if doc.get("scenes")
             else list(range(len(doc.get("nodes", [])))))
    for r in roots:
        walk(r, ml.mat4_identity())

    # --- geometry contract -------------------------------------------------
    flat_total = sum(mesh_tris(m) for m, _ in inst_records)
    use_inst, reason = False, "no mesh instances"
    if instancing != "flatten" and inst_records:
        use_inst, reason = _instancing_eligible(doc, inst_records,
                                                    mesh_tris)
        if instancing == "auto" and use_inst:
            unique_total = sum(mesh_tris(m) for m in {m for m, _ in
                                                      inst_records})
            amp = flat_total / max(unique_total, 1)
            use_inst = (flat_total > max_flat_tris
                        or (amp >= INST_AUTO_AMP
                            and flat_total >= INST_AUTO_MIN))
        if instancing == "instanced" and not use_inst:
            raise ValueError(f"{os.path.basename(path)}: instancing "
                             f"requested but the asset is ineligible: "
                             f"{reason}")
    if not use_inst and flat_total > max_flat_tris:
        raise ValueError(
            f"{os.path.basename(path)}: instance flattening expands to "
            f"{flat_total:,} world-space triangles, past the "
            f"{max_flat_tris:,}-triangle bound; keep the instances with "
            f"load_gltf(instancing='instanced') or raise max_flat_tris")

    tris_v, tris_n, tris_uv, tri_mat = [], [], [], []

    def emit_mesh(mesh_idx: int, xform: np.ndarray):
        for pos, idx, nrm, uv, mat in decoded_mesh(mesh_idx):
            tv = ml.transform_points(xform, pos)[idx]            # [t, 3, 3]
            if nrm is None:
                gn = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
                gn /= np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True),
                                 1e-30)
                tn = np.repeat(gn[:, None, :], 3, axis=1)
            else:
                tn = ml.transform_normals(xform, nrm)[idx]
            tris_v.append(tv)
            tris_n.append(tn)
            tris_uv.append(uv[idx])
            tri_mat.append(np.full(tv.shape[0], mat, np.int64))

    inst_table = None
    if use_inst:
        # Each used mesh once, in mesh space; instances become table rows.
        mesh_slots: dict = {}
        mesh_ranges, mesh_aabbs = [], []
        n_emitted = 0
        for mesh_idx, _ in inst_records:
            if mesh_idx in mesh_slots:
                continue
            emit_mesh(mesh_idx, ml.mat4_identity())
            mesh_slots[mesh_idx] = len(mesh_ranges)
            mesh_ranges.append((n_emitted, n_emitted + mesh_tris(mesh_idx)))
            n_emitted += mesh_tris(mesh_idx)
            pts = np.concatenate([p[0] for p in decoded_mesh(mesh_idx)])
            mesh_aabbs.append((pts.min(axis=0), pts.max(axis=0)))
        slot_records = [(mesh_slots[m], xf) for m, xf in inst_records]
        inst_table = instanced.build_instance_table(mesh_ranges, mesh_aabbs,
                                                    slot_records)
    else:
        for mesh_idx, xform in inst_records:
            emit_mesh(mesh_idx, xform)
    if not tris_v:
        raise ValueError(f"no triangle geometry in {path}")
    tv = np.concatenate(tris_v)
    tn = np.concatenate(tris_n)
    tuv = np.concatenate(tris_uv)
    tmat = np.concatenate(tri_mat)

    # --- materials and textures -------------------------------------------
    gmats = doc.get("materials") or [{}]
    n_m = max(len(gmats), int(tmat.max()) + 1)
    tables = _default_whitted_tables(n_m)
    textures, tex_wraps, tex_cache = [], [], {}

    def load_tex(info) -> int:
        """Texture info -> texture slot, deduplicated by (image, sampler)."""
        tex = doc["textures"][info["index"]]
        key = (tex["source"], tex.get("sampler", -1))
        if key not in tex_cache:
            wrap_s = wrap_t = 10497                  # REPEAT
            if key[1] >= 0:
                s = doc.get("samplers", [])[key[1]]
                wrap_s, wrap_t = s.get("wrapS", 10497), s.get("wrapT", 10497)
            tex_cache[key] = len(textures)
            textures.append(torch.as_tensor(
                _decode_image(g, doc["images"][key[0]])))
            tex_wraps.append((wrap_s, wrap_t))
        return tex_cache[key]

    for i, m in enumerate(gmats):
        pbr = m.get("pbrMetallicRoughness", {})
        tables["base_color"][i] = np.asarray(
            pbr.get("baseColorFactor", [1, 1, 1, 1]), np.float32)
        tables["metallic"][i] = pbr.get("metallicFactor", 1.0)
        tables["roughness"][i] = pbr.get("roughnessFactor", 1.0)
        tables["emissive"][i] = np.asarray(m.get("emissiveFactor", [0, 0, 0]),
                                           np.float32)
        tables["alpha_mode"][i] = {"OPAQUE": ALPHA_OPAQUE, "MASK": ALPHA_MASK,
                                   "BLEND": ALPHA_BLEND}[
            m.get("alphaMode", "OPAQUE")]
        tables["alpha_cutoff"][i] = m.get("alphaCutoff", 0.5)
        bct = pbr.get("baseColorTexture")
        if bct is not None:
            tables["tex_id"][i] = load_tex(bct)
            xf = bct.get("extensions", {}).get("KHR_texture_transform")
            if xf:
                ox, oy = xf.get("offset", [0.0, 0.0])
                sx, sy = xf.get("scale", [1.0, 1.0])
                r = xf.get("rotation", 0.0)
                cr, sr = np.cos(r), np.sin(r)
                # uv' = T R S [u, v, 1] (KHR_texture_transform).
                tables["tex_uvx"][i] = [sx * cr, sy * sr, ox,
                                        -sx * sr, sy * cr, oy]
        mrt = pbr.get("metallicRoughnessTexture")
        if mrt is not None:
            tables["mrtex_id"][i] = load_tex(mrt)   # G roughness, B metallic
        et = m.get("emissiveTexture")
        if et is not None:
            tables["etex_id"][i] = load_tex(et)
        nt = m.get("normalTexture")
        if nt is not None:
            tables["ntex_id"][i] = load_tex(nt)
            tables["ntex_scale"][i] = nt.get("scale", 1.0)

    # --- scene extent, camera and lights ----------------------------------
    if use_inst:
        bx = inst_table.boxes[:inst_table.count].numpy()
        ext_lo, ext_hi = bx[:, 0:3].min(axis=0), bx[:, 3:6].max(axis=0)
    else:
        ext_lo, ext_hi = tv.reshape(-1, 3).min(axis=0), \
            tv.reshape(-1, 3).max(axis=0)
    cam_tuple = ()
    gcams = doc.get("cameras", [])
    for cam_idx, xform in cameras:
        if not 0 <= cam_idx < len(gcams):
            continue                             # dangling reference
        gc = gcams[cam_idx]
        if gc.get("type") != "perspective":
            continue
        eye = xform[:3, 3].astype(np.float32)
        fwd = -xform[:3, 2]
        n_f = np.linalg.norm(fwd)
        fwd = (fwd / n_f if n_f > 0 else np.array([0, 0, -1.0])).astype(
            np.float32)
        fov = float(np.degrees(gc.get("perspective", {}).get(
            "yfov", np.radians(45.0))))
        focal = max(1.0, 0.5 * float(np.linalg.norm(ext_hi - ext_lo)))
        cam_tuple = (tuple(float(x) for x in eye),
                     tuple(float(x) for x in eye + fwd * focal),
                     tuple(float(x) for x in xform[:3, 1].astype(np.float32)),
                     fov)
        break
    if not lights_pos and default_lights:
        # Two default point lights when the scene has none (the reference
        # app's Whitted host setup).
        c = 0.5 * (ext_lo + ext_hi)
        ext = float(np.linalg.norm(ext_hi - ext_lo))
        lights_pos = [c + np.array([0.6, 1.0, 0.4]) * ext,
                      c + np.array([-0.5, 0.8, -0.6]) * ext]
        lights_color = [np.array([0.8, 0.8, 0.8], np.float32),
                        np.array([0.4, 0.4, 0.4], np.float32)]
    # Whitted shadow segments end at the point lights, which may lie
    # outside the scene's box: flattened scenes take them as extra
    # endpoints of the occluder analysis, so one subset serves both
    # pipelines.
    extra = (np.asarray(lights_pos, np.float32)
             if lights_pos and not use_inst else None)

    # --- SceneArrays and per-triangle tables ------------------------------
    n_t = tv.shape[0]
    pt_mats = [dict(diffuse=tuple(tables["base_color"][i, :3]),
                    emission=tuple(tables["emissive"][i]),
                    roughness=float(tables["roughness"][i]),
                    metallic=float(tables["metallic"][i]),
                    ior=float(tables["ior"][i]),
                    bsdf=BSDF_REFRACTION if tables["kind"][i] == KIND_GLASS
                    else BSDF_DIFFUSE)
               for i in range(n_m)]

    def scene_arrays(sel, extra_endpoints):
        verts = tv[sel].reshape(-1, 3)
        idx = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
        return build_scene_arrays(verts, idx, tmat[sel], pt_mats,
                                  light=default_cornell_light("cpu"),
                                  extra_endpoints=extra_endpoints,
                                  device="cpu")

    from ..intersect.lbvh import with_bvh
    everything = np.ones(n_t, bool)
    geom = with_bvh(scene_arrays(everything, extra))
    t_pad = geom.num_tris_padded
    vtx_attr = np.zeros((t_pad, 16), np.float32)
    vtx_attr[:n_t, 0:9] = tn.reshape(n_t, 9)
    vtx_attr[:n_t, 9:15] = tuv.reshape(n_t, 6)
    # UV-space tangent dP/du per triangle: [e1; e2] = [duv1; duv2] [T; B];
    # degenerate UVs take the first edge (orthonormalised at shading).
    e1 = tv[:, 1] - tv[:, 0]
    e2 = tv[:, 2] - tv[:, 0]
    duv1 = tuv[:, 1] - tuv[:, 0]
    duv2 = tuv[:, 2] - tuv[:, 0]
    det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, det, 1.0)
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) / inv_det[:, None]
    tri_tangent = np.zeros((t_pad, 3), np.float32)
    tri_tangent[:n_t] = np.where(ok[:, None], tangent, e1)

    # --- fractional alpha-shadow split (whitted.cu:113-138) ---------------
    alpha_mats = (tables["alpha_mode"] != ALPHA_OPAQUE) & (tables["tex_id"]
                                                           >= 0)
    tri_alpha = alpha_mats[np.clip(tmat, 0, n_m - 1)]
    alpha_occ = None
    if tri_alpha.any():
        alpha_geom = scene_arrays(tri_alpha, None)
        n_a = int(tri_alpha.sum())
        alpha_uv = np.zeros((alpha_geom.num_tris_padded, 6), np.float32)
        alpha_uv[:n_a] = tuv[tri_alpha].reshape(n_a, 6)
        occ_inst = alpha_inst = None
        if use_inst:
            occ_inst = _subset_instance_table(slot_records, mesh_ranges,
                                              ~tri_alpha, tv)
            alpha_inst = _subset_instance_table(slot_records, mesh_ranges,
                                                tri_alpha, tv)
        # Each alpha triangle is hit at most once per segment, per
        # instance on instanced scenes.
        max_hits = min(n_a * (len(inst_records) if use_inst else 1),
                       ALPHA_MARCH_MAX)
        alpha_occ = AlphaOccluders(
            occ_geom=with_bvh(scene_arrays(~tri_alpha, extra)),
            geom=alpha_geom,
            uv=torch.as_tensor(alpha_uv), max_hits=max_hits,
            occ_inst=occ_inst, inst=alpha_inst)

    # --- analytic primitives and curves from the document's extras ---------
    # The reference binds sphere / sphere-shell / parallelogram programs
    # into its Whitted SBT from hardcoded sample setup
    # (``sutil/Scene.cpp:1368-1450``) and carries four round-curve types
    # (``cuda/GeometryData.h:95-127``); here the asset declares them:
    #   "extras": {"tpu_pt_primitives": [{"type": "sphere", "center": [..],
    #                "radius": r, "material": <glTF material index>}, ...],
    #              "tpu_pt_curves": [{"basis": "cubic_bspline", "points":
    #                [[x, y, z], ...], "radii": r | [r, ...],
    #                "material": <index>}]}
    # Their hits shade with the analytic normal and carry the glTF
    # material; KIND_GLASS ones pass shadow rays. Every ray is tested
    # against every primitive and every curve piece: fine for decorative
    # strands, wrong for a 10k-segment hair asset.
    extras = doc.get("extras", {})
    fake_bsdf = np.where(tables["kind"] == KIND_GLASS, BSDF_REFRACTION,
                         BSDF_DIFFUSE)
    analytic = {}
    if extras.get("tpu_pt_primitives"):
        from ..intersect.primitives import make_primitives
        specs = []
        for p in extras["tpu_pt_primitives"]:
            d = dict(kind=_PRIM_KINDS[p["type"]],
                     mat=int(p.get("material", 0)))
            if p["type"] == "sphere":
                d.update(center=p["center"], radius=p["radius"])
            elif p["type"] == "sphere_shell":
                d.update(center=p["center"], radius1=p["radius1"],
                         radius2=p["radius2"])
            else:
                d.update(anchor=p["anchor"], v1=p["v1"], v2=p["v2"])
            specs.append(d)
        analytic["prims"] = make_primitives(specs, mat_bsdf=fake_bsdf)
    if extras.get("tpu_pt_curves"):
        from ..intersect.curves import expand_curve_spec, make_curves
        segs = []
        for c in extras["tpu_pt_curves"]:
            segs.extend(expand_curve_spec(c, int(c.get("material", 0))))
        analytic["curves"] = make_curves(segs, mat_bsdf=fake_bsdf)
    if analytic:
        geom = dataclasses.replace(geom, **analytic)
        if alpha_occ is not None:    # they stop shadow rays outright
            alpha_occ.occ_geom = dataclasses.replace(alpha_occ.occ_geom,
                                                     **analytic)

    ws = WhittedScene(
        geom=geom,
        vtx_attr=torch.as_tensor(vtx_attr),
        **{k: torch.as_tensor(tables[k]) for k in (
            "base_color", "metallic", "roughness", "emissive", "kind",
            "alpha_mode", "alpha_cutoff", "ior", "phong_ks", "phong_exp",
            "phong_kr", "checker2", "tex_id", "tex_uvx", "ntex_id",
            "ntex_scale", "mrtex_id", "etex_id")},
        tri_tangent=torch.as_tensor(tri_tangent),
        light_pos=torch.as_tensor(
            np.asarray(lights_pos, np.float32).reshape(-1, 3)),
        light_color=torch.as_tensor(
            np.asarray(lights_color, np.float32).reshape(-1, 3)),
        ambient=torch.as_tensor(ambient),
        textures=tuple(textures),
        tex_wrap=tuple(tex_wraps),
        has_normal_maps=bool((tables["ntex_id"] >= 0).any()),
        has_mr_tex=bool((tables["mrtex_id"] >= 0).any()),
        has_emissive_tex=bool((tables["etex_id"] >= 0).any()),
        camera=cam_tuple,
        inst=inst_table,
        alpha_occ=alpha_occ)
    return ws.to(device)


def whitted_scene_from_numpy(leaves: dict, device="cuda") -> WhittedScene:
    """WhittedScene on ``device`` from the numpy leaves of another build of
    the same scene (the counterpart of ``scene_from_numpy``), so that both
    packages render the identical scene whatever either loader does.

    ``leaves`` maps every field of :class:`WhittedScene` to its value:
    arrays for the tensor fields, a list of [h, w, 4] arrays for
    ``textures``, the static fields as they are, and for ``geom`` a
    ``scene_from_numpy`` leaves mapping that also holds ``num_tris`` and
    ``num_occluders``. ``inst`` is None or a mapping of the
    InstanceTable's fields (its world culling margins are recomputed,
    ``instanced.culling_margins``); ``alpha_occ`` is None or a mapping of
    AlphaOccluders' fields, with ``occ_geom`` / ``geom`` as ``geom`` and
    ``occ_inst`` / ``inst`` as ``inst``."""
    def geom(g):
        return scene_from_numpy(g, g["num_tris"], g["num_occluders"],
                                device=device)

    def table(t):
        if t is None:
            return None
        boxes = instanced.culling_margins(t["rows"], t["fwd"], t["boxes"],
                                          t["count"])
        return instanced.InstanceTable(
            rows=torch.as_tensor(np.array(t["rows"]), device=device),
            nrm=torch.as_tensor(np.array(t["nrm"]), device=device),
            fwd=torch.as_tensor(np.array(t["fwd"]), device=device),
            boxes=torch.as_tensor(boxes, device=device), count=int(t["count"]),
            mesh_ranges=tuple(tuple(int(x) for x in r)
                              for r in t["mesh_ranges"]))

    kw = {}
    for f in dataclasses.fields(WhittedScene):
        val = leaves[f.name]
        if f.name == "geom":
            val = geom(val)
        elif f.name == "inst":
            val = table(val)
        elif f.name == "alpha_occ":
            val = None if val is None else AlphaOccluders(
                occ_geom=geom(val["occ_geom"]), geom=geom(val["geom"]),
                uv=torch.as_tensor(np.array(val["uv"]), device=device),
                max_hits=int(val["max_hits"]),
                occ_inst=table(val["occ_inst"]), inst=table(val["inst"]))
        elif f.name == "textures":
            val = tuple(torch.as_tensor(np.array(x), device=device)
                        for x in val)
        elif f.type == "torch.Tensor":
            val = torch.as_tensor(np.array(val), device=device)
        kw[f.name] = val
    return WhittedScene(**kw)
