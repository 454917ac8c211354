"""Wavefront OBJ + MTL loader (counterpart of the Python OBJ path of
``tpu_pt/scene/objloader.py``; the native parser, glTF and scene JSON are
not ported yet).

Triangulating OBJ parse, per-face material indices and the reference's
BSDF-by-material-name rule (``TinyObjWrapper.cpp:153-164``): a name
containing "Refractive" -> refraction, "Metallic" -> metallic, anything
else -> diffuse.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .arrays import (BSDF_DIFFUSE, BSDF_METALLIC, BSDF_REFRACTION,
                     AreaLight, SceneArrays, _f32, build_scene_arrays,
                     default_cornell_light)


@dataclasses.dataclass
class Material:
    """Host-side material (``TinyObjWrapper.h:33-40``)."""
    name: str = ""
    diffuse: tuple = (0.8, 0.8, 0.8)
    emission: tuple = (0.0, 0.0, 0.0)
    roughness: float = 0.5
    metallic: float = 0.0
    ior: float = 1.0
    bsdf: int = BSDF_DIFFUSE

    def as_dict(self) -> dict:
        return dict(diffuse=self.diffuse, emission=self.emission,
                    roughness=self.roughness, metallic=self.metallic,
                    ior=self.ior, bsdf=self.bsdf)


def classify_bsdf(name: str) -> int:
    """Name-substring BSDF classification (``TinyObjWrapper.cpp:153-164``)."""
    if "Refractive" in name:
        return BSDF_REFRACTION
    if "Metallic" in name:
        return BSDF_METALLIC
    return BSDF_DIFFUSE


def parse_mtl(path: str) -> dict[str, Material]:
    """Parse a .mtl file. Supports Kd, Ke, Ni, Pr (roughness), Pm (metallic)."""
    mats: dict[str, Material] = {}
    cur: Material | None = None
    if not os.path.exists(path):
        return mats
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "newmtl":
                name = " ".join(parts[1:])
                cur = Material(name=name, bsdf=classify_bsdf(name))
                mats[name] = cur
            elif cur is None:
                continue
            elif key == "Kd" and len(parts) >= 4:
                cur.diffuse = tuple(float(x) for x in parts[1:4])
            elif key == "Ke" and len(parts) >= 4:
                cur.emission = tuple(float(x) for x in parts[1:4])
            elif key == "Ni" and len(parts) >= 2:
                cur.ior = float(parts[1])
            elif key == "Pr" and len(parts) >= 2:
                cur.roughness = float(parts[1])
            elif key == "Pm" and len(parts) >= 2:
                cur.metallic = float(parts[1])
    return mats


@dataclasses.dataclass
class ObjMesh:
    """Parsed OBJ: vertices [V, 3], triangles [T, 3], material ids [T]."""
    vertices: np.ndarray
    indices: np.ndarray
    mat_indices: np.ndarray
    materials: list


def load_obj(path: str) -> ObjMesh:
    """Parse an OBJ file; polygons are fan-triangulated (tinyobj
    ``triangulate=true``, ``TinyObjWrapper.cpp:43``)."""
    verts: list[tuple] = []
    tris: list[tuple] = []
    tri_mats: list[int] = []
    mat_lookup: dict[str, int] = {}
    materials: list[Material] = []
    cur_mat = -1
    base_dir = os.path.dirname(os.path.abspath(path))

    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts or parts[0].startswith("#"):
                continue
            key = parts[0]
            if key == "v" and len(parts) >= 4:
                verts.append((float(parts[1]), float(parts[2]),
                              float(parts[3])))
            elif key == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    tris.append((idx[0], idx[k], idx[k + 1]))
                    tri_mats.append(cur_mat)
            elif key == "usemtl":
                name = " ".join(parts[1:])
                if name not in mat_lookup:
                    # Forward reference to a material not in the mtl
                    # file: a default with the classified BSDF.
                    mat_lookup[name] = len(materials)
                    materials.append(
                        Material(name=name, bsdf=classify_bsdf(name)))
                cur_mat = mat_lookup[name]
            elif key == "mtllib":
                mtl_path = os.path.join(base_dir, " ".join(parts[1:]))
                for name, mat in parse_mtl(mtl_path).items():
                    if name in mat_lookup:
                        materials[mat_lookup[name]] = mat
                    else:
                        mat_lookup[name] = len(materials)
                        materials.append(mat)

    if not materials:
        materials = [Material(name="default")]
    return ObjMesh(
        vertices=np.asarray(verts, np.float32).reshape(-1, 3),
        indices=np.asarray(tris, np.int64).reshape(-1, 3),
        mat_indices=np.clip(np.asarray(tri_mats, np.int64), 0,
                            len(materials) - 1),
        materials=materials)


def detect_area_light(mesh: ObjMesh) -> AreaLight | None:
    """An AreaLight from the scene's emissive quad, or None when the
    emissive geometry is not a single two-triangle rectangle.

    The reference hardcodes the Cornell light (``PathTracerMain.cpp:154-158``);
    detecting it lets any OBJ scene get correct NEE. The normal is
    oriented toward the scene centroid (NEE's LnDl = -dot(normal, L))."""
    emissive_ids = [i for i, m in enumerate(mesh.materials)
                    if float(np.linalg.norm(m.emission)) > 0.0]
    if not emissive_ids:
        return None
    tri = mesh.indices[np.isin(mesh.mat_indices, emissive_ids)]
    if tri.shape[0] != 2:
        return None
    vids = np.unique(tri.reshape(-1))
    if vids.shape[0] != 4:
        return None
    pts = mesh.vertices[vids]
    # Corner = first point; v1, v2 = edges to the two points that are
    # not diagonally opposite it.
    c = pts[0]
    d = np.linalg.norm(pts[1:] - c, axis=1)
    far = 1 + int(np.argmax(d))
    others = [i for i in range(1, 4) if i != far]
    v1 = pts[others[0]] - c
    v2 = pts[others[1]] - c
    n = np.cross(v1, v2)
    nl = np.linalg.norm(n)
    if nl == 0:
        return None
    n = n / nl
    centroid = mesh.vertices.mean(axis=0)
    light_center = c + 0.5 * (v1 + v2)
    if float(np.dot(n, centroid - light_center)) < 0.0:
        n = -n
    mat = mesh.materials[emissive_ids[0]]
    return AreaLight(corner=_f32(c), v1=_f32(v1), v2=_f32(v2),
                     normal=_f32(n), emission=_f32(mat.emission))


def load_scene(path: str, light: AreaLight | None = None,
               auto_light: bool = True, device=None) -> SceneArrays:
    """OBJ file -> SceneArrays on ``device``.

    The light is ``light`` if given, else the scene's emissive quad
    (``auto_light``), else the reference's Cornell light."""
    if not path.lower().endswith(".obj"):
        raise NotImplementedError(
            f"{path}: only OBJ scenes are ported so far (glTF and scene "
            "JSON are queued in ROADMAP.md)")
    mesh = load_obj(path)
    if light is None and auto_light:
        light = detect_area_light(mesh)
    if light is None:
        light = default_cornell_light()
    return build_scene_arrays(
        mesh.vertices, mesh.indices, mesh.mat_indices,
        [m.as_dict() for m in mesh.materials], light=light, device=device)
