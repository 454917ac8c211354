"""Scene JSON: an OBJ mesh plus analytic primitives in one renderable file
(counterpart of ``tpu_pt/scene/scenejson.py``).

The reference binds sphere / sphere-shell / parallelogram intersection
programs into its pipeline through the SBT (``sutil/Scene.cpp:1368-1450``,
``cuda/geometry.cu:38-144``, ``cuda/sphere.cu:37-97``); its scene *data*
for those comes from hardcoded C++ sample setup. Here the same
capability is reachable from a scene file: a small JSON that references an
optional OBJ mesh and declares primitives + extra materials.

Format (all paths relative to the JSON file)::

    {
      "obj": "cornell_box.obj",            // optional triangle mesh
      "materials": [                        // appended to the OBJ's .mtl set
        {"name": "RefractiveShell", "diffuse": [1, 1, 1], "ior": 1.5}
      ],
      "primitives": [
        {"type": "sphere", "center": [x, y, z], "radius": r,
         "material": "name-or-index"},
        {"type": "sphere_shell", "center": [...], "radius1": ri,
         "radius2": ro, "material": ...},
        {"type": "parallelogram", "anchor": [...], "v1": [...],
         "v2": [...], "material": ...},
        {"type": "curve", "basis": "linear" | "quadratic_bspline" |
         "cubic_bspline" | "catmullrom", "points": [[x, y, z], ...],
         "radii": [r, ...] | r, "material": ...}
      ],
      "light": {"corner": [...], "v1": [...], "v2": [...],
                "emission": [...]}          // optional AreaLight override
    }

Material ``bsdf`` defaults to the reference's name-substring rule
(``classify_bsdf``), so a material named "Refractive..." refracts, exactly
as it would coming from an .mtl.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

from .arrays import (AreaLight, SceneArrays, _f32, build_scene_arrays,
                     default_cornell_light)
from .objloader import (Material, ObjMesh, classify_bsdf, detect_area_light,
                        load_obj)

_PRIM_TYPES = {"sphere": 0, "parallelogram": 1, "sphere_shell": 2}


def load_scene_json(path: str, light: AreaLight | None = None,
                    auto_light: bool = True, build_bvh: bool = True,
                    device="cuda") -> SceneArrays:
    """Scene JSON -> SceneArrays on ``device`` (the card unless the caller
    asks for the CPU) with ``prims`` and ``curves`` attached."""
    with open(path) as f:
        doc = json.load(f)
    base = os.path.dirname(os.path.abspath(path))

    if "obj" in doc:
        mesh = load_obj(os.path.join(base, doc["obj"]))
    else:
        mesh = ObjMesh(vertices=np.zeros((0, 3), np.float32),
                       indices=np.zeros((0, 3), np.int64),
                       mat_indices=np.zeros((0,), np.int64), materials=[])
    materials = list(mesh.materials)
    if not materials:
        materials = [Material(name="default")]
    name_to_idx = {m.name: i for i, m in enumerate(materials)}

    for md in doc.get("materials", []):
        name = md.get("name", f"json_mat_{len(materials)}")
        mat = Material(
            name=name,
            diffuse=tuple(md.get("diffuse", (0.8, 0.8, 0.8))),
            emission=tuple(md.get("emission", (0.0, 0.0, 0.0))),
            roughness=float(md.get("roughness", 0.5)),
            metallic=float(md.get("metallic", 0.0)),
            ior=float(md.get("ior", 1.0)),
            bsdf=int(md["bsdf"]) if "bsdf" in md else classify_bsdf(name),
        )
        name_to_idx[name] = len(materials)
        materials.append(mat)

    def mat_index(ref) -> int:
        if isinstance(ref, int):
            return ref
        if ref not in name_to_idx:
            raise ValueError(f"scene JSON references unknown material {ref!r}")
        return name_to_idx[ref]

    prim_dicts = []
    curve_dicts = []
    for p in doc.get("primitives", []):
        if p.get("type") == "curve":
            from ..intersect.curves import expand_curve_spec
            curve_dicts.extend(
                expand_curve_spec(p, mat_index(p.get("material", 0))))
            continue
        kind = _PRIM_TYPES.get(p.get("type"))
        if kind is None:
            raise ValueError(f"unknown primitive type {p.get('type')!r}")
        d = dict(kind=kind, mat=mat_index(p.get("material", 0)))
        if p["type"] == "sphere":
            d.update(center=p["center"], radius=p["radius"])
        elif p["type"] == "sphere_shell":
            d.update(center=p["center"], radius1=p["radius1"],
                     radius2=p["radius2"])
        else:
            d.update(anchor=p["anchor"], v1=p["v1"], v2=p["v2"])
        prim_dicts.append(d)

    if light is None and "light" in doc:
        ld = doc["light"]
        v1 = np.asarray(ld["v1"], np.float32)
        v2 = np.asarray(ld["v2"], np.float32)
        n = np.cross(v1, v2)
        n = (n / max(float(np.linalg.norm(n)), 1e-30)).astype(np.float32)
        light = AreaLight(corner=_f32(ld["corner"]), v1=_f32(v1),
                          v2=_f32(v2), normal=_f32(n),
                          emission=_f32(ld["emission"]))
    if light is None and auto_light and mesh.indices.shape[0]:
        light = detect_area_light(mesh)
    if light is None:
        light = default_cornell_light("cpu")

    scene = build_scene_arrays(
        mesh.vertices, mesh.indices, mesh.mat_indices,
        [m.as_dict() for m in materials], light=light, device=device)
    if build_bvh and mesh.indices.shape[0]:
        from ..intersect.lbvh import with_bvh
        scene = with_bvh(scene)

    mat_bsdf = np.array([m.bsdf for m in materials], np.int32)
    if prim_dicts:
        from ..intersect.primitives import make_primitives
        scene = dataclasses.replace(scene, prims=make_primitives(
            prim_dicts, mat_bsdf=mat_bsdf, device=device))
    if curve_dicts:
        from ..intersect.curves import make_curves
        scene = dataclasses.replace(scene, curves=make_curves(
            curve_dicts, mat_bsdf=mat_bsdf, device=device))
    return scene
