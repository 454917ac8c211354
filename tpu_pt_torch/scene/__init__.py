"""Scene IO and flattened scene arrays."""

from .arrays import (BSDF_DIFFUSE, BSDF_METALLIC, BSDF_REFRACTION, AreaLight,
                     SceneArrays, build_scene_arrays, default_cornell_light,
                     median_split_order, nee_occluder_index, scene_from_numpy)
from .gltf import (AlphaOccluders, WhittedScene, load_gltf,
                   whitted_scene_from_numpy)
from .objloader import (Material, ObjMesh, classify_bsdf, detect_area_light,
                        load_obj, load_scene, parse_mtl)
from .refine import split_large_tris
from .scenejson import load_scene_json

__all__ = [
    "AreaLight", "SceneArrays", "build_scene_arrays",
    "default_cornell_light", "median_split_order", "nee_occluder_index",
    "scene_from_numpy", "AlphaOccluders", "WhittedScene", "load_gltf",
    "whitted_scene_from_numpy",
    "BSDF_DIFFUSE", "BSDF_METALLIC", "BSDF_REFRACTION", "Material",
    "ObjMesh", "classify_bsdf", "detect_area_light", "load_obj",
    "load_scene", "parse_mtl", "split_large_tris", "load_scene_json",
]
