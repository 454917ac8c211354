"""Flattened scene representation (counterpart of ``tpu_pt/scene/arrays.py``).

The reference uploads vertices/indices/material indices into an OptiX GAS
and dispatches materials through per-material SBT records
(``PathTracerMain.cpp:260-398,544-627``). Here a scene is a dataclass of
tensors: padded triangle arrays plus material tables indexed by
``mat_id``. The host-side build runs in numpy with the JAX package's exact
operations, so both packages hold bitwise-equal scenes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# BSDF ids — parity with ``TinyObjWrapper.h:27-31`` (BSDFType).
BSDF_DIFFUSE = 0
BSDF_METALLIC = 1
BSDF_REFRACTION = 2

# Triangle arrays are padded to a multiple of this (the JAX package's
# TRI_PAD, kept so both packages hold the same padded arrays).
TRI_PAD = 128

_LIGHT_FIELDS = ("corner", "v1", "v2", "normal", "emission")


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x, np.float32), device=device)


@dataclasses.dataclass
class AreaLight:
    """Rectangular area light (``pathTracer.h:77-83`` AreaLight); [3] tensors."""
    corner: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    normal: torch.Tensor
    emission: torch.Tensor

    def to(self, device) -> "AreaLight":
        return AreaLight(*(getattr(self, f).to(device) for f in _LIGHT_FIELDS))

    def host(self) -> tuple[np.ndarray, ...]:
        """(corner, v1, v2, normal, emission) as float32 numpy arrays."""
        return tuple(np.asarray(getattr(self, f).cpu(), np.float32)
                     for f in _LIGHT_FIELDS)


@dataclasses.dataclass
class SceneArrays:
    """Padded scene. Triangles are (v0, e1 = v1 - v0, e2 = v2 - v0) with the
    geometric normal ``normalize(cross(e1, e2))`` (the reference's per-hit
    N_0, ``pathTracerPrograms.cu:886-891``) precomputed."""
    tri_v0: torch.Tensor        # [T, 3] f32
    tri_e1: torch.Tensor        # [T, 3] f32
    tri_e2: torch.Tensor        # [T, 3] f32
    tri_normal: torch.Tensor    # [T, 3] f32
    tri_valid: torch.Tensor     # [T] bool (False on padding)
    mat_id: torch.Tensor        # [T] i32

    mat_diffuse: torch.Tensor    # [M, 3] f32
    mat_emission: torch.Tensor   # [M, 3] f32
    mat_roughness: torch.Tensor  # [M] f32
    mat_metallic: torch.Tensor   # [M] f32
    mat_ior: torch.Tensor        # [M] f32
    mat_bsdf: torch.Tensor       # [M] i32
    mat_is_emissive: torch.Tensor  # [M] bool

    light: AreaLight

    # True (unpadded) triangle count; 0 = unknown.
    num_tris: int = 0
    # NEE shadow-ray occluder subset (``nee_occluder_index``): padded-row
    # indices of every triangle that can occlude a surface -> light
    # segment, padded to a multiple of 8. None / -1 = unknown.
    occ_index: torch.Tensor | None = None   # [O_pad] i32
    num_occluders: int = -1

    @property
    def num_tris_padded(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_diffuse.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "SceneArrays":
        """A copy with every tensor on ``device``."""
        kw = {}
        for f in dataclasses.fields(self):
            val = getattr(self, f.name)
            kw[f.name] = (val.to(device)
                          if isinstance(val, (torch.Tensor, AreaLight))
                          else val)
        return SceneArrays(**kw)


def default_cornell_light(device=None) -> AreaLight:
    """The reference's hardcoded Cornell area light (``PathTracerMain.cpp:154-158``)."""
    v1 = np.array([0.0, 0.0, 105.0], np.float32)
    v2 = np.array([-130.0, 0.0, 0.0], np.float32)
    n = np.cross(v1, v2)
    n = n / np.linalg.norm(n)
    return AreaLight(corner=_f32([343.0, 547.0, 227.0], device),
                     v1=_f32(v1, device), v2=_f32(v2, device),
                     normal=_f32(n, device),
                     emission=_f32([10.0, 10.0, 10.0], device))


def nee_occluder_index(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                       valid: np.ndarray, refractive: np.ndarray,
                       light_cvv: tuple, pad_align: int = 8):
    """Indices of every triangle that can occlude an NEE shadow segment.

    NEE shadow rays (``pathTracerPrograms.cu:1003-1026``) are segments from
    a scene-surface point to a point on the area light. Refractive
    triangles never occlude (``pathTracerPrograms.cu:672-681``), and a
    triangle with every possible endpoint (the scene AABB corners and the
    light quad's corners) on one side of its plane cannot be properly
    crossed by any segment; both are culled. Points within ``eps`` (1e-4
    of the scene diagonal) of the plane count as on it. ``light_cvv`` is
    the host-side (corner, v1, v2). Returns (int32 [O_pad], n_occ).
    """
    v0 = np.asarray(v0, np.float32)
    e1 = np.asarray(e1, np.float32)
    e2 = np.asarray(e2, np.float32)
    valid = np.asarray(valid, bool)
    refractive = np.asarray(refractive, bool)

    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nlen > 0, n / np.maximum(nlen, np.float32(1e-30)), 0.0)
    d0 = np.sum(n * v0, axis=-1)                              # [T]

    vmask = np.concatenate([valid, valid, valid])
    pts = np.concatenate([v0, v0 + e1, v0 + e2], axis=0)[vmask]
    if pts.size == 0:
        return np.zeros(pad_align, np.int32), 0
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1])
                        for z in (lo[2], hi[2])], np.float32)  # [8, 3]
    lc, lv1, lv2 = (np.asarray(x, np.float32) for x in light_cvv)
    endpoints = np.concatenate(
        [corners, [lc, lc + lv1, lc + lv2, lc + lv1 + lv2]], axis=0)

    eps = 1e-4 * float(np.linalg.norm(hi - lo)) + 1e-12
    dist = endpoints @ n.T - d0[None, :]    # [12, T]
    one_side = np.all(dist >= -eps, axis=0) | np.all(dist <= eps, axis=0)

    mask = valid & ~refractive & ~one_side
    idx = np.flatnonzero(mask).astype(np.int32)
    n_occ = int(idx.size)
    o_pad = max(pad_align, -(-n_occ // pad_align) * pad_align)
    out = np.zeros(o_pad, np.int32)
    out[:n_occ] = idx
    return out, n_occ


def build_scene_arrays(vertices: np.ndarray, indices: np.ndarray,
                       mat_ids: np.ndarray, materials: list[dict],
                       light: AreaLight | None = None,
                       pad_to: int = TRI_PAD, device=None) -> SceneArrays:
    """Flatten host-side mesh data into a padded SceneArrays on ``device``.

    ``vertices`` [V, 3], ``indices`` [T, 3] int, ``mat_ids`` [T] int,
    ``materials`` a list of dicts with keys diffuse/emission/roughness/
    metallic/ior/bsdf (``TinyObjWrapper.h:33-40``).
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    mat_ids = np.asarray(mat_ids, np.int64).reshape(-1)
    t = indices.shape[0]
    if mat_ids.shape[0] != t:
        raise ValueError(f"{mat_ids.shape[0]} material ids for {t} triangles")

    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    n = np.where(nlen > 0, n / np.maximum(nlen, 1e-30), 0.0).astype(np.float32)

    t_pad = max(pad_to, ((t + pad_to - 1) // pad_to) * pad_to)

    def pad(a, fill=0.0):
        out = np.full((t_pad,) + a.shape[1:], fill, a.dtype)
        out[:t] = a
        return out

    if not materials:
        materials = [dict(diffuse=(0.8, 0.8, 0.8), emission=(0, 0, 0),
                          roughness=0.5, metallic=0.0, ior=1.0,
                          bsdf=BSDF_DIFFUSE)]
        mat_ids = np.zeros(t, np.int64)

    m = len(materials)
    diffuse = np.array([mm["diffuse"] for mm in materials], np.float32)
    emission = np.array([mm["emission"] for mm in materials], np.float32)
    roughness = np.array([mm["roughness"] for mm in materials], np.float32)
    metallic = np.array([mm["metallic"] for mm in materials], np.float32)
    ior = np.array([mm["ior"] for mm in materials], np.float32)
    bsdf = np.array([mm["bsdf"] for mm in materials], np.int32)
    is_emissive = np.linalg.norm(emission, axis=-1) > 0.0

    mat_ids = np.clip(mat_ids, 0, m - 1)
    host_v0, host_e1, host_e2 = pad(v0), pad(e1), pad(e2)
    host_valid = pad(np.ones(t, bool), fill=False)
    host_mat = pad(mat_ids.astype(np.int32))

    the_light = light if light is not None else default_cornell_light()
    refr = bsdf[host_mat] == BSDF_REFRACTION
    occ_index, n_occ = nee_occluder_index(
        host_v0, host_e1, host_e2, host_valid, refr, the_light.host()[:3])

    def dev(a):
        return torch.as_tensor(a, device=device)

    return SceneArrays(
        tri_v0=dev(host_v0), tri_e1=dev(host_e1), tri_e2=dev(host_e2),
        tri_normal=dev(pad(n)), tri_valid=dev(host_valid),
        mat_id=dev(host_mat),
        mat_diffuse=dev(diffuse), mat_emission=dev(emission),
        mat_roughness=dev(roughness), mat_metallic=dev(metallic),
        mat_ior=dev(ior), mat_bsdf=dev(bsdf),
        mat_is_emissive=dev(is_emissive),
        light=the_light.to(device),
        num_tris=t, occ_index=dev(occ_index), num_occluders=n_occ)


def scene_from_numpy(leaves, num_tris: int, num_occluders: int,
                     device=None) -> SceneArrays:
    """SceneArrays from numpy leaves of another build of the same scene.

    ``leaves`` maps each tensor field of :class:`SceneArrays` to an array
    (``occ_index`` may be None) and ``"light"`` to a mapping of the five
    :class:`AreaLight` fields. This carries a scene built elsewhere (for
    example ``np.asarray`` of every leaf of a ``tpu_pt`` scene) over
    unchanged, so both packages trace the identical scene."""
    kw = {}
    for f in dataclasses.fields(SceneArrays):
        if f.name in ("light", "num_tris", "num_occluders"):
            continue
        val = leaves.get(f.name) if f.name == "occ_index" else leaves[f.name]
        kw[f.name] = (None if val is None
                      else torch.as_tensor(np.array(val), device=device))
    light = leaves["light"]
    return SceneArrays(
        light=AreaLight(*(_f32(light[k], device) for k in _LIGHT_FIELDS)),
        num_tris=int(num_tris), num_occluders=int(num_occluders), **kw)
