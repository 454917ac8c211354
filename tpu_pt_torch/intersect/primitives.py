"""Analytic primitive intersectors: sphere, sphere shell, parallelogram
(counterpart of ``tpu_pt/intersect/primitives.py``; plain PyTorch on
``[N, 3]`` rays, the JAX package's operations in its order).

Parity with the reference's custom-primitive intersection programs
(``cuda/geometry.cu:38-144``, ``cuda/sphere.cu:37-97``) and the
``GeometryData`` tagged union (``cuda/GeometryData.h:55-127``): a small
array of analytic primitives intersected wavefront-wide in a few dense
ops. Combined with triangle hits by min-t (``combine_hits``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import vec3 as v3
from ..scene.arrays import BSDF_REFRACTION
from .moller import T_FAR, Hit

# Primitive kinds (GeometryData union parity).
PRIM_SPHERE = 0
PRIM_PARALLELOGRAM = 1
PRIM_SPHERE_SHELL = 2


@dataclasses.dataclass
class Primitives:
    """SoA analytic primitives.

    ``kind`` is a Python tuple: the per-primitive dispatch is a host loop,
    as each OptiX custom primitive binds its own intersection program
    through the SBT.

    ``params`` layout per kind:
      SPHERE:         center xyz, radius
      PARALLELOGRAM:  anchor xyz, v1 xyz, v2 xyz (plane extent basis)
      SPHERE_SHELL:   center xyz, radius1 (inner), radius2 (outer)
    """
    kind: tuple                 # per-primitive PRIM_* ints
    params: torch.Tensor        # [P, 12] f32
    mat: torch.Tensor           # [P] i32
    # Per-primitive "can occlude an NEE shadow ray" flags: refractive
    # primitives pass light, as the reference's occlusion program skips
    # refractive hits (``pathTracerPrograms.cu:672-681``). Empty = all
    # occlude.
    occludes: tuple = ()

    @property
    def count(self) -> int:
        return len(self.kind)

    def to(self, device) -> "Primitives":
        return dataclasses.replace(self, params=self.params.to(device),
                                   mat=self.mat.to(device))


def occluder_flags(mats, mat_bsdf) -> tuple:
    """Per-item "occludes" flags: False for a refractive material
    (``mat_bsdf`` host [M] ints, or None: everything occludes)."""
    if mat_bsdf is None:
        return tuple(True for _ in mats)
    bsdf = np.asarray(mat_bsdf)
    return tuple(bool(bsdf[m] != BSDF_REFRACTION) for m in mats)


def make_primitives(prims: list[dict], mat_bsdf: np.ndarray | None = None,
                    device="cpu") -> Primitives:
    """Build from dicts: {kind, mat, center/radius/... per kind}.

    ``mat_bsdf`` (host [M] ints) marks refractive materials so that their
    primitives are left out of NEE occlusion at build time."""
    p = len(prims)
    kind = []
    params = np.zeros((p, 12), np.float32)
    mat = np.zeros(p, np.int32)
    for i, d in enumerate(prims):
        kind.append(int(d["kind"]))
        mat[i] = d.get("mat", 0)
        if d["kind"] == PRIM_SPHERE:
            params[i, 0:3] = d["center"]
            params[i, 3] = d["radius"]
        elif d["kind"] == PRIM_PARALLELOGRAM:
            params[i, 0:3] = d["anchor"]
            params[i, 3:6] = d["v1"]
            params[i, 6:9] = d["v2"]
        elif d["kind"] == PRIM_SPHERE_SHELL:
            params[i, 0:3] = d["center"]
            params[i, 3] = d["radius1"]
            params[i, 4] = d["radius2"]
        else:
            raise ValueError(f"unknown primitive kind {d['kind']}")
    return Primitives(kind=tuple(kind),
                      params=torch.as_tensor(params, device=device),
                      mat=torch.as_tensor(mat, device=device),
                      occludes=occluder_flags(mat, mat_bsdf))


def _sphere_t(o, d, c, r, tmin, tmax):
    """Nearest sphere intersection in range: (t, normal). sphere.cu:37-97.
    ``tmax`` is a scalar or [N]."""
    oc = o - c
    a = v3.dot(d, d)
    b = 2.0 * v3.dot(oc, d)
    cc = v3.dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    ok = disc > 0.0
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    inv2a = 1.0 / torch.clamp_min(2.0 * a, 1e-30)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    t0_in = (t0 > tmin) & (t0 < tmax)
    t1_in = (t1 > tmin) & (t1 < tmax)
    t = torch.where(t0_in, t0, torch.where(t1_in, t1, T_FAR))
    t = torch.where(ok, t, T_FAR)
    p = o + d * t[:, None]
    n = (p - c) * (1.0 / torch.clamp_min(r, 1e-30))
    return t, n


def _shell_t(o, d, c, r1, r2, tmin, tmax):
    """Sphere shell: nearest of outer entry / inner surface / outer exit
    (geometry.cu:67-144: a hollow sphere with two radii)."""
    t_in, n_in = _sphere_t(o, d, c, r1, tmin, tmax)
    t_out, n_out = _sphere_t(o, d, c, r2, tmin, tmax)
    t = torch.minimum(t_in, t_out)
    n = torch.where((t_in <= t_out)[:, None], n_in, n_out)
    return t, n


def _parallelogram_t(o, d, anchor, v1, v2, tmin, tmax):
    """Parallelogram plane intersection and UV bounds (geometry.cu:38-66)."""
    n = v3.cross(v1, v2)
    nl2 = v3.dot(n, n)
    n_unit = v3.normalize(n)
    dt = v3.dot(d, n_unit)
    t = v3.dot(anchor - o, n_unit) / torch.where(dt.abs() > 1e-12, dt, 1e30)
    p = o + d * t[:, None]
    vi = p - anchor
    # Barycentric coordinates through the dual basis.
    inv = 1.0 / torch.clamp_min(nl2, 1e-30)
    a1 = v3.dot(v3.cross(vi, v2), n) * inv
    a2 = v3.dot(v3.cross(v1, vi), n) * inv
    ok = ((dt.abs() > 1e-12) & (t > tmin) & (t < tmax)
          & (a1 >= 0.0) & (a1 <= 1.0) & (a2 >= 0.0) & (a2 <= 1.0))
    return torch.where(ok, t, T_FAR), n_unit.expand(o.shape[0], 3)


def _prim_t(prims: Primitives, i: int, o, d, tmin, tmax):
    """(t, normal) of every ray against primitive ``i``."""
    q = prims.params[i]
    kind = prims.kind[i]
    if kind == PRIM_SPHERE:
        return _sphere_t(o, d, q[0:3], q[3], tmin, tmax)
    if kind == PRIM_SPHERE_SHELL:
        return _shell_t(o, d, q[0:3], q[3], q[4], tmin, tmax)
    return _parallelogram_t(o, d, q[0:3], q[3:6], q[6:9], tmin, tmax)


def intersect_primitives(prims: Primitives, origins: torch.Tensor,
                         dirs: torch.Tensor, tmin: float = 0.01,
                         tmax: float = T_FAR, index_offset: int = 0) -> Hit:
    """Closest hit over all analytic primitives (a dense loop; P is small).

    ``index_offset`` biases ``Hit.tri`` so that primitive ids live past the
    triangle ids when combined with a mesh hit (id >= num_tris_padded
    means primitive)."""
    n_rays, dev = origins.shape[0], origins.device
    best_t = torch.full((n_rays,), T_FAR, dtype=torch.float32, device=dev)
    best_n = torch.zeros((n_rays, 3), dtype=torch.float32, device=dev)
    best_i = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    best_m = torch.zeros(n_rays, dtype=torch.int32, device=dev)
    for i in range(prims.count):
        t, n = _prim_t(prims, i, origins, dirs, tmin, tmax)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_n = torch.where(better[:, None], n, best_n)
        best_i = torch.where(better, index_offset + i, best_i)
        best_m = torch.where(better, prims.mat[i], best_m)
    zero = torch.zeros_like(best_t)
    return Hit(t=best_t, tri=best_i, hit=best_t < T_FAR, normal=best_n,
               mat=best_m, u=zero, v=zero)


def occluded_primitives(prims: Primitives, origins: torch.Tensor,
                        dirs: torch.Tensor, tmax: torch.Tensor,
                        tmin: float = 0.01) -> torch.Tensor:
    """Any-hit over the occluding primitives for NEE shadow segments.

    Refractive primitives never occlude (the ``occludes`` flags; the
    reference's convention, ``pathTracerPrograms.cu:672-681``). ``tmax``
    is per lane (l_dist - eps)."""
    occ = torch.zeros(origins.shape[0], dtype=torch.bool,
                      device=origins.device)
    for i in range(prims.count):
        if prims.occludes and not prims.occludes[i]:
            continue
        t, _ = _prim_t(prims, i, origins, dirs, tmin, tmax)
        occ = occ | (t < tmax)
    return occ


def combine_hits(a: Hit, b: Hit) -> Hit:
    """Min-t combination of two closest-hit results."""
    take_b = b.t < a.t
    return Hit(
        t=torch.where(take_b, b.t, a.t),
        tri=torch.where(take_b, b.tri, a.tri),
        hit=a.hit | b.hit,
        normal=torch.where(take_b[:, None], b.normal, a.normal),
        mat=torch.where(take_b, b.mat, a.mat),
        u=torch.where(take_b, b.u, a.u),
        v=torch.where(take_b, b.v, a.v),
    )
