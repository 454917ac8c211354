"""Brute-force Möller-Trumbore intersection in plain PyTorch (counterpart
of ``tpu_pt/intersect/moller.py``).

The port's CPU path and an independent oracle for the dense kernels: a
dense all-rays × all-triangles test, chunked over rays and triangle
blocks so intermediates stay small. Triangles are two-sided (OptiX
default) and refractive surfaces do not occlude
(``pathTracerPrograms.cu:672-681``). Ties in t go to the lowest
triangle index.
"""

from __future__ import annotations

import dataclasses

import torch

from ..scene.arrays import BSDF_REFRACTION, SceneArrays

DET_EPS = 1e-9
T_FAR = 1e16


@dataclasses.dataclass
class Hit:
    """Closest-hit result per ray."""
    t: torch.Tensor        # [N] f32, T_FAR on miss
    tri: torch.Tensor      # [N] i32, 0 on miss
    hit: torch.Tensor      # [N] bool
    normal: torch.Tensor   # [N, 3] f32 geometric normal N_0, 0 on miss
    mat: torch.Tensor      # [N] i32 material id, 0 on miss
    u: torch.Tensor        # [N] f32 barycentric u (0 on miss)
    v: torch.Tensor        # [N] f32 barycentric v (0 on miss)
    # [N] i32 winning instance of an instanced scene (0 on miss); None
    # for world-space (flattened) scenes.
    inst: torch.Tensor | None = None


def _fit_tri_block(requested: int, n_tri: int) -> int:
    """Largest block size <= requested that divides n_tri."""
    b = min(requested, n_tri)
    while n_tri % b:
        b -= 1
    return b


def _mt_block(o, d, v0, e1, e2, tmin, tmax):
    """Möller-Trumbore: [R] rays vs [B] triangles -> (t, valid, u, v) [R, B]."""
    ox, oy, oz = (o[:, k:k + 1] for k in range(3))
    dx, dy, dz = (d[:, k:k + 1] for k in range(3))
    v0x, v0y, v0z = (v0[None, :, k] for k in range(3))
    e1x, e1y, e1z = (e1[None, :, k] for k in range(3))
    e2x, e2y, e2z = (e2[None, :, k] for k in range(3))

    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = torch.abs(det) > DET_EPS
    inv_det = 1.0 / torch.where(ok, det, 1.0)

    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det

    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin) & (t < tmax))
    return t, valid, u, v


def intersect_closest(scene: SceneArrays, origins: torch.Tensor,
                      dirs: torch.Tensor, tmin: float = 0.01,
                      tmax: float = T_FAR, ray_chunk: int = 8192,
                      tri_block: int = 512) -> Hit:
    """Closest hit for rays ``origins``/``dirs`` [N, 3]."""
    n = origins.shape[0]
    n_tri = scene.num_tris_padded
    tri_block = _fit_tri_block(tri_block, n_tri)
    dev = origins.device
    best_t = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    best_i = torch.zeros((n,), dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros((n,), dtype=torch.float32, device=dev)
    for r0 in range(0, n, ray_chunk):
        o = origins[r0:r0 + ray_chunk]
        d = dirs[r0:r0 + ray_chunk]
        bt, bi = best_t[r0:r0 + ray_chunk], best_i[r0:r0 + ray_chunk]
        bu, bv = best_u[r0:r0 + ray_chunk], best_v[r0:r0 + ray_chunk]
        for s in range(0, n_tri, tri_block):
            sl = slice(s, s + tri_block)
            t, valid, u, v = _mt_block(o, d, scene.tri_v0[sl],
                                       scene.tri_e1[sl], scene.tri_e2[sl],
                                       tmin, tmax)
            valid = valid & scene.tri_valid[sl][None, :]
            t = torch.where(valid, t, T_FAR)
            blk_t, blk_arg = torch.min(t, dim=1)
            blk_arg = blk_arg[:, None]
            better = blk_t < bt
            bt.copy_(torch.where(better, blk_t, bt))
            bi.copy_(torch.where(better, blk_arg[:, 0] + s, bi))
            bu.copy_(torch.where(better, u.gather(1, blk_arg)[:, 0], bu))
            bv.copy_(torch.where(better, v.gather(1, blk_arg)[:, 0], bv))
    hit = best_t < T_FAR
    normal = torch.where(hit[:, None], scene.tri_normal[best_i], 0.0)
    mat = torch.where(hit, scene.mat_id[best_i], 0).to(torch.int32)
    return Hit(t=best_t, tri=best_i.to(torch.int32), hit=hit, normal=normal,
               mat=mat, u=best_u, v=best_v)


def intersect_occluded(scene: SceneArrays, origins: torch.Tensor,
                       dirs: torch.Tensor, tmax: torch.Tensor,
                       tmin: float = 0.01, ray_chunk: int = 8192,
                       tri_block: int = 512,
                       quirk_first_hit: bool = False) -> torch.Tensor:
    """Shadow-ray occlusion with per-ray ``tmax`` [N]. Returns bool [N].

    Occluded iff any non-refractive surface lies in (tmin, tmax)
    (``traceOcclusion``, ``pathTracerPrograms.cu:651-684``).
    ``quirk_first_hit`` tests only the closest surface, as the
    reference's TERMINATE_ON_FIRST_HIT does."""
    if quirk_first_hit:
        h = intersect_closest(scene, origins, dirs, tmin=tmin, tmax=T_FAR,
                              ray_chunk=ray_chunk, tri_block=tri_block)
        in_range = h.hit & (h.t < tmax)
        return in_range & (scene.mat_bsdf[h.mat.long()] != BSDF_REFRACTION)
    n = origins.shape[0]
    n_tri = scene.num_tris_padded
    tri_block = _fit_tri_block(tri_block, n_tri)
    blocks = (scene.tri_valid
              & (scene.mat_bsdf[scene.mat_id.long()] != BSDF_REFRACTION))
    occ = torch.zeros((n,), dtype=torch.bool, device=origins.device)
    for r0 in range(0, n, ray_chunk):
        o = origins[r0:r0 + ray_chunk]
        d = dirs[r0:r0 + ray_chunk]
        tm = tmax[r0:r0 + ray_chunk, None]
        for s in range(0, n_tri, tri_block):
            sl = slice(s, s + tri_block)
            t, valid, _, _ = _mt_block(o, d, scene.tri_v0[sl],
                                       scene.tri_e1[sl], scene.tri_e2[sl],
                                       tmin, T_FAR)
            valid = valid & blocks[sl][None, :] & (t < tm)
            occ[r0:r0 + ray_chunk] |= valid.any(dim=1)
    return occ
