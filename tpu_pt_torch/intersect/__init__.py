"""Intersection backends (counterpart of ``tpu_pt/intersect/__init__.py``).

``get_intersectors`` picks the backend per config:

- ``bruteforce``: chunked Möller-Trumbore in plain PyTorch (any device);
- ``dense``: the hand-written kernels of ``dense``, or of ``clustered``
  for a scene above ``dense.TRI_SLAB`` packed rows (their plain versions
  for a scene on the CPU);
- ``bvh``: the LBVH walk of ``lbvh`` in plain PyTorch (any device);
- ``auto``: the JAX package's rule with ``dense`` for its Pallas kernels.
  On a CUDA device ``dense``, unless the scene is above
  ``TPU_BVH_CROSSOVER_TRIS`` padded triangles and has a BVH; on the CPU
  ``bvh`` above ``BVH_CROSSOVER_TRIS`` when the scene has one, else
  ``bruteforce``.

A scene's analytic primitives and curves (``primitives``, ``curves``) are
intersected beside whichever backend it takes and combined by min-t.
``get_fused_closest_nee`` returns the fused closest-hit + NEE kernels
(K4 / K5 of ``dense``) where the JAX package fuses, else None.
"""

from __future__ import annotations

import dataclasses
import os
from functools import partial

from ..config import RenderConfig
from ..scene.arrays import SceneArrays
from . import clustered, dense
from .clustered import SLAB_UNKNOWN
from .moller import Hit, intersect_closest, intersect_occluded

__all__ = ["Hit", "intersect_closest", "intersect_occluded",
           "get_intersectors", "get_fused_closest_nee", "kernel_module",
           "SLAB_UNKNOWN"]

# Dense all-pairs testing beats the LBVH walk below these padded triangle
# counts (the JAX package's thresholds: the walk is gather-bound, so the
# kernels win far longer than the chunked CPU sweep does).
BVH_CROSSOVER_TRIS = 4096            # CPU (bruteforce vs lbvh)
TPU_BVH_CROSSOVER_TRIS = 1 << 20     # the card (dense vs lbvh)


def _count(part) -> int:
    return 0 if part is None else part.count


def _resolve(scene: SceneArrays, cfg: RenderConfig) -> str:
    if cfg.intersector != "auto":
        return cfg.intersector
    if scene.device.type == "cuda":
        if (scene.num_tris_padded > TPU_BVH_CROSSOVER_TRIS
                and scene.bvh is not None):
            return "bvh"
        return "dense"
    if scene.num_tris_padded > BVH_CROSSOVER_TRIS and scene.bvh is not None:
        return "bvh"
    return "bruteforce"


def kernel_module(scene: SceneArrays):
    """The kernels a scene takes on the ``dense`` backend: ``dense``, or
    ``clustered`` for a scene above ``dense.TRI_SLAB`` packed rows
    (``pallas_bf._intersect_closest_tiled``'s single-slab test). Each
    module has ``prepare``, ``closest_hit`` and ``occluded_hit``."""
    rows = dense._pad_to(scene.num_tris_padded, dense.TRI_BLOCK)
    return clustered if rows > dense.TRI_SLAB else dense


def get_fused_closest_nee(scene: SceneArrays, cfg: RenderConfig):
    """``fused_fn(o, d, lz1, lz2) -> (Hit, occluded)``, the fused
    closest-hit + NEE-occlusion kernels, or None
    (``tpu_pt.intersect.get_fused_closest_nee``, with ``dense`` for
    ``pallas``). None, so that the two-kernel path runs, when
    ``fused_nee`` is off, the backend is not ``dense``, the scene has no
    light, the quirk occlusion mode is on, the scene has analytic
    primitives or curves (the fused kernels know nothing of them), or it
    is above ``dense.TRI_SLAB`` rows (the fused kernels sweep one table)."""
    if (not cfg.fused_nee or _resolve(scene, cfg) != "dense"
            or scene.light is None or cfg.quirks.occlusion_first_hit_only
            or _count(scene.prims) or _count(scene.curves)
            or scene.num_tris_padded > dense.TRI_SLAB):
        return None
    return partial(dense.closest_nee_hit, dense.prepare(scene),
                   dense.light_vector(scene), tmin=cfg.t_min, tmax=cfg.t_max)


def _with_analytic(closest_fn, occluded_fn, closest_extra, occluded_extra):
    """Bind analytic geometry into the pipeline: its closest hit joins the
    backend's by min-t, its any-hit by or. A landing-slab prediction
    passes through to the backend, and the slab that comes back is reset
    to ``SLAB_UNKNOWN`` where the analytic geometry wins."""
    import torch
    from .primitives import combine_hits
    supports_pred = getattr(closest_fn, "supports_pred", False)

    def closest(o, d, pred=None, want_slab=False):
        extra = closest_extra(o, d)
        if want_slab:
            hit, slab = closest_fn(o, d, pred=pred, want_slab=True)
            slab = torch.where(extra.t < hit.t, SLAB_UNKNOWN, slab)
            return combine_hits(hit, extra), slab
        hit = (closest_fn(o, d, pred=pred) if supports_pred
               else closest_fn(o, d))
        return combine_hits(hit, extra)

    closest.supports_pred = supports_pred

    def occluded(o, d, tmax):
        return occluded_fn(o, d, tmax) | occluded_extra(o, d, tmax)

    return closest, occluded


def _with_primitives(scene: SceneArrays, cfg: RenderConfig, closest_fn,
                     occluded_fn):
    """The reference's SBT-bound custom-primitive programs
    (``sutil/Scene.cpp:1368-1450``) as a dense pass over the few
    primitives beside the triangles. Primitive ids are offset past the
    padded triangles, so that consumers can tell them apart."""
    from .primitives import intersect_primitives, occluded_primitives
    return _with_analytic(
        closest_fn, occluded_fn,
        partial(intersect_primitives, scene.prims, tmin=cfg.t_min,
                tmax=cfg.t_max, index_offset=scene.num_tris_padded),
        lambda o, d, tmax: occluded_primitives(scene.prims, o, d, tmax,
                                               tmin=cfg.t_min))


def _with_curves(scene: SceneArrays, cfg: RenderConfig, closest_fn,
                 occluded_fn):
    """Swept-sphere curves (``intersect.curves``) join the hit stream as
    the primitives do; their ids lie past the primitives'."""
    from .curves import intersect_curves, occluded_curves
    offset = scene.num_tris_padded + _count(scene.prims)
    return _with_analytic(
        closest_fn, occluded_fn,
        partial(intersect_curves, scene.curves, tmin=cfg.t_min,
                tmax=cfg.t_max, index_offset=offset),
        lambda o, d, tmax: occluded_curves(scene.curves, o, d, tmax,
                                           tmin=cfg.t_min))


def get_intersectors(scene: SceneArrays, cfg: RenderConfig,
                     want_uv: bool = True):
    """Returns (closest_fn(o, d) -> Hit, occluded_fn(o, d, tmax) -> bool).
    On the clustered kernels ``closest_fn`` also takes ``pred=`` (per-ray
    predicted landing slabs) and ``want_slab=True`` (returns (Hit, slab
    [N] i32)), and carries ``supports_pred``: true where the JAX package
    predicts (no u, v wanted, a scene above ``TRI_SLAB``, ``TPT_LEAN_BIG``
    not 0, ``TPT_BINNED`` not on the closest side, ``TPT_PRED`` not 0)."""
    if _count(scene.curves):
        base = dataclasses.replace(scene, curves=None)
        return _with_curves(scene, cfg,
                            *get_intersectors(base, cfg, want_uv=want_uv))
    if _count(scene.prims):
        base = dataclasses.replace(scene, prims=None)
        return _with_primitives(scene, cfg,
                                *get_intersectors(base, cfg, want_uv=want_uv))
    backend = _resolve(scene, cfg)
    quirk = cfg.quirks.occlusion_first_hit_only
    if backend == "dense":
        kernels = kernel_module(scene)
        tables = kernels.prepare(scene)
        closest = partial(kernels.closest_hit, tables, tmin=cfg.t_min,
                          tmax=cfg.t_max, want_uv=want_uv)
        occluded = partial(kernels.occluded_hit, tables, tmin=cfg.t_min,
                           quirk_first_hit=quirk)
        if kernels is clustered:
            # The landing-slab prediction pays only where the clustered
            # lean path runs: it takes the prediction (K11's slab order)
            # and gives the next one (the winning row's slab).
            # TPT_PRED=0 turns it off.
            env = os.environ.get
            closest.supports_pred = (not want_uv
                                     and env("TPT_LEAN_BIG", "1") == "1"
                                     and env("TPT_BINNED", "0")
                                     not in ("1", "closest")
                                     and env("TPT_PRED", "1") != "0")
        return closest, occluded
    if backend == "bvh":
        from . import lbvh
        closest = partial(lbvh.intersect_closest, scene, tmin=cfg.t_min,
                          tmax=cfg.t_max)
        occluded = partial(lbvh.intersect_occluded, scene, tmin=cfg.t_min,
                           quirk_first_hit=quirk)
        return closest, occluded
    if backend != "bruteforce":
        raise ValueError(f"unknown intersector {backend!r} (auto, "
                         "bruteforce, dense or bvh)")
    closest = partial(intersect_closest, scene, tmin=cfg.t_min,
                      tmax=cfg.t_max, ray_chunk=cfg.ray_chunk,
                      tri_block=cfg.tri_block)
    occluded = partial(intersect_occluded, scene, tmin=cfg.t_min,
                       ray_chunk=cfg.ray_chunk, tri_block=cfg.tri_block,
                       quirk_first_hit=quirk)
    return closest, occluded
