"""Intersection backends (counterpart of ``tpu_pt/intersect/__init__.py``).

``get_intersectors`` picks the backend per config:

- ``bruteforce``: chunked Möller-Trumbore in plain PyTorch (any device);
- ``dense``: the hand-written kernels of ``dense``, or of ``clustered``
  for a scene above ``dense.TRI_SLAB`` packed rows (their plain versions
  for a scene on the CPU);
- ``auto``: ``dense`` for a scene on a CUDA device, ``bruteforce`` for a
  scene on the CPU (as the JAX package runs its Pallas kernels only on a
  TPU).

``get_fused_closest_nee`` returns the fused closest-hit + NEE kernels
(K4 / K5 of ``dense``) where the JAX package fuses, else None.

Analytic primitives, curves and the LBVH are not ported yet.
"""

from __future__ import annotations

from functools import partial

from ..config import RenderConfig
from ..scene.arrays import SceneArrays
from . import clustered, dense
from .moller import Hit, intersect_closest, intersect_occluded

__all__ = ["Hit", "intersect_closest", "intersect_occluded",
           "get_intersectors", "get_fused_closest_nee", "kernel_module"]


def _resolve(scene: SceneArrays, cfg: RenderConfig) -> str:
    if cfg.intersector != "auto":
        return cfg.intersector
    return "dense" if scene.device.type == "cuda" else "bruteforce"


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
    light, the quirk occlusion mode is on, or the scene is above
    ``dense.TRI_SLAB`` rows (the fused kernels sweep one table)."""
    if (not cfg.fused_nee or _resolve(scene, cfg) != "dense"
            or scene.light is None or cfg.quirks.occlusion_first_hit_only
            or scene.num_tris_padded > dense.TRI_SLAB):
        return None
    return partial(dense.closest_nee_hit, dense.prepare(scene),
                   dense.light_vector(scene), tmin=cfg.t_min, tmax=cfg.t_max)


def get_intersectors(scene: SceneArrays, cfg: RenderConfig,
                     want_uv: bool = True):
    """Returns (closest_fn(o, d) -> Hit, occluded_fn(o, d, tmax) -> bool)."""
    backend = _resolve(scene, cfg)
    quirk = cfg.quirks.occlusion_first_hit_only
    if backend == "dense":
        kernels = kernel_module(scene)
        tables = kernels.prepare(scene)
        closest = partial(kernels.closest_hit, tables, tmin=cfg.t_min,
                          tmax=cfg.t_max, want_uv=want_uv)
        occluded = partial(kernels.occluded_hit, tables, tmin=cfg.t_min,
                           quirk_first_hit=quirk)
        return closest, occluded
    if backend != "bruteforce":
        raise NotImplementedError(
            f"intersector {backend!r} is not ported (use auto, bruteforce "
            "or dense)")
    closest = partial(intersect_closest, scene, tmin=cfg.t_min,
                      tmax=cfg.t_max, ray_chunk=cfg.ray_chunk,
                      tri_block=cfg.tri_block)
    occluded = partial(intersect_occluded, scene, tmin=cfg.t_min,
                       ray_chunk=cfg.ray_chunk, tri_block=cfg.tri_block,
                       quirk_first_hit=quirk)
    return closest, occluded
