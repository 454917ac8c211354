"""Intersection backends (counterpart of ``tpu_pt/intersect/__init__.py``).

``get_intersectors`` picks the backend per config:

- ``bruteforce``: chunked Möller-Trumbore in plain PyTorch (any device);
- ``dense``: the hand-written dense kernels of ``dense`` (their plain
  versions for a scene on the CPU);
- ``auto``: ``dense`` for a scene on a CUDA device, ``bruteforce`` for a
  scene on the CPU (as the JAX package runs its Pallas kernels only on a
  TPU).

Analytic primitives, curves, the BVH and the fused closest-hit + NEE
kernel are not ported yet.
"""

from __future__ import annotations

from functools import partial

from ..config import RenderConfig
from ..scene.arrays import SceneArrays
from . import dense
from .moller import Hit, intersect_closest, intersect_occluded

__all__ = ["Hit", "intersect_closest", "intersect_occluded",
           "get_intersectors"]


def _resolve(scene: SceneArrays, cfg: RenderConfig) -> str:
    if cfg.intersector != "auto":
        return cfg.intersector
    return "dense" if scene.device.type == "cuda" else "bruteforce"


def get_intersectors(scene: SceneArrays, cfg: RenderConfig,
                     want_uv: bool = True):
    """Returns (closest_fn(o, d) -> Hit, occluded_fn(o, d, tmax) -> bool)."""
    if cfg.fused_nee:
        raise NotImplementedError("fused_nee: the fused closest-hit + NEE "
                                  "kernel is not ported yet (ROADMAP.md)")
    backend = _resolve(scene, cfg)
    quirk = cfg.quirks.occlusion_first_hit_only
    if backend == "dense":
        tables = dense.prepare(scene)
        closest = partial(dense.closest_hit, tables, tmin=cfg.t_min,
                          tmax=cfg.t_max, want_uv=want_uv)
        occluded = partial(dense.occluded_hit, tables, tmin=cfg.t_min,
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
