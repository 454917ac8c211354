"""Per-pixel path debugging and frame validation (counterpart of
``tpu_pt/debug.py``).

The reference debugs paths with pixel-targeted device printf macros
(``cuda/util.h:34-47``) and a commented DoneReason dump in raygen
(``pathTracerPrograms.cu:786-801``). ``trace_pixel`` replays one (pixel,
sample) path through the same ``_bounce`` transition the renderer runs
(the counter RNG makes the replay exact) and returns one record per
bounce. ``validate_frame`` / ``validate_whitted_frame`` are the OptiX
validation mode (``PathTracerMain.cpp:248-253``): the JAX package ran the
frame under ``checkify``; here every intersector result of the frame and
the frame itself go through explicit checks, and a failed check raises
:class:`ValidationError` with its name.
"""

from __future__ import annotations

import torch

from . import film, rng
from .config import RenderConfig
from .intersect import get_fused_closest_nee, get_intersectors
from .render import (DONE_REASON_NAMES, CameraArrays, _bounce, _wavefront,
                     camera_rays, init_accum)
from .scene.arrays import SceneArrays


class ValidationError(RuntimeError):
    """A check of ``validate_frame`` / ``validate_whitted_frame`` failed."""


def _vec(a: torch.Tensor) -> tuple:
    return tuple(float(x) for x in a[0].cpu())


def trace_pixel(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                x: int, y: int, sample: int = 0,
                frame: int = 0) -> list[dict]:
    """Replay one sample's path at pixel (x, y) bounce by bounce.

    Returns a list of per-bounce records: depth, ray origin/direction,
    attenuation after the hit, radiance contribution added this bounce,
    and the DoneReason name when the path ends. The contributions sum to
    the sample's radiance in a frame of the same config (through the
    fused kernels too, where ``cfg.fused_nee`` selects them)."""
    dev = scene.device
    closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=False)
    fused_fn = get_fused_closest_nee(scene, cfg)
    pix = torch.tensor([y * cfg.width + x], dtype=torch.int64, device=dev)
    samp = torch.tensor([sample], dtype=torch.int64, device=dev)
    jx, jy = rng.uniform2(pix, samp, frame, rng.STREAM_JITTER)
    origin, direction = camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)
    atten = torch.ones((1, 3), dtype=torch.float32, device=dev)

    records: list[dict] = []
    for depth in range(cfg.max_depth + 1):
        step = _bounce(scene, cfg, closest_fn, occluded_fn, pix, samp, frame,
                       origin, direction, atten,
                       torch.tensor([depth], device=dev), fused_fn)
        done = bool(step["done"][0])
        records.append(dict(
            depth=depth,
            origin=_vec(origin),
            direction=_vec(direction),
            contrib=_vec(step["contrib"]),
            atten=_vec(step["atten_new"]),
            done=done,
            reason=(DONE_REASON_NAMES[int(step["reason"][0])] if done
                    else "NOT_DONE")))
        if done:
            break
        origin, direction = step["new_origin"], step["new_dir"]
        atten = step["atten_cont"]
    return records


def format_trace(records: list[dict]) -> str:
    """Human-readable dump, one line per bounce (the printf analog)."""
    lines = []
    for r in records:
        o, d, c = r["origin"], r["direction"], r["contrib"]
        lines.append(
            f"d{r['depth']}: o=({o[0]:.2f},{o[1]:.2f},{o[2]:.2f}) "
            f"dir=({d[0]:.3f},{d[1]:.3f},{d[2]:.3f}) "
            f"contrib=({c[0]:.4f},{c[1]:.4f},{c[2]:.4f}) "
            f"{r['reason'] if r['done'] else ''}".rstrip())
    return "\n".join(lines)


def _check(name: str, ok) -> None:
    if not bool(ok):
        raise ValidationError(name)


def _finite(name: str, x: torch.Tensor) -> None:
    _check(f"{name}: NaN or Inf", torch.isfinite(x).all())


def _in_range(name: str, ids: torch.Tensor, hit: torch.Tensor,
              bound: int) -> None:
    _check(f"{name} out of range [0, {bound})",
           ((ids >= 0) & (ids < bound) | ~hit).all())


def _check_hit(hit, n_rows: int, n_mats: int, n_inst: int | None) -> None:
    """One closest-hit result: finite t and normal, and the row, material
    and (instanced) instance of every hit lane in range."""
    _finite("hit t", hit.t)
    _finite("hit normal", hit.normal)
    _in_range("hit row id", hit.tri, hit.hit, n_rows)
    _in_range("hit material id", hit.mat, hit.hit, n_mats)
    if n_inst is not None:
        _in_range("hit instance id", hit.inst, hit.hit, n_inst)


def _checked(closest_fn, occluded_fn, geom: SceneArrays, n_inst=None,
             fused_fn=None):
    """The intersectors with every result checked as it comes. Hit ids
    range over the padded triangles, then the scene's analytic primitives,
    then its curve segments."""
    n_ids = geom.num_tris_padded + sum(
        0 if part is None else part.count for part in (geom.prims,
                                                       geom.curves))
    bounds = (n_ids, geom.num_materials, n_inst)

    def closest(o, d):
        hit = closest_fn(o, d)
        _check_hit(hit, *bounds)
        return hit

    def occluded(o, d, tmax):
        occ = occluded_fn(o, d, tmax)
        _check("occlusion flags: not bool [N]",
               occ.dtype == torch.bool and occ.shape == tmax.shape)
        return occ

    def fused(o, d, lz1, lz2):
        hit, occ = fused_fn(o, d, lz1, lz2)
        _check_hit(hit, *bounds)
        return hit, occ

    return closest, occluded, (None if fused_fn is None else fused)


def _finish(cfg, radiance, stats, frame_idx: int, accum):
    """Check the frame's radiance, fold it into ``accum`` and check that."""
    _finite("frame radiance", radiance)
    _check("NOT_DONE paths remain", stats.done_histogram[-1] == 0)
    accum.copy_(film.accumulate(accum, radiance.reshape(cfg.height,
                                                        cfg.width, 3),
                                frame_idx))
    _finite("accumulator", accum)
    return accum, film.make_color(accum), stats


def validate_frame(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                   frame_idx: int = 0, accum=None):
    """``render_frame`` with every check of the module docstring; slower
    (each check reads back a flag), a debugging tool. Returns (accum,
    frame_u8, stats) like ``render_frame``; raises ValidationError."""
    if accum is None:
        accum = init_accum(cfg, device=scene.device)
    closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=False)
    closest_fn, occluded_fn, fused_fn = _checked(
        closest_fn, occluded_fn, scene,
        fused_fn=get_fused_closest_nee(scene, cfg))
    radiance, stats = _wavefront(scene, cam, cfg, 0, cfg.width * cfg.height,
                                 frame_idx, closest_fn, occluded_fn,
                                 fused_fn)
    return _finish(cfg, radiance, stats, frame_idx, accum)


def validate_whitted_frame(ws, cam: CameraArrays, cfg: RenderConfig,
                           frame_idx: int = 0, accum=None):
    """``validate_frame`` for the Whitted pipeline (every scene part's
    intersectors checked, instance ids included). Returns (accum,
    frame_u8, stats); raises ValidationError."""
    from .whitted import _intersectors, render_whitted_wavefront
    if accum is None:
        accum = init_accum(cfg, device=ws.device)

    def intersectors(geom, table, cfg):
        closest, occluded, _ = _checked(
            *_intersectors(geom, table, cfg), geom,
            None if table is None else table.count)
        return closest, occluded

    radiance, stats = render_whitted_wavefront(
        ws, cam, cfg, 0, cfg.width * cfg.height, frame_idx,
        intersectors=intersectors)
    return _finish(cfg, radiance, stats, frame_idx, accum)
