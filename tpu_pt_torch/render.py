"""Wavefront path-trace core (counterpart of ``tpu_pt/render.py``).

The reference's OptiX megakernel (``__raygen__rg`` / ``__miss__ms`` /
``__closesthit__diffuse__ch``, ``pathTracerPrograms.cu:707-1031``) as a
wavefront: a batch of rays is traced, shaded with vectorised BSDF
selects keyed by material id, and terminated by masks and Russian
roulette, bounce for bounce as the JAX package does it.

Schedulers, equal up to floating-point add order (the counter RNG keys
every draw by (pixel, sample, frame, stream), not by lane):

- ``scan``: loops over samples x bounces, the simple oracle;
- ``pixelq`` (default): a persistent wavefront whose lanes claim work
  items (runs of ``samples_per_item`` samples of one pixel) as soon as
  theirs finish. A finished item adds its radiance into the frame with one
  ``index_add_`` per round: static shapes, no host sync, atomic on the
  card. (The JAX package's slot buffers and sort-based drain exist only
  because TPU scatters are slow.) The ``while`` loop syncs with the host
  once per round to test for live lanes.

``regen`` is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import bsdf, film, rng
from . import vec3 as v3
from .config import RenderConfig
from .intersect import get_intersectors
from .scene.arrays import BSDF_METALLIC, BSDF_REFRACTION, SceneArrays

# DoneReason parity (``pathTracer.h:11-17``).
MISS = 0
MAX_DEPTH = 1
RUSSIAN_ROULETTE = 2
LIGHT_HIT = 3
NOT_DONE = 4
NUM_DONE_REASONS = 5

# Dead lanes and ineligible shadow rays are parked: origin far outside
# any scene, a fixed diagonal direction, shadow tmax 0.
PARK_COORD = 3.0e7
PARK_DIR = 0.5773503


@dataclasses.dataclass
class CameraArrays:
    """Device-side camera: eye + (non-orthonormal) UVW frame
    (``pathTracer.h:96-99``); [3] f32 tensors."""
    eye: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    w: torch.Tensor

    @classmethod
    def from_camera(cls, camera, device=None) -> "CameraArrays":
        u, v, w = camera.uvw_frame()
        return cls(*(torch.as_tensor(np.asarray(a, np.float32), device=device)
                     for a in (camera.eye, u, v, w)))


@dataclasses.dataclass
class RenderStats:
    """Per-frame telemetry: ray counts for Mrays/s and the DoneReason
    histogram. Counts are exact int64 tensors on the render device."""
    rays_traced: torch.Tensor           # radiance rays of live lanes
    shadow_rays: torch.Tensor           # NEE occlusion rays
    done_histogram: torch.Tensor        # [5], indexed by DoneReason
    wavefront_iterations: torch.Tensor  # trace rounds executed


def camera_rays(cam: CameraArrays, pixel_ids: torch.Tensor, width: int,
                height: int, jx: torch.Tensor, jy: torch.Tensor):
    """Primary rays for flat pixel ids (y*width + x), jittered in-pixel
    (``pathTracerPrograms.cu:730-738``). Row 0 is the image bottom.
    Returns (origins [N, 3], directions [N, 3])."""
    x = (pixel_ids % width).to(torch.float32)
    y = (pixel_ids // width).to(torch.float32)
    dx = 2.0 * ((x + jx) / width) - 1.0
    dy = 2.0 * ((y + jy) / height) - 1.0
    u, v, w = cam.u, cam.v, cam.w
    direction = v3.normalize(dx[:, None] * u + dy[:, None] * v + w)
    origin = cam.eye.expand(pixel_ids.shape[0], 3).contiguous()
    return origin, direction


def _lookup_materials(scene: SceneArrays, mat_ids: torch.Tensor) -> dict:
    """Per-lane material properties by gather."""
    m = mat_ids.long()
    return dict(diffuse=scene.mat_diffuse[m], emission=scene.mat_emission[m],
                roughness=scene.mat_roughness[m], ior=scene.mat_ior[m],
                bsdf_type=scene.mat_bsdf[m],
                is_emissive=scene.mat_is_emissive[m])


def _shade_hit(scene: SceneArrays, cfg: RenderConfig, origin, direction,
               hit, z) -> dict:
    """Closest-hit shading for the whole wavefront
    (``__closesthit__diffuse__ch``, ``pathTracerPrograms.cu:866-983``).
    ``z`` is (z1, z2, z3). Returns the per-lane BSDF transition; callers
    mask by hit."""
    props = _lookup_materials(scene, hit.mat)
    diffuse = props["diffuse"]
    ior = props["ior"]
    bsdf_type = props["bsdf_type"]
    if cfg.quirks.fixed_metal_roughness:
        roughness = torch.full_like(props["roughness"], 0.2)
    else:
        roughness = props["roughness"]

    n0 = hit.normal
    n = v3.faceforward(n0, -direction, n0)
    p = origin + direction * hit.t[:, None]
    z1, z2, z3 = z

    # diffuse: hemisphere sample about N in the reference ONB (cu:907-930)
    dir_diffuse = bsdf.sample_hemisphere_world(
        n, z1, z2, cfg.use_importance_sampling)

    # metallic: GGX half-vector reflect + conductor Fresnel (cu:931-952)
    h = bsdf.sample_ggx(z1, z2, roughness, n)
    dir_metal = v3.reflect(direction, h)
    org_metal = p + dir_metal * 1e-4
    cos_t = torch.clamp_min(v3.dot(h, -direction), 0.0)
    eta, k = bsdf.metal_eta_k(direction.device)
    mult_metal = bsdf.fresnel_conductor(cos_t, eta, k) * diffuse

    # refraction: dielectric Fresnel chooses reflect/refract (cu:954-981)
    d_norm = v3.normalize(direction)
    cos_i = v3.dot(-d_norm, n0)
    fr = bsdf.fr_dielectric(cos_i, 1.0, ior)
    refr_dir, did_refract = v3.refract(d_norm, n0, ior)
    refl_dir = v3.reflect(d_norm, n0)
    choose_reflect = ((z3 < fr) | ~did_refract)[:, None]
    dir_refr = torch.where(choose_reflect, refl_dir, refr_dir)
    org_refr = p + dir_refr * 1e-3

    is_metal = (bsdf_type == BSDF_METALLIC)[:, None]
    is_refr = (bsdf_type == BSDF_REFRACTION)[:, None]
    new_dir = torch.where(is_refr, dir_refr,
                          torch.where(is_metal, dir_metal, dir_diffuse))
    new_org = torch.where(is_refr, org_refr, torch.where(is_metal, org_metal, p))
    atten_mult = torch.where(is_refr | ~is_metal, diffuse, mult_metal)
    return dict(new_origin=new_org, new_dir=new_dir, atten_mult=atten_mult,
                n=n, p=p, emission=props["emission"],
                is_emissive=props["is_emissive"], bsdf_type=bsdf_type)


def _nee(scene: SceneArrays, occluded_fn, shade: dict, hit_mask, lz1, lz2):
    """Next-event estimation from the area light
    (``pathTracerPrograms.cu:1003-1026``). Returns (radiance [N, 3],
    shadow-ray mask [N])."""
    light = scene.light
    p, n = shade["p"], shade["n"]
    light_pos = light.corner + light.v1 * lz1[:, None] + light.v2 * lz2[:, None]
    to_l = light_pos - p
    l_dist = v3.length(to_l)
    l_dir = v3.normalize(to_l)
    n_dl = v3.dot(n, l_dir)
    ln_dl = -v3.dot(light.normal, l_dir)

    eligible = (hit_mask & (shade["bsdf_type"] != BSDF_REFRACTION)
                & (n_dl > 0.0) & (ln_dl > 0.0))
    # Ineligible lanes trace a parked shadow ray (tmax 0: never occluded).
    occ_org = torch.where(eligible[:, None], p, PARK_COORD)
    occ_dir = torch.where(eligible[:, None], l_dir, PARK_DIR)
    occ_tmax = torch.where(eligible, l_dist - 0.01, 0.0)
    occluded = occluded_fn(occ_org, occ_dir, occ_tmax)

    area = v3.length(v3.cross(light.v1, light.v2))
    m = torch.clamp_min(l_dist, 1e-6)
    weight = n_dl * ln_dl * area / (math.pi * (m * m))
    w = torch.where(eligible & ~occluded, weight, 0.0)
    return light.emission * w[:, None], eligible


def _bounce(scene: SceneArrays, cfg: RenderConfig, closest_fn, occluded_fn,
            pixel_ids, sample_idx, frame_idx, origin, direction, atten,
            depth) -> dict:
    """One trace + shade round for the whole wavefront. ``sample_idx`` and
    ``depth`` are ints (scan) or per-lane int64 tensors (pixelq)."""
    depth_t = torch.as_tensor(depth, dtype=torch.int64, device=origin.device)
    sa = rng.STREAM_BOUNCE_A + 2 * depth_t
    sb = rng.STREAM_BOUNCE_B + 2 * depth_t
    z1, z2, z3, _ = rng.uniform4(pixel_ids, sample_idx, frame_idx, sa)
    lz1, lz2, z_rr, _ = rng.uniform4(pixel_ids, sample_idx, frame_idx, sb)

    hit = closest_fn(origin, direction)
    hit_mask = hit.hit
    shade = _shade_hit(scene, cfg, origin, direction, hit, (z1, z2, z3))

    # Emission channel: only at depth 0 (cu:898-901); a miss writes 0.
    emit_mask = hit_mask & (depth_t == 0) & shade["is_emissive"]
    emitted = shade["emission"] * emit_mask[:, None].to(torch.float32)

    # Radiance channel: miss -> background (cu:841), light hit -> emission
    # (cu:992-996), else 0; NEE adds direct light.
    light_hit = hit_mask & shade["is_emissive"]
    miss_f = torch.where(hit_mask, 0.0, 1.0)[:, None]
    background = torch.tensor(cfg.background, dtype=torch.float32,
                              device=origin.device)
    radiance = torch.where(light_hit[:, None], shade["emission"],
                           miss_f * background)
    shadow_mask = torch.zeros_like(hit_mask)
    if cfg.use_direct_lighting:
        nee_radiance, shadow_mask = _nee(scene, occluded_fn, shade,
                                         hit_mask, lz1, lz2)
        radiance = radiance + nee_radiance

    # Attenuation takes the hit BSDF color BEFORE weighting the radiance
    # (the reference's closest-hit-then-raygen order).
    atten_new = torch.where(hit_mask[:, None], atten * shade["atten_mult"],
                            atten)
    contrib = emitted + radiance * atten_new

    # Russian roulette on perceived brightness (cu:763-773).
    p_rr = v3.luminance(atten_new)
    rr_kill = z_rr > p_rr
    at_max = depth_t >= cfg.max_depth
    done = ~hit_mask | light_hit | rr_kill | at_max

    # DoneReason precedence (cu:768-771): MAX_DEPTH beats RR beats
    # MISS / LIGHT_HIT.
    base_reason = torch.where(~hit_mask, MISS,
                              torch.where(light_hit, LIGHT_HIT, NOT_DONE))
    reason = torch.where(at_max, MAX_DEPTH,
                         torch.where(rr_kill, RUSSIAN_ROULETTE, base_reason))

    # RR compensation applies only to surviving paths (cu:773 safeDivide).
    atten_cont = v3.safe_divide(atten_new, p_rr)
    return dict(contrib=contrib, atten_new=atten_new, atten_cont=atten_cont,
                new_origin=shade["new_origin"], new_dir=shade["new_dir"],
                done=done, reason=reason, shadow_mask=shadow_mask)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _render_scan(scene, cam, cfg, pixel_start, n, frame_idx, closest_fn,
                 occluded_fn):
    """Reference-shaped scheduler: samples x bounces, every lane every
    bounce (dead lanes masked)."""
    dev = scene.device
    pixel_ids = pixel_start + torch.arange(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_rays, n_shadow = _zero_count(dev), _zero_count(dev)
    hist = torch.zeros(NUM_DONE_REASONS, dtype=torch.int64, device=dev)
    for sample in range(cfg.spp):
        jx, jy = rng.uniform2(pixel_ids, sample, frame_idx,
                              rng.STREAM_JITTER)
        origin, direction = camera_rays(cam, pixel_ids, cfg.width,
                                        cfg.height, jx, jy)
        atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
        reason = torch.full((n,), NOT_DONE, dtype=torch.int64, device=dev)
        for depth in range(cfg.max_depth + 1):
            step = _bounce(scene, cfg, closest_fn, occluded_fn, pixel_ids,
                           sample, frame_idx, origin, direction, atten, depth)
            alive_f = alive.to(torch.float32)[:, None]
            result = result + step["contrib"] * alive_f
            reason = torch.where(alive & step["done"], step["reason"], reason)
            n_rays += alive.sum()
            n_shadow += (alive & step["shadow_mask"]).sum()
            alive_next = (alive & ~step["done"])[:, None]
            atten = torch.where(alive_next, step["atten_cont"],
                                step["atten_new"])
            origin = torch.where(alive_next, step["new_origin"], origin)
            direction = torch.where(alive_next, step["new_dir"], direction)
            alive = alive_next[:, 0]
        hist += torch.bincount(reason, minlength=NUM_DONE_REASONS)
        acc = acc + result
    iters = torch.tensor(cfg.spp * (cfg.max_depth + 1), device=dev)
    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist, wavefront_iterations=iters)
    return acc * (1.0 / cfg.spp), stats


def _render_pixelq(scene, cam, cfg, pixel_start, n, frame_idx, closest_fn,
                   occluded_fn):
    """Persistent wavefront over a pixel-granular work queue.

    Item g covers pixel slot g % n, samples (g // n) * chunk onward, with
    chunk = min(spp, samples_per_item). A lane traces its item's samples
    back to back, accumulating radiance in ``pending``; when the item's
    last path ends it adds ``pending`` into the frame and claims the next
    unissued item (tickets by exclusive cumsum over finishing lanes).
    The wavefront holds min(lanes, max(4096, items // 8), items) lanes, so
    each lane averages about eight items and the queue keeps lanes busy
    until it drains."""
    dev = scene.device
    chunk = max(1, min(cfg.spp, cfg.samples_per_item))
    n_chunks = (cfg.spp + chunk - 1) // chunk
    total = n * n_chunks
    n_lanes = min(cfg.lanes, max(4096, total // 8), total)

    def item_pixel(g):
        return g % n, (g // n) * chunk          # (pixel slot, first sample)

    def item_rays(j, sample):
        pix = pixel_start + j
        jx, jy = rng.uniform2(pix, sample, frame_idx, rng.STREAM_JITTER)
        return camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)

    g = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    j, sample = item_pixel(g)
    origin, direction = item_rays(j, sample)
    atten = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    pending = torch.zeros((n_lanes, 3), dtype=torch.float32, device=dev)
    active = g < total
    next_g = torch.tensor(n_lanes, dtype=torch.int64, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_rays, n_shadow = _zero_count(dev), _zero_count(dev)
    hist = torch.zeros(NUM_DONE_REASONS, dtype=torch.int64, device=dev)
    iters = 0

    while bool(active.any()):
        j, chunk0 = item_pixel(g)
        step = _bounce(scene, cfg, closest_fn, occluded_fn, pixel_start + j,
                       sample, frame_idx, origin, direction, atten, depth)
        pending = pending + step["contrib"] * active.to(torch.float32)[:, None]
        path_done = active & step["done"]
        hist.index_add_(0, step["reason"], path_done.to(torch.int64))
        n_rays += active.sum()
        n_shadow += (active & step["shadow_mask"]).sum()

        item_end = torch.clamp_max(chunk0 + chunk, cfg.spp)
        more_samples = path_done & (sample + 1 < item_end)
        pixel_done = path_done & (sample + 1 >= item_end)
        result.index_add_(0, j, pending * pixel_done.to(torch.float32)[:, None])

        # Claim the next queue items: finishing lane k gets ticket
        # next_g + (number of finishing lanes before k).
        fin = pixel_done.to(torch.int64)
        rank = torch.cumsum(fin, 0) - fin
        new_g = next_g + rank
        has_new = pixel_done & (new_g < total)
        next_g = next_g + fin.sum()

        cont = active & ~step["done"]
        respawn = more_samples | has_new
        g = torch.where(has_new, new_g, g)
        new_j, new_s0 = item_pixel(g)
        j = torch.where(has_new, new_j, j)
        sample = torch.where(more_samples, sample + 1,
                             torch.where(has_new, new_s0, sample))
        o_new, d_new = item_rays(torch.where(respawn, j, 0),
                                 torch.where(respawn, sample, 0))
        cont3, respawn3 = cont[:, None], respawn[:, None]
        # Retired lanes park their rays.
        origin = torch.where(cont3, step["new_origin"],
                             torch.where(respawn3, o_new, PARK_COORD))
        direction = torch.where(cont3, step["new_dir"],
                                torch.where(respawn3, d_new, PARK_DIR))
        atten = torch.where(cont3, step["atten_cont"],
                            torch.where(respawn3, 1.0, atten))
        depth = torch.where(cont, depth + 1, 0)
        pending = torch.where(pixel_done[:, None], 0.0, pending)
        active = cont | respawn
        iters += 1

    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist,
                        wavefront_iterations=torch.tensor(iters, device=dev))
    return result * (1.0 / cfg.spp), stats


def render_wavefront(scene: SceneArrays, cam: CameraArrays,
                     cfg: RenderConfig, pixel_start: int, n_pixels: int,
                     frame_idx: int):
    """Mean radiance over ``cfg.spp`` samples for ``n_pixels`` consecutive
    pixels from flat index ``pixel_start``. Returns (radiance [n, 3] f32,
    RenderStats)."""
    closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=False)
    impls = {"scan": _render_scan, "pixelq": _render_pixelq}
    if cfg.scheduler not in impls:
        raise NotImplementedError(f"scheduler {cfg.scheduler!r} is not "
                                  "ported (use pixelq or scan)")
    return impls[cfg.scheduler](scene, cam, cfg, pixel_start, n_pixels,
                                frame_idx, closest_fn, occluded_fn)


def render_frame(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                 frame_idx: int, accum: torch.Tensor):
    """Progressive frame step: trace, average, fold into the accumulator
    (one ``optixLaunch`` + accumulation, ``PathTracerMain.cpp:184-210``).

    ``accum`` [H, W, 3] f32 is updated IN PLACE (the JAX version donates
    it) and returned. Returns (accum, srgb_u8 [H, W, 3], RenderStats)."""
    n = cfg.width * cfg.height
    radiance, stats = render_wavefront(scene, cam, cfg, 0, n, frame_idx)
    frame_img = radiance.reshape(cfg.height, cfg.width, 3)
    accum.copy_(film.accumulate(accum, frame_img, frame_idx))
    return accum, film.make_color(accum), stats


def init_accum(cfg: RenderConfig, device=None) -> torch.Tensor:
    """Fresh accumulation buffer (``PathTracerMain.cpp:166-182``)."""
    return torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                       device=device)


def image_to_host(frame_u8: torch.Tensor) -> np.ndarray:
    """Device frame -> numpy, flipped to top-down row order for image files."""
    return frame_u8.cpu().numpy()[::-1]
