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
- ``regen``: a persistent wavefront over a queue of single (pixel,
  sample) paths; a lane claims the next path as soon as its own ends, and
  each round adds its lanes' radiance into the frame with one
  ``index_add_``. Several lanes may hold samples of one pixel at once, so
  on the card the adds into a pixel come in no fixed order.

With ``cfg.fused_nee`` the closest hit and the NEE shadow ray of a round
run as one kernel where the JAX package fuses them
(``intersect.get_fused_closest_nee``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import bsdf, film, rng
from .profiling import span
from . import vec3 as v3
from .config import RenderConfig
from .intersect import (SLAB_UNKNOWN, get_fused_closest_nee,
                        get_intersectors)
from .scene.arrays import BSDF_METALLIC, BSDF_REFRACTION, SceneArrays

# DoneReason parity (``pathTracer.h:11-17``).
MISS = 0
MAX_DEPTH = 1
RUSSIAN_ROULETTE = 2
LIGHT_HIT = 3
NOT_DONE = 4
NUM_DONE_REASONS = 5
DONE_REASON_NAMES = ("MISS", "MAX_DEPTH", "RUSSIAN_ROULETTE", "LIGHT_HIT",
                     "NOT_DONE")

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
    def from_camera(cls, camera, device="cuda") -> "CameraArrays":
        """The camera's frame on ``device`` (the card unless the caller
        asks for the CPU)."""
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
    with span("pt.nee"):
        light = scene.light
        p, n = shade["p"], shade["n"]
        light_pos = (light.corner + light.v1 * lz1[:, None]
                     + light.v2 * lz2[:, None])
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
        with span("pt.intersect"):
            occluded = occluded_fn(occ_org, occ_dir, occ_tmax)

        area = v3.length(v3.cross(light.v1, light.v2))
        m = torch.clamp_min(l_dist, 1e-6)
        weight = n_dl * ln_dl * area / (math.pi * (m * m))
        w = torch.where(eligible & ~occluded, weight, 0.0)
        return light.emission * w[:, None], eligible


def _bounce(scene: SceneArrays, cfg: RenderConfig, closest_fn, occluded_fn,
            pixel_ids, sample_idx, frame_idx, origin, direction, atten,
            depth, fused_fn=None, pred=None) -> dict:
    """One trace + shade round for the whole wavefront. ``sample_idx`` and
    ``depth`` are ints (scan) or per-lane int64 tensors (pixelq, regen).
    ``shadow_count`` is the lane's number of shadow rays (0 or 1).

    With ``pred`` (per-lane predicted landing slabs, the clustered lean
    path) the closest hit is asked for its winner's slab too, returned as
    ``hit_slab``: the next round's prediction.

    With ``fused_fn`` and direct lighting on, one fused call gives the
    closest hit and the occlusion of the shadow ray toward the light
    sample (lz1, lz2), drawn before the trace (the counter RNG allows it);
    ``_nee`` then reads that occlusion instead of tracing."""
    with span("pt.rng"):
        z1, z2, z3, lz1, lz2, z_rr = rng.bounce_uniforms(
            pixel_ids, sample_idx, frame_idx, depth)

    hit_slab = None
    with span("pt.intersect"):
        if fused_fn is not None and cfg.use_direct_lighting:
            hit, occ_pre = fused_fn(origin, direction, lz1, lz2)

            def occluded_fn(o, d, tmax):
                return occ_pre
        elif pred is not None:
            hit, hit_slab = closest_fn(origin, direction, pred=pred,
                                       want_slab=True)
        else:
            hit = closest_fn(origin, direction)
    with span("pt.shade"):
        depth_t = torch.as_tensor(depth, dtype=torch.int64,
                                  device=origin.device)
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
        atten_new = torch.where(hit_mask[:, None],
                                atten * shade["atten_mult"], atten)
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
                             torch.where(rr_kill, RUSSIAN_ROULETTE,
                                         base_reason))

        # RR compensation applies only to surviving paths (cu:773 safeDivide).
        atten_cont = v3.safe_divide(atten_new, p_rr)
        shadow_count = shadow_mask.to(torch.int64)
    return dict(contrib=contrib, atten_new=atten_new, atten_cont=atten_cont,
                new_origin=shade["new_origin"], new_dir=shade["new_dir"],
                done=done, reason=reason, hit_slab=hit_slab,
                shadow_count=shadow_count)


def _zero_count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=device)


def _render_scan(scene, cam, cfg, pixel_start, n, frame_idx, closest_fn,
                 occluded_fn, fused_fn=None, sample_offset: int = 0):
    """Reference-shaped scheduler: samples x bounces, every lane every
    bounce (dead lanes masked). The RNG's sample axis starts at
    ``sample_offset``."""
    dev = scene.device
    pixel_ids = pixel_start + torch.arange(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_rays, n_shadow = _zero_count(dev), _zero_count(dev)
    hist = torch.zeros(NUM_DONE_REASONS, dtype=torch.int64, device=dev)
    for sample in range(sample_offset, sample_offset + cfg.spp):
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
                           sample, frame_idx, origin, direction, atten, depth,
                           fused_fn)
            alive_f = alive.to(torch.float32)[:, None]
            result = result + step["contrib"] * alive_f
            reason = torch.where(alive & step["done"], step["reason"], reason)
            n_rays += alive.sum()
            n_shadow += (step["shadow_count"] * alive).sum()
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


def _render_pixelq(dev, cam, cfg, pixel_start, n, frame_idx, bounce_fn,
                   items_per_lane: int, sample_offset: int = 0,
                   use_pred: bool = False):
    """Persistent wavefront over a pixel-granular work queue.

    Item g covers pixel slot g % n, samples (g // n) * chunk onward, with
    chunk = min(spp, samples_per_item). A lane traces its item's samples
    back to back, accumulating radiance in ``pending``; when the item's
    last path ends it adds ``pending`` into the frame and claims the next
    unissued item (tickets by exclusive cumsum over finishing lanes).
    The wavefront holds min(lanes, max(4096, items // items_per_lane),
    items) lanes on device ``dev``.

    ``bounce_fn(pix, sample, origin, direction, atten, depth)`` is the
    integrator's round (``_bounce``, or the Whitted step); its step dict
    counts each lane's shadow rays in ``shadow_count``. It is handed
    ``sample + sample_offset``, the RNG's sample axis.

    With ``use_pred`` each lane carries the predicted landing slab of its
    current ray (``tpu_pt.render._render_pixelq``): a bounce ray inherits
    its parent's landing slab, the next sample of the same pixel the
    pixel's last camera-ray slab, a newly claimed pixel starts unknown.
    ``bounce_fn`` then takes ``pred=`` and returns ``hit_slab``. The
    prediction orders work only: frames are bitwise the same without it."""
    chunk = max(1, min(cfg.spp, cfg.samples_per_item))
    n_chunks = (cfg.spp + chunk - 1) // chunk
    total = n * n_chunks
    n_lanes = min(cfg.lanes, max(4096, total // items_per_lane), total)

    def item_pixel(g):
        return g % n, (g // n) * chunk          # (pixel slot, first sample)

    def item_rays(j, sample):
        pix = pixel_start + j
        with span("pt.rng"):
            jx, jy = rng.uniform2(pix, sample + sample_offset, frame_idx,
                                  rng.STREAM_JITTER)
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
    if use_pred:
        pred = torch.full((n_lanes,), SLAB_UNKNOWN, dtype=torch.int32,
                          device=dev)
        cam_slab = pred.clone()

    while bool(active.any()):
        with span("pt.round"):
            j, chunk0 = item_pixel(g)
            step = bounce_fn(pixel_start + j, sample + sample_offset, origin,
                             direction, atten, depth,
                             **(dict(pred=pred) if use_pred else {}))
            with span("pt.queue"):
                pending = (pending
                           + step["contrib"] * active.to(torch.float32)[:, None])
                path_done = active & step["done"]
                hist.index_add_(0, step["reason"], path_done.to(torch.int64))
                n_rays += active.sum()
                n_shadow += (step["shadow_count"] * active).sum()

                item_end = torch.clamp_max(chunk0 + chunk, cfg.spp)
                more_samples = path_done & (sample + 1 < item_end)
                pixel_done = path_done & (sample + 1 >= item_end)
                result.index_add_(
                    0, j, pending * pixel_done.to(torch.float32)[:, None])

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
                if use_pred:
                    hs = step["hit_slab"]
                    # The pixel's camera-ray landing slab, kept while the
                    # lane holds the pixel, predicts its next sample's
                    # camera ray.
                    cam_slab = torch.where(
                        active & (depth == 0) & (hs != SLAB_UNKNOWN), hs,
                        cam_slab)
                    pred = torch.where(
                        cont, hs, torch.where(
                            more_samples, cam_slab,
                            torch.where(has_new, SLAB_UNKNOWN, pred)))
                depth = torch.where(cont, depth + 1, 0)
                pending = torch.where(pixel_done[:, None], 0.0, pending)
                active = cont | respawn
            iters += 1

    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist,
                        wavefront_iterations=torch.tensor(iters, device=dev))
    return result * (1.0 / cfg.spp), stats


def _render_regen(dev, cam, cfg, pixel_start, n, frame_idx, bounce_fn,
                  sample_offset: int = 0):
    """Persistent wavefront over a queue of ``n * spp`` single-path items
    (``tpu_pt.render._render_regen``): item g is pixel slot g % n, sample
    g // n. Each lane holds one item and claims the next unissued one the
    moment its path ends (tickets by exclusive cumsum over the finished
    lanes), so no lane waits for the unluckiest sample of its pixel.

    A round runs ``cfg.bounces_per_round`` bounces; lanes whose path ends
    mid-round idle until it ends. The round's radiance goes into the frame
    with one ``index_add_``. ``bounce_fn`` and ``sample_offset`` as in
    ``_render_pixelq``."""
    total = n * cfg.spp
    n_lanes = min(cfg.lanes, total)
    k_steps = max(1, int(cfg.bounces_per_round))

    def item_rays(g):
        pix = pixel_start + g % n
        with span("pt.rng"):
            jx, jy = rng.uniform2(pix, g // n + sample_offset, frame_idx,
                                  rng.STREAM_JITTER)
        return camera_rays(cam, pix, cfg.width, cfg.height, jx, jy)

    g = torch.arange(n_lanes, dtype=torch.int64, device=dev)
    origin, direction = item_rays(g)
    atten = torch.ones((n_lanes, 3), dtype=torch.float32, device=dev)
    depth = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    active = g < total
    next_g = torch.tensor(n_lanes, dtype=torch.int64, device=dev)
    result = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_rays, n_shadow = _zero_count(dev), _zero_count(dev)
    hist = torch.zeros(NUM_DONE_REASONS, dtype=torch.int64, device=dev)
    iters = 0

    while bool(active.any()):
        with span("pt.round"):
            j, sample = g % n, g // n + sample_offset
            alive = active
            pending = torch.zeros((n_lanes, 3), dtype=torch.float32,
                                  device=dev)
            for _ in range(k_steps):
                step = bounce_fn(pixel_start + j, sample, origin, direction,
                                 atten, depth)
                with span("pt.queue"):
                    alive_f = alive.to(torch.float32)[:, None]
                    pending = pending + step["contrib"] * alive_f
                    hist.index_add_(0, step["reason"],
                                    (alive & step["done"]).to(torch.int64))
                    n_rays += alive.sum()
                    n_shadow += (step["shadow_count"] * alive).sum()
                    cont = alive & ~step["done"]
                    cont3 = cont[:, None]
                    origin = torch.where(cont3, step["new_origin"], origin)
                    direction = torch.where(cont3, step["new_dir"], direction)
                    atten = torch.where(cont3, step["atten_cont"], atten)
                    depth = torch.where(cont, depth + 1, depth)
                    alive = cont
            with span("pt.queue"):
                result.index_add_(0, j, pending)

                # Claim the next queue items: finished lane k gets ticket
                # next_g + (number of finished lanes before k).
                fin = (active & ~alive).to(torch.int64)
                rank = torch.cumsum(fin, 0) - fin
                new_g = next_g + rank
                has_new = (fin > 0) & (new_g < total)
                next_g = next_g + fin.sum()
                o_new, d_new = item_rays(torch.where(has_new, new_g, 0))
                new3, alive3 = has_new[:, None], alive[:, None]
                # Retired lanes park their rays.
                origin = torch.where(new3, o_new,
                                     torch.where(alive3, origin, PARK_COORD))
                direction = torch.where(new3, d_new,
                                        torch.where(alive3, direction,
                                                    PARK_DIR))
                atten = torch.where(new3, 1.0, atten)
                depth = torch.where(has_new, 0, depth)
                g = torch.where(has_new, new_g, g)
                active = alive | has_new
            iters += k_steps

    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist,
                        wavefront_iterations=torch.tensor(iters, device=dev))
    return result * (1.0 / cfg.spp), stats


def _wavefront(scene, cam, cfg, pixel_start, n_pixels, frame_idx,
               closest_fn, occluded_fn, fused_fn, sample_offset: int = 0):
    """``render_wavefront`` on given intersectors (``debug.validate_frame``
    hands in checked ones)."""
    if cfg.scheduler == "scan":
        return _render_scan(scene, cam, cfg, pixel_start, n_pixels,
                            frame_idx, closest_fn, occluded_fn, fused_fn,
                            sample_offset)
    if cfg.scheduler not in ("pixelq", "regen"):
        raise ValueError(f"unknown scheduler {cfg.scheduler!r} (pixelq, "
                         "regen or scan)")

    def bounce(pix, sample, origin, direction, atten, depth, pred=None):
        return _bounce(scene, cfg, closest_fn, occluded_fn, pix, sample,
                       frame_idx, origin, direction, atten, depth, fused_fn,
                       pred)
    if cfg.scheduler == "regen":
        return _render_regen(scene.device, cam, cfg, pixel_start, n_pixels,
                             frame_idx, bounce, sample_offset)
    # 8 items per lane: tpu_pt.render._render_pixelq's path-trace default.
    use_pred = (fused_fn is None
                and getattr(closest_fn, "supports_pred", False))
    return _render_pixelq(scene.device, cam, cfg, pixel_start, n_pixels,
                          frame_idx, bounce, items_per_lane=8,
                          sample_offset=sample_offset, use_pred=use_pred)


def render_wavefront(scene: SceneArrays, cam: CameraArrays,
                     cfg: RenderConfig, pixel_start: int, n_pixels: int,
                     frame_idx: int, sample_offset: int = 0):
    """Mean radiance over ``cfg.spp`` samples for ``n_pixels`` consecutive
    pixels from flat index ``pixel_start``. ``sample_offset`` shifts the
    counter RNG's sample axis, so that calls which split a pixel's samples
    draw disjoint sets. Returns (radiance [n, 3] f32, RenderStats)."""
    with span("pt.prepare"):
        closest_fn, occluded_fn = get_intersectors(scene, cfg, want_uv=False)
        fused_fn = get_fused_closest_nee(scene, cfg)
    return _wavefront(scene, cam, cfg, pixel_start, n_pixels, frame_idx,
                      closest_fn, occluded_fn, fused_fn, sample_offset)


def render_frame(scene: SceneArrays, cam: CameraArrays, cfg: RenderConfig,
                 frame_idx: int, accum: torch.Tensor):
    """Progressive frame step: trace, average, fold into the accumulator
    (one ``optixLaunch`` + accumulation, ``PathTracerMain.cpp:184-210``).

    ``accum`` [H, W, 3] f32 is updated IN PLACE (the JAX version donates
    it) and returned. Returns (accum, srgb_u8 [H, W, 3], RenderStats)."""
    with span("pt.frame"):
        n = cfg.width * cfg.height
        radiance, stats = render_wavefront(scene, cam, cfg, 0, n, frame_idx)
        frame_img = radiance.reshape(cfg.height, cfg.width, 3)
        accum.copy_(film.accumulate(accum, frame_img, frame_idx))
        return accum, film.make_color(accum), stats


def init_accum(cfg: RenderConfig, device="cuda") -> torch.Tensor:
    """Fresh accumulation buffer (``PathTracerMain.cpp:166-182``) on
    ``device`` (the card unless the caller asks for the CPU)."""
    return torch.zeros((cfg.height, cfg.width, 3), dtype=torch.float32,
                       device=device)


def image_to_host(frame_u8: torch.Tensor) -> np.ndarray:
    """Device frame -> numpy, flipped to top-down row order for image files."""
    return frame_u8.cpu().numpy()[::-1]
