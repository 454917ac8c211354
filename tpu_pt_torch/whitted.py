"""Whitted-style direct-lighting renderer, the reference's second
pipeline (counterpart of ``tpu_pt/whitted.py``; the SDK's
``cuda/whitted.cu:44-289`` and ``cuda/shading.cu``).

PBR metallic-roughness direct lighting with GGX specular (Schlick
Fresnel, Smith joint visibility, ``whitted_cuda.h:48-70``) from point
lights with shadow rays, an ambient term, smooth normals, base-color /
normal / metallic-roughness / emissive textures, alpha mask and blend,
CheckerPhong, and recursive reflection and refraction for Phong-metal
and glass materials up to ``MAX_TRACE_DEPTH``.

Recursion becomes a per-lane depth carry driven by the path tracer's
pixelq work queue (``render._render_pixelq`` with ``bounce_fn``);
branching continuations are resolved per lane with the branch weights
folded into the attenuation. Material, attribute, instance and texture
lookups are gathers (the JAX package's one-hot MXU selects exist only
for the TPU; textures take its ``TPT_WTEX=0`` gather form, sampled once
per bounce). Instanced scenes trace through the two-level kernels K9/K10
(``intersect.instanced``), flattened ones through ``get_intersectors``.
"""

from __future__ import annotations

import math

import torch

from . import bsdf, film, rng
from . import vec3 as v3
from .config import RenderConfig
from .intersect import get_intersectors, instanced
from .render import (PARK_COORD, PARK_DIR, CameraArrays, RenderStats,
                     NUM_DONE_REASONS, _render_pixelq, camera_rays)
from .scene.gltf import (ALPHA_BLEND, ALPHA_MASK, KIND_CHECKER, KIND_GLASS,
                         KIND_PHONG, WhittedScene)

MAX_TRACE_DEPTH = 8  # whitted.h:42

_WRAP_REPEAT, _WRAP_CLAMP, _WRAP_MIRROR = 10497, 33071, 33648
_INV_PI = 1.0 / math.pi


def _intersectors(geom, table, cfg: RenderConfig):
    """(closest_fn, occluded_fn) of a scene part: the instanced kernels
    when it keeps instances, else ``get_intersectors`` (u/v wanted)."""
    if table is not None:
        return instanced.get_intersectors(geom, table, cfg)
    return get_intersectors(geom, cfg, want_uv=True)


def _lookup_wmat(ws: WhittedScene, mat_ids: torch.Tensor) -> dict:
    """Per-lane material properties by gather
    (``tpu_pt.whitted._lookup_wmat``)."""
    m = mat_ids.long()
    return dict(base=ws.base_color[m], metallic=ws.metallic[m],
                roughness=ws.roughness[m], emissive=ws.emissive[m],
                kind=ws.kind[m], alpha_mode=ws.alpha_mode[m],
                alpha_cutoff=ws.alpha_cutoff[m], ior=ws.ior[m],
                tex_id=ws.tex_id[m], ntex_id=ws.ntex_id[m],
                ntex_scale=ws.ntex_scale[m], mrtex_id=ws.mrtex_id[m],
                etex_id=ws.etex_id[m], tex_uvx=ws.tex_uvx[m],
                phong_kr=ws.phong_kr[m], checker2=ws.checker2[m])


def _interp_attrs_rows(rows: torch.Tensor, hit):
    """Smooth normal [N, 3] and UV from barycentrics (LocalGeometry.h)."""
    u, v = hit.u, hit.v
    w0 = 1.0 - u - v
    n = v3.vec3(rows[:, 0] * w0 + rows[:, 3] * u + rows[:, 6] * v,
                rows[:, 1] * w0 + rows[:, 4] * u + rows[:, 7] * v,
                rows[:, 2] * w0 + rows[:, 5] * u + rows[:, 8] * v)
    uu = rows[:, 9] * w0 + rows[:, 11] * u + rows[:, 13] * v
    vv = rows[:, 10] * w0 + rows[:, 12] * u + rows[:, 14] * v
    return v3.normalize(n), uu, vv


def _wrap_coord(u: torch.Tensor, mode: int) -> torch.Tensor:
    """glTF sampler wrap to [0, 1] (GL semantics)."""
    if mode == _WRAP_CLAMP:
        return torch.clamp(u, 0.0, 1.0)
    if mode == _WRAP_MIRROR:
        return 1.0 - torch.abs(torch.remainder(u, 2.0) - 1.0)
    return torch.remainder(u, 1.0)                  # REPEAT (default)


def _bilinear_gather(tex: torch.Tensor, uu, vv, wrap_s: int,
                     wrap_t: int) -> torch.Tensor:
    """Edge-clamped 4-tap bilinear fetch of ``tex`` [h, w, 4] -> [N, 4]
    (``tpu_pt.whitted._bilinear_gather``; indices clamp as the JAX
    package's gathers do)."""
    h, w = tex.shape[0], tex.shape[1]
    x = _wrap_coord(uu, wrap_s) * (w - 1)
    y = _wrap_coord(vv, wrap_t) * (h - 1)
    x0f, y0f = torch.floor(x), torch.floor(y)
    x0 = torch.clamp(x0f, 0, w - 1).long()
    y0 = torch.clamp(y0f, 0, h - 1).long()
    x1 = torch.clamp_max(x0 + 1, w - 1)
    y1 = torch.clamp_max(y0 + 1, h - 1)
    fx = (x - x0f)[:, None]
    fy = (y - y0f)[:, None]
    return (tex[y0, x0] * (1 - fx) * (1 - fy) + tex[y0, x1] * fx * (1 - fy)
            + tex[y1, x0] * (1 - fx) * fy + tex[y1, x1] * fx * fy)


def _sample_all(ws: WhittedScene, uu, vv) -> list:
    """Raw RGBA [N, 4] of every texture at (uu, vv): the four texture
    consumers of a bounce sample at the same UV, so each texture is
    fetched once."""
    return [_bilinear_gather(tex, uu, vv,
                             *(ws.tex_wrap[k] if k < len(ws.tex_wrap)
                               else (_WRAP_REPEAT, _WRAP_REPEAT)))
            for k, tex in enumerate(ws.textures)]


def _tex_lookup(texels: list, tex_id: torch.Tensor, srgb: bool = True):
    """Each lane's texture (by id; white where -1), sRGB-decoded
    (``whitted::linearize``, gamma 2.2) unless ``srgb`` is False.
    Returns (rgb [N, 3], alpha [N])."""
    out = torch.ones((tex_id.shape[0], 4), dtype=torch.float32,
                     device=tex_id.device)
    for k, c in enumerate(texels):
        out = torch.where((tex_id == k)[:, None], c, out)
    rgb = out[:, :3]
    if srgb:
        rgb = torch.pow(torch.clamp_min(rgb, 1e-9), 2.2)
    return rgb, out[:, 3]


def _schlick(spec: torch.Tensor, v_dot_h: torch.Tensor) -> torch.Tensor:
    """whitted_cuda.h:48-51."""
    p = torch.pow(torch.clamp_min(1.0 - v_dot_h, 0.0), 5.0)
    return spec + (1.0 - spec) * p[:, None]


def _vis(n_dot_l, n_dot_v, alpha):
    """Smith joint visibility, whitted_cuda.h:53-61."""
    a2 = alpha * alpha
    ggx0 = n_dot_l * torch.sqrt(n_dot_v * n_dot_v * (1.0 - a2) + a2)
    ggx1 = n_dot_v * torch.sqrt(n_dot_l * n_dot_l * (1.0 - a2) + a2)
    return 2.0 * n_dot_l * n_dot_v / torch.clamp_min(ggx0 + ggx1, 1e-9)


def _ggx_d(n_dot_h, alpha):
    """GGX NDF, whitted_cuda.h:64-70."""
    a2 = alpha * alpha
    x = n_dot_h * n_dot_h * (a2 - 1.0) + 1.0
    return a2 / (math.pi * x * x)


def _uv_affine(uvx: torch.Tensor, uu, vv):
    """A material's UV affine (KHR_texture_transform)."""
    return (uvx[:, 0] * uu + uvx[:, 1] * vv + uvx[:, 2],
            uvx[:, 3] * uu + uvx[:, 4] * vv + uvx[:, 5])


def _make_occlusion(ws: WhittedScene, cfg: RenderConfig, occluded_fn,
                    intersectors=_intersectors):
    """Shadow-ray transmission ``(o, d, tmax) -> [N] f32``
    (``whitted_cuda.h:127-159`` and ``__anyhit__occlusion``,
    ``whitted.cu:113-138``). Without textured alpha occluders it is the
    whole scene's boolean sweep ``occluded_fn`` (1 or 0). Otherwise one
    boolean sweep over the opaque subset, times a closest-hit march over
    the alpha subset that multiplies in each hit's transmission: a MASK
    hit below its cutoff passes, any other textured hit passes 1 - alpha
    of the base-color texture (no factor, no sRGB)."""
    ao = ws.alpha_occ
    if ao is None:
        return lambda o, d, tmax: torch.where(occluded_fn(o, d, tmax),
                                              0.0, 1.0)
    _, occ_opaque = intersectors(ao.occ_geom, ao.occ_inst, cfg)
    closest_alpha, _ = intersectors(ao.geom, ao.inst, cfg)

    def occ_att(o, d, tmax):
        trans = torch.where(occ_opaque(o, d, tmax), 0.0, 1.0)
        t_base = torch.zeros_like(tmax)
        for _ in range(ao.max_hits):
            h = closest_alpha(o + d * t_base[:, None], d)
            seg = h.hit & (t_base + h.t < tmax)
            rows = ao.uv[h.tri.long()]
            w0 = 1.0 - h.u - h.v
            uu = rows[:, 0] * w0 + rows[:, 2] * h.u + rows[:, 4] * h.v
            vv = rows[:, 1] * w0 + rows[:, 3] * h.u + rows[:, 5] * h.v
            props = _lookup_wmat(ws, h.mat)
            uu, vv = _uv_affine(props["tex_uvx"], uu, vv)
            _, a = _tex_lookup(_sample_all(ws, uu, vv), props["tex_id"],
                               srgb=False)
            mask_pass = ((props["alpha_mode"] == ALPHA_MASK)
                         & (a < props["alpha_cutoff"]))
            f = torch.where(mask_pass, 1.0, 1.0 - a)
            trans = trans * torch.where(seg, f, 1.0)
            # Advance past the hit; tmin keeps it from being hit again.
            t_base = torch.where(seg, t_base + h.t, t_base)
        return trans

    return occ_att


def _make_whitted_step(ws: WhittedScene, cfg: RenderConfig, closest_fn,
                       occ_att_fn, frame_idx: int, depth_cap: int):
    """Per-round Whitted transition in ``render._bounce``'s step-dict
    shape, for the pixelq scheduler (``tpu_pt.whitted._make_whitted_step``).

    ``step(pix, sample_idx, origin, direction, atten, depth)`` treats
    every lane as live (the scheduler masks dead ones). ``shadow_count``
    is each lane's number of shadow rays (one per lit light); all lights'
    shadow rays go to ``occ_att_fn`` in one batched call."""
    dev = ws.device
    n_lights = ws.light_pos.shape[0]
    light_pos = [ws.light_pos[k] for k in range(n_lights)]
    light_color = [ws.light_color[k] for k in range(n_lights)]
    tri_tbl = torch.cat([ws.vtx_attr, ws.tri_tangent], dim=1)   # [T, 19]
    background = torch.tensor(cfg.background, dtype=torch.float32,
                              device=dev)
    f0 = 0.04

    def step(pix, sample_idx, origin, direction, atten, depth):
        depth = torch.as_tensor(depth, dtype=torch.int64, device=dev)
        hit = closest_fn(origin, direction)
        hmask = hit.hit
        props = _lookup_wmat(ws, hit.mat)
        kind = props["kind"]
        metallic, roughness = props["metallic"], props["roughness"]

        # Analytic primitives and curves (ids past the padded triangles)
        # have no vertex attributes: they shade with the intersector's
        # analytic normal (``cuda/sphere.cu:37-97``, ``geometry.cu:38-144``)
        # at UV (0, 0).
        analytic = hit.tri >= tri_tbl.shape[0]
        tri_rows = tri_tbl[torch.clamp_max(hit.tri.long(),
                                           tri_tbl.shape[0] - 1)]
        ns, uu, vv = _interp_attrs_rows(tri_rows, hit)
        if ws.inst is not None:
            # Mesh-space vertex normals -> world by the winning instance
            # (interpolate, then rotate).
            ns = instanced.world_normal(ws.inst, ns, hit.inst, hmask)
        ns = torch.where(analytic[:, None], hit.normal, ns)
        uu = torch.where(analytic, 0.0, uu)
        vv = torch.where(analytic, 0.0, vv)
        # Face the shading normal toward the ray (whitted.cu:221-223).
        ns = torch.where((v3.dot(ns, direction) > 0.0)[:, None], -ns, ns)

        texels = None
        if ws.textures:
            uu, vv = _uv_affine(props["tex_uvx"], uu, vv)
            texels = _sample_all(ws, uu, vv)
        if ws.textures and ws.has_normal_maps:
            # Tangent-space normal mapping (whitted.cu:226-244): TBN from
            # the triangle's UV tangent orthonormalised against the
            # shading normal; degenerate tangents take an ONB axis.
            n_id = props["ntex_id"]
            tan = tri_rows[:, 16:19]
            if ws.inst is not None:
                tan = instanced.world_tangent(ws.inst, tan, hit.inst)
            tan = tan - ns * v3.dot(ns, tan)[:, None]
            t_len2 = v3.dot(tan, tan)
            onb_t, _, _ = v3.onb_from_normal(ns)
            tan = torch.where(
                (t_len2 > 1e-12)[:, None],
                tan * torch.rsqrt(torch.clamp_min(t_len2, 1e-12))[:, None],
                onb_t)
            bit = v3.cross(ns, tan)
            nm, _ = _tex_lookup(texels, n_id, srgb=False)
            n_scale = props["ntex_scale"]
            tx = (nm[:, 0] * 2.0 - 1.0) * n_scale
            ty = (nm[:, 1] * 2.0 - 1.0) * n_scale
            tz = nm[:, 2] * 2.0 - 1.0
            perturbed = v3.normalize(tan * tx[:, None] + bit * ty[:, None]
                                     + ns * tz[:, None])
            ns = torch.where((hmask & (n_id >= 0))[:, None], perturbed, ns)

        base_rgb = props["base"][:, 0:3]
        base_a = props["base"][:, 3]
        emissive_rgb = props["emissive"]

        # CheckerPhong (shading.cu:169-206): even cells take the second
        # parameter set, before texturing.
        c2 = props["checker2"]
        tcx = torch.floor(uu * c2[:, 10]).to(torch.int64)
        tcy = torch.floor(vv * c2[:, 11]).to(torch.int64)
        use2 = hmask & (kind == KIND_CHECKER) & (((tcx + tcy) & 1) == 0)
        base_rgb = torch.where(use2[:, None], c2[:, 0:3], base_rgb)
        if ws.textures:
            tex_rgb, tex_a = _tex_lookup(texels, props["tex_id"])
            base_rgb = base_rgb * tex_rgb
            base_a = base_a * tex_a
        if ws.textures and ws.has_mr_tex:
            # G = roughness, B = metallic, linear (MaterialData.h:83).
            mr_id = props["mrtex_id"]
            mr, _ = _tex_lookup(texels, mr_id, srgb=False)
            has_mr = mr_id >= 0
            roughness = torch.where(has_mr, roughness * mr[:, 1], roughness)
            metallic = torch.where(has_mr, metallic * mr[:, 2], metallic)
        if ws.textures and ws.has_emissive_tex:
            e_id = props["etex_id"]
            em, _ = _tex_lookup(texels, e_id)
            emissive_rgb = torch.where((e_id >= 0)[:, None],
                                       emissive_rgb * em, emissive_rgb)

        # Alpha mask: sub-cutoff hits continue straight through.
        masked_out = (hmask & (props["alpha_mode"] == ALPHA_MASK)
                      & (base_a < props["alpha_cutoff"]))

        p = origin + direction * hit.t[:, None]
        vdir = v3.normalize(-direction)
        diff_color = base_rgb * ((1.0 - f0) * (1.0 - metallic))[:, None]
        spec_color = f0 + (base_rgb - f0) * metallic[:, None]
        a_r = roughness * roughness

        result = emissive_rgb
        # Per-light terms, then ONE occlusion call over every light's
        # shadow rays; ineligible lanes park their rays.
        lights = []
        for lpos in light_pos:
            to_l = lpos - p
            l_dist = v3.length(to_l)
            ldir = v3.normalize(to_l)
            n_dot_l = v3.dot(ns, ldir)
            n_dot_v = v3.dot(ns, vdir)
            lit = hmask & (n_dot_l > 0.0) & (n_dot_v > 0.0)
            lights.append(dict(
                ldir=ldir, lit=lit, n_dot_l=n_dot_l, n_dot_v=n_dot_v,
                occ_org=torch.where(lit[:, None], p, PARK_COORD),
                occ_dir=torch.where(lit[:, None], ldir, PARK_DIR),
                occ_tmax=torch.where(lit, l_dist - 0.001, 0.0)))
        shadow_count = torch.zeros(hmask.shape, dtype=torch.int64,
                                   device=dev)
        if lights:
            att = occ_att_fn(
                torch.cat([ld["occ_org"] for ld in lights]).contiguous(),
                torch.cat([ld["occ_dir"] for ld in lights]).contiguous(),
                torch.cat([ld["occ_tmax"] for ld in lights]).contiguous())
            n_l = hmask.shape[0]
            for k, ld in enumerate(lights):
                ld["att"] = att[k * n_l:(k + 1) * n_l]

        for ld, lcol in zip(lights, light_color):
            ldir, lit = ld["ldir"], ld["lit"]
            hvec = v3.normalize(ldir + vdir)
            n_dot_h = v3.dot(ns, hvec)
            v_dot_h = v3.dot(vdir, hvec)
            shadow_count += lit.to(torch.int64)
            f = _schlick(spec_color, v_dot_h)
            g_vis = _vis(torch.clamp_min(ld["n_dot_l"], 1e-6),
                         torch.clamp_min(ld["n_dot_v"], 1e-6), a_r)
            dd = _ggx_d(n_dot_h, a_r)
            brdf = (1.0 - f) * diff_color * _INV_PI + f * (g_vis * dd)[:, None]
            # Light color x shadow transmission x N.L (whitted.cu:246-263).
            w = torch.where(lit, ld["n_dot_l"] * ld["att"], 0.0)
            result = result + brdf * (lcol * w[:, None])

        # Ambient light (whitted.cu:264-267).
        result = result + base_rgb * ws.ambient

        # Continuations: glass reflects or refracts by Fresnel, Phong
        # metals mirror-reflect weighted by Kr, alpha blend continues
        # straight with weight 1 - alpha.
        is_glass = kind == KIND_GLASS
        d_norm = v3.normalize(direction)
        refl_dir = v3.reflect(d_norm, ns)
        sa, _ = rng.bounce_streams(depth)
        z1, _, _, _ = rng.uniform4(pix, sample_idx, frame_idx, sa)
        fres = bsdf.fr_dielectric(v3.dot(vdir, ns), 1.0, props["ior"])
        refr_dir, ok_refr = v3.refract(d_norm, ns, props["ior"])
        glass_reflect = (z1 < fres) | ~ok_refr
        glass_dir = torch.where(glass_reflect[:, None], refl_dir, refr_dir)

        kr_v = torch.where(use2[:, None], c2[:, 6:9], props["phong_kr"])
        phong_kind = (kind == KIND_PHONG) | (kind == KIND_CHECKER)
        phong_refl = hmask & phong_kind & (v3.luminance(kr_v) > 0.0)

        blend = hmask & (props["alpha_mode"] == ALPHA_BLEND) & ~masked_out
        result = torch.where(blend[:, None], result * base_a[:, None], result)

        cont_glass = hmask & is_glass
        cont = cont_glass | phong_refl | blend | masked_out
        new_dir = torch.where(cont_glass[:, None], glass_dir,
                              torch.where(phong_refl[:, None], refl_dir,
                                          direction))
        new_origin = p + new_dir * 1e-3
        ones = torch.ones_like(base_rgb)
        cont_weight = torch.where(
            masked_out[:, None], ones,
            torch.where(blend[:, None], ones * (1.0 - base_a)[:, None],
                        torch.where(cont_glass[:, None], base_rgb, kr_v)))
        # Masked-out lanes contribute nothing at this hit.
        result = torch.where(masked_out[:, None], 0.0, result)
        contrib = torch.where(hmask[:, None], result * atten, 0.0)
        # Miss: the background, once per path.
        miss = ~hmask
        contrib = torch.where(miss[:, None], background * atten, contrib)

        # Reasons reuse DoneReason slots: 0 miss, 1 depth-capped,
        # 2 absorbed (an opaque direct-lit hit, the normal end).
        go_on = hmask & cont & (depth + 1 < depth_cap)
        capped = hmask & cont & ~(depth + 1 < depth_cap)
        reason = torch.where(miss, 0, torch.where(capped, 1, 2))
        return dict(contrib=contrib, new_origin=new_origin, new_dir=new_dir,
                    atten_cont=atten * cont_weight, done=~go_on,
                    reason=reason, shadow_count=shadow_count)

    return step


def _render_wide(ws, cam, cfg, pixel_start, n, frame_idx, step_fn,
                 depth_cap, sample_offset: int = 0):
    """Every pixel's samples in turn, each a depth loop over all lanes
    that ends once no lane continues (``tpu_pt.whitted``'s wide
    ``while_loop``). The RNG's sample axis starts at ``sample_offset``."""
    dev = ws.device
    pixel_ids = pixel_start + torch.arange(n, dtype=torch.int64, device=dev)
    acc = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n_rays, n_shadow, iters = zero.clone(), zero.clone(), 0
    hist = torch.zeros(NUM_DONE_REASONS, dtype=torch.int64, device=dev)
    for sample in range(sample_offset, sample_offset + cfg.spp):
        jx, jy = rng.uniform2(pixel_ids, sample, frame_idx,
                              rng.STREAM_JITTER)
        origin, direction = camera_rays(cam, pixel_ids, cfg.width,
                                        cfg.height, jx, jy)
        atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
        alive = torch.ones(n, dtype=torch.bool, device=dev)
        depth = 0
        while depth < depth_cap and bool(alive.any()):
            s = step_fn(pixel_ids, sample, origin, direction, atten, depth)
            acc = acc + torch.where(alive[:, None], s["contrib"], 0.0)
            fin = alive & s["done"]
            n_rays += alive.sum()
            n_shadow += (s["shadow_count"] * alive).sum()
            hist.index_add_(0, s["reason"], fin.to(torch.int64))
            iters += 1
            origin, direction = s["new_origin"], s["new_dir"]
            atten = s["atten_cont"]
            alive = alive & ~s["done"]
            depth += 1
    stats = RenderStats(rays_traced=n_rays, shadow_rays=n_shadow,
                        done_histogram=hist,
                        wavefront_iterations=torch.tensor(iters, device=dev))
    return acc * (1.0 / cfg.spp), stats


def render_whitted_wavefront(ws: WhittedScene, cam: CameraArrays,
                             cfg: RenderConfig, pixel_start: int,
                             n_pixels: int, frame_idx: int,
                             intersectors=_intersectors,
                             sample_offset: int = 0):
    """Direct-lighting estimate over ``cfg.spp`` jittered samples per
    pixel for ``n_pixels`` pixels from flat index ``pixel_start``.
    Returns (radiance [n, 3], RenderStats); the histogram's slots are
    [miss, depth-capped, absorbed, 0, 0]. ``cfg.scheduler`` ``pixelq``
    (default) takes the work queue, any other (``scan``, ``regen``) the
    wide depth loop, as in the JAX package. ``sample_offset`` shifts the
    RNG's sample axis. ``intersectors(geom, table, cfg)`` gives each scene
    part's (closest_fn, occluded_fn) (``debug.validate_whitted_frame``
    hands in checked ones)."""
    closest_fn, occluded_fn = intersectors(ws.geom, ws.inst, cfg)
    occ_att_fn = _make_occlusion(ws, cfg, occluded_fn, intersectors)
    depth_cap = min(cfg.max_depth, MAX_TRACE_DEPTH)
    step_fn = _make_whitted_step(ws, cfg, closest_fn, occ_att_fn, frame_idx,
                                 depth_cap)
    if cfg.scheduler == "pixelq":
        # tpu_pt.render._render_pixelq's Whitted default: 16 items per
        # lane, 4 on a scene above 8,192 triangles.
        per_lane = 4 if ws.geom.num_tris_padded > 8192 else 16
        return _render_pixelq(ws.device, cam, cfg, pixel_start, n_pixels,
                              frame_idx, step_fn, items_per_lane=per_lane,
                              sample_offset=sample_offset)
    return _render_wide(ws, cam, cfg, pixel_start, n_pixels, frame_idx,
                        step_fn, depth_cap, sample_offset)


def render_whitted_frame(ws: WhittedScene, cam: CameraArrays,
                         cfg: RenderConfig, frame_idx: int,
                         accum: torch.Tensor):
    """Progressive Whitted frame (``whitted.cu:44-98``): ``accum``
    [H, W, 3] is updated in place and returned with the sRGB frame and
    the stats, as ``render.render_frame`` does."""
    n = cfg.width * cfg.height
    radiance, stats = render_whitted_wavefront(ws, cam, cfg, 0, n, frame_idx)
    frame_img = radiance.reshape(cfg.height, cfg.width, 3)
    accum.copy_(film.accumulate(accum, frame_img, frame_idx))
    return accum, film.make_color(accum), stats
