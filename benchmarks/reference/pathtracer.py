"""A plain PyTorch path tracer: the reference that decides ``correct``.

It renders chosen pixels of progressive frames with the semantics of the
renderer under test, written out here on its own: the counter RNG
(PCG4D keyed by pixel, sample, frame and stream), jittered pinhole
camera rays, Möller-Trumbore closest hits and shadow-ray any-hits
against every triangle (refractive ones pass light), diffuse (cosine or
uniform hemisphere), GGX-conductor and dielectric BSDFs, next-event
estimation from the area light, Russian roulette on the path's
luminance from the first bounce, the per-pixel mean over the frame's
samples, and the progressive running mean over frames.

Every path of a frame runs on its own: there is no wavefront, no queue,
no kernel. ``dtype`` sets the precision of all geometry and shading
(float32 as the renderer states; bfloat16 makes the control); integer
counters stay int64. The cluster boxes that cull (ray, cluster) pairs
stay float32, since they change no result.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .scene import METALLIC, REFRACTIVE, RefScene, load

T_MIN = 0.01
T_FAR = 1e16
MISS_KEY = torch.iinfo(torch.int64).max
_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * math.pi
METAL_ETA = (1.45, 0.7, 1.55)
METAL_K = (3.0, 2.2, 3.5)
BOX_TESTS_PER_BLOCK = 1 << 22   # (ray, box) slab tests at once
PAIRS_PER_BLOCK = 1 << 16       # (ray, cluster) pairs swept at once

STREAM_JITTER, STREAM_A, STREAM_B = 0, 1, 2


# -- counter RNG --------------------------------------------------------------

def _mul32(a, b):
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def pcg4d(a, b, c, d):
    """PCG4D (Jarzynski & Olano, JCGT 2020) on int64 tensors that hold
    uint32 values."""
    dev = next(v.device for v in (a, b, c, d) if isinstance(v, torch.Tensor))
    x, y, z, w = (torch.as_tensor(v, device=dev).to(torch.int64) & _M32
                  for v in (a, b, c, d))
    x, y, z, w = torch.broadcast_tensors(x, y, z, w)
    x, y, z, w = ((v * 1664525 + 1013904223) & _M32 for v in (x, y, z, w))
    for round_ in range(2):
        x = (x + _mul32(y, w)) & _M32
        y = (y + _mul32(z, x)) & _M32
        z = (z + _mul32(x, y)) & _M32
        w = (w + _mul32(y, z)) & _M32
        if round_ == 0:
            x, y, z, w = (v ^ (v >> 16) for v in (x, y, z, w))
    return x, y, z, w


def uniforms(pixel, sample, frame, stream, dtype):
    """Four uniforms in [0, 1), 24 bits each."""
    return tuple(((v >> 8).to(torch.float32) * 5.9604644775390625e-08).to(dtype)
                 for v in pcg4d(pixel, sample, frame, stream))


# -- vectors -------------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def vec(x, y, z):
    return torch.stack(torch.broadcast_tensors(x, y, z), dim=-1)


def cross(a, b):
    return vec(a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
               a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
               a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])


def normalize(a):
    n2 = dot(a, a)
    inv = torch.where(n2 > 1e-12, torch.rsqrt(torch.clamp_min(n2, 1e-30)),
                      torch.zeros_like(n2))
    return a * inv[..., None]


def length(a):
    return torch.sqrt(torch.clamp_min(dot(a, a), 0.0))


def reflect(i, n):
    return i - n * (2.0 * dot(n, i))[..., None]


# -- intersection ----------------------------------------------------------------

def _pairs(scene: RefScene, o, d, tmax):
    """(ray, cluster) pairs whose grown box the ray meets in (T_MIN, tmax),
    in blocks of at most PAIRS_PER_BLOCK."""
    o32, d32 = o.float(), d.float()
    inv = 1.0 / torch.where(d32.abs() < 1e-30, torch.full_like(d32, 1e-30), d32)
    rays_per_block = max(1, BOX_TESTS_PER_BLOCK // scene.box_lo.shape[0])
    for r0 in range(0, o.shape[0], rays_per_block):
        sl = slice(r0, r0 + rays_per_block)
        a = (scene.box_lo[None] - o32[sl, None]) * inv[sl, None]
        b = (scene.box_hi[None] - o32[sl, None]) * inv[sl, None]
        near = torch.minimum(a, b).amax(-1)
        far = torch.maximum(a, b).amin(-1)
        ok = (near <= far) & (far > T_MIN) & (near < tmax[sl, None].float())
        ray, cl = ok.nonzero(as_tuple=True)
        for k in range(0, ray.shape[0], PAIRS_PER_BLOCK):
            yield ray[k:k + PAIRS_PER_BLOCK] + r0, cl[k:k + PAIRS_PER_BLOCK]


def _moller(scene: RefScene, o, d, tri):
    """Möller-Trumbore of rays [K] against their triangles [K, C]:
    (t, valid) [K, C], t > T_MIN."""
    t, _, _, valid = moller_uv(scene, o, d, tri)
    return t, valid


def moller_uv(scene, o, d, tri):
    """:func:`_moller` with the barycentrics: (t, u, v, valid) [K, C]."""
    tri = tri.clamp_min(0)
    v0, e1, e2 = scene.v0[tri], scene.e1[tri], scene.e2[tri]
    o, d = o[:, None], d[:, None]
    p = cross(d.expand_as(e2), e2)
    det = dot(e1, p)
    ok = torch.abs(det) > 1e-9
    inv = 1.0 / torch.where(ok, det, torch.ones_like(det))
    tv = o - v0
    u = dot(tv, p) * inv
    q = cross(tv, e1)
    v = dot(d.expand_as(q), q) * inv
    t = dot(e2, q) * inv
    valid = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return t, u, v, valid


def closest(scene: RefScene, o, d, t_lo=None):
    """(t, triangle, hit) per ray; ties go to the lowest triangle. With
    ``t_lo`` [N], only hits with t > t_lo count."""
    n = o.shape[0]
    best = torch.full((n,), MISS_KEY, dtype=torch.int64, device=o.device)
    tmax = torch.full((n,), T_FAR, device=o.device)
    for ray, cl in _pairs(scene, o, d, tmax):
        tri = scene.cluster_tris[cl]
        t, valid = _moller(scene, o[ray], d[ray], tri)
        valid &= (tri >= 0) & (t < T_FAR)
        if t_lo is not None:
            valid &= t > t_lo[ray, None]
        # t > 0, so its float32 bits order as the values do.
        bits = t.float().view(torch.int32).to(torch.int64)
        key = torch.where(valid, (bits << 32) | tri, MISS_KEY).amin(-1)
        best.scatter_reduce_(0, ray, key, "amin")
    hit = best != MISS_KEY
    tri = torch.where(hit, best & _M32, 0)
    t = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                    torch.full((n,), T_FAR, device=o.device)).to(o.dtype)
    return t, tri, hit


def occluded(scene: RefScene, o, d, tmax):
    """Per ray: does a non-refractive triangle lie in (T_MIN, tmax)?"""
    out = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    for ray, cl in _pairs(scene, o, d, tmax):
        tri = scene.cluster_tris[cl]
        t, valid = _moller(scene, o[ray], d[ray], tri)
        valid &= (tri >= 0) & scene.occludes[tri.clamp_min(0)] & (t < tmax[ray, None])
        out.scatter_reduce_(0, ray, valid.any(-1).to(torch.int64), "amax")
    return out.bool()


# -- BSDFs -------------------------------------------------------------------------

def _hemisphere(n, u1, u2, cosine: bool):
    if cosine:
        cos_t = torch.sqrt(u1)
        sin_t = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
        phi = _TWO_PI * u2
        local = vec(sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t)
    else:
        sin_t = torch.sqrt(torch.clamp_min(1.0 - u1 * u1, 0.0))
        phi = _TWO_PI * u2
        local = vec(torch.cos(phi) * sin_t, torch.sin(phi) * sin_t, u1)
    nx, ny, nz = n[..., 0], n[..., 1], n[..., 2]
    use_x = (torch.abs(nx) > torch.abs(nz))[..., None]
    zero = torch.zeros_like(nx)
    b = normalize(torch.where(use_x, vec(-ny, nx, zero), vec(zero, -nz, ny)))
    t = cross(b, n)
    return (t * local[..., 0:1] + b * local[..., 1:2]) + n * local[..., 2:3]


def _ggx_half(u1, u2, roughness, n):
    a = torch.clamp(roughness, 0.001, 1.0)
    phi = _TWO_PI * u1
    cos_t = torch.sqrt((1.0 - u2) / (1.0 + (a * a - 1.0) * u2))
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    hx, hy, hz = sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t
    pole = (torch.abs(n[..., 2]) >= 0.999)[..., None]
    x_axis = torch.tensor([1.0, 0.0, 0.0], device=n.device, dtype=n.dtype)
    z_axis = torch.tensor([0.0, 0.0, 1.0], device=n.device, dtype=n.dtype)
    up = torch.where(pole, x_axis, z_axis).expand_as(n)
    tangent = normalize(cross(up, n))
    bitangent = cross(n, tangent)
    h = (tangent * hx[..., None] + bitangent * hy[..., None]) + n * hz[..., None]
    return normalize(h)


def _conductor(cos_theta, eta, k):
    c2 = (cos_theta * cos_theta)[..., None]
    e2 = eta * eta
    k2 = k * k
    t1 = e2 - k2 - c2
    a2b2 = torch.sqrt(torch.clamp_min(t1 * t1 + 4.0 * e2 * k2, 0.0))
    t2 = a2b2 + c2
    two_ec = 2.0 * eta * torch.sqrt(c2)
    rs = (t2 - two_ec + c2) / (t2 + two_ec + c2)
    rp = rs * (t2 - two_ec + 1.0) / (t2 + two_ec + 1.0)
    return 0.5 * (rs + rp)


def _dielectric(cos_i, ior):
    """Fresnel reflectance from air (index 1) into ``ior``; a negative
    cosine is a ray inside; total internal reflection gives 1."""
    cos_i = torch.clamp(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    one = torch.ones((), dtype=cos_i.dtype, device=cos_i.device)
    ei = torch.where(entering, one, ior)
    et = torch.where(entering, ior, one)
    cos_i = torch.abs(cos_i)
    sin_i = torch.sqrt(torch.clamp_min(1.0 - cos_i * cos_i, 0.0))
    sin_t = ei / torch.clamp_min(et, 1e-12) * sin_i
    tir = sin_t >= 1.0
    cos_t = torch.sqrt(torch.clamp_min(1.0 - sin_t * sin_t, 0.0))
    d_parl = (et * cos_i) + (ei * cos_t)
    d_perp = (ei * cos_i) + (et * cos_t)
    r_parl = ((et * cos_i) - (ei * cos_t)) / torch.where(d_parl > 0, d_parl, 1.0)
    r_perp = ((ei * cos_i) - (et * cos_t)) / torch.where(d_perp > 0, d_perp, 1.0)
    f = 0.5 * (r_parl * r_parl + r_perp * r_perp)
    return torch.where(tir, 1.0, f)


def _refract(i, n, ior):
    """(direction, refracted): zero direction on total internal reflection."""
    neg_ndotv = dot(i, n)
    exiting = neg_ndotv > 0.0
    eta = torch.where(exiting, ior, 1.0 / ior)
    nn = torch.where(exiting[..., None], -n, n)
    cos_i = torch.where(exiting, -neg_ndotv, neg_ndotv)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    ok = k >= 0.0
    r = i * eta[..., None] - nn * (eta * cos_i
                                   + torch.sqrt(torch.clamp_min(k, 0.0)))[..., None]
    r = normalize(r)
    return torch.where(ok[..., None], r, torch.zeros_like(r)), ok


# -- the integrator ------------------------------------------------------------------

class Camera:
    """Pinhole camera from eye, lookat, up, vertical field of view and
    aspect: W = lookat - eye, U and V scaled to the image plane at W."""

    def __init__(self, eye, lookat, up, fov_y, aspect, device, dtype):
        eye = np.asarray(eye, np.float32)
        w = (np.asarray(lookat, np.float32) - eye).astype(np.float32)
        wlen = float(np.linalg.norm(w))
        u = np.cross(w, np.asarray(up, np.float32))
        u = (u / float(np.linalg.norm(u))).astype(np.float32)
        v = np.cross(u, w)
        v = (v / float(np.linalg.norm(v))).astype(np.float32)
        vlen = wlen * math.tan(0.5 * math.radians(fov_y))
        v = v * vlen
        u = u * (vlen * aspect)
        self.eye, self.u, self.v, self.w = (
            torch.as_tensor(np.asarray(a, np.float32), device=device).to(dtype)
            for a in (eye, u, v, w))


def _camera_rays(cam: Camera, pixel, width, height, jx, jy):
    x = (pixel % width).to(jx.dtype)
    y = (pixel // width).to(jx.dtype)
    dx = 2.0 * ((x + jx) / width) - 1.0
    dy = 2.0 * ((y + jy) / height) - 1.0
    direction = normalize(dx[:, None] * cam.u + dy[:, None] * cam.v + cam.w)
    return cam.eye.expand(pixel.shape[0], 3).contiguous(), direction


def trace_paths(scene: RefScene, cam: Camera, pixel, sample, frame, *, width,
                height, max_depth, importance, direct):
    """Radiance [N, 3] of the paths of (pixel, sample, frame) [N]."""
    dt = cam.w.dtype
    dev = pixel.device
    n = pixel.shape[0]
    jx, jy, _, _ = uniforms(pixel, sample, frame, STREAM_JITTER, dt)
    origin, direction = _camera_rays(cam, pixel, width, height, jx, jy)
    atten = torch.ones((n, 3), dtype=dt, device=dev)
    result = torch.zeros((n, 3), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)          # paths still running
    eta = torch.tensor(METAL_ETA, dtype=dt, device=dev)
    kap = torch.tensor(METAL_K, dtype=dt, device=dev)
    light = scene.light
    area = length(cross(light["v1"], light["v2"]))
    for depth in range(max_depth + 1):
        if live.numel() == 0:
            break
        pix, smp, frm = pixel[live], sample[live], frame[live]
        z1, z2, z3, _ = uniforms(pix, smp, frm, STREAM_A + 2 * depth, dt)
        lz1, lz2, z_rr, _ = uniforms(pix, smp, frm, STREAM_B + 2 * depth, dt)
        t, tri, hit = closest(scene, origin, direction)
        mat = torch.where(hit, scene.tri_mat[tri], 0)
        diffuse, emission = scene.diffuse[mat], scene.emission[mat]
        roughness, ior = scene.roughness[mat], scene.ior[mat]
        bsdf, emissive = scene.bsdf[mat], scene.emissive[mat]
        n0 = torch.where(hit[:, None], scene.normal[tri], 0.0)
        n = n0 * torch.where(dot(-direction, n0) >= 0.0, 1.0, -1.0).to(dt)[:, None]
        p = origin + direction * t[:, None]

        dir_diffuse = _hemisphere(n, z1, z2, importance)
        h = _ggx_half(z1, z2, roughness, n)
        dir_metal = reflect(direction, h)
        org_metal = p + dir_metal * 1e-4
        cos_h = torch.clamp_min(dot(h, -direction), 0.0)
        mult_metal = _conductor(cos_h, eta, kap) * diffuse
        d_norm = normalize(direction)
        fr = _dielectric(dot(-d_norm, n0), ior)
        refr_dir, refracted = _refract(d_norm, n0, ior)
        refl_dir = reflect(d_norm, n0)
        dir_refr = torch.where(((z3 < fr) | ~refracted)[:, None], refl_dir, refr_dir)
        org_refr = p + dir_refr * 1e-3
        is_metal = (bsdf == METALLIC)[:, None]
        is_refr = (bsdf == REFRACTIVE)[:, None]
        new_dir = torch.where(is_refr, dir_refr, torch.where(is_metal, dir_metal, dir_diffuse))
        new_org = torch.where(is_refr, org_refr, torch.where(is_metal, org_metal, p))
        atten_mult = torch.where(is_refr | ~is_metal, diffuse, mult_metal)

        emitted = emission * (hit & emissive & (depth == 0))[:, None].to(dt)
        light_hit = hit & emissive
        # The background is black: a miss adds nothing.
        radiance = torch.where(light_hit[:, None], emission, torch.zeros_like(emission))
        if direct:
            lpos = light["corner"] + light["v1"] * lz1[:, None] + light["v2"] * lz2[:, None]
            to_l = lpos - p
            l_dist = length(to_l)
            l_dir = normalize(to_l)
            n_dl = dot(n, l_dir)
            ln_dl = -dot(light["normal"], l_dir)
            eligible = hit & (bsdf != REFRACTIVE) & (n_dl > 0.0) & (ln_dl > 0.0)
            blocked = torch.zeros_like(eligible)
            e = eligible.nonzero(as_tuple=True)[0]
            if e.numel():
                blocked[e] = occluded(scene, p[e], l_dir[e], l_dist[e] - 0.01)
            m = torch.clamp_min(l_dist, 1e-6)
            weight = n_dl * ln_dl * area / (math.pi * (m * m))
            w = torch.where(eligible & ~blocked, weight, 0.0)
            radiance = radiance + light["emission"] * w[:, None]

        atten_new = torch.where(hit[:, None], atten * atten_mult, atten)
        result[live] = result[live] + (emitted + radiance * atten_new)
        p_rr = atten_new[:, 0] * 0.30 + atten_new[:, 1] * 0.59 + atten_new[:, 2] * 0.11
        done = ~hit | light_hit | (z_rr > p_rr) | (depth >= max_depth)
        zero = p_rr == 0.0
        inv = torch.where(zero, 0.0, 1.0 / torch.where(zero, 1.0, p_rr))
        keep = ~done
        atten = (atten_new * inv[:, None])[keep]
        origin, direction = new_org[keep], new_dir[keep]
        live = live[keep]
    return result


def render_pixels(scene: RefScene, cam: Camera, pixels, frames, *, width, height,
                  spp, max_depth, importance, direct, snapshot_frames=0,
                  paths_per_call=1 << 18):
    """Running-mean accumulator [P, 3] of ``pixels`` after rendering each
    frame of ``frames`` in turn into a zero accumulator: frame k's mean
    over samples 0..spp-1 is folded in with weight 1 / (k + 1) (frame 0
    overwrites). Returns it with a copy of it after the first
    ``snapshot_frames`` frames (the final one when there are fewer).
    Paths are traced ``paths_per_call`` at a time."""
    dev = scene.v0.device
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    frames = [int(k) for k in frames]
    n_pix = pixels.shape[0]
    # Every (frame, sample, pixel) path, frame-major.
    pix = pixels.repeat(len(frames) * spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(n_pix).repeat(len(frames))
    frm = torch.tensor(frames, device=dev).repeat_interleave(spp * n_pix)
    rad = torch.cat([
        trace_paths(scene, cam, pix[a:a + paths_per_call], smp[a:a + paths_per_call],
                    frm[a:a + paths_per_call], width=width, height=height,
                    max_depth=max_depth, importance=importance, direct=direct)
        for a in range(0, pix.shape[0], paths_per_call)])
    return fold(rad.reshape(len(frames), spp, n_pix, 3), frames, snapshot_frames)


def fold(rad, frames, snapshot_frames=0):
    """The running-mean accumulator [P, 3] after folding each frame k of
    ``frames``, whose samples' radiance is ``rad`` [frame, sample, P, 3],
    in turn into a zero accumulator: frame k's mean over its samples with
    weight 1 / (k + 1) (frame 0 overwrites). Returns it with a copy of it
    after the first ``snapshot_frames`` frames (the final one when there
    are fewer)."""
    _, spp, n_pix, _ = rad.shape
    dt, dev = rad.dtype, rad.device
    acc = torch.zeros((n_pix, 3), dtype=dt, device=dev)
    snap = None
    for i, (k, per_sample) in enumerate(zip(frames, rad)):
        total = torch.zeros((n_pix, 3), dtype=dt, device=dev)
        for r in per_sample:
            total = total + r
        mean = total * (1.0 / spp)
        if k <= 0:
            acc = mean.clone()
        else:
            a = float(np.float32(1.0) / (np.float32(k) + np.float32(1.0)))
            acc = acc + (mean - acc) * a
        if i + 1 == snapshot_frames:
            snap = acc.clone()
    return acc, (acc if snap is None else snap)


def values(scene_path, config: dict, traffic: dict, pixels, frames, device,
           dtype=torch.float32, snapshot_frames: int = 0) -> dict:
    """The reference's accumulator at ``pixels`` after ``frames``
    (``values``) and after the first ``snapshot_frames`` of them
    (``snapshot``), from the OBJ at ``scene_path``."""
    scene = load(str(scene_path), device, dtype)
    c = config["camera"]
    cam = Camera(c["eye"], c["lookat"], c["up"], c["fov_y"],
                 traffic["width"] / traffic["height"], device, dtype)
    with torch.no_grad():
        acc, snap = render_pixels(
            scene, cam, pixels, frames, width=traffic["width"],
            height=traffic["height"], spp=traffic["spp"],
            max_depth=traffic["max_depth"],
            importance=config["use_importance_sampling"],
            direct=config["use_direct_lighting"], snapshot_frames=snapshot_frames)
    return {"values": acc.float().cpu().numpy(), "snapshot": snap.float().cpu().numpy()}
