"""A plain PyTorch Whitted renderer: the reference that decides ``correct``
for configurations whose ``renderer`` is ``whitted``.

It renders chosen pixels of progressive frames with the semantics of the
OptiX SDK's Whitted sample (``cuda/whitted.cu``, ``whitted_cuda.h``),
written out here on its own over every triangle of the glTF scene in
world space (``reference/gltf.py`` reads it; each mesh instance is
transformed by its node's world matrix, its normals by the inverse
transpose):

- jittered pinhole camera rays from the counter RNG, as the path tracer's
  reference draws them (``pathtracer.uniforms``, ``STREAM_JITTER``);
- the closest hit with t > T_MIN, ties to the lowest triangle; a hit on an
  alpha-MASK material whose alpha lies below its cutoff is ignored and the
  same ray goes on past it (an any-hit that ignores the intersection);
- smooth normals (the vertex normals by the barycentrics, normalised,
  turned toward the ray);
- PBR metallic-roughness shading: Lambert diffuse of (1 - F0)(1 -
  metallic) of the base colour, GGX specular with Schlick's Fresnel and
  Smith's joint visibility (``whitted_cuda.h:48-70``), from each point
  light, times its shadow ray's transmission and N.L, plus the emissive
  factor and an ambient term of 0.1 times the base colour;
- the base colour is the factor times the base-colour texture (sRGB
  decoded with gamma 2.2; its alpha times the factor's alpha), sampled
  bilinearly under the sampler's wrap modes;
- a shadow ray from the hit toward each light, over (T_MIN, distance -
  1e-3): any opaque-class triangle blocks it; every hit on a textured
  MASK or BLEND triangle multiplies in its transmission: 1 where a MASK
  hit's texture alpha lies below the cutoff, else 1 - that alpha
  (``__anyhit__occlusion``, ``whitted.cu:113-138``; the texture's alpha
  alone, no factor);
- an alpha-BLEND hit weighs its shading by its alpha and continues
  straight on, from 1e-3 past the hit, with weight 1 - alpha, up to
  ``MAX_TRACE_DEPTH`` (``whitted.h:42``) traced segments; a miss adds the
  background, black;
- each frame's mean over its samples folded into a zero accumulator as
  the program's film does.

Every path runs on its own: no wavefront, no kernel, no cache. ``dtype``
sets the precision of geometry and shading (float32 as the program
states; bfloat16 makes the control); the cluster boxes that cull (ray,
cluster) pairs stay float32, since they change no result. TF32 is off.

Departures from the SDK, kept as the program states them: texel i sits at
u = i / (width - 1), with the corner indices clamped to the image (CUDA's
``tex2D`` puts it at (i + 0.5) / width); the wrap modes are GL's. Not
covered, and raising ``NotImplementedError`` naming the feature (in
``reference/gltf.py`` or here): normal, metallic-roughness and emissive
textures, ``KHR_texture_transform``, glass and every other material
extension (Phong and checker materials have no glTF form), analytic
primitives and curves, ``EXT_mesh_gpu_instancing``, binary glTF, and a
scene with no lights (the program's two default lights).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import gltf, pathtracer
from .pathtracer import STREAM_JITTER, Camera, _camera_rays, dot, length, normalize, uniforms

MAX_TRACE_DEPTH = 8
AMBIENT = 0.1
F0 = 0.04
CLUSTER = 64                    # triangles of one mesh part a culling box holds
OPAQUE, MASK, BLEND = (gltf.ALPHA_MODES.index(m) for m in gltf.ALPHA_MODES)
_CLAMP, _MIRROR = 33071, 33648


class Part:
    """World-space triangles [T] of one class (all, opaque or alpha) with
    their culling clusters, in the path tracer's reference's layout
    (``cluster_tris`` [C, K] with -1 pads, float32 boxes ``box_lo`` /
    ``box_hi`` [C, 3], vertices ``v0``, ``e1``, ``e2``; every triangle
    ``occludes``), with normals ``n`` [T, 3, 3], UVs ``uv`` [T, 3, 2] and
    materials ``mat``."""

    def __init__(self, tris, normals, uvs, mats, parts, device, dtype):
        self.count = tris.shape[0]
        self.occludes = torch.ones(self.count, dtype=torch.bool, device=device)
        t = torch.as_tensor(tris, dtype=torch.float32, device=device)
        self.v0, self.e1, self.e2 = (x.to(dtype) for x in (t[:, 0], t[:, 1] - t[:, 0],
                                                           t[:, 2] - t[:, 0]))
        self.n = torch.as_tensor(normals, dtype=torch.float32, device=device).to(dtype)
        self.uv = torch.as_tensor(uvs, dtype=torch.float32, device=device).to(dtype)
        self.mat = torch.as_tensor(mats, dtype=torch.int64, device=device)
        # Clusters: runs of at most CLUSTER triangles of one mesh part.
        runs = [(a, min(a + CLUSTER, b)) for a, b in parts for a in range(a, b, CLUSTER)]
        width = max([b - a for a, b in runs], default=1)
        ids = np.full((max(len(runs), 1), width), -1, np.int64)
        lo = np.full((ids.shape[0], 3), 3e37, np.float32)
        hi = np.full((ids.shape[0], 3), 3e37, np.float32)
        for c, (a, b) in enumerate(runs):
            ids[c, :b - a] = np.arange(a, b)
            lo[c], hi[c] = tris[a:b].reshape(-1, 3).min(0), tris[a:b].reshape(-1, 3).max(0)
        self.cluster_tris = torch.as_tensor(ids, device=device)
        self.box_lo = torch.as_tensor(lo, device=device)
        self.box_hi = torch.as_tensor(hi, device=device)


class Scene:
    """The glTF scene in world space, split for shadow rays into its opaque
    class and its alpha class (textured MASK or BLEND materials)."""

    def __init__(self, doc: gltf.Document, device, dtype):
        tris, normals, uvs, mats, parts = [], [], [], [], []
        n = 0
        for mesh, world in doc.instances:
            lin, inv_t = world[:3, :3], np.linalg.inv(world[:3, :3]).T
            for pos, idx, nrm, uv, mat in doc.meshes[mesh]:
                wp = pos @ lin.T + world[:3, 3]
                tv = wp[idx]
                if nrm is None:
                    g = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
                    tn = np.repeat(g[:, None], 3, axis=1)
                else:
                    tn = (nrm @ inv_t.T)[idx]
                tn = tn / np.maximum(np.linalg.norm(tn, axis=-1, keepdims=True), 1e-30)
                tris.append(tv)
                normals.append(tn)
                uvs.append(uv[idx])
                mats.append(np.full(tv.shape[0], mat))
                parts.append((n, n + tv.shape[0]))
                n += tv.shape[0]
        tris, normals, uvs, mats = (np.concatenate(x) for x in (tris, normals, uvs, mats))
        m = doc.materials
        self.alpha_mode = torch.tensor([gltf.ALPHA_MODES.index(x.alpha_mode) for x in m],
                                       device=device)
        self.texture = torch.tensor([x.texture for x in m], device=device)
        self.base = torch.tensor([x.base_color for x in m], device=device).to(dtype)
        self.metallic = torch.tensor([x.metallic for x in m], device=device).to(dtype)
        self.roughness = torch.tensor([x.roughness for x in m], device=device).to(dtype)
        self.emissive = torch.tensor([x.emissive for x in m], device=device).to(dtype)
        self.cutoff = torch.tensor([x.alpha_cutoff for x in m], device=device).to(dtype)
        self.textures = [(torch.as_tensor(t.rgba, device=device).to(dtype), t.wrap_s, t.wrap_t)
                         for t in doc.textures]
        self.lights = [(torch.as_tensor(p, dtype=torch.float32, device=device).to(dtype),
                        torch.as_tensor(c, dtype=torch.float32, device=device).to(dtype))
                       for p, c in doc.lights]
        alpha_mat = np.array([x.alpha_mode != "OPAQUE" and x.texture >= 0 for x in m])
        alpha = alpha_mat[mats]

        def part(sel):
            idx = np.nonzero(sel)[0]
            cum = np.concatenate([[0], np.cumsum(sel)])
            runs = [(int(cum[a]), int(cum[b])) for a, b in parts if cum[b] > cum[a]]
            return Part(tris[idx].astype(np.float32), normals[idx], uvs[idx], mats[idx], runs,
                        device, dtype)
        self.all = part(np.ones(n, bool))
        self.opaque = part(~alpha)
        self.alpha = part(alpha)


# -- intersection ----------------------------------------------------------------------

def closest(part: Part, o, d, t_lo):
    """(t, triangle, u, v, hit) per ray: the nearest hit with t > T_MIN
    and t > ``t_lo``; ties go to the lowest triangle."""
    _, tri, hit = pathtracer.closest(part, o, d, t_lo)
    t, u, v, _ = pathtracer.moller_uv(part, o, d, tri[:, None])
    return t[:, 0], tri, u[:, 0], v[:, 0], hit


def _bilinear(tex, uu, vv):
    """RGBA [N, 4] of texture ``(rgba, wrap_s, wrap_t)`` at (uu, vv)."""
    rgba, wrap_s, wrap_t = tex
    h, w = rgba.shape[0], rgba.shape[1]

    def wrap(x, mode):
        if mode == _CLAMP:
            return torch.clamp(x, 0.0, 1.0)
        if mode == _MIRROR:
            return 1.0 - torch.abs(torch.remainder(x, 2.0) - 1.0)
        return torch.remainder(x, 1.0)
    x = wrap(uu, wrap_s) * (w - 1)
    y = wrap(vv, wrap_t) * (h - 1)
    xf, yf = torch.floor(x), torch.floor(y)
    x0, y0 = xf.long().clamp(0, w - 1), yf.long().clamp(0, h - 1)
    x1, y1 = (x0 + 1).clamp_max(w - 1), (y0 + 1).clamp_max(h - 1)
    fx, fy = (x - xf)[:, None], (y - yf)[:, None]
    return (rgba[y0, x0] * (1 - fx) * (1 - fy) + rgba[y0, x1] * fx * (1 - fy)
            + rgba[y1, x0] * (1 - fx) * fy + rgba[y1, x1] * fx * fy)


def _texel(scene: Scene, tex_id, uu, vv):
    """Each ray's base-colour texture RGBA [N, 4] (1 where it has none)."""
    out = torch.ones((tex_id.shape[0], 4), dtype=uu.dtype, device=uu.device)
    for k, tex in enumerate(scene.textures):
        sel = (tex_id == k).nonzero(as_tuple=True)[0]
        if sel.numel():
            out[sel] = _bilinear(tex, uu[sel], vv[sel])
    return out


def _surface(scene: Scene, part: Part, tri, u, v):
    """(material, UV, texture RGBA) of hits on ``part``'s triangles."""
    mat = part.mat[tri]
    w0 = 1.0 - u - v
    uvs = part.uv[tri]
    uu = uvs[:, 0, 0] * w0 + uvs[:, 1, 0] * u + uvs[:, 2, 0] * v
    vv = uvs[:, 0, 1] * w0 + uvs[:, 1, 1] * u + uvs[:, 2, 1] * v
    return mat, uu, vv, _texel(scene, scene.texture[mat], uu, vv)


def visible(scene: Scene, o, d):
    """The first hit that a MASK material's cutoff does not ignore:
    (t, triangle, u, v, hit, material, texture RGBA)."""
    n, dev, dt = o.shape[0], o.device, o.dtype
    t_lo = torch.zeros(n, dtype=dt, device=dev)
    out = None
    pending = torch.arange(n, device=dev)
    while pending.numel():
        t, tri, u, v, hit = closest(scene.all, o[pending], d[pending], t_lo[pending])
        mat, _, _, tex = _surface(scene, scene.all, tri, u, v)
        alpha = scene.base[mat, 3] * tex[:, 3]
        ignored = hit & (scene.alpha_mode[mat] == MASK) & (alpha < scene.cutoff[mat])
        got = (t, tri, u, v, hit, mat, tex)
        if out is None:
            out = [x.clone() for x in got]
        keep = pending[~ignored]
        for dst, src in zip(out, got):
            dst[keep] = src[~ignored]
        t_lo[pending[ignored]] = t[ignored]
        pending = pending[ignored]
    return out


def transmission(scene: Scene, o, d, tmax):
    """Per shadow ray: 0 where an opaque-class triangle lies in (T_MIN,
    tmax), else the product of the alpha-class hits' transmissions."""
    blocked = pathtracer.occluded(scene.opaque, o, d, tmax)
    trans = torch.where(blocked, 0.0, 1.0).to(o.dtype)
    part = scene.alpha
    if not part.count:
        return trans
    for ray, cl in pathtracer._pairs(part, o, d, tmax):
        tri = part.cluster_tris[cl]
        t, u, v, valid = pathtracer.moller_uv(part, o[ray], d[ray], tri)
        valid &= (tri >= 0) & (t < tmax[ray, None])
        k, j = valid.nonzero(as_tuple=True)
        if not k.numel():
            continue
        mat, _, _, tex = _surface(scene, part, tri[k, j], u[k, j], v[k, j])
        a = tex[:, 3]
        passes = (scene.alpha_mode[mat] == MASK) & (a < scene.cutoff[mat])
        trans.scatter_reduce_(0, ray[k], torch.where(passes, 1.0, 1.0 - a).to(o.dtype), "prod")
    return trans


# -- shading ---------------------------------------------------------------------------

def shade(scene: Scene, p, d, h):
    """(radiance [N, 3], base alpha [N]) of visible hits ``h`` (from
    :func:`visible`) at points ``p`` of rays ``d``, each light's shadow
    ray traced."""
    _, tri, u, v, _, mat, tex = h
    nrm = scene.all.n[tri]
    w0 = 1.0 - u - v
    ns = normalize(nrm[:, 0] * w0[:, None] + nrm[:, 1] * u[:, None] + nrm[:, 2] * v[:, None])
    ns = torch.where((dot(ns, d) > 0.0)[:, None], -ns, ns)
    base = scene.base[mat, :3] * torch.pow(torch.clamp_min(tex[:, :3], 1e-9), 2.2)
    base_a = scene.base[mat, 3] * tex[:, 3]
    metallic, rough = scene.metallic[mat], scene.roughness[mat]
    vdir = normalize(-d)
    diff = base * ((1.0 - F0) * (1.0 - metallic))[:, None]
    spec = F0 + (base - F0) * metallic[:, None]
    a2 = (rough * rough) ** 2
    result = scene.emissive[mat].clone()
    for lpos, lcol in scene.lights:
        to_l = lpos - p
        ldir = normalize(to_l)
        ndl, ndv = dot(ns, ldir), dot(ns, vdir)
        lit = ((ndl > 0.0) & (ndv > 0.0)).nonzero(as_tuple=True)[0]
        att = torch.zeros_like(ndl)
        att[lit] = transmission(scene, p[lit], ldir[lit], length(to_l)[lit] - 0.001)
        hv = normalize(ldir + vdir)
        ndh, vdh = dot(ns, hv), dot(vdir, hv)
        f = spec + (1.0 - spec) * torch.pow(torch.clamp_min(1.0 - vdh, 0.0), 5.0)[:, None]
        nl, nv = torch.clamp_min(ndl, 1e-6), torch.clamp_min(ndv, 1e-6)
        vis = 2.0 * nl * nv / torch.clamp_min(
            nl * torch.sqrt(nv * nv * (1.0 - a2) + a2) + nv * torch.sqrt(nl * nl * (1.0 - a2) + a2),
            1e-9)
        x = ndh * ndh * (a2 - 1.0) + 1.0
        dd = a2 / (math.pi * x * x)
        brdf = (1.0 - f) * diff * (1.0 / math.pi) + f * (vis * dd)[:, None]
        result = result + brdf * lcol * (ndl * att)[:, None]
    return result + base * AMBIENT, base_a


def trace_paths(scene: Scene, cam: Camera, pixel, sample, frame, *, width, height, max_depth):
    """Radiance [N, 3] of the Whitted paths of (pixel, sample, frame) [N]."""
    dt = cam.w.dtype
    n, dev = pixel.shape[0], pixel.device
    jx, jy, _, _ = uniforms(pixel, sample, frame, STREAM_JITTER, dt)
    o, d = _camera_rays(cam, pixel, width, height, jx, jy)
    weight = torch.ones((n, 3), dtype=dt, device=dev)
    total = torch.zeros((n, 3), dtype=dt, device=dev)
    live = torch.arange(n, device=dev)
    for depth in range(min(max_depth, MAX_TRACE_DEPTH)):
        h = visible(scene, o, d)
        hit, mat = h[4], h[5]
        p = o + d * h[0][:, None]
        rad = torch.zeros_like(o)
        a = torch.ones_like(o[:, 0])
        s = hit.nonzero(as_tuple=True)[0]
        if s.numel():
            rad[s], a[s] = shade(scene, p[s], d[s], [x[s] for x in h])
        blend = hit & (scene.alpha_mode[mat] == BLEND)
        total[live] = total[live] + torch.where(blend[:, None], rad * a[:, None], rad) * weight
        if depth + 1 >= min(max_depth, MAX_TRACE_DEPTH) or not blend.any():
            break
        o, d = (p + d * 1e-3)[blend], d[blend]
        weight = (weight * (1.0 - a)[:, None])[blend]
        live = live[blend]
    return total


def render_pixels(scene: Scene, cam: Camera, pixels, frames, *, width, height, spp,
                  max_depth, snapshot_frames=0, paths_per_call=1 << 16):
    """The accumulator [P, 3] of ``pixels`` after ``frames``, and a copy
    after the first ``snapshot_frames`` (``pathtracer.fold``). Paths are
    traced ``paths_per_call`` at a time."""
    dev = scene.all.v0.device
    pixels = torch.as_tensor(pixels, dtype=torch.int64, device=dev)
    frames = [int(k) for k in frames]
    n_pix = pixels.shape[0]
    # Every (frame, sample, pixel) path, frame-major.
    pix = pixels.repeat(len(frames) * spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(n_pix).repeat(len(frames))
    frm = torch.tensor(frames, device=dev).repeat_interleave(spp * n_pix)
    rad = torch.cat([
        trace_paths(scene, cam, pix[a:a + paths_per_call], smp[a:a + paths_per_call],
                    frm[a:a + paths_per_call], width=width, height=height, max_depth=max_depth)
        for a in range(0, pix.shape[0], paths_per_call)])
    return pathtracer.fold(rad.reshape(len(frames), spp, n_pix, 3), frames, snapshot_frames)


def values(scene_path, config: dict, traffic: dict, pixels, frames, device,
           dtype=torch.float32, snapshot_frames: int = 0) -> dict:
    """The reference's accumulator at ``pixels`` after ``frames``
    (``values``) and after the first ``snapshot_frames`` (``snapshot``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = Scene(gltf.read(str(scene_path)), device, dtype)
    c = config["camera"]
    cam = Camera(c["eye"], c["lookat"], c["up"], c["fov_y"],
                 traffic["width"] / traffic["height"], device, dtype)
    with torch.no_grad():
        acc, snap = render_pixels(scene, cam, pixels, frames, width=traffic["width"],
                                  height=traffic["height"], spp=traffic["spp"],
                                  max_depth=traffic["max_depth"],
                                  snapshot_frames=snapshot_frames)
    return {"values": acc.float().cpu().numpy(), "snapshot": snap.float().cpu().numpy()}
