"""Swept-sphere curve primitives: linear, quadratic / cubic B-spline,
Catmull-Rom (counterpart of ``tpu_pt/intersect/curves.py``; plain PyTorch
on ``[N, 3]`` rays, the JAX package's operations in its order).

Parity with the reference's curve support (``cuda/GeometryData.h:55-127``
lists the four round-curve types; ``cuda/curve.h:312-443`` evaluates the
segment polynomial and its surface normal):

- Every segment type is converted once to a power-basis polynomial
  ``c(u) = k3 u^3 + k2 u^2 + k1 u + k0`` over xyz + radius, so evaluation
  is a Horner scheme over [S] segments.
- Intersection tessellates each segment into ``PIECES`` rounded cones (a
  sphere swept along a line with linearly varying radius) and tests all
  rays against all pieces with the closed-form rounded-cone quadratic, the
  same dense all-pairs shape as the analytic primitives. Pieces have
  spherical joints and caps, so chained segments stay watertight.
- The normal at the winning piece is then refined with the exact
  swept-sphere surface normal of ``curve.h:333-443`` (type 2): project the
  hit point onto the curve frame at u, then
  ``n = (|c'|^2 - <c'', o1>) o1 - (r' r) c'``.

Returns the shared ``Hit`` so that ``combine_hits`` merges curve hits with
triangles and analytic primitives by min-t.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import vec3 as v3
from .moller import T_FAR, Hit
from .primitives import occluder_flags

# Curve kinds (GeometryData round-curve union parity).
CURVE_LINEAR = 0
CURVE_QUADRATIC_BSPLINE = 1
CURVE_CUBIC_BSPLINE = 2
CURVE_CATMULLROM = 3

PIECES = 8          # rounded-cone pieces per segment
_EPS = 1e-12

# Basis name -> (CURVE_* kind, control points per segment). A strand of n
# points yields n - (cps - 1) sliding-window segments, the curve-array
# vertex indexing of the reference's four curve types
# (``cuda/GeometryData.h:95-127``). Shared by every loader that accepts
# curve declarations (scene JSON, glTF extras).
CURVE_BASES = {
    "linear": (CURVE_LINEAR, 2),
    "quadratic_bspline": (CURVE_QUADRATIC_BSPLINE, 3),
    "cubic_bspline": (CURVE_CUBIC_BSPLINE, 4),
    "catmullrom": (CURVE_CATMULLROM, 4),
}


def expand_curve_spec(spec: dict, mat: int) -> list[dict]:
    """One loader curve declaration -> per-segment dicts for make_curves.

    ``spec`` carries ``basis`` (default cubic_bspline), ``points`` ([n, 3])
    and ``radii`` (scalar or [n]); validation errors name the offending
    field. Returns sliding-window segment dicts {kind, points, radii,
    mat}."""
    basis = spec.get("basis", "cubic_bspline")
    if basis not in CURVE_BASES:
        raise ValueError(f"unknown curve basis {basis!r}")
    ckind, cps = CURVE_BASES[basis]
    pts = np.asarray(spec["points"], np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3 or pts.shape[0] < cps:
        raise ValueError(f"curve needs >= {cps} [x,y,z] points for {basis}")
    radii = spec.get("radii", 0.1)
    if np.ndim(radii) == 0:
        radii = np.full((pts.shape[0],), float(radii), np.float32)
    else:
        radii = np.asarray(radii, np.float32)
    if radii.shape[0] != pts.shape[0]:
        raise ValueError("curve radii must match points")
    return [dict(kind=ckind, points=pts[s:s + cps], radii=radii[s:s + cps],
                 mat=mat)
            for s in range(pts.shape[0] - (cps - 1))]


@dataclasses.dataclass
class CurveSegments:
    """SoA curve segments in power basis: k0..k3 are [S, 4] (xyz, radius)."""
    k0: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    mat: torch.Tensor    # [S] i32
    # Per-segment "can occlude an NEE shadow ray" flags: refractive curves
    # pass light, as the primitives do. Empty = all occlude.
    occludes: tuple = ()

    @property
    def count(self) -> int:
        return self.k0.shape[0]

    def to(self, device) -> "CurveSegments":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device)
                     for k in ("k0", "k1", "k2", "k3", "mat")})


def _to_power_basis(kind: int, q: np.ndarray):
    """Control points [S, n, 4] -> power-basis coefficients (4 x [S, 4])."""
    z = np.zeros_like(q[:, 0])
    if kind == CURVE_LINEAR:
        return q[:, 0], q[:, 1] - q[:, 0], z, z
    if kind == CURVE_QUADRATIC_BSPLINE:
        q0, q1, q2 = q[:, 0], q[:, 1], q[:, 2]
        return (q0 + q1) / 2, q1 - q0, (q0 - 2 * q1 + q2) / 2, z
    if kind == CURVE_CUBIC_BSPLINE:
        q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
        return ((q0 + 4 * q1 + q2) / 6, (q2 - q0) / 2,
                (q0 - 2 * q1 + q2) / 2, (-q0 + 3 * q1 - 3 * q2 + q3) / 6)
    if kind != CURVE_CATMULLROM:
        raise ValueError(f"unknown curve kind {kind}")
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return (q1, (q2 - q0) / 2, q0 - 2.5 * q1 + 2 * q2 - 0.5 * q3,
            1.5 * (q1 - q2) + 0.5 * (q3 - q0))


def make_curves(segments: list[dict], mat_bsdf: np.ndarray | None = None,
                device="cpu") -> CurveSegments:
    """Build from dicts {kind, points [n, 3], radii [n], mat}.

    ``mat_bsdf`` (host [M] ints) marks refractive materials so that their
    segments are left out of NEE occlusion at build time (the contract of
    ``primitives.make_primitives``)."""
    ks = [[], [], [], []]
    mat = []
    for d in segments:
        pts = np.asarray(d["points"], np.float32)
        rad = np.asarray(d["radii"], np.float32)
        q = np.concatenate([pts, rad[:, None]], axis=1)[None]  # [1, n, 4]
        for i, k in enumerate(_to_power_basis(int(d["kind"]), q)):
            ks[i].append(k[0])
        mat.append(d.get("mat", 0))

    def dev(a):
        return torch.as_tensor(a, device=device)
    return CurveSegments(
        k0=dev(np.stack(ks[0])), k1=dev(np.stack(ks[1])),
        k2=dev(np.stack(ks[2])), k3=dev(np.stack(ks[3])),
        mat=dev(np.asarray(mat, np.int32)),
        occludes=occluder_flags(mat, mat_bsdf))


def _horner4(k0, k1, k2, k3, u):
    """Batched position4: k* [..., 4] with matching leading dims on u."""
    u = u[..., None]
    return ((k3 * u + k2) * u + k1) * u + k0


def _piece_table(k0, k1, k2, k3):
    """Tessellate segments into rounded-cone pieces: (pa, pb [S * PIECES,
    4] endpoint positions and radii, seg [S * PIECES] segment ids, u0 the
    pieces' start parameters), segment-major."""
    s_cnt = k0.shape[0]
    us = torch.as_tensor(np.linspace(0.0, 1.0, PIECES + 1, dtype=np.float32),
                         device=k0.device)
    ends = _horner4(k0[:, None, :], k1[:, None, :], k2[:, None, :],
                    k3[:, None, :], us[None, :])            # [S, P + 1, 4]
    pa = ends[:, :-1, :].reshape(s_cnt * PIECES, 4)
    pb = ends[:, 1:, :].reshape(s_cnt * PIECES, 4)
    seg = torch.arange(s_cnt, device=k0.device).repeat_interleave(PIECES)
    u0 = us[:-1].repeat(s_cnt)
    return pa, pb, seg, u0


def _rounded_cone_t(o, d, pa, pb, ra, rb, tmin, tmax):
    """Closed-form ray vs rounded cone (a sphere swept pa -> pb, radius
    ra -> rb). Returns (t with T_FAR misses, axis parameter in [0, 1]).
    Body and spherical end caps; two-sided like every other intersector."""
    ba = pb - pa
    oa = o - pa
    ob = o - pb
    rr = ra - rb
    m0 = v3.dot(ba, ba)
    m1 = v3.dot(ba, oa)
    m2 = v3.dot(ba, d)
    m3 = v3.dot(d, oa)
    m5 = v3.dot(oa, oa)
    m6 = v3.dot(ob, d)
    m7 = v3.dot(ob, ob)
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + m1 * rr * ra * 2.0 - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    sq = torch.sqrt(torch.clamp_min(h, 0.0))
    k2s = torch.where(k2.abs() > _EPS, k2, 1.0)
    t_body = (-sq - k1) / k2s
    y = m1 - ra * rr + t_body * m2
    body_ok = (h > 0.0) & (k2.abs() > _EPS) & (y > 0.0) & (y < d2)
    t_body = torch.where(body_ok, t_body, T_FAR)

    def cap(mm3, mm5, r):
        hc = mm3 * mm3 - mm5 + r * r
        tc = -mm3 - torch.sqrt(torch.clamp_min(hc, 0.0))
        return torch.where(hc > 0.0, tc, T_FAR)

    t_a = cap(m3, m5, ra)
    t_b = cap(m6, m7, rb)
    t = torch.minimum(t_body, torch.minimum(t_a, t_b))
    t = torch.where((t > tmin) & (t < tmax), t, T_FAR)
    s_axis = torch.clamp(
        torch.where(t == t_body, y / torch.clamp_min(d2, _EPS),
                    torch.where(t == t_a, 0.0, 1.0)), 0.0, 1.0)
    return t, s_axis


def _surface_normal_k(k0, k1, k2, k3, u, ps):
    """Exact swept-sphere normal (``curve.h:333-443``, type 2) from
    per-lane power-basis rows ``k*`` [N, 4] at parameter ``u`` [N] and
    surface point ``ps`` [N, 3]."""
    p4 = _horner4(k0, k1, k2, k3, u)
    p, r = p4[..., 0:3], p4[..., 3]
    uc = u[..., None]
    d4 = (3 * k3 * uc + 2 * k2) * uc + k1
    d, dr = d4[..., 0:3], d4[..., 3]
    dd = v3.dot(d, d)
    o1 = ps - p
    o1 = o1 - d * (v3.dot(o1, d) / torch.clamp_min(dd, _EPS))[..., None]
    o1 = o1 * (r / torch.clamp_min(v3.length(o1), _EPS))[..., None]
    acc = 6 * k3[..., :3] * uc + 2 * k2[..., :3]
    ddc = dd - v3.dot(acc, o1)
    return v3.normalize(o1 * ddc[..., None] - d * (dr * r)[..., None])


def _surface_normal(c: CurveSegments, s: int, u, ps):
    """``_surface_normal_k`` for one segment (tests)."""
    shape = u.shape + (4,)
    return _surface_normal_k(c.k0[s].expand(shape), c.k1[s].expand(shape),
                             c.k2[s].expand(shape), c.k3[s].expand(shape),
                             u, ps)


def intersect_curves(curves: CurveSegments, origins: torch.Tensor,
                     dirs: torch.Tensor, tmin: float = 0.01,
                     tmax: float = T_FAR, index_offset: int = 0) -> Hit:
    """Closest hit over all curve segments for a flat ray batch.

    One loop over the tessellated piece table (segment-major, piece-minor:
    the order fixes strict-`<` ties); the winning segment's exact normal
    is evaluated once per lane from its gathered power-basis rows."""
    n, dev = origins.shape[0], origins.device
    du = 1.0 / PIECES
    pa, pb, seg, u0 = _piece_table(curves.k0, curves.k1, curves.k2, curves.k3)
    best_t = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_seg = torch.zeros(n, dtype=torch.int64, device=dev)
    for k in range(pa.shape[0]):
        t, ax = _rounded_cone_t(origins, dirs, pa[k, :3], pb[k, :3],
                                pa[k, 3], pb[k, 3], tmin, tmax)
        better = t < best_t
        best_t = torch.where(better, t, best_t)
        best_u = torch.where(better, u0[k] + ax * du, best_u)
        best_seg = torch.where(better, seg[k], best_seg)
    hit = best_t < T_FAR
    ps = origins + dirs * best_t[:, None]
    s = torch.where(hit, best_seg, 0)
    normal = _surface_normal_k(curves.k0[s], curves.k1[s], curves.k2[s],
                               curves.k3[s], best_u, ps)
    normal = torch.where(hit[:, None], normal, 0.0)
    mat = torch.where(hit, curves.mat[s], 0).to(torch.int32)
    return Hit(t=best_t, tri=(best_seg + index_offset).to(torch.int32),
               hit=hit, normal=normal, mat=mat, u=best_u,
               v=torch.zeros_like(best_t))


def occluded_curves(curves: CurveSegments, origins: torch.Tensor,
                    dirs: torch.Tensor, tmax: torch.Tensor,
                    tmin: float = 0.01) -> torch.Tensor:
    """Any-hit occlusion over the occluding (non-refractive) segments.

    The semantics of ``primitives.occluded_primitives``: a per-ray tmax
    bounds the light distance; segments whose ``occludes`` flag is False
    pass light (chosen at build time, so they cost nothing)."""
    n, dev = origins.shape[0], origins.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    keep = (np.asarray([bool(f) for f in curves.occludes]) if curves.occludes
            else np.ones((curves.count,), bool))
    if not keep.any():
        return occ
    idx = torch.as_tensor(np.nonzero(keep)[0], device=dev)
    pa, pb, _, _ = _piece_table(curves.k0[idx], curves.k1[idx],
                                curves.k2[idx], curves.k3[idx])
    for k in range(pa.shape[0]):
        t, _ = _rounded_cone_t(origins, dirs, pa[k, :3], pb[k, :3], pa[k, 3],
                               pb[k, 3], tmin, T_FAR)
        occ = occ | (t < tmax)
    return occ
