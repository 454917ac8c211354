"""Dense single-slab ray-triangle intersection: the port of the Pallas
kernels on the path tracer's main path (single-slab part of
``tpu_pt/intersect/pallas_bf.py``).

Five kernels, each with a wrapper, a plain PyTorch version and a launch
counter (wrapper: the kernel it replaces, via its call site; plain
version):

- ``closest_lean`` (K1): ``_closest_kernel_lean`` via
  ``_closest_call_lean``; ``_closest_plain``;
- ``occluded`` (K2): ``_occluded_kernel`` via ``_occluded_call``;
  ``_occluded_plain``;
- ``closest_full`` (K3): ``_closest_kernel`` via ``_closest_call``;
  ``_closest_plain(full=True)``;
- ``closest_nee_lean`` (K4): ``_closest_nee_kernel_lean`` via
  ``_closest_nee_call_lean``; ``_closest_nee_plain``;
- ``closest_nee_full`` (K5): ``_closest_nee_kernel`` via
  ``_closest_nee_call``; ``_closest_nee_kd_plain`` (the function of
  ``_closest_nee_plain(full=True)`` on the kd copy of the table).

K4 and K5 are the fused closest hit + NEE shadow ray of
``RenderConfig.fused_nee`` (``intersect_closest_nee``). K5 walks a kd copy
of its table (``KdTables``: the rows of ``clustered.pack_tris_clustered``,
128-row clusters with boxes, and their ``cluster_tree``), which ``prepare``
builds for a table above ``LEAN_MAX_TRIS`` rows; ties go to the lowest
dense row (column 15), as in the dense sweep. Its dense body stays as
``closest_nee_full_dense``, on no path, the yardstick ``chip_smoke.py``
holds the walk against.

The CUDA kernels are in ``csrc/dense_intersect.cu`` (bound by
``tpu_pt_torch._kernels``). A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel, and for
anything else it raises. ``LAUNCHES`` counts kernel launches per wrapper.

The winner's normal and material after the lean kernel come from a plain
gather of its packed row; the JAX package used a one-hot bf16 matmul there
(``_lean_resolve``) only because TPU gathers are slow. Scenes above
``TRI_SLAB`` packed rows take the clustered kernels of ``clustered``
instead (``intersect.kernel_module`` chooses).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import vec3 as v3
from ..scene.arrays import BSDF_REFRACTION, SceneArrays, median_split_order
from .moller import T_FAR, Hit

TRI_BLOCK = 512        # packed tables pad to a multiple of this
TRI_SLAB = 8192        # largest packed table the single-slab kernels take
LEAN_MAX_TRIS = 2048   # above this (or with a finite tmax) K3 runs, not K1
TOP_SPAN = 8           # K5 sweeps a triangle wider than 1/8 of the scene
# Lanes a ray of K5's walk: 16 was fastest at both ray counts
# tools/clustered_group_trial.py times (65,536 and 262,144; PERF.md).
NEE_WALK_GROUP = 16
_PLAIN_PAIRS = 1 << 21  # ray x row pairs per block of the plain versions
_PLAIN_ROWS = 4096      # rows per block (temporaries stay cache-sized)

# Kernel launches per wrapper (read by chip_smoke.py). Plain-version calls
# on CPU tensors do not count.
LAUNCHES = {"closest_lean": 0, "occluded": 0, "closest_full": 0,
            "closest_nee_lean": 0, "closest_nee_full": 0,
            "closest_nee_full_dense": 0}
NEE_EPS = 0.01         # shadow-ray range shrink (cu:1017 "Ldist - 0.01")


def _pad_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


def pack_tris(scene: SceneArrays) -> torch.Tensor:
    """Scene triangles -> [T_pad, 16] kernel rows (``pallas_bf.pack_tris``).

    The plane + edge-function form: for P = v0 + u*e1 + v*e2,
    ``u = wu . P + cu`` with ``wu = (e2 x n) / ((e2 x n) . e1)`` (and the
    symmetric ``wv``), and ``t = (d0 - n . o) / (n . d)`` with the unit
    geometric normal n and ``d0 = n . v0``. Rows are zero-padded to a
    TRI_BLOCK multiple; zero rows never hit.

    Columns: n xyz, d0, wu xyz, cu, wv xyz, cv, valid, refractive, mat, id.
    """
    refr = scene.mat_bsdf[scene.mat_id.long()] == BSDF_REFRACTION
    t = scene.num_tris_padded
    n = scene.tri_normal
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2

    def guarded_div(num, den):
        return num / torch.where(torch.abs(den) > 1e-20, den, 1.0)[:, None]

    cu_dir = v3.cross(e2, n)
    wu = guarded_div(cu_dir, v3.dot(cu_dir, e1))
    cv_dir = v3.cross(e1, n)
    wv = guarded_div(cv_dir, v3.dot(cv_dir, e2))
    cols = [
        n, v3.dot(n, v0)[:, None],
        wu, -v3.dot(wu, v0)[:, None],
        wv, -v3.dot(wv, v0)[:, None],
        scene.tri_valid.to(torch.float32)[:, None],
        refr.to(torch.float32)[:, None],
        scene.mat_id.to(torch.float32)[:, None],
        torch.arange(t, dtype=torch.float32, device=n.device)[:, None],
    ]
    packed = torch.cat(cols, dim=1)
    t_pad = _pad_to(t, TRI_BLOCK)
    if t_pad != t:
        packed = torch.nn.functional.pad(packed, (0, 0, 0, t_pad - t))
    return packed.contiguous()


def _trim_rows(t_real: int, packed: torch.Tensor) -> torch.Tensor:
    """Trim a packed table to the finest split of its ``t_real`` rows into
    equal 8-aligned blocks of at most TRI_BLOCK rows
    (``pallas_bf._trim_rows``): the mixed Cornell box (428 triangles)
    sweeps 432 rows, not 512. Only the row count matters here; it decides
    between K1 and K3 as it does in the JAX package."""
    if not t_real or t_real >= packed.shape[0]:
        return packed
    nb = -(-t_real // TRI_BLOCK)
    return packed[:min(-(-t_real // (8 * nb)) * 8 * nb, packed.shape[0])]


def _occ_subset(scene: SceneArrays):
    """(packed rows of the NEE occluder subset [O_pad, 16], n_occ), or None
    when the scene carries no occluder analysis. Padding rows (copies of
    row ``occ_index[0]``) are zeroed so they never hit."""
    if scene.num_occluders < 0 or scene.occ_index is None:
        return None
    sub = pack_tris(scene)[scene.occ_index.long()]
    keep = torch.arange(sub.shape[0], device=sub.device) < scene.num_occluders
    return (sub * keep.to(sub.dtype)[:, None]).contiguous(), scene.num_occluders


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference)
# --------------------------------------------------------------------------

def _pe_block(o: torch.Tensor, d: torch.Tensor, tris: torch.Tensor,
              tmin: float):
    """Plane + edge-function test, [R] rays x [T] rows
    (``pallas_bf._pe_block``). Returns (t [R, T] with T_FAR on a miss,
    u, v). No validity test: zero and degenerate rows give a zero
    ``n . d``, whose reciprocal is inf, so t is inf or NaN and fails the
    comparisons (NaN compares false)."""
    ox, oy, oz = o[:, 0:1], o[:, 1:2], o[:, 2:3]
    dx, dy, dz = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    c = [tris[None, :, k] for k in range(12)]
    nx, ny, nz, d0, wux, wuy, wuz, cu, wvx, wvy, wvz, cv = c
    ndotd = nx * dx + ny * dy + nz * dz
    rcp = 1.0 / ndotd
    t = (d0 - (nx * ox + ny * oy + nz * oz)) * rcp
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    u = wux * px + wuy * py + wuz * pz + cu
    v = wvx * px + wvy * py + wvz * pz + cv
    hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
    return torch.where(hit, t, T_FAR), u, v


def _blocks(n: int, rows: int):
    """(ray ranges, row ranges) tiling the plain versions' ray x row
    sweep into blocks of about _PLAIN_PAIRS pairs."""
    block = max(1, min(rows, _PLAIN_ROWS))
    step = max(1, _PLAIN_PAIRS // block)
    return ([(r, min(r + step, n)) for r in range(0, n, step)],
            [(s, min(s + block, rows)) for s in range(0, rows, block)])


def _closest_plain(origins, dirs, tris, tmin: float, tmax: float = T_FAR,
                   full: bool = False, want_uv: bool = False):
    """Plain version of K1 (``full=False``: returns (t, row)) and K3
    (``full=True``: returns (t, row, normal, mat, u, v)); t is clipped at
    ``tmax`` (K1 takes none). Misses give t = T_FAR and zeros; ties go to
    the lowest row."""
    n, dev = origins.shape[0], origins.device
    t_out = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    row_out = torch.zeros(n, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    iota = torch.arange(tris.shape[0], dtype=torch.int32, device=dev)
    ray_ranges, row_ranges = _blocks(n, tris.shape[0])
    for a, b in ray_ranges:
        # Row blocks in ascending order, each replacing the running best
        # only on a strictly smaller t: ties go to the lowest row.
        for s, e in row_ranges:
            t, u, v = _pe_block(origins[a:b], dirs[a:b], tris[s:e], tmin)
            if tmax < T_FAR:
                t = torch.where(t < tmax, t, T_FAR)
            best = t.min(dim=1).values
            sub = torch.where(t == best[:, None], iota[s:e], tris.shape[0])
            sub = sub.min(dim=1).values
            better = best < t_out[a:b]
            t_out[a:b] = torch.where(better, best, t_out[a:b])
            row_out[a:b] = torch.where(better, sub, row_out[a:b])
            if full and want_uv:
                sel = (sub - s).long()[:, None]
                u_out[a:b] = torch.where(better, u.gather(1, sel)[:, 0],
                                         u_out[a:b])
                v_out[a:b] = torch.where(better, v.gather(1, sel)[:, 0],
                                         v_out[a:b])
    if not full:
        return t_out, row_out
    hit = t_out < T_FAR
    rows = tris[row_out.long()]
    normal = torch.where(hit[:, None], rows[:, 0:3], 0.0)
    mat = torch.where(hit, rows[:, 14], 0.0).to(torch.int32)
    return t_out, row_out, normal, mat, u_out, v_out


def _occluded_plain(origins, dirs, tmax, tris, tmin: float) -> torch.Tensor:
    """Plain version of K2: any hit with tmin < t < tmax on a row whose
    refractive column is < 0.5. Returns bool [N]."""
    out = torch.zeros(origins.shape[0], dtype=torch.bool,
                      device=origins.device)
    opaque = tris[None, :, 13] < 0.5
    ray_ranges, row_ranges = _blocks(origins.shape[0], tris.shape[0])
    for a, b in ray_ranges:
        for s, e in row_ranges:
            t, _, _ = _pe_block(origins[a:b], dirs[a:b], tris[s:e], tmin)
            out[a:b] |= ((t < tmax[a:b, None]) & opaque[:, s:e]).any(dim=1)
    return out


def _shadow_rays(origins, dirs, t, lz1, lz2, light):
    """The fused kernels' NEE shadow rays, traced on every lane: from
    p = o + t d toward the light point corner + v1 lz1 + v2 lz2 (``light``
    [9] = corner, v1, v2), tmax |to_light| - NEE_EPS. 1/|to_light| is an
    IEEE square root and division, as in the kernels (XLA's rsqrt in the
    JAX kernel differs by an ulp)."""
    p = origins + t[:, None] * dirs
    tl = (light[0:3] + light[3:6] * lz1[:, None]
          + light[6:9] * lz2[:, None] - p)
    dist2 = tl[:, 0] * tl[:, 0] + tl[:, 1] * tl[:, 1] + tl[:, 2] * tl[:, 2]
    inv = 1.0 / torch.sqrt(torch.clamp_min(dist2, 1e-12))
    return p, tl * inv[:, None], dist2 * inv - NEE_EPS


def _closest_by_id_plain(origins, dirs, rows, tmin: float,
                         tmax: float = T_FAR):
    """The closest hit with t < tmax over ``rows`` whose column 15 is an
    id, ties to the lowest id whatever the rows' order: (t, id, row of the
    winner in ``rows``), T_FAR / 0 / 0 on a miss. Over a kd copy of a
    dense table this is the dense sweep's answer (``_closest_plain``),
    with the dense row as the id."""
    n, dev = origins.shape[0], origins.device
    t_out = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    id_out = torch.zeros(n, dtype=torch.int32, device=dev)
    row_out = torch.zeros(n, dtype=torch.int32, device=dev)
    ids = rows[:, 15].to(torch.int32)
    iota = torch.arange(rows.shape[0], dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int32).max
    ray_ranges, row_ranges = _blocks(n, rows.shape[0])
    for a, b in ray_ranges:
        for s, e in row_ranges:
            t, _, _ = _pe_block(origins[a:b], dirs[a:b], rows[s:e], tmin)
            if tmax < T_FAR:
                t = torch.where(t < tmax, t, T_FAR)
            best = t.min(dim=1).values
            at_best = t == best[:, None]
            low = torch.where(at_best, ids[s:e], big).min(dim=1).values
            sub = torch.where(at_best & (ids[s:e] == low[:, None]),
                              iota[s:e], big).min(dim=1).values
            better = (best < t_out[a:b]) | ((best == t_out[a:b])
                                            & (best < T_FAR)
                                            & (low < id_out[a:b]))
            t_out[a:b] = torch.where(better, best, t_out[a:b])
            id_out[a:b] = torch.where(better, low, id_out[a:b])
            row_out[a:b] = torch.where(better, sub, row_out[a:b])
    return t_out, id_out, row_out


def _closest_nee_plain(origins, dirs, lz1, lz2, tris, occ_tris, light,
                       tmin: float, tmax: float = T_FAR, full: bool = False):
    """Plain version of K4 (``full=False``: K1's sweep, then the shadow
    ray any-hit over ``occ_tris``; returns (t, row, occ)) and K5
    (``full=True``: K3's sweep clipped at ``tmax`` without u/v, the shadow
    ray over ``tris``; returns (t, row, normal, mat, occ)). The occlusion
    flag of a miss lane is meaningless."""
    if full:
        t, row, normal, mat, _, _ = _closest_plain(origins, dirs, tris, tmin,
                                                   tmax, full=True)
    else:
        t, row = _closest_plain(origins, dirs, tris, tmin)
    so, sd, stmax = _shadow_rays(origins, dirs, t, lz1, lz2, light)
    occ = _occluded_plain(so, sd, stmax, occ_tris, tmin)
    return (t, row, normal, mat, occ) if full else (t, row, occ)


def _closest_nee_kd_plain(origins, dirs, lz1, lz2, kd_rows, light,
                          tmin: float, tmax: float = T_FAR):
    """Plain version of K5 on the kd copy of its table: the closest hit
    clipped at ``tmax``, ties to the lowest dense row (column 15), its
    normal and material from the winning kd row; then the shadow ray
    any-hit over every kd row. Returns (t, dense row, normal, mat, occ),
    bit for bit ``_closest_nee_plain(full=True)`` on the dense table."""
    t, ids, krow = _closest_by_id_plain(origins, dirs, kd_rows, tmin, tmax)
    hit = t < T_FAR
    won = kd_rows[krow.long()]
    normal = torch.where(hit[:, None], won[:, 0:3], 0.0)
    mat = torch.where(hit, won[:, 14], 0.0).to(torch.int32)
    so, sd, stmax = _shadow_rays(origins, dirs, t, lz1, lz2, light)
    occ = _occluded_plain(so, sd, stmax, kd_rows, tmin)
    return t, ids, normal, mat, occ


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _on_cpu(origins: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors
    (kernel); raises for any other device."""
    if origins.device.type == "cpu":
        return True
    if origins.device.type != "cuda":
        raise ValueError(f"the kernel wrappers take CPU or CUDA tensors, "
                         f"not {origins.device}")
    return False


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_inputs(origins, dirs, tris) -> tuple[int, int]:
    n, rows = origins.shape[0], tris.shape[0]
    dev = origins.device
    _check("origins", origins, torch.float32, (n, 3), dev)
    _check("dirs", dirs, torch.float32, (n, 3), dev)
    _check("tris", tris, torch.float32, (rows, 16), dev)
    if tris.data_ptr() % 16:
        raise ValueError("tris must be 16-byte aligned (float4 row loads)")
    if n >= 2 ** 31 or rows >= 2 ** 31:
        raise ValueError("ray and row counts must fit in int32")
    return n, rows


def _stream(device: torch.device):
    from ctypes import c_void_p
    return c_void_p(torch.cuda.current_stream(device).cuda_stream)


def closest_lean(origins: torch.Tensor, dirs: torch.Tensor,
                 tris: torch.Tensor, tmin: float):
    """K1: per ray, (t, row) of the closest hit over all ``tris`` rows
    (t = T_FAR and row 0 on a miss). Rays [N, 3] f32, rows [T, 16] f32."""
    if _on_cpu(origins):
        return _closest_plain(origins, dirs, tris, tmin)
    from .. import _kernels
    n, rows = _check_inputs(origins, dirs, tris)
    dev = origins.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _kernels.launch("tpt_closest_lean", origins.data_ptr(),
                        dirs.data_ptr(), tris.data_ptr(), n, rows,
                        float(tmin), t.data_ptr(), row.data_ptr(),
                        _stream(dev))
        LAUNCHES["closest_lean"] += 1
    return t, row


def closest_full(origins: torch.Tensor, dirs: torch.Tensor,
                 tris: torch.Tensor, tmin: float, tmax: float,
                 want_uv: bool):
    """K3: K1 clipped at ``tmax`` plus the winner's normal [N, 3], material
    id and (``want_uv``) barycentrics; zeros on a miss."""
    if _on_cpu(origins):
        return _closest_plain(origins, dirs, tris, tmin, tmax, full=True,
                              want_uv=want_uv)
    from .. import _kernels
    n, rows = _check_inputs(origins, dirs, tris)
    dev = origins.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _kernels.launch("tpt_closest_full", origins.data_ptr(),
                        dirs.data_ptr(), tris.data_ptr(), n, rows,
                        float(tmin), float(tmax), int(bool(want_uv)),
                        t.data_ptr(), row.data_ptr(), normal.data_ptr(),
                        mat.data_ptr(), u.data_ptr(), v.data_ptr(),
                        _stream(dev))
        LAUNCHES["closest_full"] += 1
    return t, row, normal, mat, u, v


def occluded(origins: torch.Tensor, dirs: torch.Tensor, tmax: torch.Tensor,
             tris: torch.Tensor, tmin: float) -> torch.Tensor:
    """K2: per ray, is any non-refractive row hit with tmin < t < tmax[i]?
    Returns bool [N]."""
    if _on_cpu(origins):
        return _occluded_plain(origins, dirs, tmax, tris, tmin)
    from .. import _kernels
    n, rows = _check_inputs(origins, dirs, tris)
    _check("tmax", tmax, torch.float32, (n,), origins.device)
    out = torch.empty(n, dtype=torch.bool, device=origins.device)
    if n:
        _kernels.launch("tpt_occluded", origins.data_ptr(), dirs.data_ptr(),
                        tmax.data_ptr(), tris.data_ptr(), n, rows,
                        float(tmin), out.data_ptr(), _stream(origins.device))
        LAUNCHES["occluded"] += 1
    return out


def _check_nee(origins, lz1, lz2, light) -> None:
    n, dev = origins.shape[0], origins.device
    _check("lz1", lz1, torch.float32, (n,), dev)
    _check("lz2", lz2, torch.float32, (n,), dev)
    _check("light", light, torch.float32, (9,), dev)


def closest_nee_lean(origins: torch.Tensor, dirs: torch.Tensor,
                     lz1: torch.Tensor, lz2: torch.Tensor, tris: torch.Tensor,
                     occ_tris: torch.Tensor, light: torch.Tensor,
                     tmin: float):
    """K4: K1 over ``tris``, then per ray the NEE shadow ray toward the
    light point (lz1, lz2) any-hit over ``occ_tris``. ``light`` [9] f32 is
    (corner, v1, v2). Returns (t, row, occluded bool [N])."""
    if _on_cpu(origins):
        return _closest_nee_plain(origins, dirs, lz1, lz2, tris, occ_tris,
                                  light, tmin)
    from .. import _kernels
    n, rows = _check_inputs(origins, dirs, tris)
    _, n_occ = _check_inputs(origins, dirs, occ_tris)
    _check_nee(origins, lz1, lz2, light)
    dev = origins.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _kernels.launch("tpt_closest_nee_lean", origins.data_ptr(),
                        dirs.data_ptr(), lz1.data_ptr(), lz2.data_ptr(),
                        tris.data_ptr(), rows, occ_tris.data_ptr(), n_occ,
                        light.data_ptr(), n, float(tmin), t.data_ptr(),
                        row.data_ptr(), occ.data_ptr(), _stream(dev))
        LAUNCHES["closest_nee_lean"] += 1
    return t, row, occ


def closest_nee_full(origins: torch.Tensor, dirs: torch.Tensor,
                     lz1: torch.Tensor, lz2: torch.Tensor, rows: torch.Tensor,
                     top: int, boxes: torch.Tensor, nodes: torch.Tensor,
                     scale: float, light: torch.Tensor, tmin: float,
                     tmax: float, group: int | None = None):
    """K5: the closest hit clipped at ``tmax`` (no u/v), then the NEE
    shadow ray any-hit over every row, on the kd copy of the table
    (``KdTables``: ``rows`` [top + C * cluster, 16] whose column 15 is the
    dense row, the ``top`` rows every ray sweeps first, cluster ``boxes``
    [C, 8], ``nodes`` [C - 1, 8], ``scale``), walked by ``group`` lanes a
    ray (NEE_WALK_GROUP when None). Returns (t, dense row, normal [N, 3],
    mat, occluded bool [N]): the dense sweep's answer, ties to the lowest
    dense row."""
    if _on_cpu(origins):
        return _closest_nee_kd_plain(origins, dirs, lz1, lz2, rows, light,
                                     tmin, tmax)
    from .. import _kernels
    from . import clustered
    n, _ = _check_inputs(origins, dirs, rows)
    _check_nee(origins, lz1, lz2, light)
    dev = origins.device
    if not 0 <= top <= rows.shape[0]:
        raise ValueError(f"{top} top rows of a {rows.shape[0]}-row table")
    n_boxes, cluster = clustered._check_tables(rows[top:], boxes, dev)
    clustered._check_nodes(nodes, n_boxes, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _kernels.launch("tpt_closest_nee_full", origins.data_ptr(),
                        dirs.data_ptr(), lz1.data_ptr(), lz2.data_ptr(),
                        rows.data_ptr(), int(top), boxes.data_ptr(),
                        nodes.data_ptr(), n_boxes, cluster, float(scale),
                        clustered.BOX_MARGIN, light.data_ptr(), n,
                        float(tmin), float(tmax),
                        t.data_ptr(), row.data_ptr(), normal.data_ptr(),
                        mat.data_ptr(), occ.data_ptr(),
                        NEE_WALK_GROUP if group is None else int(group),
                        _stream(dev))
        LAUNCHES["closest_nee_full"] += 1
    return t, row, normal, mat, occ


def closest_nee_full_dense(origins: torch.Tensor, dirs: torch.Tensor,
                           lz1: torch.Tensor, lz2: torch.Tensor,
                           tris: torch.Tensor, light: torch.Tensor,
                           tmin: float, tmax: float):
    """K5's function through its dense body (both sweeps over every row of
    the dense table ``tris``): on no path, the yardstick of the walk."""
    if _on_cpu(origins):
        return _closest_nee_plain(origins, dirs, lz1, lz2, tris, tris, light,
                                  tmin, tmax, full=True)
    from .. import _kernels
    n, rows = _check_inputs(origins, dirs, tris)
    _check_nee(origins, lz1, lz2, light)
    dev = origins.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _kernels.launch("tpt_closest_nee_full_dense", origins.data_ptr(),
                        dirs.data_ptr(), lz1.data_ptr(), lz2.data_ptr(),
                        tris.data_ptr(), rows, light.data_ptr(), n,
                        float(tmin), float(tmax), t.data_ptr(),
                        row.data_ptr(), normal.data_ptr(), mat.data_ptr(),
                        occ.data_ptr(), _stream(dev))
        LAUNCHES["closest_nee_full_dense"] += 1
    return t, row, normal, mat, occ


# --------------------------------------------------------------------------
# Intersector entry points
# --------------------------------------------------------------------------

@dataclasses.dataclass
class KdTables:
    """K5's kd copy of a dense table (``kd_tables``): the packed rows of
    the scene's real triangles, bit for bit the dense table's (column 15
    is the dense row), the ``top`` rows of the triangles that span the
    scene first, then the rest in balanced-kd order cut into clusters of
    ``clustered.CLUSTER`` rows (zero rows pad the last); the clusters'
    boxes, their ``cluster_tree`` and ``box_scale``."""
    rows: torch.Tensor        # [top + C * CLUSTER, 16]
    top: int
    boxes: torch.Tensor       # [C, 8]
    nodes: torch.Tensor       # [C - 1, 8]
    scale: float


@dataclasses.dataclass
class DenseTables:
    """A scene's packed rows, trimmed once per render."""
    rows: torch.Tensor        # K1 / K3 table
    occ_rows: torch.Tensor    # K2 table: the NEE occluder subset, or all rows
    mat_bsdf: torch.Tensor    # [M] i32, for the first-hit occlusion quirk
    kd: KdTables | None = None  # K5's walk, above LEAN_MAX_TRIS rows


def kd_tables(scene: SceneArrays) -> KdTables:
    """The kd copy of ``scene``'s packed rows that K5 walks. A triangle
    whose box spans more than 1 / TOP_SPAN of the scene's largest extent
    (a Cornell box's walls, floor, ceiling and blocks) would stretch any
    cluster box over the room, so such triangles, at most CLUSTER of them
    (the widest), lead the copy as rows every ray sweeps; the others are
    ordered by ``median_split_order`` and cut into clusters whose boxes
    span their rows' vertices. Host numpy, once per ``prepare``."""
    from . import clustered
    cluster = clustered.CLUSTER
    packed = pack_tris(scene)
    host = [np.asarray(x.cpu()) for x in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2, scene.tri_valid)]
    v0, e1, e2, valid = host
    corners = np.stack([v0, v0 + e1, v0 + e2])          # f32, as the rows
    lo, hi = corners.min(0), corners.max(0)
    real = np.nonzero(valid)[0]
    ext = (hi - lo).max(1)
    span = float((hi[real].max(0) - lo[real].min(0)).max()) if real.size \
        else 0.0
    wide = real[ext[real] > span / TOP_SPAN]
    wide = wide[np.argsort(-ext[wide], kind="stable")[:cluster]]
    rest = np.setdiff1d(real, wide)
    rest = rest[median_split_order(v0[rest], e1[rest], e2[rest],
                                   np.ones(rest.size, bool), leaf=cluster)]
    n_c = max(1, -(-rest.size // cluster))
    order = np.full(wide.size + n_c * cluster, -1, np.int64)
    order[:wide.size] = wide
    order[wide.size:wide.size + rest.size] = rest
    idx = torch.as_tensor(order, device=packed.device)
    rows = torch.where((idx >= 0)[:, None], packed[idx.clamp_min(0)], 0.0)
    boxes = np.full((n_c, 8), clustered.EMPTY_BOX, np.float32)
    boxes[:, 6:8] = 0.0
    for c in range(n_c):
        members = rest[c * cluster:(c + 1) * cluster]
        if members.size:
            boxes[c, 0:3] = lo[members].min(0)
            boxes[c, 3:6] = hi[members].max(0)
    boxes = torch.as_tensor(boxes, device=packed.device)
    return KdTables(rows=rows.contiguous(), top=int(wide.size), boxes=boxes,
                    nodes=clustered.cluster_tree(boxes),
                    scale=clustered.box_scale(boxes))


def prepare(scene: SceneArrays) -> DenseTables:
    """The scene's single-slab kernel tables (one table of every row), and
    for a table above LEAN_MAX_TRIS rows (the K3 / K5 side) K5's kd copy."""
    rows = _trim_rows(scene.num_tris, pack_tris(scene))
    sub = _occ_subset(scene)
    occ_rows = rows if sub is None else _trim_rows(sub[1], sub[0])
    kd = kd_tables(scene) if rows.shape[0] > LEAN_MAX_TRIS else None
    return DenseTables(rows=rows.contiguous(), occ_rows=occ_rows.contiguous(),
                       mat_bsdf=scene.mat_bsdf, kd=kd)


def _lean_resolve(tris: torch.Tensor, origins, dirs, t, row,
                  want_uv: bool) -> Hit:
    """Hit from K1's (t, row): the winner's normal and material by a plain
    gather of its packed row, u/v from its edge functions at the hit point."""
    hit = t < T_FAR
    rows = tris[row.long()]
    normal = torch.where(hit[:, None], rows[:, 0:3], 0.0)
    mat = torch.where(hit, torch.round(rows[:, 14]), 0.0).to(torch.int32)
    if want_uv:
        p = origins + t[:, None] * dirs
        u = torch.where(hit, v3.dot(rows[:, 4:7], p) + rows[:, 7], 0.0)
        v = torch.where(hit, v3.dot(rows[:, 8:11], p) + rows[:, 11], 0.0)
    else:
        u = v = torch.zeros_like(t)
    return Hit(t=t, tri=row, hit=hit, normal=normal, mat=mat, u=u, v=v)


def closest_hit(tables: DenseTables, origins: torch.Tensor,
                dirs: torch.Tensor, tmin: float = 0.01,
                tmax: float = T_FAR, want_uv: bool = True) -> Hit:
    """Closest hit: K1 + gather for small tables at tmax = T_FAR, else K3
    (``pallas_bf._intersect_closest_tiled``, single-slab branches).
    ``TPT_LEAN_UV=0``, read at every call, sends a call that wants u, v to
    K3 whatever the table's size (``pallas_bf.py:2324-2339``)."""
    lean_ok = not want_uv or os.environ.get("TPT_LEAN_UV", "1") == "1"
    if lean_ok and tmax >= T_FAR and tables.rows.shape[0] <= LEAN_MAX_TRIS:
        t, row = closest_lean(origins, dirs, tables.rows, tmin)
        return _lean_resolve(tables.rows, origins, dirs, t, row, want_uv)
    t, row, normal, mat, u, v = closest_full(origins, dirs, tables.rows,
                                             tmin, tmax, want_uv)
    return Hit(t=t, tri=row, hit=t < T_FAR, normal=normal, mat=mat, u=u, v=v)


def occluded_hit(tables: DenseTables, origins: torch.Tensor,
                 dirs: torch.Tensor, tmax: torch.Tensor, tmin: float = 0.01,
                 quirk_first_hit: bool = False) -> torch.Tensor:
    """Any-hit occlusion with per-ray tmax over the NEE occluder subset
    (``pallas_bf.intersect_occluded``); refractive surfaces pass light."""
    if quirk_first_hit:
        h = closest_hit(tables, origins, dirs, tmin=tmin, want_uv=False)
        in_range = h.hit & (h.t < tmax)
        return in_range & (tables.mat_bsdf[h.mat.long()] != BSDF_REFRACTION)
    return occluded(origins, dirs, tmax, tables.occ_rows, tmin)


def light_vector(scene: SceneArrays) -> torch.Tensor:
    """The area light as the fused kernels take it: [9] f32 (corner, v1,
    v2) on the scene's device."""
    light = scene.light
    return torch.cat([light.corner, light.v1, light.v2]).to(
        torch.float32).contiguous()


def closest_nee_hit(tables: DenseTables, light: torch.Tensor,
                    origins: torch.Tensor, dirs: torch.Tensor,
                    lz1: torch.Tensor, lz2: torch.Tensor, tmin: float = 0.01,
                    tmax: float = T_FAR) -> tuple[Hit, torch.Tensor]:
    """Closest hit plus the NEE shadow ray's occlusion in one kernel
    (``pallas_bf.intersect_closest_nee``): K4 when the table has at most
    LEAN_MAX_TRIS rows, whatever tmax is (its shadow sweep takes the
    occluder subset), else K5 on the kd copy. Returns (Hit without u/v,
    occluded [N] bool); the flag is meaningful only on hit lanes."""
    if tables.rows.shape[0] <= LEAN_MAX_TRIS:
        t, row, occ = closest_nee_lean(origins, dirs, lz1, lz2, tables.rows,
                                       tables.occ_rows, light, tmin)
        return _lean_resolve(tables.rows, origins, dirs, t, row, False), occ
    kd = tables.kd
    t, row, normal, mat, occ = closest_nee_full(
        origins, dirs, lz1, lz2, kd.rows, kd.top, kd.boxes, kd.nodes,
        kd.scale, light, tmin, tmax)
    zero = torch.zeros_like(t)
    return Hit(t=t, tri=row, hit=t < T_FAR, normal=normal, mat=mat, u=zero,
               v=zero), occ


def intersect_closest_nee(scene: SceneArrays, origins: torch.Tensor,
                          dirs: torch.Tensor, lz1: torch.Tensor,
                          lz2: torch.Tensor, tmin: float = 0.01,
                          tmax: float = T_FAR) -> tuple[Hit, torch.Tensor]:
    """Closest hit plus NEE shadow-ray occlusion over a flat ray batch
    (``pallas_bf.intersect_closest_nee``)."""
    return closest_nee_hit(prepare(scene), light_vector(scene), origins, dirs,
                           lz1, lz2, tmin, tmax)


def intersect_closest(scene: SceneArrays, origins: torch.Tensor,
                      dirs: torch.Tensor, tmin: float = 0.01,
                      tmax: float = T_FAR, want_uv: bool = True) -> Hit:
    """Closest hit over a flat ray batch [N, 3] (``pallas_bf.intersect_closest``)."""
    return closest_hit(prepare(scene), origins, dirs, tmin, tmax, want_uv)


def intersect_occluded(scene: SceneArrays, origins: torch.Tensor,
                       dirs: torch.Tensor, tmax: torch.Tensor,
                       tmin: float = 0.01,
                       quirk_first_hit: bool = False) -> torch.Tensor:
    """Occlusion with per-ray tmax (``pallas_bf.intersect_occluded``)."""
    return occluded_hit(prepare(scene), origins, dirs, tmax, tmin,
                        quirk_first_hit)
