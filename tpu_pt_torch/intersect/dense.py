"""Dense single-slab ray-triangle intersection: the port of the Pallas
kernels on the path tracer's main path (single-slab part of
``tpu_pt/intersect/pallas_bf.py``).

Three kernels, each with a wrapper, a plain PyTorch version and a launch
counter:

======================  ==========================================  =================
wrapper                 replaces (``tpu_pt/intersect/pallas_bf.py``)  plain version
======================  ==========================================  =================
``closest_lean`` (K1)   ``_closest_kernel_lean`` via ``_closest_call_lean``  ``_closest_plain``
``occluded`` (K2)       ``_occluded_kernel`` via ``_occluded_call``           ``_occluded_plain``
``closest_full`` (K3)   ``_closest_kernel`` via ``_closest_call``             ``_closest_plain(full=True)``
======================  ==========================================  =================

The CUDA kernels are in ``csrc/dense_intersect.cu`` (bound by
``tpu_pt_torch._kernels``). A wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel, and for
anything else it raises. ``LAUNCHES`` counts kernel launches per wrapper.

The winner's normal and material after the lean kernel come from a plain
gather of its packed row; the JAX package used a one-hot bf16 matmul there
(``_lean_resolve``) only because TPU gathers are slow. Scenes above
``TRI_SLAB`` packed rows need the clustered kernels, which are not ported
yet (ROADMAP.md, Queue 2).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import vec3 as v3
from ..scene.arrays import BSDF_REFRACTION, SceneArrays
from .moller import T_FAR, Hit

TRI_BLOCK = 512        # packed tables pad to a multiple of this
TRI_SLAB = 8192        # largest packed table the single-slab kernels take
LEAN_MAX_TRIS = 2048   # above this (or with a finite tmax) K3 runs, not K1
_PLAIN_PAIRS = 1 << 21  # ray x row pairs per chunk of the plain versions

# Kernel launches per wrapper (read by chip_smoke.py). Plain-version calls
# on CPU tensors do not count.
LAUNCHES = {"closest_lean": 0, "occluded": 0, "closest_full": 0}


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


def _ray_chunks(n: int, rows: int):
    step = max(256, _PLAIN_PAIRS // max(rows, 1))
    return ((r, min(r + step, n)) for r in range(0, n, step))


def _closest_plain(origins, dirs, tris, tmin: float, tmax: float = T_FAR,
                   full: bool = False, want_uv: bool = False):
    """Plain version of K1 (``full=False``: returns (t, row)) and K3
    (``full=True``: returns (t, row, normal, mat, u, v), t clipped at
    ``tmax``). Misses give t = T_FAR and zeros; ties go to the lowest row."""
    n, dev = origins.shape[0], origins.device
    t_out = torch.empty(n, dtype=torch.float32, device=dev)
    row_out = torch.empty(n, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    iota = torch.arange(tris.shape[0], dtype=torch.int32, device=dev)
    for a, b in _ray_chunks(n, tris.shape[0]):
        t, u, v = _pe_block(origins[a:b], dirs[a:b], tris, tmin)
        if full and tmax < T_FAR:
            t = torch.where(t < tmax, t, T_FAR)
        best = t.min(dim=1).values
        row = torch.where(t == best[:, None], iota, tris.shape[0])
        row = row.min(dim=1).values
        hit = best < T_FAR
        row = torch.where(hit, row, 0)
        t_out[a:b] = best
        row_out[a:b] = row
        if full and want_uv:
            sel = row.long()[:, None]
            u_out[a:b] = torch.where(hit, u.gather(1, sel)[:, 0], 0.0)
            v_out[a:b] = torch.where(hit, v.gather(1, sel)[:, 0], 0.0)
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
    out = torch.empty(origins.shape[0], dtype=torch.bool,
                      device=origins.device)
    opaque = tris[None, :, 13] < 0.5
    for a, b in _ray_chunks(origins.shape[0], tris.shape[0]):
        t, _, _ = _pe_block(origins[a:b], dirs[a:b], tris, tmin)
        out[a:b] = ((t < tmax[a:b, None]) & opaque).any(dim=1)
    return out


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _on_cpu(origins: torch.Tensor) -> bool:
    """True for CPU tensors (plain version); False for CUDA tensors
    (kernel); raises for any other device."""
    if origins.device.type == "cpu":
        return True
    if origins.device.type != "cuda":
        raise ValueError(f"dense kernels take CPU or CUDA tensors, "
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


# --------------------------------------------------------------------------
# Intersector entry points
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DenseTables:
    """A scene's packed rows, trimmed once per render."""
    rows: torch.Tensor        # K1 / K3 table
    occ_rows: torch.Tensor    # K2 table: the NEE occluder subset, or all rows
    mat_bsdf: torch.Tensor    # [M] i32, for the first-hit occlusion quirk


def prepare(scene: SceneArrays) -> DenseTables:
    packed = pack_tris(scene)
    if packed.shape[0] > TRI_SLAB:
        raise NotImplementedError(
            f"{packed.shape[0]} packed rows exceed TRI_SLAB={TRI_SLAB}: "
            "scenes this large need the clustered kernels, which are not "
            "ported yet (ROADMAP.md, Queue 1 'resolve above TRI_SLAB' and "
            "Queue 2)")
    rows = _trim_rows(scene.num_tris, packed)
    sub = _occ_subset(scene)
    occ_rows = rows if sub is None else _trim_rows(sub[1], sub[0])
    return DenseTables(rows=rows.contiguous(), occ_rows=occ_rows.contiguous(),
                       mat_bsdf=scene.mat_bsdf)


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
    (``pallas_bf._intersect_closest_tiled``, single-slab branches)."""
    if tmax >= T_FAR and tables.rows.shape[0] <= LEAN_MAX_TRIS:
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
