"""Five more schedulers of the clustered closest hit and any-hit: the
port of the kernel families of ``tpu_pt/intersect/pallas_ablations.py``.

Each computes what ``clustered.closest_clustered`` (K6) /
``clustered.occluded_clustered`` (K8) compute, (t, packed row) of the
closest hit or the any-hit flag over the clustered table, on another
schedule. ``clustered.closest_hit`` / ``occluded_hit`` reach them through
the JAX package's variables, read at every call:

- ``TPT_SEED=1``: the ROTATED chain, ``closest_rotated`` (K11). The table
  is cut into S slabs (``clustered._clustered_slab_rows``); a ray visits
  its predicted landing slab first and the rest in ascending order
  (``rotated_slab_order``), each slab culled against its best hit so far.
  Any prediction gives the same hits.
- ``TPT_STREAM=1``: the STREAMED path, ``closest_streamed`` /
  ``occluded_streamed`` (K12). A tile of ``RAY_TILE_C`` consecutive lanes
  shares one list of the boxes any of its rays pierces, sorted by the
  tile's least entry distance (``stream_candidates``, plain PyTorch); the
  kernel sweeps the list through a ``STREAM_BUF``-slot ring of row
  buffers, stops at the first key no lane can still use, and with the
  guard on (``TPT_STREAM_GUARD``, default 1) skips a candidate no lane
  can improve on.
- ``TPT_CBIN=1``: the CLUSTER-BINNED path, ``closest_cbin`` /
  ``occluded_cbin`` (K13). Per-group lists of pierced clusters are
  regrouped by cluster into jobs of ``RAY_TILE_C`` (ray, cluster) pair
  lanes (``cbin_pairs``, plain PyTorch); the kernel sweeps each job
  against its one cluster and writes per-pair results, which
  ``_cbin_reduce`` / ``_cbin_reduce_occ`` fold per ray (the per-pair
  layout and the plain reduce are kept as they are; a fused atomic reduce
  is left to later work). Lanes whose group overflowed a static cap are
  ``incomplete`` and finished by the streamed pass with every other lane
  parked.
- ``TPT_BINNED`` (``1``, or ``closest`` / ``occ`` for one side): the
  PAIR-BINNED path, ``closest_binned`` / ``occluded_binned`` (K14), taken
  before every other scheduler. Each ray's ``PAIR_K`` nearest pierced
  clusters become (ray, cluster) pairs, laid out cluster-major in tiles of
  ``PAIR_TILE`` pairs against one cluster (``_pair_schedule``, plain
  PyTorch); the kernel folds each pair's hit into its ray with one 64-bit
  ``atomicMin`` (``_reduce_pairs`` is the plain fold). Rays that pierce
  more clusters, and whose hit lies beyond the next entry distance (or,
  any-hit, that are not blocked yet), are finished by the ordinary path
  with every other lane parked.
- ``TPT_GRP=1`` / ``2``: the 8-LANE GROUPS, ``closest_grp`` /
  ``occluded_grp`` (K15), serial or bundled. Eight consecutive lanes share
  ``stream_candidates``' near-first list at a tile of ``GRP_LANES``; each
  lane culls the listed clusters by its own grown-box test, and the group
  stops at the first key no lane can still use.

Every wrapper launches its kernel (``csrc/ablations_intersect.cu`` for
K11-K13, ``csrc/ablations_binned.cu`` for K14 / K15) for CUDA tensors, runs
its plain version for CPU tensors and raises otherwise.
The plain versions follow the schedules step by step over the same lists,
so the CPU tests hold the schedules, not only the answers, against the
dense sweep. Results are bitwise those of ``dense._closest_plain`` /
``dense._occluded_plain``: the closest kernels compare (t, row)
lexicographically, and every cull uses the boxes grown by the per-ray
margin ``clustered.BOX_MARGIN * (scale + max|o|)``.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from . import clustered, dense
from .moller import T_FAR, Hit

RAY_TILE_C = int(os.environ.get("TPT_RT_C", 256))   # lanes per tile / job
STREAM_BUF = 4                                       # ring slots
CBIN_PAIR_MULT = int(os.environ.get("TPT_CBIN_PAIRS", 12))   # P_cap = mult*N
CBIN_K_OUT = int(os.environ.get("TPT_CBIN_K", 32))           # per-group cap
CBIN_GROUP = int(os.environ.get("TPT_CBIN_GROUP", 1))        # lanes/work list
CBIN_FAN = int(os.environ.get("TPT_CBIN_FAN", 8))            # parents: children
CBIN_K1 = int(os.environ.get("TPT_CBIN_K1", 16))             # parent-list cap
CBIN_LVL = int(os.environ.get("TPT_CBIN_LVL", 0))            # 0 auto, 1, 2
CBIN_LVL2_MIN = int(os.environ.get("TPT_CBIN_LVL2_MIN", 192))

PARK_COORD = 3.0e7       # render.PARK_COORD / PARK_DIR: a parked lane
PARK_DIR = 0.5773503
_BIG = 3e38
_BIG_IDX = 2 ** 30

# Kernel launches per wrapper (read by chip_smoke.py). Plain-version calls
# on CPU tensors do not count.
LAUNCHES = {"closest_rotated": 0, "closest_streamed": 0,
            "occluded_streamed": 0, "closest_cbin": 0, "occluded_cbin": 0,
            "closest_binned": 0, "occluded_binned": 0, "closest_grp": 0,
            "occluded_grp": 0}


def _stream_guard() -> bool:
    """The per-candidate re-test against the running best
    (``TPT_STREAM_GUARD=0`` turns it off), read at every call."""
    return os.environ.get("TPT_STREAM_GUARD", "1") == "1"


# --------------------------------------------------------------------------
# Rays and slab tests
# --------------------------------------------------------------------------

def pack_rays(origins: torch.Tensor, dirs: torch.Tensor, tmax,
              n_pad: int) -> torch.Tensor:
    """Rays as [n_pad, 8] rows (o xyz, d xyz, tmax, 0), padded with parked
    rays (``pallas_bf.pack_rays``, one ray per row). ``tmax`` is a float
    or [N]."""
    n = origins.shape[0]
    tm = torch.as_tensor(tmax, dtype=torch.float32,
                         device=origins.device).expand(n)
    rays = torch.cat([origins, dirs, tm[:, None], torch.zeros_like(tm)[:, None]],
                     dim=1)
    if n_pad > n:
        fill = rays.new_tensor([PARK_COORD] * 3 + [PARK_DIR] * 3 + [0.0, 0.0])
        rays = torch.cat([rays, fill.expand(n_pad - n, 8)])
    return rays.contiguous()


def _park_rays(rays: torch.Tensor, park: torch.Tensor) -> torch.Tensor:
    """``rays`` [N, 8] with the lanes of ``park`` [N] replaced by parked
    rays: every box and triangle test fails, so they add nothing to any
    list."""
    fill = rays.new_tensor([PARK_COORD] * 3 + [PARK_DIR] * 3 + [0.0, 0.0])
    return torch.where(park[:, None], fill, rays)


def _ray_inv(d: torch.Tensor) -> torch.Tensor:
    """The guarded reciprocal direction of the slab tests
    (``pallas_bf._ray_inv``)."""
    eps = 1e-12
    return 1.0 / torch.where(d.abs() > eps, d,
                             torch.where(d >= 0, eps, -eps).to(d.dtype))


def _margin(rays: torch.Tensor, scale: float) -> torch.Tensor:
    """Per-ray culling margin [N] (``clustered.BOX_MARGIN``)."""
    return clustered.BOX_MARGIN * (scale + rays[:, 0:3].abs().amax(1))


def _near_far(rays: torch.Tensor, inv: torch.Tensor, m: torch.Tensor,
              boxes: torch.Tensor):
    """Entry and exit distances [R, B] of rays [R, 8] through boxes
    [B, >= 6] grown by m [R], in the kernels' operation order
    (``slab_passes`` of ``csrc/pe_block.cuh``)."""
    tn = tf = None
    mm = m[:, None]
    for a in range(3):
        o = rays[:, a:a + 1]
        t0 = (boxes[None, :, a] - mm - o) * inv[:, a:a + 1]
        t1 = (boxes[None, :, a + 3] + mm - o) * inv[:, a:a + 1]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return tn, tf


def _ray_box_test(rays, boxes, scale, tmin: float, tmax, col_chunk: int):
    """Yield (column start, ok [N, nc], tn [N, nc]) of the exact per-ray
    test of every box grown by the ray's margin, in column chunks:
    ok = the ray's interval through the box meets (tmin, tmax[r]]."""
    inv = _ray_inv(rays[:, 3:6])
    m = _margin(rays, scale)
    tmax_r = torch.as_tensor(tmax, dtype=torch.float32,
                             device=rays.device).expand(rays.shape[0])[:, None]
    for c0 in range(0, boxes.shape[0], col_chunk):
        tn, tf = _near_far(rays, inv, m, boxes[c0:c0 + col_chunk])
        yield c0, (tn <= tf) & (tf > tmin) & (tn <= tmax_r), tn


# --------------------------------------------------------------------------
# K11: the rotated chain
# --------------------------------------------------------------------------

ROT_TILE = 32     # lanes that agree on a first slab (a warp on the card)


def _tile_pred(pred: torch.Tensor, s_count: int, rt: int) -> torch.Tensor:
    """The first slab of each tile of ``rt`` lanes: the most frequent
    prediction of its lanes, ties to the lowest slab; unknown and
    out-of-range predictions, and the lanes that pad the last tile, count
    as slab 0 (the fixed order). Returns [tiles] i64."""
    n = pred.shape[0]
    p = pred.long()
    p = torch.where((p < 0) | (p >= s_count), 0, p)
    p = torch.nn.functional.pad(p, (0, -n % rt)).view(-1, rt)
    votes = (p[:, :, None] == p[:, None, :]).sum(2)
    best = (votes * (1 << 24) + ((1 << 24) - 1 - p)).amax(1)
    return (1 << 24) - 1 - best % (1 << 24)


def rotated_slab_order(tile_pred: torch.Tensor, s_count: int) -> torch.Tensor:
    """Per-tile slab visit order [S, tiles]: the predicted slab first, then
    visit j >= 1 takes slab j - 1 where that precedes the prediction, else
    j (``pallas_bf.py:2427-2434``). Predictions >= s_count fall back to
    slab 0 first, the fixed order."""
    pred_eff = torch.where(tile_pred >= s_count, 0, tile_pred)
    j = torch.arange(s_count, device=tile_pred.device)[:, None]
    rest = torch.where(j - 1 < pred_eff[None], j - 1, j)
    return torch.where(j == 0, pred_eff[None], rest)


def _lex_merge(best_t, best_row, t, row):
    """The (t, row)-lexicographic minimum of two candidates per lane."""
    better = (t < best_t) | ((t == best_t) & (row < best_row))
    return torch.where(better, t, best_t), torch.where(better, row, best_row)


def _closest_rotated_plain(origins, dirs, tris, pred, slab_rows: int,
                           tmin: float, tmax: float = T_FAR):
    """Plain version of K11: the slab visits of ``rotated_slab_order`` in
    turn, each a dense sweep of the slab's rows merged into the running
    best in (t, row) order."""
    n, dev = origins.shape[0], origins.device
    s_count = -(-tris.shape[0] // slab_rows)
    order = rotated_slab_order(_tile_pred(pred, s_count, ROT_TILE), s_count)
    lane_order = order.repeat_interleave(ROT_TILE, dim=1)[:, :n]
    best_t = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    best_row = torch.full((n,), _BIG_IDX, dtype=torch.int32, device=dev)
    for j in range(s_count):
        for sid in lane_order[j].unique().tolist():
            lanes = (lane_order[j] == sid).nonzero()[:, 0]
            t, row = dense._closest_plain(
                origins[lanes], dirs[lanes],
                tris[sid * slab_rows:(sid + 1) * slab_rows], tmin, tmax)
            row = torch.where(t < T_FAR, row + sid * slab_rows, _BIG_IDX)
            bt, br = _lex_merge(best_t[lanes], best_row[lanes], t,
                                row.to(torch.int32))
            best_t[lanes], best_row[lanes] = bt, br
    return best_t, torch.where(best_t < T_FAR, best_row, 0).to(torch.int32)


def closest_rotated(origins: torch.Tensor, dirs: torch.Tensor,
                    tris: torch.Tensor, boxes: torch.Tensor, scale: float,
                    pred: torch.Tensor, slab_rows: int, tmin: float,
                    tmax: float = T_FAR):
    """K11: K6's (t, packed row) with the table's slabs of ``slab_rows``
    rows visited per ray in the order of ``pred`` [N] i32, the predicted
    landing slab (``SLAB_UNKNOWN`` or anything out of range: slab 0)
    first. The result does not depend on ``pred``."""
    if dense._on_cpu(origins):
        return _closest_rotated_plain(origins, dirs, tris, pred, slab_rows,
                                      tmin, tmax)
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    n_boxes, cluster = clustered._check_tables(tris, boxes, dev)
    dense._check("pred", pred, torch.int32, (n,), dev)
    if slab_rows < cluster or slab_rows % cluster:
        raise ValueError(f"slab_rows {slab_rows} is not a multiple of the "
                         f"cluster size {cluster}")
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _kernels.launch("tpt_closest_rotated", origins.data_ptr(),
                        dirs.data_ptr(), tris.data_ptr(), boxes.data_ptr(),
                        pred.data_ptr(), n, n_boxes, cluster,
                        slab_rows // cluster, float(scale),
                        clustered.BOX_MARGIN, float(tmin), float(tmax),
                        t.data_ptr(), row.data_ptr(), dense._stream(dev))
        LAUNCHES["closest_rotated"] += 1
    return t, row


# --------------------------------------------------------------------------
# K12: the streamed path
# --------------------------------------------------------------------------

def stream_candidates(rays: torch.Tensor, boxes: torch.Tensor, scale: float,
                      rt: int, tmin: float, tmax):
    """Whole-table per-tile work lists for the streamed kernels
    (``pallas_ablations.stream_candidates``).

    ``rays`` [n_pad, 8] with n_pad a multiple of ``rt``; ``tmax`` a float
    or [n_pad]. Returns (cand [tiles, C] i32, keys [tiles, C] f32, cnt
    [tiles] i32, far [n_pad] f32): the tile's boxes in ascending key order
    (stable, so equal keys keep ascending box order), a box's key being
    the least entry distance over the tile's rays that pierce it within
    their tmax and T_FAR when none does; the first ``cnt`` are the listed
    ones; ``far`` is each ray's largest entry distance over the boxes it
    pierces (-3e38: none), beyond which the ray takes part in no
    candidate. The dense test runs in chunks of 1,024 columns and 32,768
    rays, so temporaries stay bounded."""
    n_pad, ns = rays.shape[0], boxes.shape[0]
    if n_pad % rt:
        raise ValueError(f"{n_pad} rays do not split into tiles of {rt}")
    tm = torch.as_tensor(tmax, dtype=torch.float32,
                         device=rays.device).expand(n_pad)
    step = max(rt, 32768 // rt * rt)
    any_parts, key_parts, far_parts = [], [], []
    for r0 in range(0, n_pad, step):
        part = rays[r0:r0 + step]
        tiles = part.shape[0] // rt
        far = part.new_full((part.shape[0],), -_BIG)
        any_cols, key_cols = [], []
        for _, ok, tn in _ray_box_test(part, boxes, scale, tmin,
                                       tm[r0:r0 + step], 1024):
            okt = ok.view(tiles, rt, -1)
            any_cols.append(okt.any(1))
            key_cols.append(torch.where(okt, tn.view(tiles, rt, -1),
                                        T_FAR).amin(1))
            far = torch.maximum(far, torch.where(ok, tn, -_BIG).amax(1))
        any_parts.append(torch.cat(any_cols, 1))
        key_parts.append(torch.cat(key_cols, 1))
        far_parts.append(far)
    any_ = torch.cat(any_parts)
    key = torch.where(any_, torch.cat(key_parts), T_FAR)
    keys, order = torch.sort(key, dim=1, stable=True)
    return (order.to(torch.int32).contiguous(), keys.contiguous(),
            any_.sum(1).to(torch.int32), torch.cat(far_parts))


def _pe_rows(o, d, rows, tmin: float):
    """``dense._pe_block`` batched: rays o, d [A, R, 3] against their own
    rows [A, T, 16]; returns t [A, R, T] (T_FAR on a miss), the same
    operations in the same order."""
    ox, oy, oz = o[..., 0:1], o[..., 1:2], o[..., 2:3]
    dx, dy, dz = d[..., 0:1], d[..., 1:2], d[..., 2:3]
    c = [rows[:, None, :, k] for k in range(12)]
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
    return torch.where(hit, t, T_FAR)


def _tile_pass(rays_t, inv_t, m_t, boxes, c, tmin, bound):
    """Per lane of tiles [A, rt]: does the grown box c[a] pass the slab
    test within ``bound`` [A, rt]? (the kernels' guard)."""
    a, rt = bound.shape
    b = boxes[c.long()]                                       # [A, 8]
    tn = tf = None
    for ax in range(3):
        o = rays_t[:, :, ax]
        t0 = (b[:, None, ax] - m_t - o) * inv_t[:, :, ax]
        t1 = (b[:, None, ax + 3] + m_t - o) * inv_t[:, :, ax]
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = lo if tn is None else torch.maximum(tn, lo)
        tf = hi if tf is None else torch.minimum(tf, hi)
    return (tn <= tf) & (tf > tmin) & (tn <= bound)


def _streamed_plain(rays, tris, boxes, scale, lists, rt, tmin, tmax, guard,
                    occluded: bool):
    """The streamed schedule in plain PyTorch, all tiles in step: walk
    each tile's list in key order; stop a tile at the first key beyond
    every lane's bound (its best t or tmax, and its last entry); with the
    guard skip a candidate no lane's grown-box test passes; else sweep the
    candidate's rows for every lane. Returns (t, row) or the flags."""
    cand, keys, cnt, far = lists
    n_pad, dev = rays.shape[0], rays.device
    tiles, cluster = n_pad // rt, tris.shape[0] // boxes.shape[0]
    rays_t = rays.view(tiles, rt, 8)
    inv_t = _ray_inv(rays[:, 3:6]).view(tiles, rt, 3)
    m_t = _margin(rays, scale).view(tiles, rt)
    far_t = far.view(tiles, rt)
    table = tris.view(boxes.shape[0], cluster, 16)
    best = torch.full((tiles, rt), T_FAR, dtype=torch.float32, device=dev)
    best_row = torch.zeros((tiles, rt), dtype=torch.int64, device=dev)
    tm = rays_t[:, :, 6] if occluded else None
    open_ = (tm > tmin) if occluded else None
    running = torch.ones(tiles, dtype=torch.bool, device=dev)
    sub = torch.arange(cluster, device=dev)
    for k in range(int(cnt.max()) if tiles else 0):
        key = keys[:, k:k + 1]
        if occluded:
            goes = (open_ & (key <= torch.minimum(far_t, tm))).any(1)
        else:
            goes = (key <= torch.minimum(best, far_t)).any(1)
        running = running & (k < cnt) & goes
        if not bool(running.any()):
            break
        sel = running.nonzero()[:, 0]
        c = cand[sel, k]
        if occluded:
            bound = tm[sel]
            useful = open_[sel]
        else:
            bound = torch.clamp_max(best[sel], tmax)
            useful = torch.ones_like(bound, dtype=torch.bool)
        if guard:
            lane_ok = useful & _tile_pass(rays_t[sel], inv_t[sel], m_t[sel],
                                          boxes, c, tmin, bound)
            keep = lane_ok.any(1)
            sel, c = sel[keep], c[keep]
            if not sel.numel():
                continue
        rows = table[c.long()]                                # [A, cluster, 16]
        t = _pe_rows(rays_t[sel, :, 0:3], rays_t[sel, :, 3:6], rows, tmin)
        if occluded:
            blocking = (t < tm[sel][:, :, None]) & (rows[:, None, :, 13] < 0.5)
            open_[sel] = open_[sel] & ~blocking.any(2)
            continue
        if tmax < T_FAR:
            t = torch.where(t < tmax, t, T_FAR)
        blk_t = t.amin(2)
        blk_sub = torch.where(t == blk_t[:, :, None], sub, cluster).amin(2)
        blk_row = torch.where(blk_t < T_FAR,
                              blk_sub + c.long()[:, None] * cluster, _BIG_IDX)
        cur_row = torch.where(best[sel] < T_FAR, best_row[sel], _BIG_IDX)
        bt, br = _lex_merge(best[sel], cur_row, blk_t, blk_row)
        best[sel], best_row[sel] = bt, br
    if occluded:
        return ((tm > tmin) & ~open_).view(n_pad)
    best, best_row = best.view(n_pad), best_row.view(n_pad)
    return best, torch.where(best < T_FAR, best_row, 0).to(torch.int32)


def _check_lists(lists, n_pad: int, rt: int, n_boxes: int, dev) -> None:
    cand, keys, cnt, far = lists
    tiles = n_pad // rt
    dense._check("cand", cand, torch.int32, (tiles, n_boxes), dev)
    dense._check("keys", keys, torch.float32, (tiles, n_boxes), dev)
    dense._check("cnt", cnt, torch.int32, (tiles,), dev)
    dense._check("far", far, torch.float32, (n_pad,), dev)


def closest_streamed(rays: torch.Tensor, tris: torch.Tensor,
                     boxes: torch.Tensor, scale: float, lists, rt: int,
                     tmin: float, tmax: float = T_FAR, guard: bool = True):
    """K12 closest: K6's (t, packed row) for ``rays`` [n_pad, 8]
    (``pack_rays``; n_pad a multiple of ``rt``) over the tile lists of
    ``stream_candidates(rays, boxes, scale, rt, tmin, tmax)``."""
    if dense._on_cpu(rays):
        return _streamed_plain(rays, tris, boxes, scale, lists, rt, tmin,
                               tmax, guard, occluded=False)
    from .. import _kernels
    dev, n_pad = rays.device, rays.shape[0]
    dense._check("rays", rays, torch.float32, (n_pad, 8), dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    dense._check_inputs(o, d, tris)
    n_boxes, cluster = clustered._check_tables(tris, boxes, dev)
    _check_lists(lists, n_pad, rt, n_boxes, dev)
    t = torch.empty(n_pad, dtype=torch.float32, device=dev)
    row = torch.empty(n_pad, dtype=torch.int32, device=dev)
    if n_pad:
        cand, keys, cnt, far = lists
        _kernels.launch("tpt_closest_streamed", o.data_ptr(), d.data_ptr(),
                        tris.data_ptr(), boxes.data_ptr(), cand.data_ptr(),
                        keys.data_ptr(), cnt.data_ptr(), far.data_ptr(),
                        n_pad, n_boxes, cluster, rt, float(scale),
                        clustered.BOX_MARGIN, float(tmin), float(tmax),
                        int(bool(guard)), t.data_ptr(), row.data_ptr(),
                        dense._stream(dev))
        LAUNCHES["closest_streamed"] += 1
    return t, row


def occluded_streamed(rays: torch.Tensor, tris: torch.Tensor,
                      boxes: torch.Tensor, scale: float, lists, rt: int,
                      tmin: float, guard: bool = True) -> torch.Tensor:
    """K12 any-hit: K8's flag for ``rays`` [n_pad, 8] (column 6: the
    ray's tmax) over the tile lists of ``stream_candidates(rays, boxes,
    scale, rt, tmin, rays[:, 6])``. Returns bool [n_pad]."""
    if dense._on_cpu(rays):
        return _streamed_plain(rays, tris, boxes, scale, lists, rt, tmin,
                               T_FAR, guard, occluded=True)
    from .. import _kernels
    dev, n_pad = rays.device, rays.shape[0]
    dense._check("rays", rays, torch.float32, (n_pad, 8), dev)
    o, d = rays[:, 0:3].contiguous(), rays[:, 3:6].contiguous()
    tmax = rays[:, 6].contiguous()
    dense._check_inputs(o, d, tris)
    n_boxes, cluster = clustered._check_tables(tris, boxes, dev)
    _check_lists(lists, n_pad, rt, n_boxes, dev)
    out = torch.empty(n_pad, dtype=torch.bool, device=dev)
    if n_pad:
        cand, keys, cnt, far = lists
        _kernels.launch("tpt_occluded_streamed", o.data_ptr(), d.data_ptr(),
                        tmax.data_ptr(), tris.data_ptr(), boxes.data_ptr(),
                        cand.data_ptr(), keys.data_ptr(), cnt.data_ptr(),
                        far.data_ptr(), n_pad, n_boxes, cluster, rt,
                        float(scale), clustered.BOX_MARGIN, float(tmin),
                        int(bool(guard)), out.data_ptr(), dense._stream(dev))
        LAUNCHES["occluded_streamed"] += 1
    return out


# --------------------------------------------------------------------------
# K13: the cluster-binned path
# --------------------------------------------------------------------------

def _cbin_exact() -> bool:
    return os.environ.get("TPT_CBIN_EXACT", "1") == "1"


def _cbin_ray_bounds(rays: torch.Tensor, scale: float, g: int):
    """Per-group interval bounds for the conservative slab tests
    (``pallas_ablations._cbin_ray_bounds``): (o_lo, o_hi, i_lo, i_hi
    [ng, 3], any_live [ng], tmax_g [ng, 1], m_g [ng, 1]). Parked lanes
    (origin x >= 1e7) are masked out, so a retired lane cannot blow up its
    group's bounds; a group of parked lanes reports any_live False. The
    group's margin is its live members' largest."""
    ng = rays.shape[0] // g
    o = rays[:, 0:3].view(ng, g, 3)
    inv = _ray_inv(rays[:, 3:6]).view(ng, g, 3)
    parked = o[:, :, 0] >= 1.0e7                              # [ng, g]
    any_live = ~parked.all(1)
    p3 = parked[:, :, None]

    def lo(x):
        return torch.where(p3, _BIG, x).amin(1)

    def hi(x):
        return torch.where(p3, -_BIG, x).amax(1)

    tmax_g = torch.where(parked, -_BIG, rays[:, 6].view(ng, g)).amax(
        1, keepdim=True)
    m_g = torch.where(parked, 0.0, _margin(rays, scale).view(ng, g)).amax(
        1, keepdim=True)
    return lo(o), hi(o), lo(inv), hi(inv), any_live, tmax_g, m_g


def _interval_slab(bounds, box_lo, box_hi, tmin: float) -> torch.Tensor:
    """Conservative slab test of group intervals against boxes
    (``pallas_ablations._interval_slab``). ``box_lo`` / ``box_hi`` are
    [ng, m, 3] or broadcastable; they are grown by the group's margin
    here. Per axis the eight endpoint products of (face - o) x inv bound
    every member's entry from below and exit from above, so the test is a
    superset of each member's exact test. Returns [ng, m] bool."""
    o_lo, o_hi, i_lo, i_hi, any_live, tmax_g, m_g = bounds
    tn = tf = None
    for a in range(3):
        lo_a = box_lo[..., a] - m_g
        hi_a = box_hi[..., a] + m_g
        f_lo0 = lo_a - o_hi[:, a:a + 1]
        f_hi0 = lo_a - o_lo[:, a:a + 1]
        f_lo1 = hi_a - o_hi[:, a:a + 1]
        f_hi1 = hi_a - o_lo[:, a:a + 1]
        il, ih = i_lo[:, a:a + 1], i_hi[:, a:a + 1]
        pmin = pmax = None
        for f in (f_lo0, f_hi0, f_lo1, f_hi1):
            for i in (il, ih):
                p = f * i
                pmin = p if pmin is None else torch.minimum(pmin, p)
                pmax = p if pmax is None else torch.maximum(pmax, p)
        tn = pmin if tn is None else torch.maximum(tn, pmin)
        tf = pmax if tf is None else torch.minimum(tf, pmax)
    return (tn <= tf) & (tf > tmin) & (tn <= tmax_g) & any_live[:, None]


def _cbin_group_test(rays: torch.Tensor, boxes: torch.Tensor, scale: float,
                     tmin: float, g: int) -> torch.Tensor:
    """Slab test of every group against every cluster box, [N // g, C]
    bool (``pallas_ablations._cbin_group_test``). For g > 1 the exact
    union of the members' own tests by default; ``TPT_CBIN_EXACT=0``, and
    g = 1, take the interval test (at g = 1 the intervals are points)."""
    n_pad = rays.shape[0]
    ng = n_pad // g
    if g > 1 and _cbin_exact():
        parts = []
        step = max(g, 32768 // g * g)
        for r0 in range(0, n_pad, step):
            part = rays[r0:r0 + step]
            parts.append(torch.cat(
                [ok.view(part.shape[0] // g, g, -1).any(1)
                 for _, ok, _ in _ray_box_test(part, boxes, scale, tmin,
                                               part[:, 6], 512)], 1))
        return torch.cat(parts)
    parts = []
    step = max(1, 32768 // g) * g
    for r0 in range(0, n_pad, step):
        bounds = _cbin_ray_bounds(rays[r0:r0 + step], scale, g)
        parts.append(torch.cat(
            [_interval_slab(bounds, boxes[None, c0:c0 + 1024, 0:3],
                            boxes[None, c0:c0 + 1024, 3:6], tmin)
             for c0 in range(0, boxes.shape[0], 1024)], 1))
    return torch.cat(parts).view(ng, -1)


def _extract_lists(okt: torch.Tensor, ids: torch.Tensor, k: int):
    """Compact per-group id lists from a pierce mask
    (``pallas_ablations._extract_lists``). ``okt`` [ng, m] bool; ``ids``
    [m] or [ng, m] i32, ascending along the last axis. Returns (c_list
    [ng, k] i32 with -1 padding, valid [ng, k], cnt [ng]): entry (group,
    rank) is the rank-th passing id. The reference compares over
    [ng, m, k]; here each passing id is scattered to its rank, which
    builds the same lists without that tensor."""
    ng, m = okt.shape
    mi = okt.to(torch.int64)
    rank = torch.cumsum(mi, 1) - mi
    cnt = mi.sum(1)
    keep = okt & (rank < k)
    c_list = torch.full((ng, k + 1), -1, dtype=torch.int32, device=okt.device)
    c_list.scatter_(1, torch.where(keep, rank, k),
                    ids.to(torch.int32).expand(ng, m))
    c_list = c_list[:, :k].contiguous()
    return c_list, c_list >= 0, cnt


def _cbin_lists(rays: torch.Tensor, boxes: torch.Tensor, scale: float,
                tmin: float, g: int, k: int):
    """Per-group compact cluster work lists, ascending cluster ids
    (``pallas_ablations._cbin_lists``). Returns (c_list [ng, k], valid
    [ng, k], inc [ng]); ``inc`` marks groups whose list a static cap cut.

    Flat: the dense group test over all C boxes. Two-level
    (``CBIN_LVL`` 2, or 0 with the interval test and at least
    ``CBIN_LVL2_MIN`` boxes): the interval test over parents of
    ``CBIN_FAN`` boxes, at most ``CBIN_K1`` kept, then over the kept
    parents' children only."""
    ns, dev = boxes.shape[0], rays.device
    ng = rays.shape[0] // g
    fan, lvl = CBIN_FAN, CBIN_LVL
    exact_g = g > 1 and _cbin_exact()
    two = lvl == 2 or (lvl == 0 and not exact_g and ns >= CBIN_LVL2_MIN)
    if not two:
        okt = _cbin_group_test(rays, boxes, scale, tmin, g)
        c_list, valid, cnt = _extract_lists(
            okt, torch.arange(ns, dtype=torch.int32, device=dev), k)
        return c_list, valid, cnt > k
    ns1 = (ns + fan - 1) // fan
    k1 = min(CBIN_K1, max(1, ns1))
    pad = ns1 * fan - ns
    lo8 = torch.nn.functional.pad(boxes[:, 0:3], (0, 0, 0, pad),
                                  value=_BIG).view(ns1, fan, 3)
    hi8 = torch.nn.functional.pad(boxes[:, 3:6], (0, 0, 0, pad),
                                  value=-_BIG).view(ns1, fan, 3)
    lo1, hi1 = lo8.amin(1), hi8.amax(1)
    bounds = _cbin_ray_bounds(rays, scale, g)
    okt1 = torch.cat(
        [_interval_slab(bounds, lo1[None, c0:c0 + 1024],
                        hi1[None, c0:c0 + 1024], tmin)
         for c0 in range(0, ns1, 1024)], 1)
    c1, valid1, cnt1 = _extract_lists(
        okt1, torch.arange(ns1, dtype=torch.int32, device=dev), k1)
    c1c = c1.clamp_min(0).long()
    ch_lo = lo8[c1c].view(ng, k1 * fan, 3)
    ch_hi = hi8[c1c].view(ng, k1 * fan, 3)
    ok2 = (_interval_slab(bounds, ch_lo, ch_hi, tmin)
           & valid1.repeat_interleave(fan, dim=1))
    ids2 = (c1c[:, :, None] * fan
            + torch.arange(fan, device=dev)).view(ng, k1 * fan)
    c_list, valid, cnt2 = _extract_lists(ok2, ids2, k)
    return c_list, valid, (cnt1 > k1) | (cnt2 > k)


def _cbin_group(n: int, rt: int) -> int:
    """Lanes that share one work list: ``CBIN_GROUP`` halved until it
    divides both the ray count and the job width."""
    g = max(1, min(CBIN_GROUP, rt))
    while n % g or rt % g:
        g //= 2
    return g


def cbin_pairs(rays: torch.Tensor, boxes: torch.Tensor, scale: float,
               tmin: float):
    """Cluster-major padded work lists for the binned sweep
    (``pallas_ablations.cbin_pairs``). ``rays`` [n, 8], n a multiple of
    ``RAY_TILE_C``, each ray's bound in column 6.

    Returns (pair_rays [P_cap, 8], job_cluster [J_cap] i32 with -1 for an
    empty job, row_tgt [P_cap // g] i64, incomplete [n] bool, (ng, g, k)).
    Job j covers pair lanes [rt j, rt j + rt): rt // g groups of g
    adjacent lanes sharing one work list, against one cluster. ``row_tgt``
    maps each g-lane result row to its (group * k + rank) reduce cell
    (``ng * k``: dropped padding). ``incomplete`` marks the lanes whose
    group overflowed the per-group cap ``CBIN_K_OUT`` or the pair budget
    ``CBIN_PAIR_MULT * n``: the caller finishes them another way."""
    ns, n, dev = boxes.shape[0], rays.shape[0], rays.device
    rt = RAY_TILE_C
    g = _cbin_group(n, rt)
    ng, k = n // g, CBIN_K_OUT
    qpj = rt // g                                   # group-pairs per job
    p_cap = CBIN_PAIR_MULT * n
    j_cap = p_cap // rt

    c_list, valid, inc_lists = _cbin_lists(rays, boxes, scale, tmin, g, k)

    # Cluster-major order: one stable sort of the (group, rank) pair ids,
    # so groups ascend within a cluster.
    skey = torch.where(valid, c_list, ns).view(-1).long()
    skey_s, sval = torch.sort(skey, stable=True)
    edges = torch.searchsorted(skey_s, torch.arange(ns + 1, device=dev))
    start_cl = edges[:ns]
    cnt_cl = edges[1:] - edges[:ns]
    jobs = (cnt_cl + qpj - 1) // qpj
    base_job = torch.cumsum(jobs, 0) - jobs
    total_jobs = jobs.sum()
    jtab = torch.full((j_cap + 1,), -1, dtype=torch.int64, device=dev)
    jtab[torch.where(jobs > 0, base_job.clamp_max(j_cap), j_cap)] = \
        torch.arange(ns, device=dev)
    jtab = torch.cummax(jtab[:j_cap], 0).values             # forward fill
    j_iota = torch.arange(j_cap, device=dev)
    jtab = torch.where(j_iota < total_jobs.clamp_max(j_cap), jtab, -1)

    # Sorted group-pairs -> padded job slots.
    cjs = jtab.clamp_min(0)
    q0 = (j_iota - base_job[cjs]) * qpj             # job's first pair rank
    qi = torch.arange(qpj, device=dev)[None, :]
    pos = (start_cl[cjs][:, None] + q0[:, None] + qi).clamp_max(ng * k - 1)
    okq = (jtab[:, None] >= 0) & ((q0[:, None] + qi) < cnt_cl[cjs][:, None])
    pidq = sval[pos]                                        # [j_cap, qpj]
    gg = pidq // k
    kk = pidq - gg * k
    gg = torch.where(okq, gg, ng)                           # pad sentinel
    row_tgt = torch.where(okq, gg * k + kk, ng * k).view(-1)

    # Pair rays: one gather of g-ray group rows; the sentinel row is
    # parked rays (zeros would pass every slab and plane guard).
    park_row = rays.new_tensor(
        ([PARK_COORD] * 3 + [PARK_DIR] * 3 + [0.0, 0.0]) * g)
    grp = torch.cat([rays.view(ng, g * 8), park_row[None]])
    pair_rays = grp[gg].view(p_cap, 8)

    # Lanes whose group overflowed the per-group cap, or whose cluster's
    # padded segment spilled past the pair budget (which covers the job
    # table's overflow too), stay incomplete.
    bad_c = (base_job + jobs) * rt > p_cap
    inc_g = inc_lists | (valid & bad_c[c_list.clamp(0, ns - 1).long()]).any(1)
    return (pair_rays.contiguous(), jtab.to(torch.int32).contiguous(),
            row_tgt, inc_g.repeat_interleave(g), (ng, g, k))


def _cbin_reduce(res_t, res_i, row_tgt, n: int, ng: int, g: int, k: int):
    """Per-ray lexicographic (t, row) minimum over the per-pair results
    (``pallas_ablations._cbin_reduce``): the [g]-wide result rows go to
    their (group * k + rank) cells, each written once, and the k axis is
    folded. Returns (t [n], row [n] i32), row 0 on a miss."""
    cells = ng * k + 1
    tt = res_t.new_full((cells, g), T_FAR)
    ii = torch.full((cells, g), _BIG_IDX, dtype=torch.int32,
                    device=res_t.device)
    tt[row_tgt] = res_t.view(-1, g)
    ii[row_tgt] = res_i.view(-1, g)
    tt = tt[:ng * k].view(ng, k, g)
    ii = ii[:ng * k].view(ng, k, g)
    bt = tt.amin(1)
    bi = torch.where(tt == bt[:, None, :], ii, _BIG_IDX).amin(1)
    bt, bi = bt.reshape(n), bi.reshape(n)
    return bt, torch.where(bt < T_FAR, bi, 0).to(torch.int32)


def _cbin_reduce_occ(res_o, row_tgt, n: int, ng: int, g: int, k: int):
    """Per-lane OR over the per-pair blocked flags
    (``pallas_ablations._cbin_reduce_occ``). Returns bool [n]."""
    oo = torch.zeros((ng * k + 1, g), dtype=torch.int32, device=res_o.device)
    oo[row_tgt] = res_o.view(-1, g)
    return oo[:ng * k].view(ng, k, g).amax(1).reshape(n) > 0


def _cbin_sweep_plain(pair_rays, tris, jtab, cluster: int, rt: int,
                      tmin: float, occluded: bool):
    """The binned kernels in plain PyTorch: every job's pair lanes against
    the job's one cluster; an empty job writes T_FAR / row 0 / 0."""
    dev = pair_rays.device
    j_cap = jtab.shape[0]
    live = jtab >= 0
    pr = pair_rays.view(j_cap, rt, 8)
    rows = tris.view(-1, cluster, 16)[jtab.clamp_min(0).long()]
    t = _pe_rows(pr[:, :, 0:3], pr[:, :, 3:6], rows, tmin)  # [J, rt, cluster]
    if occluded:
        blocking = (t < pr[:, :, 6:7]) & (rows[:, None, :, 13] < 0.5)
        return (blocking.any(2) & live[:, None]).to(torch.int32).view(-1)
    blk_t = t.amin(2)
    sub = torch.arange(cluster, device=dev)
    blk_sub = torch.where(t == blk_t[:, :, None], sub, cluster).amin(2)
    blk_sub = torch.where(blk_t < T_FAR, blk_sub, 0)
    row = blk_sub + jtab.clamp_min(0).long()[:, None] * cluster
    return (torch.where(live[:, None], blk_t, T_FAR).view(-1),
            torch.where(live[:, None], row, 0).to(torch.int32).view(-1))


def _check_jobs(pair_rays, tris, jtab, rt: int) -> int:
    dev = pair_rays.device
    j_cap = jtab.shape[0]
    dense._check("pair_rays", pair_rays, torch.float32, (j_cap * rt, 8), dev)
    dense._check("tris", tris, torch.float32, (tris.shape[0], 16), dev)
    dense._check("jtab", jtab, torch.int32, (j_cap,), dev)
    if pair_rays.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("pair_rays and tris must be 16-byte aligned")
    return j_cap


def closest_cbin(pair_rays: torch.Tensor, tris: torch.Tensor,
                 jtab: torch.Tensor, cluster: int, rt: int, tmin: float):
    """K13 closest: for every pair lane of ``cbin_pairs`` the closest
    (t, packed row) within its job's cluster, (T_FAR, the cluster's first
    row) on a miss, (T_FAR, 0) in an empty job. Returns ([P_cap] f32,
    [P_cap] i32)."""
    if dense._on_cpu(pair_rays):
        return _cbin_sweep_plain(pair_rays, tris, jtab, cluster, rt, tmin,
                                 occluded=False)
    from .. import _kernels
    j_cap = _check_jobs(pair_rays, tris, jtab, rt)
    dev = pair_rays.device
    t = torch.empty(j_cap * rt, dtype=torch.float32, device=dev)
    row = torch.empty(j_cap * rt, dtype=torch.int32, device=dev)
    if j_cap:
        _kernels.launch("tpt_closest_cbin", pair_rays.data_ptr(),
                        tris.data_ptr(), jtab.data_ptr(), j_cap, cluster, rt,
                        float(tmin), t.data_ptr(), row.data_ptr(),
                        dense._stream(dev))
        LAUNCHES["closest_cbin"] += 1
    return t, row


def occluded_cbin(pair_rays: torch.Tensor, tris: torch.Tensor,
                  jtab: torch.Tensor, cluster: int, rt: int,
                  tmin: float) -> torch.Tensor:
    """K13 any-hit: for every pair lane, is a non-refractive row of its
    job's cluster hit with tmin < t < the lane's tmax (column 6)? Returns
    [P_cap] i32."""
    if dense._on_cpu(pair_rays):
        return _cbin_sweep_plain(pair_rays, tris, jtab, cluster, rt, tmin,
                                 occluded=True)
    from .. import _kernels
    j_cap = _check_jobs(pair_rays, tris, jtab, rt)
    dev = pair_rays.device
    out = torch.empty(j_cap * rt, dtype=torch.int32, device=dev)
    if j_cap:
        _kernels.launch("tpt_occluded_cbin", pair_rays.data_ptr(),
                        tris.data_ptr(), jtab.data_ptr(), j_cap, cluster, rt,
                        float(tmin), out.data_ptr(), dense._stream(dev))
        LAUNCHES["occluded_cbin"] += 1
    return out


# --------------------------------------------------------------------------
# The three paths as clustered.closest_hit / occluded_hit take them
# --------------------------------------------------------------------------

def _pad_tile(n: int) -> int:
    return -(-n // RAY_TILE_C) * RAY_TILE_C


def stream_steps(origins, dirs, tmax, tris, boxes, scale, tmin: float,
                 occluded: bool):
    """The streamed path in its two steps, (rays, build, kernel):
    ``build()`` gives the tile lists of the packed ``rays``,
    ``kernel(lists)`` the padded result of K12. The paths below run one
    after the other; a bench times them apart. ``tmax`` is a float for
    the closest hit and [N] for the any-hit."""
    rays = pack_rays(origins, dirs, tmax, _pad_tile(origins.shape[0]))

    def build():
        return stream_candidates(rays, boxes, scale, RAY_TILE_C, tmin,
                                 rays[:, 6] if occluded else tmax)

    def kernel(lists):
        if occluded:
            return occluded_streamed(rays, tris, boxes, scale, lists,
                                     RAY_TILE_C, tmin, _stream_guard())
        return closest_streamed(rays, tris, boxes, scale, lists, RAY_TILE_C,
                                tmin, tmax, _stream_guard())
    return rays, build, kernel


def cbin_steps(origins, dirs, tmax, tris, boxes, scale, tmin: float,
               occluded: bool):
    """The binned sweep in its two steps, (rays, build, kernel):
    ``build()`` is ``cbin_pairs`` on the packed ``rays``,
    ``kernel(schedule)`` the per-pair results of K13 (the reduce and the
    completion pass follow in the paths below)."""
    rays = pack_rays(origins, dirs, tmax, _pad_tile(origins.shape[0]))
    cluster = tris.shape[0] // boxes.shape[0]
    sweep = occluded_cbin if occluded else closest_cbin

    def build():
        return cbin_pairs(rays, boxes, scale, tmin)

    def kernel(schedule):
        return sweep(schedule[0], tris, schedule[1], cluster, RAY_TILE_C,
                     tmin)
    return rays, build, kernel


def closest_stream_path(origins, dirs, tris, boxes, scale, tmin: float,
                        tmax: float = T_FAR):
    """``TPT_STREAM=1``: list build, then K12. Returns (t [N], row [N])."""
    n = origins.shape[0]
    _, build, kernel = stream_steps(origins, dirs, tmax, tris, boxes, scale,
                                    tmin, occluded=False)
    t, row = kernel(build())
    return t[:n], row[:n]


def occluded_stream_path(origins, dirs, tmax, tris, boxes, scale,
                         tmin: float) -> torch.Tensor:
    """``TPT_STREAM=1``, any-hit. Returns bool [N]."""
    _, build, kernel = stream_steps(origins, dirs, tmax, tris, boxes, scale,
                                    tmin, occluded=True)
    return kernel(build())[:origins.shape[0]]


def closest_cbin_path(origins, dirs, tris, boxes, scale, tmin: float,
                      tmax: float = T_FAR):
    """``TPT_CBIN=1``: the binned sweep and its reduce, then the lanes a
    cap left incomplete through K12 with every other lane parked
    (``pallas_bf.py:2444-2465``). Returns (t [N], row [N])."""
    n = origins.shape[0]
    rays, build, kernel = cbin_steps(origins, dirs, tmax, tris, boxes, scale,
                                     tmin, occluded=False)
    schedule = build()
    _, _, row_tgt, incomplete, (ng, g, k) = schedule
    res_t, res_i = kernel(schedule)
    best_t, best_row = _cbin_reduce(res_t, res_i, row_tgt, rays.shape[0], ng,
                                    g, k)
    if tmax < T_FAR:
        # The pair jobs carry no tmax: clip after the reduce.
        best_t = torch.where(best_t < tmax, best_t, T_FAR)
        best_row = torch.where(best_t < T_FAR, best_row, 0)
    rays_c = _park_rays(rays, ~incomplete)
    lists = stream_candidates(rays_c, boxes, scale, RAY_TILE_C, tmin, tmax)
    ct, ci = closest_streamed(rays_c, tris, boxes, scale, lists, RAY_TILE_C,
                              tmin, tmax, _stream_guard())
    best_t = torch.where(incomplete, ct, best_t)
    best_row = torch.where(incomplete, ci, best_row)
    return best_t[:n].contiguous(), best_row[:n].contiguous()


def _parked(o, d, lanes):
    """``o``, ``d`` with every lane outside ``lanes`` parked."""
    return (torch.where(lanes[:, None], o, PARK_COORD).contiguous(),
            torch.where(lanes[:, None], d, PARK_DIR).contiguous())


def occluded_cbin_path(origins, dirs, tmax, tris, boxes, scale, tmin: float,
                       finish) -> torch.Tensor:
    """``TPT_CBIN=1``, any-hit (``pallas_bf.py:2609-2634``): the binned
    sweep and its OR, then the lanes left incomplete and not yet blocked
    through ``finish(o, d, tmax)``, the ordinary path, every other lane
    parked. Returns bool [N]."""
    n = origins.shape[0]
    rays, build, kernel = cbin_steps(origins, dirs, tmax, tris, boxes, scale,
                                     tmin, occluded=True)
    schedule = build()
    _, _, row_tgt, incomplete, (ng, g, k) = schedule
    occ = _cbin_reduce_occ(kernel(schedule), row_tgt, rays.shape[0], ng, g,
                           k)[:n]
    ovf = incomplete[:n] & ~occ
    fb = finish(*_parked(origins, dirs, ovf),
                torch.where(ovf, tmax, 0.0).contiguous())
    return torch.where(ovf, fb, occ)


# --------------------------------------------------------------------------
# K14: the pair-binned path
# --------------------------------------------------------------------------

PAIR_TILE = 512                                      # pairs per tile
PAIR_K = int(os.environ.get("TPT_PAIR_K", 12))       # clusters per ray
_KEY_MISS = 0x7FFFFFFF                               # high word: not pierced


def binned_sides() -> tuple[bool, bool]:
    """(closest, any-hit): which calls ``TPT_BINNED`` sends to K14, read
    now (``1`` both, ``closest`` or ``occ`` one; ``pallas_bf.py:2277``,
    ``:2587``)."""
    v = os.environ.get("TPT_BINNED", "0")
    return v in ("1", "closest"), v in ("1", "occ")


class PairSchedule(NamedTuple):
    """The pair-binned work of ``_pair_schedule``. Slot p of ``pair_ray``
    ([tiles * PAIR_TILE] i32) holds its pair's ray, -1 for an unused slot;
    tile j's pairs all go against cluster ``tile_sid[j]`` (the number of
    clusters for the dead tail). ``next_tn`` [n] is the entry distance of
    each ray's (k+1)-th nearest pierced cluster (3e38: none); ``overflow``
    [n] marks the rays that pierce more than k."""
    pair_ray: torch.Tensor
    tile_sid: torch.Tensor
    next_tn: torch.Tensor
    overflow: torch.Tensor


def _order_bits(t: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 with the same order (no NaN comes here)."""
    b = t.view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def _pair_schedule(rays: torch.Tensor, boxes: torch.Tensor, scale: float,
                   k: int, tmin: float, tmax) -> PairSchedule:
    """The cluster-major pair layout of the binned kernels
    (``pallas_ablations._pair_schedule``).

    ``rays`` [n, 8] (``pack_rays``); ``tmax`` a float or [n]. Each ray's
    k (at most C, the number of clusters) nearest clusters by the entry distance into its grown box (the exact
    test of ``_ray_box_test``; equal distances to the lowest id) become
    pairs, in chunks of 32,768 rays. Pairs are laid out by a counting
    layout: per-cluster counts, each cluster's run padded to whole
    ``PAIR_TILE`` tiles, a pair's slot = its cluster's first tile x
    PAIR_TILE + its rank among the cluster's pairs in (ray, rank) order,
    as the reference's sorts place it. The buffer holds ceil(n k /
    PAIR_TILE) + C tiles, enough for any data; no host sync."""
    n, ns, dev = rays.shape[0], boxes.shape[0], rays.device
    k = min(k, ns)
    kk = min(k + 1, ns)
    tm = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    ids = torch.arange(ns, device=dev)
    near, next_tn, count = [], [], []
    for r0 in range(0, n or 1, 32768):
        part = rays[r0:r0 + 32768]
        tests = list(_ray_box_test(part, boxes, scale, tmin,
                                   tm[r0:r0 + 32768], 1024))
        ok = torch.cat([ok for _, ok, _ in tests], 1)
        tn_all = torch.cat([tn for _, _, tn in tests], 1)
        # (entry distance, id) as one int64 key: unique, so the k + 1
        # smallest come out in the stable order.
        hi = torch.where(ok, _order_bits(tn_all), _KEY_MISS).long()
        key, _ = torch.topk((hi << 32) | ids, kk, dim=1, largest=False)
        sid = (key & 0xFFFFFFFF).long()
        pierced = (key >> 32) != _KEY_MISS
        near.append(torch.where(pierced[:, :k], sid[:, :k], ns))
        if k < ns:
            next_tn.append(torch.where(pierced[:, k],
                                       tn_all.gather(1, sid[:, k:k + 1])[:, 0],
                                       _BIG))
        else:
            next_tn.append(part.new_full((part.shape[0],), _BIG))
        count.append(ok.sum(1))
    flat = torch.cat(near).view(-1)                     # [n k], ns = none
    e = flat.shape[0]
    per_c = torch.zeros(ns + 1, dtype=torch.int64, device=dev).scatter_add_(
        0, flat, torch.ones_like(flat))[:ns]
    tiles_c = (per_c + PAIR_TILE - 1) // PAIR_TILE
    tile_end = torch.cumsum(tiles_c, 0)
    n_tiles = -(-e // PAIR_TILE) + ns
    # Rank among the cluster's pairs, in (ray, rank) order.
    sid_s, order = torch.sort(flat, stable=True)
    start = torch.cumsum(per_c, 0) - per_c
    valid = sid_s < ns
    c = sid_s.clamp_max(ns - 1)
    slot = (tile_end[c] - tiles_c[c]) * PAIR_TILE \
        + torch.arange(e, device=dev) - start[c]
    cap = n_tiles * PAIR_TILE
    pair_ray = torch.full((cap + 1,), -1, dtype=torch.int32, device=dev)
    pair_ray.scatter_(0, torch.where(valid, slot, cap),
                      torch.where(valid, order // k, -1).to(torch.int32))
    tile_sid = torch.searchsorted(
        tile_end, torch.arange(n_tiles, device=dev), right=True)
    return PairSchedule(pair_ray[:cap].contiguous(),
                        tile_sid.to(torch.int32).contiguous(),
                        torch.cat(next_tn), torch.cat(count) > k)


def _binned_sweep_plain(rays, tris, pair_ray, tile_sid, cluster: int,
                        tmin: float, occluded: bool):
    """The binned kernels' per-pair work in plain PyTorch, 64 tiles at a
    time: every used slot of a live tile against the tile's cluster.
    Returns (ray [P] i64, -1 for no pair; and t [P], row [P] i32 of the
    closest row of the cluster, or the blocked flags [P])."""
    n_boxes = tris.shape[0] // cluster
    table = tris.view(n_boxes, cluster, 16)
    live = (tile_sid < n_boxes)[:, None] & (pair_ray.view(-1, PAIR_TILE) >= 0)
    ray = torch.where(live, pair_ray.view(-1, PAIR_TILE).long(), -1)
    out_t, out_row, out_occ = [], [], []
    for j0 in range(0, tile_sid.shape[0], 64):
        sid = tile_sid[j0:j0 + 64].long().clamp_max(n_boxes - 1)
        pr = rays[ray[j0:j0 + 64].clamp_min(0)]             # [J, 512, 8]
        rows = table[sid]
        t = _pe_rows(pr[..., 0:3], pr[..., 3:6], rows, tmin)
        if occluded:
            out_occ.append(((t < pr[..., 6:7])
                            & (rows[:, None, :, 13] < 0.5)).any(2))
            continue
        best = t.amin(2)
        sub = torch.arange(cluster, device=rays.device)
        at = torch.where(t == best[..., None], sub, cluster).amin(2)
        out_t.append(best)
        out_row.append((sid[:, None] * cluster
                        + torch.where(best < T_FAR, at, 0)).to(torch.int32))
    ray = ray.view(-1)
    if occluded:
        return ray, torch.cat(out_occ).view(-1)
    return ray, torch.cat(out_t).view(-1), torch.cat(out_row).view(-1)


_KEY_FAR = (_order_bits(torch.tensor([T_FAR])).long() << 32).item()


def _reduce_pairs(ray, t, row, n: int):
    """Per-ray (t, row)-lexicographic minimum of the per-pair results
    (``pallas_ablations._reduce_pairs``): one ``scatter_reduce`` ``amin`` of
    the int64 key (float bits of t) << 32 | row, which orders as (t, row)
    because every hit has t > tmin > 0. Returns (t [n], row [n] i32), T_FAR
    and row 0 on a miss."""
    hit = (ray >= 0) & (t < T_FAR)
    key = (t.view(torch.int32).long() << 32) | row.long()
    out = torch.full((n + 1,), _KEY_FAR, dtype=torch.int64, device=t.device)
    out.scatter_reduce_(0, torch.where(hit, ray, n), key, "amin")
    return _unpack_keys(out[:n])


def _unpack_keys(key: torch.Tensor):
    """(t, row i32) of the per-ray keys the closest binned kernel folds."""
    return ((key >> 32).to(torch.int32).view(torch.float32),
            (key & 0xFFFFFFFF).to(torch.int32))


def _reduce_pairs_occ(ray, blocked, n: int) -> torch.Tensor:
    """Per-ray OR of the per-pair blocked flags. Returns bool [n]."""
    out = torch.zeros(n + 1, dtype=torch.int32, device=blocked.device)
    out.scatter_reduce_(0, torch.where(ray >= 0, ray, n),
                        blocked.to(torch.int32), "amax")
    return out[:n] > 0


def _check_pairs(rays, tris, pair_ray, tile_sid, cluster: int) -> int:
    dev, n = rays.device, rays.shape[0]
    n_tiles = tile_sid.shape[0]
    dense._check("rays", rays, torch.float32, (n, 8), dev)
    dense._check("tris", tris, torch.float32, (tris.shape[0], 16), dev)
    dense._check("pair_ray", pair_ray, torch.int32, (n_tiles * PAIR_TILE,),
                 dev)
    dense._check("tile_sid", tile_sid, torch.int32, (n_tiles,), dev)
    if rays.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("rays and tris must be 16-byte aligned")
    if tris.shape[0] % cluster:
        raise ValueError(f"{tris.shape[0]} rows are no whole number of "
                         f"clusters of {cluster}")
    return n_tiles


def closest_binned(rays: torch.Tensor, tris: torch.Tensor,
                   pair_ray: torch.Tensor, tile_sid: torch.Tensor,
                   cluster: int, tmin: float):
    """K14 closest: for every ray of ``rays`` [n, 8] the closest (t,
    packed row) over the clusters of its pairs in ``_pair_schedule``'s
    layout, T_FAR and row 0 where it has none or misses them (no tmax: the
    path clips). Returns (t [n], row [n] i32)."""
    if dense._on_cpu(rays):
        ray, t, row = _binned_sweep_plain(rays, tris, pair_ray, tile_sid,
                                          cluster, tmin, occluded=False)
        return _reduce_pairs(ray, t, row, rays.shape[0])
    from .. import _kernels
    n_tiles = _check_pairs(rays, tris, pair_ray, tile_sid, cluster)
    key = torch.full((rays.shape[0],), _KEY_FAR, dtype=torch.int64,
                     device=rays.device)
    _kernels.launch("tpt_closest_binned", rays.data_ptr(), tris.data_ptr(),
                    pair_ray.data_ptr(), tile_sid.data_ptr(), n_tiles,
                    tris.shape[0] // cluster, cluster, float(tmin),
                    key.data_ptr(), dense._stream(rays.device))
    LAUNCHES["closest_binned"] += 1
    return _unpack_keys(key)


def occluded_binned(rays: torch.Tensor, tris: torch.Tensor,
                    pair_ray: torch.Tensor, tile_sid: torch.Tensor,
                    cluster: int, tmin: float) -> torch.Tensor:
    """K14 any-hit: for every ray of ``rays`` [n, 8] (column 6: its tmax),
    is a non-refractive row of one of its pairs' clusters hit with
    tmin < t < tmax? Returns bool [n]."""
    if dense._on_cpu(rays):
        ray, blocked = _binned_sweep_plain(rays, tris, pair_ray, tile_sid,
                                           cluster, tmin, occluded=True)
        return _reduce_pairs_occ(ray, blocked, rays.shape[0])
    from .. import _kernels
    n_tiles = _check_pairs(rays, tris, pair_ray, tile_sid, cluster)
    occ = torch.zeros(rays.shape[0], dtype=torch.bool, device=rays.device)
    _kernels.launch("tpt_occluded_binned", rays.data_ptr(), tris.data_ptr(),
                    pair_ray.data_ptr(), tile_sid.data_ptr(), n_tiles,
                    tris.shape[0] // cluster, cluster, float(tmin),
                    occ.data_ptr(), dense._stream(rays.device))
    LAUNCHES["occluded_binned"] += 1
    return occ


def binned_steps(origins, dirs, tmax, tris, boxes, scale, tmin: float,
                 occluded: bool, k: int | None = None):
    """The pair-binned sweep in its two steps, (rays, build, kernel):
    ``build()`` is ``_pair_schedule`` on the packed ``rays`` for the
    ray's ``k`` (``PAIR_K``) nearest clusters, ``kernel(schedule)`` the
    per-ray result of K14 (the completion pass follows in the paths)."""
    rays = pack_rays(origins, dirs, tmax, origins.shape[0])
    cluster = tris.shape[0] // boxes.shape[0]
    k = min(PAIR_K if k is None else k, boxes.shape[0])
    sweep = occluded_binned if occluded else closest_binned

    def build():
        return _pair_schedule(rays, boxes, scale, k, tmin,
                              rays[:, 6] if occluded else tmax)

    def kernel(schedule):
        return sweep(rays, tris, schedule.pair_ray, schedule.tile_sid,
                     cluster, tmin)
    return rays, build, kernel


def closest_binned_path(origins, dirs, tris, boxes, scale, tmin: float,
                        tmax: float = T_FAR, want_uv: bool = False,
                        finish=None, k: int | None = None,
                        nodes=None) -> Hit:
    """``TPT_BINNED``: the pair schedule, K14 and the tmax clip, the hit
    resolved from its packed row; then the rays that pierce more than k
    clusters and whose hit is not nearer than their (k+1)-th entry
    distance go through ``finish(o, d)`` (the ordinary path; default K6),
    every other lane parked, on every call
    (``pallas_ablations.intersect_closest_binned``). A hit no farther than
    every unvisited cluster's grown-box entry cannot be beaten; one at
    exactly that distance could tie a lower row there, so it is finished
    too (the reference finishes only beyond it). ``nodes`` is the boxes'
    ``clustered.cluster_tree``, for the default finish."""
    _, build, kernel = binned_steps(origins, dirs, tmax, tris, boxes, scale,
                                    tmin, occluded=False, k=k)
    schedule = build()
    t, row = kernel(schedule)
    if tmax < T_FAR:
        # The pairs carry no tmax: clip after the fold.
        t = torch.where(t < tmax, t, T_FAR)
        row = torch.where(t < T_FAR, row, 0)
    hit = clustered._lean_resolve_packed(tris, origins, dirs, t, row,
                                         want_uv)
    if finish is None:
        def finish(o, d):
            return clustered._lean_resolve_packed(
                tris, o, d, *clustered.closest_clustered(
                    o, d, tris, boxes, scale, tmin, tmax, nodes), want_uv)
    ovf = schedule.overflow & (t >= schedule.next_tn)
    fb = finish(*_parked(origins, dirs, ovf))

    def pick(a, b):
        return torch.where(ovf if a.dim() == 1 else ovf[:, None], a, b)
    return Hit(t=pick(fb.t, hit.t), tri=pick(fb.tri, hit.tri),
               hit=pick(fb.hit, hit.hit), normal=pick(fb.normal, hit.normal),
               mat=pick(fb.mat, hit.mat), u=pick(fb.u, hit.u),
               v=pick(fb.v, hit.v))


def occluded_binned_path(origins, dirs, tmax, tris, boxes, scale,
                         tmin: float, finish=None, k: int | None = None,
                         nodes=None) -> torch.Tensor:
    """``TPT_BINNED``, any-hit (``intersect_occluded_binned``): the pair
    schedule under each ray's own tmax, K14, then the rays that pierce more
    than k clusters and are not blocked yet through ``finish(o, d, tmax)``
    (the ordinary path; default K8 over ``nodes``, the boxes' cluster
    tree), every other lane parked with tmax 0. Returns bool [N]."""
    _, build, kernel = binned_steps(origins, dirs, tmax, tris, boxes, scale,
                                    tmin, occluded=True, k=k)
    schedule = build()
    occ = kernel(schedule)
    if finish is None:
        def finish(o, d, tm):
            return clustered.occluded_clustered(o, d, tm, tris, boxes, scale,
                                                tmin, nodes)
    ovf = schedule.overflow & ~occ
    fb = finish(*_parked(origins, dirs, ovf),
                torch.where(ovf, tmax, 0.0).contiguous())
    return torch.where(ovf, fb, occ)


# --------------------------------------------------------------------------
# K15: the 8-lane groups
# --------------------------------------------------------------------------

GRP_LANES = 8                                        # lanes per list
GRP_BUNDLE = 8                                       # groups per bundle
GRP_RT = int(os.environ.get("TPT_GRP_RT", 256))      # lanes per serial block


def _grp_bundled() -> bool:
    """``TPT_GRP=2``: the bundled lockstep body, read at every call
    (``pallas_ablations._grp_bundled``)."""
    return os.environ.get("TPT_GRP", "0") == "2"


def _grp_plain(rays, tris, boxes, scale, lists, tmin, tmax, occluded):
    """Plain version of K15, serial or bundled: every group's list walked
    step by step, all groups in step (the bundled lockstep over the whole
    batch), each group stopped at the first key beyond every lane's bound
    and a candidate skipped where no lane's grown box passes: the streamed
    schedule at a tile of ``GRP_LANES`` lanes. A lane the kernel culls on
    its own sweeps here too, and finds nothing nearer."""
    return _streamed_plain(rays, tris, boxes, scale, lists, GRP_LANES, tmin,
                           tmax, True, occluded)


def _launch_grp(name, rays, tris, boxes, scale, lists, bundled, scalars,
                outs):
    """Launch ``tpt_<name>``: the checks, then (tables, lists, sizes,
    ``scalars`` after the margin, ``outs``)."""
    from .. import _kernels
    dev, n_pad = rays.device, rays.shape[0]
    dense._check("rays", rays, torch.float32, (n_pad, 8), dev)
    if n_pad % GRP_LANES:
        raise ValueError(f"{n_pad} rays do not split into groups of "
                         f"{GRP_LANES}")
    if rays.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("rays and tris must be 16-byte aligned")
    dense._check("tris", tris, torch.float32, (tris.shape[0], 16), dev)
    n_boxes, cluster = clustered._check_tables(tris, boxes, dev)
    _check_lists(lists, n_pad, GRP_LANES, n_boxes, dev)
    cand, keys, cnt, far = lists
    if n_pad:
        _kernels.launch("tpt_" + name, rays.data_ptr(), tris.data_ptr(),
                        boxes.data_ptr(), cand.data_ptr(), keys.data_ptr(),
                        cnt.data_ptr(), far.data_ptr(), n_pad, n_boxes,
                        cluster, GRP_RT, int(bool(bundled)), float(scale),
                        clustered.BOX_MARGIN, *(float(x) for x in scalars),
                        *(x.data_ptr() for x in outs), dense._stream(dev))
        LAUNCHES[name] += 1


def closest_grp(rays: torch.Tensor, tris: torch.Tensor, boxes: torch.Tensor,
                scale: float, lists, tmin: float, tmax: float = T_FAR,
                bundled: bool = False):
    """K15 closest: K6's (t, packed row) for ``rays`` [n_pad, 8]
    (``pack_rays``; n_pad a multiple of ``GRP_LANES``) over the group lists
    of ``stream_candidates(rays, boxes, scale, GRP_LANES, tmin, tmax)``;
    ``bundled`` picks the lockstep body. Returns (t, row)."""
    if dense._on_cpu(rays):
        return _grp_plain(rays, tris, boxes, scale, lists, tmin, tmax,
                          occluded=False)
    t = torch.empty(rays.shape[0], dtype=torch.float32, device=rays.device)
    row = torch.empty(rays.shape[0], dtype=torch.int32, device=rays.device)
    _launch_grp("closest_grp", rays, tris, boxes, scale, lists, bundled,
                (tmin, tmax), (t, row))
    return t, row


def occluded_grp(rays: torch.Tensor, tris: torch.Tensor, boxes: torch.Tensor,
                 scale: float, lists, tmin: float,
                 bundled: bool = False) -> torch.Tensor:
    """K15 any-hit: K8's flag for ``rays`` [n_pad, 8] (column 6: the
    ray's tmax) over the group lists of ``stream_candidates(rays, boxes,
    scale, GRP_LANES, tmin, rays[:, 6])``. Returns bool [n_pad]."""
    if dense._on_cpu(rays):
        return _grp_plain(rays, tris, boxes, scale, lists, tmin, T_FAR,
                          occluded=True)
    out = torch.empty(rays.shape[0], dtype=torch.bool, device=rays.device)
    _launch_grp("occluded_grp", rays, tris, boxes, scale, lists, bundled,
                (tmin,), (out,))
    return out


def grp_steps(origins, dirs, tmax, tris, boxes, scale, tmin: float,
              occluded: bool):
    """The group path in its two steps, (rays, build, kernel): the
    caller's lanes as given, padded with parked rays to whole groups;
    ``build()`` gives the group lists, ``kernel(lists)`` the padded result
    of K15 under ``TPT_GRP`` (``2``: bundled)."""
    n = origins.shape[0]
    rays = pack_rays(origins, dirs, tmax, -(-n // GRP_LANES) * GRP_LANES)

    def build():
        return stream_candidates(rays, boxes, scale, GRP_LANES, tmin,
                                 rays[:, 6] if occluded else tmax)

    def kernel(lists):
        if occluded:
            return occluded_grp(rays, tris, boxes, scale, lists, tmin,
                                _grp_bundled())
        return closest_grp(rays, tris, boxes, scale, lists, tmin, tmax,
                           _grp_bundled())
    return rays, build, kernel


def closest_grp_path(origins, dirs, tris, boxes, scale, tmin: float,
                     tmax: float = T_FAR):
    """``TPT_GRP=1`` / ``2``: group lists, then K15. Returns (t [N],
    row [N])."""
    n = origins.shape[0]
    _, build, kernel = grp_steps(origins, dirs, tmax, tris, boxes, scale,
                                 tmin, occluded=False)
    t, row = kernel(build())
    return t[:n], row[:n]


def occluded_grp_path(origins, dirs, tmax, tris, boxes, scale,
                      tmin: float) -> torch.Tensor:
    """``TPT_GRP=1`` / ``2``, any-hit. Returns bool [N]."""
    _, build, kernel = grp_steps(origins, dirs, tmax, tris, boxes, scale,
                                 tmin, occluded=True)
    return kernel(build())[:origins.shape[0]]
