"""Three more schedulers of the clustered closest hit and any-hit: the
port of the first three kernel families of
``tpu_pt/intersect/pallas_ablations.py``.

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

Every wrapper launches its kernel (``csrc/ablations_intersect.cu``) for
CUDA tensors, runs its plain version for CPU tensors and raises otherwise.
The plain versions follow the schedules step by step over the same lists,
so the CPU tests hold the schedules, not only the answers, against the
dense sweep. Results are bitwise those of ``dense._closest_plain`` /
``dense._occluded_plain``: the closest kernels compare (t, row)
lexicographically, and every cull uses the boxes grown by the per-ray
margin ``clustered.BOX_MARGIN * (scale + max|o|)``.
"""

from __future__ import annotations

import os

import torch

from . import clustered, dense
from .moller import T_FAR

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
            "occluded_streamed": 0, "closest_cbin": 0, "occluded_cbin": 0}


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
    fb = finish(torch.where(ovf[:, None], origins, PARK_COORD).contiguous(),
                torch.where(ovf[:, None], dirs, PARK_DIR).contiguous(),
                torch.where(ovf, tmax, 0.0).contiguous())
    return torch.where(ovf, fb, occ)
