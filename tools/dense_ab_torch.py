#!/usr/bin/env python3
"""The dense bodies of K1-K4 (``dense.closest_lean``, ``dense.occluded``,
``dense.closest_full``, ``dense.closest_nee_lean``: the sweeps of the
tables with no kd copy) timed on the card, for a side-by-side of two
checkouts of the port.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs.

- K2 on shadow rays (chip_smoke.py's ``_phase3_rays``, one lane in eight
  parked) at 262,144, 131,072 and 65,536 rays (the first two through its
  table's row split, the last through every row) over the mixed box's 24
  NEE occluder
  rows, ``cornell_box.obj``'s subset and a 2,048-row subset with no kd
  copy (the first 2,048 rows of the sphere box's subset, with its shadow
  rays: the largest a clustered scene hands K2); K1 on ``cornell_box.obj``'s
  32 rows and the mixed box's 432 at the same counts; K3's and K4's dense
  bodies on ``cornell_box.obj`` (K3 at tmax 600 with u and v);
- every K2 call of one reference-launch frame (the mixed box, 512^2, 128
  spp, depth 4, IS + NEE), every K1 and K2 call of one ``cornell_box.obj``
  frame at the same setting, every K4 call of one such frame under
  ``fused_nee`` and every K3 call of one at a finite ``t_max`` (1e4, past
  every hit in the box), recorded and replayed;
- the reference-launch, bench (1024^2, 16 spp, depth 8) and the three
  ``cornell_box.obj`` frames: frames 0-2 (frame 0 records the calls; ms of
  frames 1-2, host clock), then one more under ``torch.profiler`` (device
  busy: the summed time of the device's own events, each of the package's
  kernels, and the launches of K1-K4 in that frame; only the device is
  traced), with a checksum
  of the accumulator after frames 0-2; and the launches of one frame of
  each scene-JSON golden (chip_smoke.py's ``JSON_GOLDENS``).

Every result is held bitwise against its plain version on the same rays.
``--accums PATH`` (.npz) writes the frames' accumulators to PATH when it
does not exist and otherwise holds them against the ones there, so that
runs of two checkouts in one call check each other: equal but for the
order of pixelq's atomic adds, which differs from run to run of one
checkout too (``_hold_accums``).

``--quick`` stops after the calls: frame 0 of each frame records them, and
nothing more is rendered. ``--inspect DIR`` (this checkout's kernels)
reports instead: ptxas' registers and spills of each kernel of the
library, how much a lazy pair test could skip on K2's rays
(``_range_shares``), how often the rays of the recorded K2 calls meet
the groups of their table's row split (``_group_shares``), what the
closest sweeps of K1, K3 and K4 would queue (``_queue_shares``: the
share of pairs whose plane t is in range, the flushes a warp and the
pairs a flush resolves, by a plain model of a warp queue that the
kernels do not run), and the SASS of the dense bodies, written to DIR
with their instruction counts (``cuobjdump``, where the toolkit has it).

Device times (``kernel_ms``, twice) are CUDA events around calls queued
behind a spin of the device, so that they run back to back with no host
gap (``device_ms``); ``events_ms`` beside them is chip_smoke.gpu_ms, events
around calls that the host launches as it goes, which time the host's
launches once a kernel is shorter than a launch. Prints one JSON line per measurement,
each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/dense_ab_torch.py [--root DIR] [--label NAME]
[--accums PATH] [--quick] [--inspect DIR]``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
# 131,072 and 65,536 lie on either side of dense.OCC_SPLIT_MIN_RAYS, where
# K2 turns from the sweep of every row to its table's row split.
COUNTS = (262144, 131072, 65536)
SUBSET_ROWS = 2048            # dense.LEAN_MAX_TRIS: the largest copy-less subset
REFERENCE = ("reference launch", "cornell_box_mixed.obj",
             dict(width=512, height=512, spp=128, max_depth=4))
BENCH = ("bench frame", "cornell_box_mixed.obj",
         dict(width=1024, height=1024, spp=16, max_depth=8))
CORNELL = ("cornell_box.obj frame", "cornell_box.obj",
           dict(width=512, height=512, spp=128, max_depth=4))
CORNELL_NEE = ("cornell_box.obj frame, fused_nee", "cornell_box.obj",
               dict(CORNELL[2], fused_nee=True))
CORNELL_CLIP = ("cornell_box.obj frame, t_max 1e4", "cornell_box.obj",
                dict(CORNELL[2], t_max=1e4))
# The dense wrappers whose calls each frame records; the kernel of each.
RECORD = {REFERENCE[0]: ("occluded",),
          CORNELL[0]: ("occluded", "closest_lean"),
          CORNELL_NEE[0]: ("closest_nee_lean",),
          CORNELL_CLIP[0]: ("closest_full",)}
KERNEL = {"closest_lean": "K1", "occluded": "K2", "closest_full": "K3",
          "closest_nee_lean": "K4"}
FRAMES = [0, 1, 2]
# Two sums of the same samples in another order: ~n eps apart for n adds
# into a pixel (128 spp: 128 x 6e-8).
ACCUM_RTOL = 2e-5


def device_ms(fn, reps: int) -> float:
    """Device ms a call of fn(), over reps calls queued behind a spin of
    the card (torch.cuda._sleep) that outlasts their enqueue, so that the
    two events see the kernels back to back with no host gap (after two
    warm-up calls). Events around calls that the host launches as it goes
    time the host's launches once a kernel is shorter than a launch (K1's
    and K2's dense bodies: ~0.02 ms), and torch.profiler drops kernels
    when it is started and stopped many times."""
    import torch
    clock_khz = torch.cuda.get_device_properties(
        torch.cuda.current_device()).clock_rate
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin_ms = 10.0 * host_ms * reps + 10.0
    for _ in range(4):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(spin_ms * clock_khz))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        if queued_ms < spin_ms:
            return start.elapsed_time(stop) / reps
        spin_ms *= 4.0      # the host stalled: queue again
    raise AssertionError(f"queueing {reps} calls took {queued_ms:.2f} ms, "
                         f"past the card's {spin_ms:.2f} ms spin")


class _Recorder:
    """Keeps the positional arguments of every call of the named dense
    wrappers while the block runs (the wrappers run as usual)."""

    def __init__(self, dense, names):
        self.dense, self.calls = dense, {k: [] for k in names}

    def __enter__(self):
        import torch
        self.real = {k: getattr(self.dense, k) for k in self.calls}

        def tap(name):
            def call(*args):
                self.calls[name].append(tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))
                return self.real[name](*args)
            return call
        for k in self.calls:
            setattr(self.dense, k, tap(k))
        return self

    def __exit__(self, *exc):
        for k, fn in self.real.items():
            setattr(self.dense, k, fn)


def _registers(lib_log: pathlib.Path) -> list[dict]:
    """ptxas' registers and spills of each dense body, from the build log."""
    out, name, spills = [], None, (0, 0)
    demangle = shutil.which("c++filt")
    for line in lib_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        if name is None or not re.search(
                r"closest_kernel|occluded_(split_)?kernel|closest_nee_kernel",
                name):
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            pretty = name
            if demangle:
                pretty = subprocess.run([demangle, name], capture_output=True,
                                        text=True).stdout.strip()
            out.append(dict(kernel=pretty, registers=int(m.group(1)),
                            spill_stores=spills[0], spill_loads=spills[1]))
            name = None
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default=None)
    ap.add_argument("--accums", default=None)
    ap.add_argument("--inspect", default=None)
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this tool times the card's kernels")
    import chip_smoke as cs
    import tpu_pt_torch as tp
    from tpu_pt_torch import _kernels
    from tpu_pt_torch.intersect import dense
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    device, smi = cs.phase_device()
    _kernels.build()

    def out(what: str, **kw) -> None:
        print(json.dumps({"label": label, "root": str(root), "what": what,
                          **kw, "device": smi}), flush=True)

    def same(got, want, what):
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{label}: {what} differs from its plain "
                                 "version")

    scenes = {f: tp.load_scene(str(cs.ASSETS / f), device=device)
              for f in ("cornell_box_mixed.obj", "cornell_box.obj",
                        "cornell_box_sphere.obj")}
    tables = {f: dense.prepare(s) for f, s in scenes.items()}

    def rays(scene_file, seed, n):
        """chip_smoke.py's rays in a box at n lanes, one in eight parked:
        ((o, d), (shadow o, d, tmax))."""
        rows = tables[scene_file].rows
        o, d, shadow = cs._phase3_rays(
            scenes[scene_file], device, seed, rows,
            lambda o, d: dense._closest_plain(o, d, rows, 0.01), n)
        return cs._park((o, d), shadow, cs.PARK_EVERY)

    mixed, cornell = tables["cornell_box_mixed.obj"], tables["cornell_box.obj"]
    sub2048 = tables["cornell_box_sphere.obj"].occ_rows[:SUBSET_ROWS]
    sub2048 = sub2048.contiguous()
    light = dense.light_vector(scenes["cornell_box.obj"])
    # (kernel, table name, rows, rays, positional arguments, plain version)
    sets = []
    for n in COUNTS:
        (om, dm), shm = rays("cornell_box_mixed.obj", 1, n)
        (oc, dc), shc = rays("cornell_box.obj", 5, n)
        _, shs = rays("cornell_box_sphere.obj", 2, n)
        lz1, lz2 = cs._light_samples(n, 11, device)
        for what, table, sh in (("mixed subset", mixed.occ_rows, shm),
                                ("cornell_box.obj subset", cornell.occ_rows,
                                 shc),
                                (f"{SUBSET_ROWS}-row subset", sub2048, shs)):
            sets.append(("K2", what, table.shape[0], n,
                         (*sh, table, 0.01), dense._occluded_plain))
        for what, table, o, d in (("cornell_box.obj", cornell.rows, oc, dc),
                                  ("mixed box", mixed.rows, om, dm)):
            sets.append(("K1", what, table.shape[0], n, (o, d, table, 0.01),
                         dense._closest_plain))
        sets.append(("K3", "cornell_box.obj", cornell.rows.shape[0], n,
                     (oc, dc, cornell.rows, 0.01, 600.0, True),
                     lambda o, d, rows, tmin, tmax, uv: dense._closest_plain(
                         o, d, rows, tmin, tmax, True, uv)))
        sets.append(("K4", "cornell_box.obj", cornell.rows.shape[0], n,
                     (oc, dc, lz1, lz2, cornell.rows, cornell.occ_rows, light,
                      0.01), dense._closest_nee_plain))
    wrapper = {"K1": "closest_lean", "K2": "occluded", "K3": "closest_full",
               "K4": "closest_nee_lean"}

    def call(kernel, a):
        return getattr(dense, wrapper[kernel])(*a)

    def held(kernel, got, want, what):
        if kernel == "K4":       # the flag of a miss lane is meaningless
            hit = want[0] < 1e15
            got = (*got[:2], got[2] & hit)
            want = (*want[:2], want[2] & hit)
        same(got, want, what)

    for kernel, what, n_rows, n, a, plain in sets:
        held(kernel, call(kernel, a), plain(*a),
             f"{kernel} on {what} at {n} rays")

    kw = dict(use_direct_lighting=True, use_importance_sampling=True)
    recorded = {}
    accums = {}
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    frames = []
    for name, scene_file, cfg_kw in (REFERENCE, BENCH, CORNELL, CORNELL_NEE,
                                     CORNELL_CLIP):
        rec = (_Recorder(dense, RECORD[name]) if name in RECORD else None)
        accum, _, per = cs._render(scenes[scene_file], device,
                                   FRAMES[:1] if args.quick else FRAMES,
                                   tap=rec, **cfg_kw, **kw)
        if rec is not None:
            for k, calls in rec.calls.items():
                if calls:
                    recorded[(name, k)] = calls
        accums[name] = accum.cpu().numpy()
        frames.append((name, scene_file, cfg_kw, per))
    def plain_call(k, a):
        """The plain version of wrapper k on its positional arguments."""
        if k == "closest_full":
            o, d, rows, tmin, tmax, want_uv = a
            return dense._closest_plain(o, d, rows, tmin, tmax, True, want_uv)
        return {"closest_lean": dense._closest_plain,
                "occluded": dense._occluded_plain,
                "closest_nee_lean": dense._closest_nee_plain}[k](*a)

    for (name, k), calls in recorded.items():
        for a in calls[:8] + calls[-8:]:
            held(KERNEL[k], getattr(dense, k)(*a), plain_call(k, a),
                 f"{k} on a recorded {name} call")

    def replay(name, k):
        calls = recorded[(name, k)]
        return lambda: [getattr(dense, k)(*a) for a in calls]

    if args.inspect:
        log = _kernels.library_paths()["dense_intersect"].with_suffix(".log")
        for entry in _registers(log):
            out("ptxas", **entry)
        _dump_sass(pathlib.Path(args.inspect), out)
        for kernel, what, n_rows, n, a, plain in sets:
            if kernel == "K2":
                out("t in range", table=what, rows=n_rows, rays=n,
                    **_range_shares(*a))
        if hasattr(dense, "row_split"):
            for (name, k), calls in recorded.items():
                if k == "occluded":
                    out("groups met", table=f"{name}, {len(calls)} calls",
                        **_group_shares(dense, calls))
        for kernel, what, n_rows, n, a, plain in sets:
            if kernel in ("K1", "K3", "K4"):
                out("queued", kernel=kernel, table=what, rows=n_rows, rays=n,
                    **_queue_shares(dense, kernel, [a]))
        for (name, k), calls in recorded.items():
            if k != "occluded":
                out("queued", kernel=KERNEL[k],
                    table=f"{name}, {len(calls)} calls",
                    **_queue_shares(dense, KERNEL[k], calls))
        return 0

    for kernel, what, n_rows, n, a, plain in sets:
        fn = (lambda kernel=kernel, a=a: call(kernel, a))
        out(kernel, table=what, rows=n_rows, rays=n,
            kernel_ms=[device_ms(fn, 20) for _ in range(2)],
            events_ms=cs.gpu_ms(fn, 20))
    for (name, k), calls in recorded.items():
        out(KERNEL[k], table=f"{name}, {len(calls)} calls",
            kernel_ms=[device_ms(replay(name, k), 1) for _ in range(2)],
            events_ms=cs.gpu_ms(replay(name, k), 3))
    recorded.clear()
    if args.quick:
        return 0

    for name, scene_file, cfg_kw, per in frames:
        cfg = tp.RenderConfig(**cfg_kw, **kw)
        acc = init_accum(cfg, device=device)
        cs._zero_counters()
        t0 = time.perf_counter()
        busy, kernels, _ = _device_profile(lambda: render_frame(
            scenes[scene_file], cam, cfg, FRAMES[-1] + 1, acc))
        wall = (time.perf_counter() - t0) * 1e3
        counts = cs._read_counters()
        out("frame", frame=name,
            ms_per_frame=[p[0] * 1e3 for p in per[1:]],
            rounds=int(per[-1][2].wavefront_iterations), busy_ms=busy,
            profiled_wall_ms=wall, kernels_ms=kernels,
            launches={k: counts[k] for k in (*KERNEL, "closest_lean_tree")},
            accum_sha256=hashlib.sha256(
                accums[name].tobytes()).hexdigest()[:16])
    for name, scene_file in cs.JSON_GOLDENS:
        scene = tp.load_scene(str(cs.ASSETS / scene_file), device=device)
        cs._zero_counters()
        cs._render(scene, device, [0], width=128, height=128, spp=32,
                   max_depth=4, **kw)
        counts = cs._read_counters()
        out("golden frame", frame=f"{name} ({scene_file}), 128^2 x 32 spp",
            launches={k: counts[k] for k in ("closest_lean", "occluded")})
    if args.accums:
        _hold_accums(pathlib.Path(args.accums), accums, label, out)
    return 0


def _range_shares(o, d, tmax, rows, tmin: float) -> dict:
    """How much a lazy any-hit test (t first, the edge functions only for a
    pair whose t lies in (tmin, tmax)) could skip: the share of live (ray,
    opaque row) pairs in range, and the share of (warp of 32 rays, opaque
    row) steps, over warps with a live ray, in which some ray's pair is,
    which is what a warp executes. t as the kernels round it."""
    import torch
    live = tmax > tmin
    opaque = rows[:, 13] < 0.5
    n_w = o.shape[0] // 32 * 32
    pairs = steps = warp_steps = 0
    in_pairs = 0
    for s in range(0, n_w, 32768):
        e = min(s + 32768, n_w)
        oo, dd, tm = o[s:e], d[s:e], tmax[s:e, None]
        c = [rows[None, opaque, k] for k in range(4)]
        nd = c[0] * dd[:, 0:1] + c[1] * dd[:, 1:2] + c[2] * dd[:, 2:3]
        num = c[3] - (c[0] * oo[:, 0:1] + c[1] * oo[:, 1:2]
                      + c[2] * oo[:, 2:3])
        t = num * (1.0 / nd)
        ok = (t > tmin) & (t < tm) & live[s:e, None]
        in_pairs += int(ok.sum())
        pairs += int(live[s:e].sum()) * int(opaque.sum())
        warps = live[s:e].view(-1, 32).any(1)
        steps += int(warps.sum()) * int(opaque.sum())
        warp_steps += int(ok.view(-1, 32, ok.shape[1]).any(1).sum())
    return dict(pair_share=in_pairs / max(pairs, 1),
                warp_step_share=warp_steps / max(steps, 1))


# The warp queue that _queue_shares models: the rays a queue serves and
# the pairs a flush resolves, the rows queued between two looks for a
# flush, and its slots (32 waiting, plus 32 a row of a group).
QUEUE_WARP = 32
QUEUE_GROUP = 3
QUEUE_RING = 128


def _queue_shares(dense, kernel: str, calls) -> dict:
    """What a warp queue of the closest sweep's in-range pairs would do on
    the positional arguments ``calls`` of K1, K3 or K4 (its closest half):
    the share of (ray, row) pairs whose plane t is in range (tmin < t <
    the ray's best so far, and t < tmax), the flushes a warp of 32 rays
    makes, and the pairs a flush resolves (of 32). The kernels do not run
    this queue: it lost to the sweep of every pair on the card
    (PERF.md)."""
    pairs = kept = warps = flushes = 0
    for a in calls:
        if kernel == "K4":
            o, d, _, _, rows, _, _, tmin = a
            tmax = dense.T_FAR
        else:
            o, d, rows, tmin = a[:4]
            tmax = a[4] if kernel == "K3" else dense.T_FAR
        c = _queue_counts(dense, o, d, rows, tmin, tmax)
        pairs += o.shape[0] * rows.shape[0]
        kept += c[0]
        warps += -(-o.shape[0] // QUEUE_WARP)
        flushes += c[1]
    return dict(in_range_share=kept / max(pairs, 1),
                flushes_a_warp=flushes / max(warps, 1),
                pairs_a_flush=kept / max(flushes, 1))


def _queue_counts(dense, origins, dirs, tris, tmin: float,
                  tmax: float) -> tuple[int, int]:
    """(pairs kept, flushes) of the queue, step by step. Rays go in warps of
    QUEUE_WARP; rows in ascending order, in tiles of ``dense.SPLIT_TILE``
    (the rows a block stages). For each row every ray forms the plane
    half of ``dense._pe_block`` (n . d, its reciprocal, t) and keeps the
    pair when tmin < t < its best so far (and t < tmax), where its best
    is the fold of the pairs resolved until then: a stale best only keeps
    more pairs, so nothing is lost. Kept pairs join their warp's queue (a
    ring of QUEUE_RING slots) in (row, lane) order; after every
    QUEUE_GROUP rows of a tile, while QUEUE_WARP of them wait, the oldest
    QUEUE_WARP are resolved (the edge half of ``_pe_block``: t on a hit,
    else T_FAR) and folded into their rays' best, and at the end of each
    tile the rest."""
    import torch
    n, dev, lanes = origins.shape[0], origins.device, QUEUE_WARP
    warps = -(-n // lanes)
    # Lanes past the last ray hold a zero ray: n . d = 0, t is inf or NaN,
    # and no pair of it is kept.
    pad = warps * lanes - n
    o = torch.nn.functional.pad(origins, (0, 0, 0, pad))
    d = torch.nn.functional.pad(dirs, (0, 0, 0, pad))
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    best = torch.full((warps * lanes,), dense.T_FAR, dtype=torch.float32,
                      device=dev)
    q_ray = torch.zeros((warps, QUEUE_RING), dtype=torch.int64, device=dev)
    q_row = torch.zeros_like(q_ray)
    q_t = torch.zeros((warps, QUEUE_RING), dtype=torch.float32, device=dev)
    head = torch.zeros(warps, dtype=torch.int64, device=dev)
    tail = torch.zeros_like(head)
    first = torch.arange(warps, device=dev)[:, None] * lanes
    step = torch.arange(lanes, device=dev)
    kept = flushes = 0

    def flush(sel, take):
        """Resolve the oldest ``take[w]`` (<= QUEUE_WARP) pairs of each
        warp w in ``sel`` and fold them into their rays' best."""
        w = torch.nonzero(sel)[:, 0]
        valid = step[None, :] < take[w, None]
        pos = (head[w, None] + step[None, :]) % QUEUE_RING
        ray = q_ray[w[:, None], pos][valid]
        row = q_row[w[:, None], pos][valid]
        t = q_t[w[:, None], pos][valid]
        c = tris[row]
        px = ox[ray] + t * dx[ray]
        py = oy[ray] + t * dy[ray]
        pz = oz[ray] + t * dz[ray]
        u = c[:, 4] * px + c[:, 5] * py + c[:, 6] * pz + c[:, 7]
        v = c[:, 8] * px + c[:, 9] * py + c[:, 10] * pz + c[:, 11]
        hit = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
        best.scatter_reduce_(0, ray, torch.where(hit, t, dense.T_FAR),
                             "amin")
        head[w] += take[w]
        return int(w.numel())

    n_rows = tris.shape[0]
    for base in range(0, n_rows, dense.SPLIT_TILE):
        end = min(base + dense.SPLIT_TILE, n_rows)
        for j in range(base, end):
            nx, ny, nz, d0 = tris[j, 0], tris[j, 1], tris[j, 2], tris[j, 3]
            rcp = 1.0 / (nx * dx + ny * dy + nz * dz)
            t = (d0 - (nx * ox + ny * oy + nz * oz)) * rcp
            keep = ((t > tmin) & (t < best) & (t < tmax)).view(warps, lanes)
            before = torch.cumsum(keep, 1) - keep.long()
            wi, li = torch.nonzero(keep, as_tuple=True)
            at = ((tail[:, None] + before) % QUEUE_RING)[wi, li]
            q_ray[wi, at] = first[wi, 0] + li
            q_row[wi, at] = j
            q_t[wi, at] = t.view(warps, lanes)[wi, li]
            added = keep.sum(1)
            tail += added
            kept += int(added.sum())
            if (j - base) % QUEUE_GROUP == QUEUE_GROUP - 1 or j == end - 1:
                full = tail - head >= lanes
                while bool(full.any()):
                    flushes += flush(full, torch.full_like(head, lanes))
                    full = tail - head >= lanes
        rest = tail - head
        if bool((rest > 0).any()):
            flushes += flush(rest > 0, rest)
    return kept, flushes


def _group_shares(dense, calls) -> dict:
    """How often the shadow rays of recorded K2 calls meet each group of
    their table's ``row_split`` within (tmin, tmax): the share of (live
    ray, group) steps that meet, and of (warp of 32 rays, group) steps
    with a live ray in which some ray does (what one ray a thread would
    execute); the pair tests a ray makes (the rows every ray sweeps, and
    those of each group met) and the rows a warp would step through one
    ray a thread, beside the table's rows."""
    import torch
    ray_steps = warp_steps = ray_meet = warp_meet = 0
    ray_pairs = warp_pairs = rays = warps = 0
    rows = None
    for a in calls:
        o, d, tmax, table, tmin = a[:5]
        split = dense.row_split(table)
        rows = table.shape[0]
        spans = dense._split_spans(split)
        n = o.shape[0] // 32 * 32
        if not spans or n == 0:
            continue
        live = tmax[:n] > tmin
        meets = torch.stack([dense._split_meets(o[:n], d[:n], split, g, tmin,
                                                tmax[:n])
                             for g in range(len(spans))], 1) & live[:, None]
        count = torch.tensor([c for _, c in spans], dtype=torch.float64,
                             device=o.device)
        wm = meets.view(-1, 32, len(spans)).any(1)
        wl = live.view(-1, 32).any(1)
        rays += int(live.sum())
        warps += int(wl.sum())
        ray_steps += int(live.sum()) * len(spans)
        warp_steps += int(wl.sum()) * len(spans)
        ray_meet += int(meets.sum())
        warp_meet += int(wm.sum())
        ray_pairs += float((meets.double() * count).sum()) \
            + split.n_all * int(live.sum())
        warp_pairs += float((wm.double() * count).sum()) \
            + split.n_all * int(wl.sum())
    return dict(rows=rows, ray_share=ray_meet / max(ray_steps, 1),
                warp_share=warp_meet / max(warp_steps, 1),
                pairs_a_ray=ray_pairs / max(rays, 1),
                rows_a_warp_step=warp_pairs / max(warps, 1))


def _hold_accums(path: pathlib.Path, accums: dict, label: str, out) -> None:
    """Writes the frames' accumulators to ``path`` (.npz) when it does not
    exist, else holds them against the ones there: equal but for the order
    of the atomic adds of pixelq's index_add_ (at 128 spp several lanes
    finish items of one pixel in one round, so even one checkout's runs
    differ in the last bits), |a - b| <= ACCUM_RTOL max(|a|, |b|)."""
    import numpy as np
    if not path.exists():
        np.savez(path, **accums)
        out("accumulators", written_to=str(path))
        return
    with np.load(path) as want:
        for name, got in accums.items():
            ref = want[name]
            scale = np.maximum(np.abs(got), np.abs(ref))
            rel = float((np.abs(got - ref) / np.maximum(scale, 1e-30)).max())
            out("accumulators", frame=name, against=str(path),
                equal_share=float((got == ref).mean()), max_rel_diff=rel)
            if not rel <= ACCUM_RTOL:
                raise AssertionError(f"{label}: the {name} accumulator "
                                     f"differs from {path}'s by {rel}")


def _device_profile(run) -> tuple[float, dict, int]:
    """Device busy ms of run() (the summed time of the device's own
    events, torch.profiler with CUDA activity only: tracing the host's
    operators too slowed a frame of 280 rounds some thirtyfold), the ms of
    each of this package's kernels, and how many of them ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy, ours, count = 0.0, {}, 0
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        ms = (evt.time_range.end - evt.time_range.start) / 1e3
        busy += ms
        # "void (anonymous namespace)::name<...>(args)" -> "name<...>"
        name = evt.name.replace("(anonymous namespace)::", "").removeprefix(
            "void ").split("(")[0]
        if "_kernel" in name and "at::" not in name:
            ours[name] = ours.get(name, 0.0) + ms
            count += 1
    if busy <= 0.0:
        raise RuntimeError("the profile holds no device events")
    return busy, ours, count


def _dump_sass(where: pathlib.Path, out) -> None:
    """The SASS of the dense bodies of K1-K4 (K2's two), into
    ``where``."""
    from tpu_pt_torch import _kernels
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        out("sass", note="no cuobjdump in this toolkit")
        return
    lib = _kernels.library_paths()["dense_intersect"]
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    where.mkdir(parents=True, exist_ok=True)
    # Mangled names: closest_kernel<false>, closest_kernel<true>,
    # closest_nee_kernel, occluded_kernel and occluded_split_kernel.
    for kernel in ("14closest_kernelILb0E", "14closest_kernelILb1E",
                   "18closest_nee_kernelE", "15occluded_kernelE",
                   "21occluded_split_kernelE"):
        at = sass.find(kernel)
        if at < 0:
            out("sass", kernel=kernel, note="not found")
            continue
        body = sass[sass.rfind("\n", 0, at):]
        end = body.find("Function :", 20)
        body = body if end < 0 else body[:end]
        (where / f"{kernel}.sass").write_text(body)
        out("sass", kernel=kernel, instructions=len(re.findall(
            r"/\*[0-9a-f]{4}\*/", body)), file=str(where / f"{kernel}.sass"))


if __name__ == "__main__":
    sys.exit(main())
