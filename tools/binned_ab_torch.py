#!/usr/bin/env python3
"""K14 (the pair-binned path: its pair schedule, its kernels and the
completion pass) timed on the card, for a side-by-side of two checkouts
of the port; with ``--tiles``, the trial that sets its tile width.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs. On the big mesh (``tools/make_assets.py --big``):

- ``closest_binned_path`` / ``occluded_binned_path`` through
  ``ablations.binned_steps`` (the schedule build, the kernel and the
  whole path apart) on chip_smoke.py's rays at 32,768 (one lane in eight
  parked) and 262,144, and on ``tools/bench_incoherent_torch.py``'s
  262,144 incoherent rays;
- every K14 call of one ``TPT_BINNED=1`` frame (frame 0 of chip_smoke.py's
  big-mesh run), recorded and replayed: the schedule builds, the kernels
  and the whole paths summed over the frame's calls;
- the big-mesh frame (512^2, 4 spp, depth 8, IS + NEE) lean and under
  ``TPT_BINNED=1``: frames 0-2 (ms of frames 1-2, host clock) and one
  more under ``torch.profiler`` (device busy: the summed time of the
  device's own events, and the time of each of the package's kernels),
  with a checksum of the accumulator.

``--tiles`` (a checkout whose kernels take ``tile``: ``BINNED_TILES``)
runs instead, at every tile width, the schedule and the kernel on the
same rays and on the frame's replayed calls (two rounds in turns), and
then the schedule at every group width of its select step
(``PAIR_GROUPS``) on the same rays and calls, and prints the ms of
each: the trial that sets ``BINNED_TILE`` and ``pair_group``.

Every result is held bitwise against K6's / K8's on the same rays.
Device times are CUDA events (chip_smoke.gpu_ms). Prints one JSON line
per measurement, each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/binned_ab_torch.py [--root DIR] [--label NAME] [--tiles]``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
FRAMES = [0, 1, 2]
VARIANTS = (("lean", {}), ("TPT_BINNED=1", dict(TPT_BINNED="1")))


def _record(mod, name: str, render) -> list:
    """(args, kwargs) of every call of ``mod.name`` while render() runs,
    its tensors cloned."""
    import torch
    real, calls = getattr(mod, name), []

    def keep(a):
        return a.clone() if torch.is_tensor(a) else a

    def tap(*args, **kw):
        calls.append((tuple(keep(a) for a in args),
                      {k: keep(v) for k, v in kw.items()}))
        return real(*args, **kw)
    setattr(mod, name, tap)
    try:
        render()
    finally:
        setattr(mod, name, real)
    return calls


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default=None)
    ap.add_argument("--tiles", action="store_true")
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
    from tpu_pt_torch.intersect import ablations, clustered
    from tpu_pt_torch.render import CameraArrays, init_accum, render_frame
    device, smi = cs.phase_device()
    _kernels.build()
    big = cs.phase_assets(device)
    tb = clustered.prepare(big)
    table = (tb.rows, tb.boxes, tb.scale, 0.01)

    def out(what: str, **kw) -> None:
        print(json.dumps({"label": label, "root": str(root), "what": what,
                          **kw, "device": smi}), flush=True)

    def k6(o, d):
        return clustered.closest_clustered(o, d, *table, nodes=tb.nodes)

    def k8(o, d, tmax):
        return clustered.occluded_clustered(o, d, tmax, *table,
                                            nodes=tb.nodes)

    def path(o, d, tmax, occluded):
        """K14's whole path, and K6's / K8's answer in its terms."""
        if occluded:
            return (ablations.occluded_binned_path(o, d, tmax, *table,
                                                   nodes=tb.nodes),)
        h = ablations.closest_binned_path(o, d, *table, tmax,
                                          nodes=tb.nodes)
        return h.t, h.tri

    def want(o, d, tmax, occluded):
        if occluded:
            return (k8(o, d, tmax),)
        t, row = clustered.closest_clustered(o, d, *table, tmax,
                                             nodes=tb.nodes)
        return t, torch.where(t < 1e15, tb.rows[row.long(), 15],
                              0.0).to(torch.int32)

    def same(got, ref, what):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: {what} differs from K6 / K8")

    sets = []
    for name, n, park in (("32768 parked", 32768, True),
                          ("262144", 262144, False)):
        o, d, shadow = cs._phase3_rays(big, device, 3, tb.rows, k6, n)
        if park:
            (o, d), shadow = cs._park((o, d), shadow, cs.PARK_EVERY)
        sets.append((name, (o, d, 1e16), shadow))
    o, d, tmax = cs._tool("bench_incoherent_torch").make_rays(big, 262144,
                                                             device)
    sets.append(("262144 incoherent", (o, d, 1e16), (o, d, tmax)))

    kw = dict(cs.BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)
    with cs._env(TPT_BINNED="1"):
        calls = _record(ablations, "binned_steps",
                        lambda: cs._render(big, device, [0], **kw))
    # (origins, dirs, tmax, occluded) of each K14 call of the frame (the
    # paths pass ``occluded`` by name).
    frame = [(a[0], a[1], a[2], kw_.get("occluded", a[7:8] == (True,)))
             for a, kw_ in calls]
    frame_name = f"TPT_BINNED=1 frame, {len(frame)} calls"

    if args.tiles:
        shipped = ablations.BINNED_TILE
        for t in ablations.BINNED_TILES:
            ablations.BINNED_TILE = t        # the paths' width below
            for name, closest, shadow in sets:
                for side, c, occluded in (("closest", closest, False),
                                          ("any-hit", shadow, True)):
                    _, build, kernel = ablations.binned_steps(
                        *c, *table[:3], 0.01, occluded, tile=t)
                    sch = build()
                    same(path(*c, occluded), want(*c, occluded),
                         f"K14 {side} at {name}")
                    out(f"K14 {side}", rays=name, tile=t,
                        build_ms=cs.gpu_ms(build, 10),
                        kernel_ms=cs.gpu_ms(lambda: kernel(sch), 10),
                        live_tiles=int(((sch.pair_ray >= 0).view(-1, t)
                                        .any(1)).sum()),
                        tiles=int(sch.tile_sid.shape[0]))
            for c in frame:
                same(path(*c), want(*c), f"K14 on a frame call at tile {t}")
        # The frame's calls at every width, in turns: two rounds, the
        # second in the reverse order.
        steps = {t: [ablations.binned_steps(*c[:3], *table[:3], 0.01, c[3],
                                            tile=t)[1:] for c in frame]
                 for t in ablations.BINNED_TILES}
        scheds = {t: [build() for build, _ in st] for t, st in steps.items()}
        runs = {t: [] for t in steps}
        for order in (list(steps), list(steps)[::-1]):
            for t in order:
                runs[t].append((
                    cs.gpu_ms(lambda: [b() for b, _ in steps[t]], 3),
                    cs.gpu_ms(lambda: [k(s) for (_, k), s in
                                       zip(steps[t], scheds[t])], 3)))
        for t, r in runs.items():
            out("K14 both sides", rays=frame_name, tile=t,
                build_ms=sum(b for b, _ in r) / len(r),
                kernel_ms=sum(k for _, k in r) / len(r),
                kernel_ms_runs=[k for _, k in r])
        del steps, scheds
        # The schedule's select step at every group width G, at the
        # shipped tile: held against _pair_schedule, timed on the same
        # rays and (two rounds in turns) on the frame's calls.
        t = ablations.BINNED_TILE = shipped
        packed = []
        for name, closest, shadow in sets:
            packed += [(f"closest, {name}",
                        ablations.pack_rays(*closest, closest[0].shape[0]),
                        False),
                       (f"any-hit, {name}",
                        ablations.pack_rays(*shadow, shadow[0].shape[0]),
                        True)]
        calls_8 = [(ablations.pack_rays(*c[:3], c[0].shape[0]), c[3])
                   for c in frame]

        def schedule(r8, occluded, g, build=ablations.pair_schedule):
            return build(r8, tb.boxes, tb.scale, ablations.PAIR_K, 0.01,
                         r8[:, 6] if occluded else 1e16, t,
                         *((g,) if g else ()))
        for name, r8, occluded in packed:
            ref = schedule(r8, occluded, None, ablations._pair_schedule)
            for g in ablations.PAIR_GROUPS:
                cs._compare_schedule(f"pair_schedule at {g} lanes",
                                     schedule(r8, occluded, g), ref)
                out("pair_schedule", rays=name, group=g, tile=t,
                    ms=cs.gpu_ms(lambda: schedule(r8, occluded, g), 10))
        group_runs = {g: [] for g in ablations.PAIR_GROUPS}
        for order in (list(group_runs), list(group_runs)[::-1]):
            for g in order:
                group_runs[g].append(cs.gpu_ms(
                    lambda: [schedule(r8, occ, g) for r8, occ in calls_8],
                    3))
        for g, r in group_runs.items():
            out("pair_schedule", rays=frame_name, group=g, tile=t,
                ms=sum(r) / len(r), ms_runs=r)
        return 0

    for name, closest, shadow in sets:
        for side, c, occluded in (("closest", closest, False),
                                  ("any-hit", shadow, True)):
            _, build, kernel = ablations.binned_steps(*c, *table[:3], 0.01,
                                                      occluded)
            sch = build()
            same(path(*c, occluded), want(*c, occluded),
                 f"K14 {side} at {name}")
            out(f"K14 {side}", rays=name,
                build_ms=cs.gpu_ms(build, 10),
                kernel_ms=cs.gpu_ms(lambda: kernel(sch), 10),
                path_ms=cs.gpu_ms(lambda: path(*c, occluded), 5),
                tiles=int(sch.tile_sid.shape[0]),
                tile=int(sch.pair_ray.shape[0] // sch.tile_sid.shape[0]),
                overflow_share=float(sch.overflow.float().mean()))
    for c in frame:
        same(path(*c), want(*c), "K14 on a frame call")
    steps = [ablations.binned_steps(*c[:3], *table[:3], 0.01, c[3])[1:]
             for c in frame]
    scheds = [build() for build, _ in steps]
    out("K14 both sides", rays=frame_name,
        build_ms=cs.gpu_ms(lambda: [b() for b, _ in steps], 3),
        kernel_ms=cs.gpu_ms(lambda: [k(s) for (_, k), s in
                                     zip(steps, scheds)], 3),
        path_ms=cs.gpu_ms(lambda: [path(*c) for c in frame], 3))
    del steps, scheds, calls, frame

    profiled = cs._tool("shadow_lists_ab_torch")._profiled
    cfg = tp.RenderConfig(**kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    for what, variables in VARIANTS:
        with cs._env(**variables):
            accum, _, per = cs._render(big, device, FRAMES, **kw)
            digest = hashlib.sha256(accum.cpu().numpy().tobytes()).hexdigest()
            acc = init_accum(cfg, device=device)
            t0 = time.perf_counter()
            busy, kernels = profiled(lambda: render_frame(big, cam, cfg, 3,
                                                          acc))
            wall = (time.perf_counter() - t0) * 1e3
        out("frame", variant=what, ms_per_frame=[p[0] * 1e3 for p in per[1:]],
            rounds=int(per[-1][2].wavefront_iterations),
            busy_ms=busy, profiled_wall_ms=wall, kernels_ms=kernels,
            accum_sha256=digest[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
