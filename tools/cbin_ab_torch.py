#!/usr/bin/env python3
"""K13 (the cluster-binned path: its schedule, its kernels and the
completion pass) and K12's closest hit timed on the card, for a
side-by-side of two checkouts of the port; with ``--widths``, the trials
that set K13's job width and K12's closest tile and lanes a ray.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs. On the big mesh (``tools/make_assets.py --big``):

- K13's closest and any-hit through ``ablations.cbin_steps`` (the
  schedule, the kernel and the whole path ``closest_cbin_path`` /
  ``occluded_cbin_path`` apart, and the share of lanes left incomplete at
  the default caps, which sets what the completion pass costs), and K12's
  closest through ``ablations.stream_steps`` (its lists, the kernel and
  ``closest_stream_path``), on chip_smoke.py's rays at 32,768 (one lane in
  eight parked) and 262,144, and on ``tools/bench_incoherent_torch.py``'s
  262,144 incoherent rays;
- every K13 call and every K12 closest call (its completion pass) of one
  ``TPT_CBIN=1`` frame, and every K12 closest call of one ``TPT_STREAM=1``
  frame (frame 0 of chip_smoke.py's big-mesh run), recorded and replayed:
  the schedules, the kernels and the whole paths summed over the frame's
  calls;
- the big-mesh frame (512^2, 4 spp, depth 8, IS + NEE) lean, under
  ``TPT_CBIN=1`` and under ``TPT_STREAM=1``: frames 0-2 (ms of frames 1-2,
  host clock) and one more under ``torch.profiler`` (device busy: the
  summed time of the device's own events, and the time of each of the
  package's kernels), with a checksum of the accumulator.

``--widths`` (this checkout's kernels) runs instead: K13's schedule and
kernels at every job width of ``CBIN_JOB_TILES`` on the same rays and on
the ``TPT_CBIN=1`` frame's replayed calls (two rounds in turns), its list
step at every lane width, and K12's closest hit at tiles of 64, 128 and
256 and every lane width of ``clustered.GROUPS`` on the same rays and on
the ``TPT_STREAM=1`` frame's replayed closest calls: the trials that set
``CBIN_JOB_TILE``, ``CBIN_LIST_LANES``, ``STREAM_CLOSEST_TILE`` and
``stream_closest_group``.

Every result is held bitwise against K6's / K8's on the same rays.
Device times are CUDA events (chip_smoke.gpu_ms). Prints one JSON line
per measurement, each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/cbin_ab_torch.py [--root DIR] [--label NAME] [--widths]``.
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
VARIANTS = (("lean", {}), ("TPT_CBIN=1", dict(TPT_CBIN="1")),
            ("TPT_STREAM=1", dict(TPT_STREAM="1")))
STREAM_TILES = (64, 128, 256)
N_PARKED, N_WIDE = 32768, 262144      # chip_smoke.py's ray counts


def _record(mod, names, render) -> dict:
    """{name: [(args, kwargs)]} of every call of each ``mod.name`` while
    render() runs, its tensors cloned."""
    import torch
    real = {k: getattr(mod, k) for k in names}
    calls = {k: [] for k in names}

    def keep(a):
        return a.clone() if torch.is_tensor(a) else a

    def tap(name):
        def call(*args, **kw):
            calls[name].append((tuple(keep(a) for a in args),
                                {k: keep(v) for k, v in kw.items()}))
            return real[name](*args, **kw)
        return call
    for k in names:
        setattr(mod, k, tap(k))
    try:
        render()
    finally:
        for k, fn in real.items():
            setattr(mod, k, fn)
    return calls


def _parts(schedule):
    """(jtab, incomplete) of a K13 schedule: a CbinSchedule, or the tuple
    of ``cbin_pairs`` that checkouts before the schedule moved to the card
    return."""
    if hasattr(schedule, "incomplete"):
        return schedule.jtab, schedule.incomplete
    return schedule[1], schedule[3]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default=None)
    ap.add_argument("--widths", action="store_true")
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

    def k8_finish(o, d, tmax):
        return clustered.occluded_clustered(o, d, tmax, *table,
                                            nodes=tb.nodes)

    def cbin_path(o, d, tmax, occluded):
        if occluded:
            return (ablations.occluded_cbin_path(o, d, tmax, *table,
                                                 finish=k8_finish),)
        return ablations.closest_cbin_path(o, d, *table, tmax)

    def stream_path(o, d, tmax):
        return ablations.closest_stream_path(o, d, *table, tmax)

    def want(o, d, tmax, occluded):
        if occluded:
            return (k8_finish(o, d, tmax),)
        return clustered.closest_clustered(o, d, *table, tmax,
                                           nodes=tb.nodes)

    def same(got, ref, what):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: {what} differs from K6 / K8")

    def k6(o, d):
        return clustered.closest_clustered(o, d, *table, nodes=tb.nodes)

    sets = []
    for name, n, park in ((f"{N_PARKED} parked", N_PARKED, True),
                          (f"{N_WIDE}", N_WIDE, False)):
        o, d, shadow = cs._phase3_rays(big, device, 3, tb.rows, k6, n)
        if park:
            (o, d), shadow = cs._park((o, d), shadow, cs.PARK_EVERY)
        sets.append((name, (o, d, 1e16), shadow))
    o, d, tmax = cs._tool("bench_incoherent_torch").make_rays(big, N_WIDE,
                                                             device)
    sets.append((f"{N_WIDE} incoherent", (o, d, 1e16), (o, d, tmax)))

    kw = dict(cs.BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)

    def frame_calls(variables, names):
        with cs._env(**variables):
            return _record(ablations, names,
                           lambda: cs._render(big, device, [0], **kw))

    def steps_args(call):
        """(origins, dirs, tmax, occluded) of a recorded *_steps call (the
        paths pass ``occluded`` by name)."""
        a, kw_ = call
        return a[0], a[1], a[2], kw_.get("occluded", a[7:8] == (True,))
    rec = frame_calls(dict(TPT_CBIN="1"), ("cbin_steps", "closest_streamed"))
    cbin_frame = [steps_args(c) for c in rec["cbin_steps"]]
    completion = [c[0] for c in rec["closest_streamed"]]
    rec = frame_calls(dict(TPT_STREAM="1"), ("stream_steps",))
    stream_frame = [c for c in map(steps_args, rec["stream_steps"])
                    if not c[3]]
    del rec
    cbin_name = f"TPT_CBIN=1 frame, {len(cbin_frame)} calls"
    stream_name = f"TPT_STREAM=1 frame, {len(stream_frame)} closest calls"
    for c in cbin_frame:
        same(cbin_path(*c), want(*c), "K13 on a frame call")
    for c in stream_frame:
        same(stream_path(*c[:3]), want(*c), "K12 closest on a frame call")

    def turns(fns: dict, reps: int = 3) -> dict:
        """Each fn timed twice, the second round in the reverse order:
        {key: [ms, ms]}."""
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cs.gpu_ms(fns[k], reps))
        return runs

    if args.widths:
        return _widths(ablations, clustered, cs, table, sets, cbin_frame,
                       stream_frame, cbin_name, stream_name, cbin_path,
                       want, same, turns, out)

    for name, closest, shadow in sets:
        for side, c, occluded in (("closest", closest, False),
                                  ("any-hit", shadow, True)):
            _, build, kernel = ablations.cbin_steps(*c, *table[:3], 0.01,
                                                    occluded)
            sch = build()
            jtab, inc = _parts(sch)
            same(cbin_path(*c, occluded), want(*c, occluded),
                 f"K13 {side} at {name}")
            out(f"K13 {side}", rays=name,
                build_ms=cs.gpu_ms(build, 10),
                kernel_ms=cs.gpu_ms(lambda: kernel(sch), 10),
                path_ms=cs.gpu_ms(lambda: cbin_path(*c, occluded), 5),
                jobs=int((jtab >= 0).sum()), job_cap=int(jtab.shape[0]),
                incomplete_share=float(inc.float().mean()))
        _, build, kernel = ablations.stream_steps(*closest, *table[:3], 0.01,
                                                  False)
        lists = build()
        same(stream_path(*closest), want(*closest, False),
             f"K12 closest at {name}")
        out("K12 closest", rays=name, lists_ms=cs.gpu_ms(build, 10),
            kernel_ms=cs.gpu_ms(lambda: kernel(lists), 10),
            path_ms=cs.gpu_ms(lambda: stream_path(*closest), 5),
            listed_boxes_per_tile=float(lists[2].float().mean()))
    steps = [ablations.cbin_steps(*c[:3], *table[:3], 0.01, c[3])[1:]
             for c in cbin_frame]
    scheds = [build() for build, _ in steps]
    out("K13 both sides", rays=cbin_name,
        build_ms=cs.gpu_ms(lambda: [b() for b, _ in steps], 3),
        kernel_ms=cs.gpu_ms(lambda: [k(s) for (_, k), s in
                                     zip(steps, scheds)], 3),
        path_ms=cs.gpu_ms(lambda: [cbin_path(*c) for c in cbin_frame], 3),
        incomplete_share=[float(_parts(s)[1].float().mean())
                          for s in scheds])
    out("K12 closest, K13's completion pass", rays=cbin_name,
        calls=len(completion),
        kernel_ms=cs.gpu_ms(lambda: [ablations.closest_streamed(*a)
                                     for a in completion], 3))
    del steps, scheds
    steps = [ablations.stream_steps(*c[:3], *table[:3], 0.01, False)[1:]
             for c in stream_frame]
    lists = [build() for build, _ in steps]
    out("K12 closest", rays=stream_name,
        lists_ms=cs.gpu_ms(lambda: [b() for b, _ in steps], 3),
        kernel_ms=cs.gpu_ms(lambda: [k(x) for (_, k), x in
                                     zip(steps, lists)], 3),
        path_ms=cs.gpu_ms(lambda: [stream_path(*c[:3])
                                   for c in stream_frame], 3))
    del steps, lists, cbin_frame, stream_frame, completion

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


def _widths(ablations, clustered, cs, table, sets, cbin_frame, stream_frame,
            cbin_name, stream_name, cbin_path, want, same, turns, out) -> int:
    """The width trials (this checkout's kernels): K13's job width and
    list lanes, K12's closest tile and lanes a ray."""
    shipped = ablations.CBIN_JOB_TILE
    for rt in ablations.CBIN_JOB_TILES:
        ablations.CBIN_JOB_TILE = rt         # the paths' width below
        for name, closest, shadow in sets:
            for side, c, occluded in (("closest", closest, False),
                                      ("any-hit", shadow, True)):
                _, build, kernel = ablations.cbin_steps(
                    *c, *table[:3], 0.01, occluded, rt)
                sch = build()
                same(cbin_path(*c, occluded), want(*c, occluded),
                     f"K13 {side} at {name}, jobs of {rt}")
                out(f"K13 {side}", rays=name, job=rt,
                    build_ms=cs.gpu_ms(build, 10),
                    kernel_ms=cs.gpu_ms(lambda: kernel(sch), 10),
                    jobs=int((sch.jtab >= 0).sum()),
                    incomplete_share=float(sch.incomplete.float().mean()))
        for c in cbin_frame:
            same(cbin_path(*c), want(*c), f"K13 on a frame call at {rt}")
    ablations.CBIN_JOB_TILE = shipped
    steps = {rt: [ablations.cbin_steps(*c[:3], *table[:3], 0.01, c[3],
                                       rt)[1:] for c in cbin_frame]
             for rt in ablations.CBIN_JOB_TILES}
    scheds = {rt: [b() for b, _ in st] for rt, st in steps.items()}
    sched_runs = turns({rt: lambda st=st: [b() for b, _ in st]
                        for rt, st in steps.items()})
    kernel_runs = turns({rt: lambda st=st, sc=scheds[rt]:
                         [k(s) for (_, k), s in zip(st, sc)]
                         for rt, st in steps.items()})
    for rt in steps:
        out("K13 both sides", rays=cbin_name, job=rt,
            build_ms_runs=sched_runs[rt], kernel_ms_runs=kernel_runs[rt],
            incomplete_share=sum(float(s.incomplete.float().mean())
                                 for s in scheds[rt]) / len(scheds[rt]))
    # The list step's lanes a group, at the shipped width, on the frame's
    # calls (held against the plain schedule on the first set).
    packed = [ablations.pack_rays(*c[:3], ablations._pad_tile(
        c[0].shape[0], 256)) for c in cbin_frame]
    r8 = ablations.pack_rays(*sets[0][1], sets[0][1][0].shape[0])
    ref = ablations._cbin_schedule(r8, *table[1:3], 0.01, shipped)
    lanes = [w for w in clustered.GROUPS if w >= ref.meta[1]]
    for w in lanes:
        cs._compare_cbin_schedule(
            f"cbin_schedule at {w} lanes", ablations.cbin_schedule(
                r8, *table[1:3], 0.01, shipped, w), ref)
    lane_runs = turns({w: lambda w=w: [ablations.cbin_schedule(
        r, *table[1:3], 0.01, shipped, w) for r in packed] for w in lanes})
    for w, r in lane_runs.items():
        out("cbin_schedule", rays=cbin_name, job=shipped, lanes=w,
            ms_runs=r)
    del steps, scheds, packed

    # K12's closest hit: every tile and lanes a ray, on the same rays and
    # the frame's calls.
    def stream_call(o, d, tmax, tile, g):
        """(build, kernel) of K12's closest hit at tiles of ``tile`` and
        ``g`` lanes a ray; kernel(lists)."""
        r = ablations.pack_rays(o, d, tmax, ablations._pad_tile(o.shape[0],
                                                                tile))

        def build():
            return ablations.stream_lists(r, *table[1:3], tile, 0.01, tmax)

        def kernel(lists):
            return ablations.closest_streamed(r, *table[:3], lists, tile,
                                              0.01, tmax, True, group=g)
        return build, kernel
    for name, closest, _ in sets:
        ref = want(*closest, False)
        n = closest[0].shape[0]
        for tile in STREAM_TILES:
            for g in clustered.GROUPS:
                build, kernel = stream_call(*closest, tile, g)
                lists = build()
                got = kernel(lists)
                same((got[0][:n], got[1][:n]), ref,
                     f"K12 closest at {name}, tiles of {tile}, {g} lanes")
                out("K12 closest", rays=name, tile=tile, group=g,
                    kernel_ms=cs.gpu_ms(lambda: kernel(lists), 10),
                    lists_ms=cs.gpu_ms(build, 5))
    calls = {}
    for tile in STREAM_TILES:
        for g in clustered.GROUPS:
            steps = [stream_call(*c[:3], tile, g) for c in stream_frame]
            calls[tile, g] = [(b, k, b()) for b, k in steps]
            for c, (_, k, lists) in zip(stream_frame, calls[tile, g]):
                n = c[0].shape[0]
                got = k(lists)
                same((got[0][:n], got[1][:n]), want(*c),
                     f"K12 closest on a frame call, tiles of {tile}, {g} "
                     "lanes")
    runs = turns({key: lambda st=st: [k(lists) for _, k, lists in st]
                  for key, st in calls.items()})
    list_runs = turns({tile: lambda st=calls[tile, 4]: [b() for b, _, _ in st]
                       for tile in STREAM_TILES})
    for (tile, g), r in runs.items():
        out("K12 closest", rays=stream_name, tile=tile, group=g,
            kernel_ms_runs=r, lists_ms_runs=list_runs[tile])
    return 0


if __name__ == "__main__":
    sys.exit(main())
