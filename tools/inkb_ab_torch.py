#!/usr/bin/env python3
"""K7 lean and K7 full (the kernels that build each ray's list of boxes
inside the kernel, ``TPT_INKB=1``) timed on the card, for a side-by-side of
two checkouts of the port; with ``--widths``, the trial that sets their
lanes a ray.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs. On the big mesh (``tools/make_assets.py --big``):

- ``clustered.closest_clustered_b`` (K7 lean) and
  ``closest_clustered_full_b`` (K7 full, with u and v) on chip_smoke.py's
  rays at 32,768 (one lane in eight parked) and 262,144, and on
  ``tools/bench_incoherent_torch.py``'s 262,144 incoherent rays; K11
  (``ablations.closest_rotated``, unknown prediction), which runs the same
  box loop a slab at a time, on the same rays;
- every K7 lean call of one ``TPT_INKB=1`` frame and every K7 full call of
  one ``TPT_INKB=1 TPT_LEAN_BIG=0`` frame (frame 0 of chip_smoke.py's
  big-mesh run), recorded and replayed;
- the big-mesh frame (512^2, 4 spp, depth 8, IS + NEE) lean, under
  ``TPT_INKB=1`` and under ``TPT_INKB=1 TPT_LEAN_BIG=0``: frames 0-2 (ms of
  frames 1-2, host clock) and one more under ``torch.profiler`` (device
  busy: the summed time of the device's own events, and the time of each
  of the package's kernels), with a checksum of the accumulator, which
  must equal the lean frame's.

``--widths`` (this checkout's kernels) runs instead: K7 lean and full at
every width of ``clustered.GROUPS`` on the same rays and on the frames'
replayed calls (two rounds in turns).

Every result is held bitwise against K6's / K6f's on the same rays.
Device times are CUDA events (chip_smoke.gpu_ms). Prints one JSON line
per measurement, each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/inkb_ab_torch.py [--root DIR] [--label NAME] [--widths]``.
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
VARIANTS = (("lean", {}), ("TPT_INKB=1", dict(TPT_INKB="1")),
            ("TPT_INKB=1 TPT_LEAN_BIG=0",
             dict(TPT_INKB="1", TPT_LEAN_BIG="0")))
N_PARKED, N_WIDE = 32768, 262144      # chip_smoke.py's ray counts


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
    table = (tb.rows, tb.boxes, tb.scale)
    srows = clustered._clustered_slab_rows(tb.rows.shape[0])
    record = cs._tool("cbin_ab_torch")._record

    def out(what: str, **kw) -> None:
        print(json.dumps({"label": label, "root": str(root), "what": what,
                          **kw, "device": smi}), flush=True)

    def k7(o, d, tmax=1e16, **kw):
        return clustered.closest_clustered_b(o, d, *table, 0.01, tmax, **kw)

    def k7f(o, d, tmax=1e16, want_uv=True, **kw):
        return clustered.closest_clustered_full_b(o, d, *table, 0.01, tmax,
                                                  want_uv, **kw)

    def want(o, d, tmax=1e16, want_uv=None):
        """K6's result, or K6f's with ``want_uv`` not None."""
        if want_uv is None:
            return clustered.closest_clustered(o, d, *table, 0.01, tmax,
                                               nodes=tb.nodes)
        return clustered.closest_clustered_full(o, d, *table, 0.01, tmax,
                                                want_uv, nodes=tb.nodes)

    def same(got, ref, what):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: {what} differs from K6 / K6f")

    sets = []
    for name, n, park in ((f"{N_PARKED} parked", N_PARKED, True),
                          (f"{N_WIDE}", N_WIDE, False)):
        o, d, shadow = cs._phase3_rays(big, device, 3, tb.rows,
                                       lambda o, d: want(o, d), n)
        if park:
            (o, d), _ = cs._park((o, d), shadow, cs.PARK_EVERY)
        sets.append((name, (o, d)))
    o, d, _ = cs._tool("bench_incoherent_torch").make_rays(big, N_WIDE,
                                                           device)
    sets.append((f"{N_WIDE} incoherent", (o, d)))

    kw = dict(cs.BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)

    def frame_calls(variables, name):
        """(origins, dirs, tmax, want_uv or None) of every call of
        ``clustered.name`` in frame 0 under ``variables``."""
        with cs._env(**variables):
            rec = record(clustered, (name,),
                         lambda: cs._render(big, device, [0], **kw))
        calls = []
        for a, kw_ in rec[name]:
            tmax = a[6] if len(a) > 6 else kw_.get("tmax", 1e16)
            uv = None
            if name == "closest_clustered_full_b":
                uv = a[7] if len(a) > 7 else kw_.get("want_uv", True)
            calls.append((a[0], a[1], tmax, uv))
        return calls
    frames = {
        "lean": frame_calls(VARIANTS[1][1], "closest_clustered_b"),
        "full": frame_calls(VARIANTS[2][1], "closest_clustered_full_b")}
    names = {k: f"{VARIANTS[1 if k == 'lean' else 2][0]} frame, "
                f"{len(c)} calls" for k, c in frames.items()}

    def kernel_of(kind):
        return k7 if kind == "lean" else k7f

    def replay(kind, **kw_):
        fn = kernel_of(kind)
        return [fn(o, d, tmax, *(() if uv is None else (uv,)), **kw_)
                for o, d, tmax, uv in frames[kind]]
    for kind, calls in frames.items():
        for (o, d, tmax, uv), got in zip(calls, replay(kind)):
            same(got, want(o, d, tmax, uv), f"K7 {kind} on a frame call")

    def turns(fns: dict, reps: int = 3) -> dict:
        """Each fn timed twice, the second round in the reverse order:
        {key: [ms, ms]}."""
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cs.gpu_ms(fns[k], reps))
        return runs

    if args.widths:
        groups = clustered.GROUPS
        for name, (o, d) in sets:
            for kind, uv in (("lean", None), ("full", True)):
                ref = want(o, d, 1e16, uv)
                for g in groups:
                    def call(g=g, kind=kind):
                        return kernel_of(kind)(o, d, group=g)
                    same(call(), ref, f"K7 {kind} at {name}, {g} lanes")
                runs = turns({g: lambda g=g, kind=kind: kernel_of(kind)(
                    o, d, group=g) for g in groups}, reps=5)
                for g, r in runs.items():
                    out(f"K7 {kind}", rays=name, group=g, kernel_ms_runs=r)
        for kind, calls in frames.items():
            for g in groups:
                for (o, d, tmax, uv), got in zip(calls,
                                                 replay(kind, group=g)):
                    same(got, want(o, d, tmax, uv),
                         f"K7 {kind} on a frame call, {g} lanes")
            runs = turns({g: lambda g=g, kind=kind: replay(kind, group=g)
                          for g in groups})
            for g, r in runs.items():
                out(f"K7 {kind}", rays=names[kind], group=g,
                    kernel_ms_runs=r)
        return 0

    for name, (o, d) in sets:
        for kind, uv in (("lean", None), ("full", True)):
            ref = want(o, d, 1e16, uv)
            same(kernel_of(kind)(o, d), ref, f"K7 {kind} at {name}")
            out(f"K7 {kind}", rays=name, kernel_ms=cs.gpu_ms(
                lambda kind=kind: kernel_of(kind)(o, d), 10))
        unknown = torch.full((o.shape[0],), clustered.SLAB_UNKNOWN,
                             dtype=torch.int32, device=device)

        def k11():
            return ablations.closest_rotated(o, d, *table, unknown, srows,
                                             0.01)
        same(k11(), want(o, d), f"K11 at {name}")
        out("K11", rays=name, prediction="unknown",
            kernel_ms=cs.gpu_ms(k11, 10))
    for kind in frames:
        out(f"K7 {kind}", rays=names[kind],
            kernel_ms=cs.gpu_ms(lambda kind=kind: replay(kind), 3))
    del frames

    profiled = cs._tool("shadow_lists_ab_torch")._profiled
    cfg = tp.RenderConfig(**kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    digests = {}
    for what, variables in VARIANTS:
        with cs._env(**variables):
            accum, _, per = cs._render(big, device, FRAMES, **kw)
            digest = hashlib.sha256(accum.cpu().numpy().tobytes()).hexdigest()
            acc = init_accum(cfg, device=device)
            t0 = time.perf_counter()
            busy, kernels = profiled(lambda: render_frame(big, cam, cfg, 3,
                                                          acc))
            wall = (time.perf_counter() - t0) * 1e3
        digests[what] = digest
        out("frame", variant=what, ms_per_frame=[p[0] * 1e3 for p in per[1:]],
            rounds=int(per[-1][2].wavefront_iterations),
            busy_ms=busy, profiled_wall_ms=wall, kernels_ms=kernels,
            accum_sha256=digest[:16])
    if len(set(digests.values())) != 1:
        raise AssertionError(f"{label}: the frames' accumulators differ from "
                             f"the lean one: {digests}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
