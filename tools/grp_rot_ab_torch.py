#!/usr/bin/env python3
"""K15 (the 8-lane groups, serial and bundled, with their 8-ray lists) and
K11 (the rotated chain) timed on the card, for a side-by-side of two
checkouts of the port; with ``--widths``, the trials that set their lanes
a ray and the route of K15's lists.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs. On the big mesh (``tools/make_assets.py --big``):

- K15's closest hit and any-hit, serial (``TPT_GRP=1``) and bundled
  (``TPT_GRP=2``), through ``ablations.grp_steps`` (the 8-ray lists and the
  kernel apart), and K11 (``ablations.closest_rotated``, under the oracle
  and the unknown prediction), on chip_smoke.py's rays at 32,768 (one lane
  in eight parked) and 262,144, and on ``tools/bench_incoherent_torch.py``'s
  262,144 incoherent rays;
- every K15 call of one ``TPT_GRP=1`` frame and every K11 call of one
  ``TPT_SEED=1`` frame (frame 0 of chip_smoke.py's big-mesh run, with its
  recorded predictions), recorded and replayed: the lists and the kernels
  summed over the frame's calls;
- the big-mesh frame (512^2, 4 spp, depth 8, IS + NEE) lean, under
  ``TPT_GRP=1``, ``TPT_GRP=2`` and ``TPT_SEED=1``: frames 0-2 (ms of frames
  1-2, host clock) and one more under ``torch.profiler`` (device busy: the
  summed time of the device's own events, and the time of each of the
  package's kernels), with a checksum of the accumulator.

``--widths`` (this checkout's kernels) runs instead: K15 at every width of
``clustered.GROUPS``, serial and bundled, on the same rays and on the
``TPT_GRP=1`` frame's replayed calls (two rounds in turns); its 8-ray lists
on each route that takes them (``ablations.list_route``'s ``small`` and
``shared``); K11 at every width on the same rays and on the ``TPT_SEED=1``
frame's replayed calls.

Every result is held bitwise against K6's / K8's on the same rays.
Device times are CUDA events (chip_smoke.gpu_ms). Prints one JSON line
per measurement, each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/grp_rot_ab_torch.py [--root DIR] [--label NAME] [--widths]``.
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
VARIANTS = (("lean", {}), ("TPT_GRP=1", dict(TPT_GRP="1")),
            ("TPT_GRP=2", dict(TPT_GRP="2")), ("TPT_SEED=1", dict(TPT_SEED="1")))
BODIES = (("serial", "1"), ("bundled", "2"))
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
    s_count = -(-tb.rows.shape[0] // srows)
    lanes = ablations.GRP_LANES
    record = cs._tool("cbin_ab_torch")._record

    def out(what: str, **kw) -> None:
        print(json.dumps({"label": label, "root": str(root), "what": what,
                          **kw, "device": smi}), flush=True)

    def k6(o, d):
        return clustered.closest_clustered(o, d, *table, 0.01,
                                           nodes=tb.nodes)

    def k8(o, d, tmax):
        return clustered.occluded_clustered(o, d, tmax, *table, 0.01,
                                            tb.nodes)

    def same(got, ref, what):
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            raise AssertionError(f"{label}: {what} differs from K6 / K8")

    def unknown(n):
        return torch.full((n,), clustered.SLAB_UNKNOWN, dtype=torch.int32,
                          device=device)

    # (name, closest (o, d), shadow (o, d, tmax), {prediction: pred}).
    sets = []
    for name, n, park in ((f"{N_PARKED} parked", N_PARKED, True),
                          (f"{N_WIDE}", N_WIDE, False)):
        o, d, shadow = cs._phase3_rays(big, device, 3, tb.rows, k6, n)
        if park:
            (o, d), shadow = cs._park((o, d), shadow, cs.PARK_EVERY)
        t6, row6 = k6(o, d)
        oracle = torch.where(t6 < 1e15, row6 // srows,
                             clustered.SLAB_UNKNOWN).to(torch.int32)
        sets.append((name, (o, d), shadow,
                     {"oracle": oracle, "unknown": unknown(n)}))
    o, d, tmax = cs._tool("bench_incoherent_torch").make_rays(big, N_WIDE,
                                                             device)
    sets.append((f"{N_WIDE} incoherent", (o, d), (o, d, tmax),
                 {"unknown": unknown(N_WIDE)}))

    kw = dict(cs.BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)

    def frame_calls(variables, names):
        with cs._env(**variables):
            return record(ablations, names,
                          lambda: cs._render(big, device, [0], **kw))

    def grp_call(o, d, tmax, occluded):
        """(build, kernel) of K15 on one call's rays; kernel(lists) takes
        its body from TPT_GRP, its result trimmed to the call's rays."""
        n = o.shape[0]
        _, build, kernel = ablations.grp_steps(o, d, tmax, *table, 0.01,
                                               occluded)
        if occluded:
            return build, lambda lists: (kernel(lists)[:n],)
        return build, lambda lists: tuple(x[:n] for x in kernel(lists))

    def want(o, d, tmax, occluded):
        return (k8(o, d, tmax),) if occluded else k6(o, d)

    def steps_args(call):
        """(origins, dirs, tmax, occluded) of a recorded grp_steps call
        (the paths pass ``occluded`` by name)."""
        a, kw_ = call
        return a[0], a[1], a[2], kw_.get("occluded", a[7:8] == (True,))
    rec = frame_calls(dict(TPT_GRP="1"), ("grp_steps",))
    grp_frame = [steps_args(c) for c in rec["grp_steps"]]
    rec = frame_calls(dict(TPT_SEED="1"), ("closest_rotated",))
    rot_frame = [c[0] for c in rec["closest_rotated"]]
    del rec
    grp_name = f"TPT_GRP=1 frame, {len(grp_frame)} calls"
    rot_name = f"TPT_SEED=1 frame, {len(rot_frame)} calls"
    for c in grp_frame:
        build, kernel = grp_call(*c)
        for _, mode in BODIES:
            with cs._env(TPT_GRP=mode):
                same(kernel(build()), want(*c), "K15 on a frame call")
    for a in rot_frame:
        same(ablations.closest_rotated(*a), k6(a[0], a[1]),
             "K11 on a frame call")

    def turns(fns: dict, reps: int = 3) -> dict:
        """Each fn timed twice, the second round in the reverse order:
        {key: [ms, ms]}."""
        runs = {k: [] for k in fns}
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                runs[k].append(cs.gpu_ms(fns[k], reps))
        return runs

    ctx = dict(ablations=ablations, clustered=clustered, cs=cs, table=table,
               srows=srows, sets=sets, grp_frame=grp_frame,
               rot_frame=rot_frame, grp_name=grp_name, rot_name=rot_name,
               want=want, same=same, turns=turns, out=out, k6=k6,
               lanes=lanes)
    if args.widths:
        return _widths(**ctx)

    for name, closest, shadow, preds in sets:
        for side, c, occluded in (("closest", (*closest, 1e16), False),
                                  ("any-hit", shadow, True)):
            build, kernel = grp_call(*c, occluded)
            lists = build()
            ref = want(*c, occluded)
            for body, mode in BODIES:
                with cs._env(TPT_GRP=mode):
                    same(kernel(lists), ref, f"K15 {side} ({body}) at {name}")
                    out(f"K15 {side}", rays=name, body=body,
                        lists_ms=cs.gpu_ms(build, 10),
                        kernel_ms=cs.gpu_ms(lambda: kernel(lists), 10),
                        listed_boxes_per_group=float(
                            lists[2].float().mean()))
        ref = k6(*closest)
        for what, pred in preds.items():
            def k11(pred=pred):
                return ablations.closest_rotated(*closest, *table, pred,
                                                 srows, 0.01)
            same(k11(), ref, f"K11 at {name}, {what} prediction")
            out("K11", rays=name, prediction=what, slabs=s_count,
                kernel_ms=cs.gpu_ms(k11, 10))
    steps = [grp_call(*c) for c in grp_frame]
    lists = [build() for build, _ in steps]
    for body, mode in BODIES:
        with cs._env(TPT_GRP=mode):
            out("K15 both sides", rays=grp_name, body=body,
                lists_ms=cs.gpu_ms(lambda: [b() for b, _ in steps], 3),
                kernel_ms=cs.gpu_ms(lambda: [k(x) for (_, k), x in
                                             zip(steps, lists)], 3),
                closest_kernel_ms=cs.gpu_ms(
                    lambda: [k(x) for (_, k), x, c in
                             zip(steps, lists, grp_frame) if not c[3]], 3),
                any_kernel_ms=cs.gpu_ms(
                    lambda: [k(x) for (_, k), x, c in
                             zip(steps, lists, grp_frame) if c[3]], 3))
    out("K11", rays=rot_name, kernel_ms=cs.gpu_ms(
        lambda: [ablations.closest_rotated(*a) for a in rot_frame], 3))
    del steps, lists, grp_frame, rot_frame

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


def _widths(ablations, clustered, cs, table, srows, sets, grp_frame,
            rot_frame, grp_name, rot_name, want, same, turns, out, k6,
            lanes) -> int:
    """The width trials (this checkout's kernels): K15's lanes a ray (both
    bodies), the route of its lists, K11's lanes a ray."""
    import torch
    groups = clustered.GROUPS
    real_route = ablations.list_route

    def routed(route, fn):
        """fn() with K15's lists on ``route`` ("small" or "shared")."""
        ablations.list_route = lambda n_boxes, rt: route
        try:
            return fn()
        finally:
            ablations.list_route = real_route
    routes = ("small", "shared")

    for name, closest, shadow, preds in sets:
        for side, c, occluded in (("closest", (*closest, 1e16), False),
                                  ("any-hit", shadow, True)):
            n = c[0].shape[0]
            r = ablations.pack_rays(*c, ablations._pad_tile(n, lanes))
            tm = r[:, 6] if occluded else 1e16

            def build():
                return ablations.stream_lists(r, *table[1:], lanes, 0.01, tm)
            lists = {rt: routed(rt, build) for rt in routes}
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*lists.values())):
                raise AssertionError(f"K15's lists at {name} differ between "
                                     "the routes")
            out("K15 lists", rays=name, side=side,
                **{f"{rt}_ms": cs.gpu_ms(lambda rt=rt: routed(rt, build), 10)
                   for rt in routes})
            ref = want(*c, occluded)
            for g in groups:
                for bundled in (False, True):
                    def kernel(g=g, bundled=bundled):
                        if occluded:
                            return (ablations.occluded_grp(
                                r, *table, lists["small"], 0.01,
                                bundled=bundled, group=g)[:n],)
                        return tuple(x[:n] for x in ablations.closest_grp(
                            r, *table, lists["small"], 0.01, 1e16, bundled,
                            group=g))
                    same(kernel(), ref, f"K15 {side} at {name}, {g} lanes, "
                         f"bundled {bundled}")
                    out(f"K15 {side}", rays=name, group=g, bundled=bundled,
                        kernel_ms=cs.gpu_ms(kernel, 10))
        ref = k6(*closest)
        for what, pred in preds.items():
            for g in groups:
                def k11(pred=pred, g=g):
                    return ablations.closest_rotated(*closest, *table, pred,
                                                     srows, 0.01, group=g)
                same(k11(), ref, f"K11 at {name}, {what}, {g} lanes")
                out("K11", rays=name, prediction=what, group=g,
                    kernel_ms=cs.gpu_ms(k11, 10))

    # The frame's replayed calls: K15's lists on each route, its kernels
    # at every width and body, K11 at every width.
    packed = []
    for c in grp_frame:
        n = c[0].shape[0]
        r = ablations.pack_rays(c[0], c[1], c[2],
                                ablations._pad_tile(n, lanes))
        packed.append((r, r[:, 6] if c[3] else c[2], c[3], n))
    list_runs = turns({rt: lambda rt=rt: routed(rt, lambda: [
        ablations.stream_lists(r, *table[1:], lanes, 0.01, tm)
        for r, tm, _, _ in packed]) for rt in routes})
    out("K15 lists", rays=grp_name, **{f"{rt}_ms_runs": list_runs[rt]
                                       for rt in routes})
    lists = [ablations.stream_lists(r, *table[1:], lanes, 0.01, tm)
             for r, tm, _, _ in packed]

    def frame_call(g, bundled, r, x, occ, n):
        """K15 on one replayed call, trimmed to its rays."""
        if occ:
            return (ablations.occluded_grp(r, *table, x, 0.01,
                                           bundled=bundled, group=g)[:n],)
        return tuple(y[:n] for y in ablations.closest_grp(
            r, *table, x, 0.01, 1e16, bundled, group=g))

    def frame_kernels(g, bundled, occluded):
        return [frame_call(g, bundled, r, x, occ, n)
                for (r, _, occ, n), x in zip(packed, lists)
                if occ == occluded]
    # Bitwise on every call, at every width and body.
    for g in groups:
        for bundled in (False, True):
            for (r, _, occ, n), x, c in zip(packed, lists, grp_frame):
                same(frame_call(g, bundled, r, x, occ, n), want(*c),
                     f"K15 on a frame call, {g} lanes, bundled {bundled}")
    for side, occluded in (("closest", False), ("any-hit", True)):
        runs = turns({(g, b): lambda g=g, b=b: frame_kernels(g, b, occluded)
                      for g in groups for b in (False, True)})
        for (g, b), r in runs.items():
            out(f"K15 {side}", rays=grp_name, group=g, bundled=b,
                kernel_ms_runs=r)
    for g in groups:
        for a in rot_frame:
            same(ablations.closest_rotated(*a, group=g), k6(a[0], a[1]),
                 f"K11 on a frame call, {g} lanes")
    runs = turns({g: lambda g=g: [ablations.closest_rotated(*a, group=g)
                                  for a in rot_frame] for g in groups})
    for g, r in runs.items():
        out("K11", rays=rot_name, group=g, kernel_ms_runs=r)
    return 0


if __name__ == "__main__":
    sys.exit(main())
