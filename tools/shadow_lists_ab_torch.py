#!/usr/bin/env python3
"""K8b and K12 (its any-hit, its closest side and their tile lists) timed
on the card, for a side-by-side of two checkouts of the port.

Run it once per checkout, in turns (A, B, B, A), each run a process of
its own: ``--root DIR`` imports ``tpu_pt_torch`` and ``chip_smoke`` from
the checkout at DIR (default: the one that holds this file), so the
rays, the frames and the timing code are the same for both, and only
the package differs. On the big mesh (``tools/make_assets.py --big``):

- ``occluded_clustered_b`` (K8b) and ``occluded_stream_path`` (K12's
  any-hit: its list build, its kernel and the whole path apart, through
  ``ablations.stream_steps``) on chip_smoke.py's shadow rays at 32,768
  (one lane in eight parked) and 262,144, and on
  ``tools/bench_incoherent_torch.py``'s 262,144 incoherent rays; K12's
  closest side (build, kernel, path) on the camera and bounce rays;
- every K8b call of one ``TPT_INKB=1`` frame and every K12 any-hit call
  of one ``TPT_STREAM=1`` frame (frame 0 of chip_smoke.py's big-mesh
  run), recorded and replayed;
- the big-mesh frame (512^2, 4 spp, depth 8, IS + NEE) lean, under
  ``TPT_INKB=1``, ``TPT_STREAM=1`` and ``TPT_GRP=1``: frames 0-2 (ms of
  frames 1-2, host clock) and one more under ``torch.profiler`` (device
  busy: the summed time of the device's own events, and the time of each
  intersection kernel), with a checksum of the accumulator.

Each K8b and K12 result is held bitwise against K8's on the same rays.
Device times are CUDA events (chip_smoke.gpu_ms). Prints one JSON line
per measurement, each with ``--label``, the card's name and power limit.

Run on a machine with a CUDA card, from the repository root:
``python3 tools/shadow_lists_ab_torch.py [--root DIR] [--label NAME]``.
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
            ("TPT_STREAM=1", dict(TPT_STREAM="1")),
            ("TPT_GRP=1", dict(TPT_GRP="1")))


def _record(mod, name: str, render) -> list:
    """The arguments of every call of ``mod.name`` while render() runs."""
    import torch
    real, calls = getattr(mod, name), []

    def tap(*args):
        calls.append(tuple(a.clone() if torch.is_tensor(a) else a
                           for a in args))
        return real(*args)
    setattr(mod, name, tap)
    try:
        render()
    finally:
        setattr(mod, name, real)
    return calls


def _profiled(render_one) -> tuple[float, dict]:
    """Device busy ms of render_one() and the ms of each of this package's
    kernels (the intersection kernels and the list build), from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render_one()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            by_name[evt.key] = by_name.get(evt.key, 0.0) + us / 1e3
    if not by_name:
        raise RuntimeError("the profile holds no device events")
    ours = {}
    for key, ms in by_name.items():
        # "void (anonymous namespace)::name<G>(args)" -> "name<G>"
        name = key.replace("(anonymous namespace)::", "").removeprefix(
            "void ").split("(")[0]
        if "_kernel" in name and "at::" not in name:
            ours[name] = ours.get(name, 0.0) + ms
    return sum(by_name.values()), ours


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO))
    ap.add_argument("--label", default=None)
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

    def k8(shadow):
        return clustered.occluded_clustered(*shadow, *table, nodes=tb.nodes)

    def same(a, b, what):
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise AssertionError(f"{label}: {what} differs from K8 / K6")

    sets = []
    for name, n, park in (("32768 parked", 32768, True),
                          ("262144", 262144, False)):
        o, d, shadow = cs._phase3_rays(big, device, 3, tb.rows, k6, n)
        if park:
            (o, d), shadow = cs._park((o, d), shadow, cs.PARK_EVERY)
        sets.append((name, (o, d), shadow))
    o, d, tmax = cs._tool("bench_incoherent_torch").make_rays(big, 262144,
                                                             device)
    sets.append(("262144 incoherent", (o, d), (o, d, tmax)))
    for name, (o, d), shadow in sets:
        want = k8(shadow)
        same(clustered.occluded_clustered_b(*shadow, *table), want,
             f"K8b at {name}")
        out("K8b", rays=name, ms=cs.gpu_ms(
            lambda: clustered.occluded_clustered_b(*shadow, *table), 10))
        for side, args_, occluded in (("any-hit", shadow, True),
                                      ("closest", (o, d, 1e16), False)):
            _, build, kernel = ablations.stream_steps(*args_, *table[:3],
                                                      0.01, occluded)
            lists = build()
            got = kernel(lists)
            if occluded:
                same(got[:o.shape[0]], want, f"K12 any-hit at {name}")
                path = lambda: ablations.occluded_stream_path(*shadow, *table)
            else:
                same(got[0][:o.shape[0]], k6(o, d)[0],
                     f"K12 closest at {name}")
                path = lambda: ablations.closest_stream_path(o, d, *table)
            out(f"K12 {side}", rays=name,
                build_ms=cs.gpu_ms(build, 5),
                kernel_ms=cs.gpu_ms(lambda: kernel(lists), 10),
                path_ms=cs.gpu_ms(path, 5),
                listed_per_tile=float(lists[2].float().mean()))

    kw = dict(cs.BENCH_BIG, use_direct_lighting=True,
              use_importance_sampling=True)
    with cs._env(TPT_INKB="1"):
        calls = _record(clustered, "occluded_clustered_b",
                        lambda: cs._render(big, device, [0], **kw))
    for a in calls:
        same(clustered.occluded_clustered_b(*a[:7]), k8(a[:3]),
             "K8b on a frame call")
    out("K8b", rays=f"TPT_INKB=1 frame, {len(calls)} calls",
        ms=cs.gpu_ms(lambda: [clustered.occluded_clustered_b(*a[:7])
                              for a in calls], 3))
    with cs._env(TPT_STREAM="1"):
        calls = _record(ablations, "occluded_stream_path",
                        lambda: cs._render(big, device, [0], **kw))
    steps = [ablations.stream_steps(*a[:3], *table[:3], 0.01, True)[1:]
             for a in calls]
    lists = [build() for build, _ in steps]
    for a, (_, kernel), lst in zip(calls, steps, lists):
        same(kernel(lst)[:a[0].shape[0]], k8(a[:3]), "K12 on a frame call")
    out("K12 any-hit", rays=f"TPT_STREAM=1 frame, {len(calls)} calls",
        build_ms=cs.gpu_ms(lambda: [b() for b, _ in steps], 3),
        kernel_ms=cs.gpu_ms(lambda: [k(lst) for (_, k), lst in
                                     zip(steps, lists)], 3),
        path_ms=cs.gpu_ms(lambda: [ablations.occluded_stream_path(
            *a[:3], *table) for a in calls], 3))
    del steps, lists, calls

    cfg = tp.RenderConfig(**kw)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device=device)
    for what, variables in VARIANTS:
        with cs._env(**variables):
            accum, _, per = cs._render(big, device, FRAMES, **kw)
            digest = hashlib.sha256(accum.cpu().numpy().tobytes()).hexdigest()
            acc = init_accum(cfg, device=device)
            t0 = time.perf_counter()
            busy, kernels = _profiled(lambda: render_frame(big, cam, cfg, 3,
                                                           acc))
            wall = (time.perf_counter() - t0) * 1e3
        out("frame", variant=what, ms_per_frame=[p[0] * 1e3 for p in per[1:]],
            rounds=int(per[-1][2].wavefront_iterations),
            busy_ms=busy, profiled_wall_ms=wall, kernels_ms=kernels,
            accum_sha256=digest[:16])
    return 0


if __name__ == "__main__":
    sys.exit(main())
