#!/usr/bin/env python3
"""The phase split of a benchmark cell's traced window, from the port's
``pt.*`` spans (``tpu_pt_torch.profiling.span``).

    python3 tools/span_split_torch.py --workload cornell_mixed.final --seed 7 --seconds 30

Runs one window of the cell as ``python -m benchmarks.run --trace 1``
does (the same set-up, warm-up, frames and ``torch.profiler`` window,
through ``benchmarks.run.run_windows``), keeps the profiler's events long
enough to summarise the spans as well (``benchmarks.spans.summary``), and
prints one JSON line: every per-layer metric of ``BENCHMARK.json`` and the
eight span readers of ``benchmarks/metrics/`` that read ``pt.*`` spans,
then the split by span (eager and own-kernel device ms a frame, waits a
round, idle ms a frame, host ms a frame) and the checks that the split
accounts for the harness's own numbers. The line and the whole summary go
to ``<out>/<cell>.<seed>.json`` (``--out``, default ``build/spans``). No
correctness check is made.

``--device cpu`` with ``--tiny`` rehearses the path on the CPU (a 12^2
frame; the CPU trace has spans but no device kernels).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmarks import manifest, run, spans, trace  # noqa: E402

SPAN_READERS = ("rng_ms_per_frame", "intersect_eager_ms_per_frame", "shade_ms_per_frame",
                "nee_ms_per_frame", "queue_ms_per_frame", "prepare_ms_per_frame",
                "issue_ms_per_round", "host_syncs_per_round")
TINY = dict(width=12, height=12, spp=2, max_depth=3, lanes=4096)


_REDUCE = trace.reduce


def _reduce_with_spans(events):
    """``trace.reduce`` with the span summary beside it, and the share of
    the kernels whose launch the trace holds (the rest are attributed by
    the spans' device annotations)."""
    out = _REDUCE(events)
    out["spans"] = spans.summary(events)
    launches = {e.correlation_id() for e in events
                if not trace._is_device(e) and e.name().startswith("cu")}
    kernels = [e.correlation_id() for e in events
               if trace._is_device(e) and trace._kind(e) == "kernel"]
    out["launched_share"] = (sum(c in launches for c in kernels) / len(kernels)
                             if kernels else None)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "spans"))
    args = ap.parse_args(argv)
    run._cache_env()
    bench = manifest.manifest()
    cell = manifest.cell(args.workload, bench)
    config = manifest.config(cell["config"])
    traffic = dict(manifest.traffic(cell["traffic"]), **(TINY if args.tiny else {}))
    with mock.patch.object(trace, "reduce", _reduce_with_spans):
        out = run.run_windows(cell, config, traffic, [args.seed], args.seconds, True,
                              args.device)[0]
    ranks = out["ranks"]
    r0 = ranks[0]
    world = len(ranks)
    record = dict(cell=cell["name"], config=config, traffic=traffic, world=world,
                  frames=len(r0["frames"]), window_s=r0["window_s"], rays=r0["rays"],
                  rays_traced=r0["rays_traced"], shadow_rays=r0["shadow_rays"],
                  rounds=r0["rounds"], lanes=traffic["lanes"],
                  triangles=config["triangles"], peaks=manifest.data("peaks.json"),
                  ranks=ranks)
    names = [m["name"] for m in manifest.per_layer(bench, cell)] + list(SPAN_READERS)
    metrics = {n: manifest.metric_reader(n)(record) for n in names}

    frames, rounds = record["frames"], record["rounds"] / world
    s = r0["trace"]["spans"]
    eager_total = trace.other_kernel_time(r0)[1]
    split = {}
    for name, b in sorted(s.items()):
        own = sum(t for k, (_, t) in b["kernels"].items()) - spans.eager_s(b)
        split[name] = dict(count=b["count"], eager_ms_per_frame=1e3 * spans.eager_s(b) / frames,
                           own_kernel_ms_per_frame=1e3 * own / frames,
                           launches_per_round=sum(n for n, _ in b["kernels"].values()) / rounds,
                           waits_per_round=b["waits"][0] / rounds,
                           wait_ms_per_frame=1e3 * b["waits"][1] / frames,
                           idle_ms_per_frame=1e3 * b["idle_s"] / frames,
                           host_ms_per_frame=1e3 * b["host_s"] / frames,
                           issue_ms_per_frame=1e3 * b["issue_s"] / frames)
    idle_total = sum(b["idle_s"] for b in s.values())
    eager_sum = sum(spans.eager_s(b) for b in s.values())
    checks = dict(
        eager_split_over_harness=eager_sum / eager_total if eager_total else None,
        none_share_of_eager=(spans.eager_s(s[spans.NONE]) / eager_total
                             if eager_total and spans.NONE in s else 0.0),
        idle_share_under_spans=(1 - s.get(spans.NONE, {"idle_s": 0})["idle_s"] / idle_total
                                if idle_total else None),
        idle_split_over_harness=(idle_total / (r0["trace"]["window_s"] - r0["trace"]["busy_s"])
                                 if r0["trace"]["window_s"] > r0["trace"]["busy_s"] else None),
        pt_round_count=s.get("pt.round", {}).get("count"), rounds_per_card=rounds,
        pt_frame_count=s.get("pt.frame", {}).get("count"), frames=frames,
        pt_names_in_reduce_kernels=[k for k in r0["trace"]["kernels"] if k.startswith("pt.")],
        kernels_launched_share=r0["trace"]["launched_share"], reduce_s=r0["trace"]["reduce_s"])
    line = dict(cell=cell["name"], seed=args.seed, device=args.device,
                card=_card(args.device), metrics=metrics, split=split, checks=checks,
                idle_gaps=r0["trace"]["idle_gaps"])
    dest = pathlib.Path(args.out)
    dest.mkdir(parents=True, exist_ok=True)
    with open(dest / f"{cell['name']}.{args.seed}.json", "w") as f:
        json.dump(dict(line, summary=s), f, indent=1)
    print(json.dumps(line))
    return 0


def _card(device: str) -> str:
    if device != "cuda":
        return "cpu"
    import torch
    return torch.cuda.get_device_name(0)


if __name__ == "__main__":
    sys.exit(main())
