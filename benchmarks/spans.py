"""The program's own spans in the device trace of a window.

The program marks the phases of a frame and of its wavefront rounds with
``torch.profiler.record_function`` spans named ``pt.*``
(``tpu_pt_torch.profiling.span``): ``pt.frame``, ``pt.prepare``,
``pt.round``, ``pt.rng``, ``pt.intersect``, ``pt.shade``, ``pt.nee`` and
``pt.queue``. Spans nest, and the innermost one owns the work.
:func:`summary` reads the same profiler events as ``trace.reduce``, inside
the ``bench.window`` annotation and on its thread, and gives for each span
name:

- ``count``: the spans of that name;
- ``host_s``: their host time, children included;
- ``issue_s``: ``host_s`` less the waits that start inside them: the host
  time spent issuing work;
- ``kernels``: ``{kernel name: [launches, device seconds]}`` of the
  kernels whose launch (the runtime call that carries the kernel's
  correlation id) lies in a span of this name and in none nested inside
  it; a kernel with no launch in the trace goes to the innermost device
  annotation of a span around it;
- ``waits``: ``[count, seconds]`` of the host's blocking calls (stream,
  device and event synchronisation, and blocking copies; an asynchronous
  copy alone is none) that start in it and in no span nested inside it;
- ``idle_s``: the device's idle time inside the window whose midpoint
  falls while this span is the innermost one on the host.

Work in no span goes under ``"(none)"``. The device time of every kernel
in the window is counted once: the buckets' kernels sum to ``reduce``'s.
The functions below turn a record's summaries into the per-layer numbers
of the span readers in ``metrics/``; they give ``None`` where a rank's
trace holds no span of the name they read. ``trace.traced`` does not yet
keep the summary (``tools/span_split_torch.py`` adds it for its own runs),
so ``BENCHMARK.json`` names none of those readers.
"""

from __future__ import annotations

import bisect

from . import trace

PREFIX = "pt."
NONE = "(none)"
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


def _innermost(spans, points):
    """For each point, the name of the innermost span that holds it, or
    ``NONE``; the points in any order."""
    order = sorted(range(len(points)), key=points.__getitem__)
    names = trace._innermost(spans, [points[i] for i in order])
    out = [NONE] * len(points)
    for i, name in zip(order, names):
        out[i] = NONE if name == "python" else name
    return out


def _bucket(out: dict, name: str) -> dict:
    if name not in out:
        out[name] = dict(count=0, host_s=0.0, issue_s=0.0, kernels={},
                         waits=[0, 0.0], idle_s=0.0)
    return out[name]


def summary(events) -> dict:
    win = [e for e in events if e.name() == trace.WINDOW and not trace._is_device(e)]
    if not win:
        raise RuntimeError("the trace holds no bench.window annotation")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    main = win[0].start_thread_id()
    spans, dev_spans, launch_at, kernels, device, waits = [], [], {}, [], [], []
    for e in events:
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if trace._is_device(e):
            if s + d < lo or s > hi:
                continue
            kind = trace._kind(e)
            if kind == "annotation" or name.startswith(PREFIX):
                if name.startswith(PREFIX):
                    dev_spans.append((s, s + d, name))
                continue
            device.append((s, s + d))
            if kind == "kernel":
                kernels.append((e.correlation_id(), s, d, name))
        elif name.startswith("cu"):
            launch_at[e.correlation_id()] = s
            if name in WAITS and e.start_thread_id() == main and lo <= s <= hi:
                waits.append((s, d))
        elif name.startswith(PREFIX) and e.start_thread_id() == main and lo <= s <= hi:
            spans.append((s, s + d, name))

    out = {}
    waits.sort()
    starts = [s for s, _ in waits]
    cum = [0]
    for _, d in waits:
        cum.append(cum[-1] + d)
    for s, e, name in spans:
        b = _bucket(out, name)
        waited = cum[bisect.bisect_right(starts, e)] - cum[bisect.bisect_left(starts, s)]
        b["count"] += 1
        b["host_s"] += (e - s) * 1e-9
        b["issue_s"] += (e - s - waited) * 1e-9

    launched = [k for k in kernels if k[0] in launch_at]
    loose = [k for k in kernels if k[0] not in launch_at]
    owners = (_innermost(spans, [launch_at[k[0]] for k in launched])
              + _innermost(dev_spans, [s + d / 2 for _, s, d, _ in loose]))
    for (_, _, d, kname), owner in zip(launched + loose, owners):
        k = _bucket(out, owner)["kernels"].setdefault(kname, [0, 0.0])
        k[0] += 1
        k[1] += d * 1e-9

    for (_, d), owner in zip(waits, _innermost(spans, starts)):
        w = _bucket(out, owner)["waits"]
        w[0] += 1
        w[1] += d * 1e-9

    gaps, prev = [], lo
    for s, e in trace._union(device, lo, hi):
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    for (a, b), owner in zip(gaps, _innermost(spans, [(a + b) / 2 for a, b in gaps])):
        _bucket(out, owner)["idle_s"] += (b - a) * 1e-9
    return out


# -- the readers' arithmetic --------------------------------------------------------

def eager_s(bucket: dict) -> float:
    """Device seconds of a bucket's kernels in neither class of
    ``kernels.json`` (the eager PyTorch ops)."""
    pats = trace._patterns().values()
    return sum(secs for name, (_, secs) in bucket["kernels"].items()
               if not any(p.search(name) for p in pats))


def buckets(record: dict, name: str):
    """Each rank's bucket of span ``name``, or None where a rank has none."""
    got = [r["trace"].get("spans", {}).get(name) for r in record["ranks"]]
    return None if any(b is None for b in got) else got


def eager_ms_per_frame(record: dict, name: str):
    """Eager device time a frame owned by span ``name``, mean over ranks."""
    got = buckets(record, name)
    if got is None:
        return None
    return 1e3 * sum(eager_s(b) for b in got) / len(got) / record["frames"]


def host_ms_per_frame(record: dict, name: str):
    """Host time a frame inside span ``name``, mean over ranks."""
    got = buckets(record, name)
    if got is None:
        return None
    return 1e3 * sum(b["host_s"] for b in got) / len(got) / record["frames"]


def per_round(record: dict, values) -> float:
    """The mean over ranks of ``values`` (one a rank) over one card's rounds."""
    return sum(values) / len(values) / (record["rounds"] / record["world"])
