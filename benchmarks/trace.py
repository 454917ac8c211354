"""The device trace of a window and its reduction.

``traced`` wraps ``torch.profiler`` (host ops and device activity) around
the measured window, marked by a ``bench.window`` annotation. ``reduce``
turns the profiler's events into a small summary that the per-layer
readers take their numbers from:

- ``window_s``: the annotation's length;
- ``busy_s``: the union of every device activity (kernels, copies, sets)
  inside the window;
- ``kernels``: device time and launch count of each kernel name;
- ``blocked_s``: host time inside calls that wait for the device
  (stream, device and event synchronisation, and blocking copies);
- ``idle_gaps``: the device's idle time inside the window, by the
  innermost host operation that was running at each gap's middle
  ("python" where none was);
- ``device_ops``: the kernels that took most device time.
"""

from __future__ import annotations

import contextlib
import re

from . import manifest

WINDOW = "bench.window"
_BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
             "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpyAsync")
TOP = 10


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """Profile the block when ``enabled`` and put its summary in
    ``out["trace"]``; the block's own window is marked by :func:`window`."""
    if not enabled:
        yield
        return
    import time
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    t0 = time.perf_counter()
    out["trace"] = reduce(prof.profiler.kineto_results.events())
    out["trace"]["reduce_s"] = time.perf_counter() - t0


def window():
    """The annotation that marks the measured window in the trace."""
    from torch.profiler import record_function
    return record_function(WINDOW)


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _kind(e) -> str:
    """``kernel``, ``copy`` (memcpy, memset) or ``annotation`` (the GPU
    side of a ``record_function``) for a device event."""
    flag = getattr(e, "is_user_annotation", None)
    name = e.name()
    if (callable(flag) and flag()) or name.startswith("bench."):
        return "annotation"
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    return "kernel"


def _union(intervals, lo, hi):
    """Merged [start, end) intervals clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _innermost(host, points):
    """For each point (sorted), the name of the innermost host interval
    that contains it, or "python"."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    stack, out, i = [], [], 0
    for m in points:
        while i < len(host) and host[i][0] <= m:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] < m:
            stack.pop()
        out.append(stack[-1][2] if stack else "python")
    return out


def reduce(events) -> dict:
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not win:
        raise RuntimeError("the trace holds no bench.window annotation")
    lo, hi = win[0].start_ns(), win[0].end_ns()
    main = win[0].start_thread_id()
    device, host, kernels = [], [], {}
    blocked = 0
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if s + d < lo or s > hi:
            continue
        if _is_device(e):
            kind = _kind(e)
            if kind == "annotation":
                continue
            device.append((s, s + d))
            if kind == "kernel":
                k = kernels.setdefault(e.name(), [0, 0.0])
                k[0] += 1
                k[1] += d * 1e-9
            continue
        name = e.name()
        if name in _BLOCKING:
            blocked += d
        if name == WINDOW or "Query" in name:
            continue
        if name.startswith("cuda") or e.start_thread_id() == main:
            host.append((s, s + d, name))
    busy = _union(device, lo, hi)
    gaps = []
    prev = lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    by_host = {}
    for (a, b), name in zip(gaps, names):
        by_host[name] = by_host.get(name, 0.0) + (b - a) * 1e-9
    return dict(
        window_s=(hi - lo) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        blocked_s=blocked * 1e-9,
        kernels=kernels,
        device_ops=sorted(([n, v[1]] for n, v in kernels.items()),
                          key=lambda x: -x[1])[:TOP],
        idle_gaps=sorted(([n, v] for n, v in by_host.items()),
                         key=lambda x: -x[1])[:TOP])


# -- kernel classes, for the readers ----------------------------------------------

def _patterns():
    """Kernel classes of ``kernels.json``: a regular expression each,
    searched in the kernel names the trace prints."""
    return {cls: re.compile(p) for cls, p in manifest.data("kernels.json").items()}


def kernel_time(rank: dict, cls: str) -> tuple[int, float]:
    """(launches, device seconds) of the kernels of class ``cls`` in
    ``kernels.json`` (``own``: the program's hand-written kernels;
    ``collective``: NCCL's) in one rank's trace."""
    pat = _patterns()[cls]
    n, t = 0, 0.0
    for name, (count, secs) in rank["trace"]["kernels"].items():
        if pat.search(name):
            n += count
            t += secs
    return n, t


def other_kernel_time(rank: dict) -> tuple[int, float]:
    """(launches, device seconds) of every kernel in neither class."""
    n = sum(c for c, _ in rank["trace"]["kernels"].values())
    t = sum(s for _, s in rank["trace"]["kernels"].values())
    for cls in _patterns():
        cn, ct = kernel_time(rank, cls)
        n, t = n - cn, t - ct
    return n, t

