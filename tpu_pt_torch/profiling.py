"""Render profiling and statistics reporting (counterpart of
``tpu_pt/profiling.py``).

Per-frame timing and running averages (``PathTracerMain.cpp:703-740``),
the stats overlay (``sutil::displayStats``, ``sutil.cpp:735-774``) plus
the framework's own telemetry: Mrays/s, wavefront occupancy and the
DoneReason histogram; ``device_trace`` wraps ``torch.profiler``.

``span`` marks the phases of a frame and of its wavefront rounds for the
profiler: ``pt.frame``, ``pt.prepare``, ``pt.round``, ``pt.rng``,
``pt.intersect``, ``pt.shade``, ``pt.nee`` and ``pt.queue``. Spans nest;
the innermost one owns the work (host ops, the kernels they launch, the
waits). They record only while a torch profiler records, on its clock,
and cost one check of the profiler's state otherwise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch


def device_barrier(x: torch.Tensor) -> float:
    """Wait until the device has finished everything queued so far, and
    pull a data-dependent scalar of ``x`` to the host (its sum), which
    cannot return before ``x`` is computed. Closes a timed region."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
    return float(x.to(torch.float32).sum())


def barrier_rtt(x: torch.Tensor) -> float:
    """Seconds that :func:`device_barrier` itself costs on an already
    computed tensor (subtract from the timed regions it closes)."""
    device_barrier(x)                    # x itself is done
    t0 = time.perf_counter()
    device_barrier(x)
    return time.perf_counter() - t0


@dataclasses.dataclass
class FrameRecord:
    ms: float
    rays: float
    shadow_rays: float
    iterations: float
    done_histogram: np.ndarray


class RenderProfiler:
    """Accumulates per-frame statistics for a render session."""

    REASONS = ("MISS", "MAX_DEPTH", "RUSSIAN_ROULETTE", "LIGHT_HIT",
               "NOT_DONE")

    def __init__(self, lanes: int | None = None):
        self.frames: list[FrameRecord] = []
        self.lanes = lanes
        self._t0 = None

    @contextlib.contextmanager
    def frame(self):
        """Time one frame; pass its RenderStats afterwards to record().
        The block should end with a device barrier."""
        t0 = time.perf_counter()
        yield
        self._t0 = (time.perf_counter() - t0) * 1e3

    def record(self, stats, ms: float | None = None) -> FrameRecord:
        rec = FrameRecord(
            ms=self._t0 if ms is None else ms,
            rays=float(stats.rays_traced),
            shadow_rays=float(stats.shadow_rays),
            iterations=float(stats.wavefront_iterations),
            done_histogram=np.asarray(stats.done_histogram.cpu()),
        )
        self.frames.append(rec)
        return rec

    # -- aggregates --------------------------------------------------------
    @property
    def total_ms(self) -> float:
        return sum(f.ms for f in self.frames)

    @property
    def avg_ms(self) -> float:
        return self.total_ms / max(len(self.frames), 1)

    @property
    def mrays_per_sec(self) -> float:
        rays = sum(f.rays + f.shadow_rays for f in self.frames)
        return rays / max(self.total_ms / 1e3, 1e-9) / 1e6

    def occupancy(self) -> float:
        """Useful path segments / (iterations x lanes): the wavefront's
        effective utilization (the metric SER optimizes in the reference)."""
        if self.lanes is None:
            return float("nan")
        segs = sum(f.rays for f in self.frames)
        slots = sum(f.iterations for f in self.frames) * self.lanes
        return segs / max(slots, 1e-9)

    def termination_histogram(self) -> dict[str, int]:
        total = np.zeros(5)
        for f in self.frames:
            total += f.done_histogram
        return {name: int(v) for name, v in zip(self.REASONS, total)}

    def report(self) -> str:
        """Human-readable stats block (displayStats parity)."""
        hist = self.termination_histogram()
        paths = max(sum(hist.values()), 1)
        lines = [
            f"frames rendered : {len(self.frames)}",
            f"avg frame time  : {self.avg_ms:9.1f} ms",
            f"total time      : {self.total_ms:9.1f} ms",
            f"throughput      : {self.mrays_per_sec:9.2f} Mrays/s",
        ]
        if self.lanes is not None:
            lines.append(f"occupancy       : {self.occupancy() * 100:8.1f} %")
        lines.append("termination     : " + ", ".join(
            f"{k}={v} ({100.0 * v / paths:.0f}%)" for k, v in hist.items()
            if v or k != "NOT_DONE"))
        return "\n".join(lines)


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function`` named ``name`` while a torch
    profiler records; otherwise one shared no-op context, so that an
    untraced render pays only the check."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with ``torch.profiler`` (host and, where there is
    a card, device activity) and write a Chrome trace into ``logdir``
    (open it in chrome://tracing or Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the time by kernel and by :func:`span`: a
    render's ``pt.*`` phases appear there and in the trace, on the host
    and, mirrored, on the device timeline. The reference's analog is
    building with -lineinfo for Nsight (``CMakeLists.txt:268``)."""
    import pathlib
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
