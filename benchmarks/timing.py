"""The benchmark's frozen copies of the program's timing arithmetic
(``tpu_pt_torch/profiling.py`` ``device_barrier`` / ``barrier_rtt`` and
the ray count of ``tpu_pt_torch/bench.py``), so that a change to the
program cannot change how its time and work are counted."""

from __future__ import annotations

import time

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
    computed tensor (subtracted from the timed region it closes)."""
    device_barrier(x)
    t0 = time.perf_counter()
    device_barrier(x)
    return time.perf_counter() - t0


def ray_counts(frame_stats) -> dict:
    """Totals over a window's frames of the renderer's exact counters:
    radiance rays of live lanes, NEE shadow rays and wavefront rounds.
    Read once the window has closed (each read waits for the device)."""
    rays = sum(int(s.rays_traced) for s in frame_stats)
    shadow = sum(int(s.shadow_rays) for s in frame_stats)
    rounds = sum(int(s.wavefront_iterations) for s in frame_stats)
    return dict(rays_traced=rays, shadow_rays=shadow, rays=rays + shadow,
                rounds=rounds)
