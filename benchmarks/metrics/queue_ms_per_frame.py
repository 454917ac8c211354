"""Eager device time a frame of the wavefront's scheduler: the kernels
launched in ``pt.queue`` spans outside their RNG draws (pending radiance,
counters, the frame's ``index_add_``, claims, respawned camera rays,
parking), averaged over the cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    return spans.eager_ms_per_frame(record, "pt.queue")
