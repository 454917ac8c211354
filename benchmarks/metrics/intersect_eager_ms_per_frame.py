"""Eager device time a frame of the intersection wrappers: the eager
kernels launched in ``pt.intersect`` spans (the gathers, casts and
selects around the program's own kernels, which ``intersect_ms_per_frame``
reads), averaged over the cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    return spans.eager_ms_per_frame(record, "pt.intersect")
