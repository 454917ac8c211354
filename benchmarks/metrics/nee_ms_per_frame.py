"""Eager device time a frame of next-event estimation: the kernels
launched in ``pt.nee`` spans outside their shadow-ray call (the light
sample, eligibility and weights), averaged over the cards. ``None``
without spans."""

from benchmarks import spans


def read(record):
    return spans.eager_ms_per_frame(record, "pt.nee")
