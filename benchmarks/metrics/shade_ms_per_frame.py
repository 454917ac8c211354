"""Eager device time a frame of shading: the kernels launched in
``pt.shade`` spans and in none nested inside them (material lookups, BSDF
sampling, radiance, attenuation, Russian roulette), averaged over the
cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    return spans.eager_ms_per_frame(record, "pt.shade")
