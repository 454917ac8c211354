"""Eager device time a frame of the counter RNG: the kernels launched in
the program's ``pt.rng`` spans (the bounce's two draws and the camera
jitter), averaged over the cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    return spans.eager_ms_per_frame(record, "pt.rng")
