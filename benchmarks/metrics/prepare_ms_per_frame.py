"""Host time a frame in ``pt.prepare``: the per-frame intersection
tables (``get_intersectors``, ``get_fused_closest_nee``), averaged over
the cards. ``None`` without spans."""

from benchmarks import spans


def read(record):
    return spans.host_ms_per_frame(record, "pt.prepare")
