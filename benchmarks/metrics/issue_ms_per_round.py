"""Host time a round spent issuing work: the ``pt.round`` spans' host time
less the waits that start inside them, over one card's rounds, averaged
over the cards. The inside counterpart of ``host_ms_per_round``; the
traced run includes the profiler's own cost per op. ``None`` without
spans."""

from benchmarks import spans


def read(record):
    got = spans.buckets(record, "pt.round")
    if got is None:
        return None
    return 1e3 * spans.per_round(record, [b["issue_s"] for b in got])
