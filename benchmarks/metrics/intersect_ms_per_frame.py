"""Device time a frame of the program's own hand-written kernels (the
``own`` class of ``kernels.json``), averaged over the cards of the run."""

from benchmarks import trace


def read(record):
    ranks = record["ranks"]
    secs = sum(trace.kernel_time(r, "own")[1] for r in ranks) / len(ranks)
    return 1e3 * secs / record["frames"] if secs > 0 else None
