"""Kernel launches a wavefront round on the card, counted in the trace,
of the kernels that are neither the program's own nor collectives. An
exact count: the round's eager op count."""

from benchmarks import trace


def read(record):
    ranks = record["ranks"]
    launches = sum(trace.other_kernel_time(r)[0] for r in ranks)
    return launches / record["rounds"]
