"""Device time a frame of every kernel that is neither the program's own
hand-written kernels nor a collective: the eager PyTorch ops of the
round's shading, bookkeeping and accumulation. Averaged over the cards."""

from benchmarks import trace


def read(record):
    ranks = record["ranks"]
    secs = sum(trace.other_kernel_time(r)[1] for r in ranks) / len(ranks)
    return 1e3 * secs / record["frames"]
