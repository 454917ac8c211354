"""Device time a frame of the collective kernels (NCCL) on rank 0, which
includes the time a collective waits for the slower tile. Nothing to read
in a run on one card."""

from benchmarks import trace


def read(record):
    if record["world"] == 1:
        return None
    secs = trace.kernel_time(record["ranks"][0], "collective")[1]
    return 1e3 * secs / record["frames"]
