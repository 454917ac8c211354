"""The least time of the window's intersection calls over the device time
of the program's own kernels, in percent.

The least time is bytes-bound: each call reads its rays and writes its
results once, and reads the scene's triangles once, at the card's HBM
rate (``peaks.json``). The calls are the program's launch counters'
deltas over the window; every call of these cells passes all of the
wavefront's lanes (the traffic's ``lanes``). Per ray a closest-hit call
reads an origin and a direction (24 bytes) and writes t and a triangle
id (8); an any-hit call also reads its tmax (28) and writes a flag (1);
a fused call does both. A triangle is three float32 vertices (36 bytes).
These are the bytes the answer needs whatever computes it, so a correct
kernel cannot take less time than this; a call counted here and run by
no kernel of the ``own`` class would push the share above 100.
"""

from benchmarks import trace

RAY_BYTES = {"closest": 24 + 8, "occluded": 28 + 1}
TRIANGLE_BYTES = 36


def call_bytes(name: str, lanes: int, triangles: int) -> int:
    kinds = [k for k in RAY_BYTES if k in name]
    if "nee" in name:
        kinds = list(RAY_BYTES)
    return sum(lanes * RAY_BYTES[k] + triangles * TRIANGLE_BYTES for k in kinds)


def read(record):
    ranks = record["ranks"]
    own = sum(trace.kernel_time(r, "own")[1] for r in ranks)
    if own <= 0:
        return None
    nbytes = sum(n * call_bytes(name, record["lanes"], record["triangles"])
                 for r in ranks for name, n in r["launches"].items())
    if nbytes <= 0:
        return None
    return 100.0 * nbytes / record["peaks"]["hbm_bytes_per_s"] / own
