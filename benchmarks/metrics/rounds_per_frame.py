"""Wavefront rounds a frame on one card (``RenderStats.wavefront_iterations``;
the sharded step sums it over the world, so it is divided by the world)."""


def read(record):
    return record["rounds"] / record["world"] / record["frames"]
