"""Radiance rays traced by live lanes over the lanes the wavefront held
in its rounds: ``rays_traced / (lanes x rounds)``, in percent."""


def read(record):
    return 100.0 * record["rays_traced"] / (record["lanes"] * record["rounds"])
