"""Broken builds of the program's frame step, put in place of
``benchmarks.session.build`` by the fault tests: each breaks the timed
path underneath an otherwise whole run, which must then read
``correct`` false."""

from benchmarks import session


def unchanged(config, traffic, device, mesh=None):
    """Each step renders, but returns its state (the accumulator) unchanged."""
    step, accum = session.build(config, traffic, device, mesh)

    def broken(k, acc):
        _, image, stats = step(k, acc.clone())
        return acc, image, stats
    return broken, accum


def half_batch(config, traffic, device, mesh=None):
    """Half of each pixel's samples left out, the mean taken over the rest."""
    return session.build(config, dict(traffic, spp=traffic["spp"] // 2), device, mesh)


def no_exchange(config, traffic, device, mesh=None):
    """The sharded step's radiance sum over each sample group left out."""
    import torch.distributed as tdist
    step, accum = session.build(config, traffic, device, mesh)
    spp_group, real = mesh.get_group("spp"), tdist.all_reduce

    def all_reduce(tensor, *args, group=None, **kw):
        if group is spp_group:
            return None
        return real(tensor, *args, group=group, **kw)
    tdist.all_reduce = all_reduce
    return step, accum


def altered(config, traffic, device, mesh=None):
    """Every frame's pixel means altered by 1% where they are produced, by
    the path tracer or by the Whitted renderer."""
    import contextlib
    from tpu_pt_torch import dist, render, whitted
    sites = [(render, "render_wavefront"), (dist, "render_wavefront"),
             (whitted, "render_whitted_wavefront"), (dist, "render_whitted_wavefront")]
    real = [getattr(mod, name) for mod, name in sites]

    def scaled(fn):
        def run(*args, **kw):
            radiance, stats = fn(*args, **kw)
            return radiance * 1.01, stats
        return run

    @contextlib.contextmanager
    def patched():
        for (mod, name), fn in zip(sites, real):
            setattr(mod, name, scaled(fn))
        try:
            yield
        finally:
            for (mod, name), fn in zip(sites, real):
                setattr(mod, name, fn)

    with patched():
        step, accum = session.build(config, traffic, device, mesh)

    def broken(k, acc):
        with patched():
            return step(k, acc)
    return broken, accum
