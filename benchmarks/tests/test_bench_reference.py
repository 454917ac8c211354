"""The plain reference agrees with the port's CPU path at a tiny size, and
its bfloat16 control fails the cell's limits."""

import numpy as np
import pytest
import torch

from benchmarks import check, manifest, session
from benchmarks.reference import pathtracer


def _program(config, traffic, frames):
    step, accum = session.build(config, traffic, torch.device("cpu"))
    for k in frames:
        accum, _, _ = step(k, accum)
    return accum.reshape(-1, 3).numpy()


@pytest.mark.parametrize("config_name,size,spp,depth", [
    ("cornell_mixed", 20, 3, 8), ("big_mesh", 6, 1, 3)])
def test_reference_matches_the_port_on_the_cpu(config_name, size, spp, depth):
    config = manifest.config(config_name)
    traffic = dict(manifest.traffic("final"), width=size, height=size, spp=spp,
                   max_depth=depth, lanes=4096)
    frames = [5, 6]
    program = _program(config, traffic, frames)
    pixels = np.arange(size * size)
    ref = check.reference_values(session.scene_path(config), config, traffic, pixels,
                                 frames, torch.device("cpu"), snapshot_frames=1)
    gap = check.gaps(program, ref["values"])
    assert gap.max() < 1e-5, gap.max()
    assert np.abs(ref["values"]).max() > 0


def test_control_fails_the_limits():
    config = manifest.config("cornell_mixed")
    traffic = dict(manifest.traffic("final"), width=24, height=24, spp=4)
    pixels = np.arange(24 * 24)
    frames = [3, 4, 5, 6]
    obj = session.scene_path(config)
    ref = check.reference_values(obj, config, traffic, pixels, frames,
                                 torch.device("cpu"), snapshot_frames=4)
    low = check.reference_values(obj, config, traffic, pixels, frames,
                                 torch.device("cpu"), torch.bfloat16, snapshot_frames=4)
    numbers = check.compare(low, ref)
    limits = manifest.check("cornell_mixed.final")["limits"]
    assert all(numbers[k] > limits[k] for k in limits), numbers
    correct, _ = check.verdict(check.compare(ref, ref), limits)
    assert correct


def test_rng_draws_the_ports_numbers():
    from tpu_pt_torch import rng
    g = torch.Generator().manual_seed(3)
    counters = [torch.randint(0, 2**32, (257,), generator=g) for _ in range(4)]
    for ours, port in zip(pathtracer.pcg4d(*counters), rng.pcg4d(*counters)):
        assert torch.equal(ours, port)
    ours = pathtracer.uniforms(counters[0], 5, 2**31 + 7, 3, torch.float32)
    assert all(torch.equal(a, b) for a, b in zip(ours, rng.uniform4(counters[0], 5,
                                                                    2**31 + 7, 3)))
