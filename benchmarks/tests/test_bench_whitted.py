"""The plain Whitted reference agrees with the port's Whitted frames on the
CPU within the default limits, its bfloat16 control fails them, and its
glTF reader, PNG decoder and the frozen glTF generator hold to what they
copy."""

import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from benchmarks import check, manifest, session
from benchmarks.reference import gltf
from benchmarks.scenes import gltf_assets
from benchmarks.tests import whitted_cases

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "assets"
FRAMES = [5, 6]
# (configuration, size, spp, the build: load_gltf's route forced, or the
# command line's "auto").
CASES = {
    "foliage_instanced": (whitted_cases.foliage_small(), 20, 1, whitted_cases.build_instanced),
    "forest_instanced": (whitted_cases.forest_small(), 32, 2, whitted_cases.build_instanced),
    "forest_flatten": (whitted_cases.forest_small(), 32, 2, whitted_cases.build_flatten),
    "alpha_shadow": (whitted_cases.alpha_shadow(), 32, 2, session.build),
}


def _traffic(size, spp):
    return dict(width=size, height=size, spp=spp, max_depth=8, scheduler="pixelq",
                samples_per_item=1, lanes=4096)


def _program(config, traffic, build):
    """The port's accumulator after FRAMES, and after the first of them."""
    step, accum = build(config, traffic, torch.device("cpu"))
    snaps = []
    for k in FRAMES:
        accum, _, _ = step(k, accum)
        snaps.append(accum.reshape(-1, 3).numpy().copy())
    return {"values": snaps[-1], "snapshot": snaps[0]}


def _reference(config, traffic, dtype=torch.float32):
    pixels = np.arange(traffic["width"] * traffic["height"])
    return check.reference_values(session.scene_path(config), config, traffic, pixels, FRAMES,
                                  torch.device("cpu"), dtype, snapshot_frames=1)


@pytest.mark.parametrize("case", list(CASES))
def test_reference_matches_the_ports_whitted_frames(case):
    config, size, spp, build = CASES[case]
    traffic = _traffic(size, spp)
    ref = _reference(config, traffic)
    numbers = check.compare(_program(config, traffic, build), ref)
    correct, shown = check.verdict(numbers, manifest.check("default")["limits"])
    assert correct, shown
    # The scene fills most of the view, and some of it lies in shadow.
    lum = ref["values"].max(axis=1)
    seen = lum[lum > 0]
    assert seen.size > 0.4 * lum.size and seen.min() < 0.6 * np.median(seen)


def test_control_fails_the_limits():
    config, size, spp, _ = CASES["foliage_instanced"]
    traffic = _traffic(size, spp)
    ref = _reference(config, traffic)
    numbers = check.compare(_reference(config, traffic, torch.bfloat16), ref)
    correct, shown = check.verdict(numbers, manifest.check("default")["limits"])
    assert not correct, shown


def test_shadow_transmissions_of_the_alpha_scene(tmp_path):
    """The analytic shadows of ``alpha_shadow``: under the textured blend
    pair 0.8 x 0.8 (left) and 0.2 x 0.2 (right), under the mask 1 (left)
    and 0.2 (right), under the untextured blend 0."""
    from benchmarks.reference import whitted
    scene = whitted.Scene(gltf.read(str(gltf_assets.ensure("alpha_shadow", tmp_path))),
                          torch.device("cpu"), torch.float32)
    ground = torch.tensor([[-3.5, 0.0, 0.0], [-2.5, 0.0, 0.0], [-0.5, 0.0, 0.0],
                           [0.5, 0.0, 0.0], [3.0, 0.0, 0.0], [5.5, 0.0, 5.5]])
    to_light = torch.tensor([0.0, 30.0, 0.0]) - ground
    dist = to_light.norm(dim=1)
    trans = whitted.transmission(scene, ground, to_light / dist[:, None], dist - 0.001)
    expect = torch.tensor([0.8 * 0.8, 0.2 * 0.2, 1.0, 0.2, 0.0, 1.0])
    assert torch.allclose(trans, expect, atol=1e-6), trans


def _png(rows: np.ndarray, kinds) -> bytes:
    """An RGBA PNG of ``rows`` [h, w, 4] with row y filtered by kinds[y]."""
    h, w, c = rows.shape
    raw, prior = b"", np.zeros(w * c, np.int64)
    for y in range(h):
        line = rows[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        paeth = np.array([gltf._paeth(a, b, d) for a, b, d in zip(left, prior, upleft)])
        pred = [0, left, prior, (left + prior) // 2, paeth][kinds[y]]
        raw += bytes([kinds[y]]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = line

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(
            ">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decoder_undoes_all_five_filters():
    img = np.random.default_rng(5).integers(0, 256, (10, 7, 4), dtype=np.uint8)
    assert np.array_equal(gltf.read_png(_png(img, [0, 1, 2, 3, 4, 4, 3, 2, 1, 0])), img)


@pytest.mark.parametrize("scene,texture", [("foliage", "leaf.png"), ("forest", None),
                                           ("alpha_shadow", "alpha.png")])
def test_generator_writes_the_repository_assets(scene, texture, tmp_path):
    path = gltf_assets.ensure(scene, tmp_path)
    assert path.read_bytes() == (ASSETS / f"{scene}.gltf").read_bytes()
    if texture:
        assert (tmp_path / texture).read_bytes() == (ASSETS / texture).read_bytes()
    assert gltf_assets.ensure(scene, tmp_path) == path       # written once
    small = gltf_assets.ensure(scene, tmp_path, n_trees=12) if scene != "alpha_shadow" else None
    if small:
        doc = gltf.read(str(small))
        assert small.name == f"{scene}_12.gltf" and len(doc.instances) == 1 + 2 * 12


def test_unsupported_features_name_themselves():
    with pytest.raises(NotImplementedError, match="normalTexture"):
        gltf.read(str(ASSETS / "pbr_test.gltf"))
    with pytest.raises(NotImplementedError, match="glb"):
        gltf.read(str(ASSETS / "pbr_test.glb"))
