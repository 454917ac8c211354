"""The benchmark's frozen scene generator gives today's scenes."""

import pathlib

import pytest

from benchmarks import manifest
from benchmarks.reference import scene as ref_scene
from benchmarks.scenes import make_assets

ASSETS = pathlib.Path(__file__).resolve().parents[2] / "assets"


@pytest.mark.parametrize("config", ["cornell_mixed", "big_mesh"])
def test_triangle_counts(config, tmp_path):
    cfg = manifest.config(config)
    obj = make_assets.ensure(cfg["scene"]["name"], tmp_path)
    _, tris, _, _ = ref_scene.read_obj(str(obj))
    assert tris.shape[0] == cfg["triangles"]
    assert make_assets.ensure(cfg["scene"]["name"], tmp_path) == obj   # written once


def test_big_mesh_is_99916_triangles(tmp_path):
    text = make_assets.ensure("big_mesh", tmp_path).read_text()
    assert sum(line.startswith("f ") for line in text.splitlines()) == 99916


def test_mixed_box_is_the_repository_asset(tmp_path):
    asset = ASSETS / "cornell_box_mixed.obj"
    if not asset.exists():
        pytest.skip("the repository's asset is not there")
    assert make_assets.ensure("cornell_box_mixed", tmp_path).read_text() == asset.read_text()
    assert (tmp_path / "cornell.mtl").read_text() == (ASSETS / "cornell.mtl").read_text()
