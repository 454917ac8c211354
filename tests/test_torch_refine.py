"""Port parity for the load-time mesh refinement:
tpu_pt_torch.scene.refine.split_large_tris against tpu_pt's on the same
numpy mesh (equal arrays: both are the same numpy operations), and
``load_scene(split_large=True)`` against the JAX loader's, leaf for leaf.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import pallas_bf  # noqa: E402
from tpu_pt.scene import refine as jrefine  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import dense  # noqa: E402
from tpu_pt_torch.scene import refine  # noqa: E402
from test_torch_scene import assert_same_scene  # noqa: E402


def _area(v, idx):
    a, b, c = v[idx[:, 0]], v[idx[:, 1]], v[idx[:, 2]]
    return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)


@pytest.mark.parametrize("frac", [1.0 / 8.0, 1.0 / 32.0, 1.0])
def test_split_large_tris_matches_reference(assets_dir, frac):
    mesh = tp.scene.load_obj(str(assets_dir / "cornell_box_mixed.obj"))
    ours = refine.split_large_tris(mesh.vertices, mesh.indices,
                                   mesh.mat_indices, max_extent_frac=frac)
    ref = jrefine.split_large_tris(mesh.vertices, mesh.indices,
                                   mesh.mat_indices, max_extent_frac=frac)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    verts, idx, mats = ours
    assert idx.shape[0] == mats.shape[0] >= mesh.indices.shape[0]
    if frac < 1.0:
        assert idx.shape[0] > mesh.indices.shape[0]
    # The same surface: the area is kept, per material, and no triangle
    # is larger than the bound.
    for m in np.unique(mesh.mat_indices):
        np.testing.assert_allclose(
            _area(verts, idx)[mats == m].sum(),
            _area(mesh.vertices, mesh.indices)[mesh.mat_indices == m].sum(),
            rtol=1e-5)
    tri = verts[idx]
    extent = (tri.max(axis=1) - tri.min(axis=1)).max(axis=1)
    scene_extent = (mesh.vertices.max(0) - mesh.vertices.min(0)).max()
    assert (extent <= scene_extent * frac * (1 + 1e-6)).all()


def test_split_is_a_noop_on_a_degenerate_extent():
    v = np.zeros((3, 3), np.float32)
    out = refine.split_large_tris(v, np.array([[0, 1, 2]]), np.array([0]))
    assert out[1].shape == (1, 3)


def test_load_scene_split_large_matches_reference(assets_dir, monkeypatch):
    """Below the clustered threshold ``split_large`` leaves the scene
    alone; above it (thresholds shrunk in both packages) both loaders
    split to the same scene."""
    path = str(assets_dir / "cornell_box_mixed.obj")
    plain = tp.load_scene(path, device="cpu", split_large=True)
    assert plain.num_tris == 428
    monkeypatch.setattr(pallas_bf, "TRI_SLAB", 256)
    monkeypatch.setattr(dense, "TRI_SLAB", 256)
    ours = tp.load_scene(path, device="cpu", split_large=True)
    ref = tpu_pt.load_scene(path, split_large=True)
    assert ours.num_tris == ref.num_tris > 428
    assert_same_scene(ours, ref)
