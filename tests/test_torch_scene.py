"""Port parity: tpu_pt_torch.load_scene builds the same scene as tpu_pt's,
leaf for leaf and bit for bit, including the NEE occluder subset."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.scene import SceneArrays, scene_from_numpy  # noqa: E402

LIGHT_FIELDS = ("corner", "v1", "v2", "normal", "emission")
SCENES = ["cornell_box.obj", "cornell_box_mixed.obj", "cornell_box_monkey.obj"]


def numpy_leaves(jscene) -> dict:
    """The JAX scene's leaves as numpy, in scene_from_numpy's layout."""
    leaves = {f.name: (None if getattr(jscene, f.name) is None
                       else np.asarray(getattr(jscene, f.name)))
              for f in dataclasses.fields(SceneArrays)
              if f.name not in ("light", "num_tris", "num_occluders")}
    leaves["light"] = {k: np.asarray(getattr(jscene.light, k))
                       for k in LIGHT_FIELDS}
    return leaves


def assert_same_scene(tscene, jscene):
    for f in dataclasses.fields(SceneArrays):
        ours, ref = getattr(tscene, f.name), getattr(jscene, f.name)
        if f.name == "light":
            for k in LIGHT_FIELDS:
                a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
        elif isinstance(ours, torch.Tensor):
            a, b = ours.numpy(), np.asarray(ref)
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert ours == ref, (f.name, ours, ref)


@pytest.mark.parametrize("name", SCENES)
def test_load_scene_matches_reference(assets_dir, name):
    path = str(assets_dir / name)
    assert_same_scene(tp.load_scene(path), tpu_pt.load_scene(path))


def test_mixed_occluder_subset(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"))
    assert scene.num_tris == 428 and scene.num_tris_padded == 512
    assert scene.num_occluders == 24
    assert scene.occ_index.shape[0] % 8 == 0


def test_scene_from_numpy_roundtrip(mixed_scene):
    scene = scene_from_numpy(numpy_leaves(mixed_scene), mixed_scene.num_tris,
                             mixed_scene.num_occluders)
    assert_same_scene(scene, mixed_scene)
    moved = scene.to("cpu")
    assert moved.device.type == "cpu" and moved.num_occluders == 24


def test_non_obj_scenes_not_ported(assets_dir):
    with pytest.raises(NotImplementedError):
        tp.load_scene(str(assets_dir / "cornell_prims.json"))
