"""Port parity: tpu_pt_torch.load_scene builds the same scene as tpu_pt's,
leaf for leaf and bit for bit, including the NEE occluder subset, the
analytic primitives and the curves. Both loaders build the LBVH with
their native host build where it is available, the same C++ on the same
arrays: then the node tables are equal bit for bit. Where either package
builds on its device instead (the device and native builders break Morton
ties differently), the trees must be of the same size, and
tests/test_torch_lbvh.py holds the device builds equal."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.scene import SceneArrays, scene_from_numpy  # noqa: E402
from torch_ref_native import reference_native  # noqa: E402

LIGHT_FIELDS = ("corner", "v1", "v2", "normal", "emission")
BVH_FIELDS = ("nodes", "left", "skip", "tri")
PRIM_FIELDS = ("params", "mat")
CURVE_FIELDS = ("k0", "k1", "k2", "k3", "mat")
PARTS = {"bvh": BVH_FIELDS, "prims": PRIM_FIELDS, "curves": CURVE_FIELDS}
SCENES = ["cornell_box.obj", "cornell_box_mixed.obj", "cornell_box_monkey.obj"]


def numpy_leaves(jscene) -> dict:
    """The JAX scene's leaves as numpy, in scene_from_numpy's layout."""
    leaves = {f.name: (None if getattr(jscene, f.name) is None
                       else np.asarray(getattr(jscene, f.name)))
              for f in dataclasses.fields(SceneArrays)
              if f.name not in ("light", "num_tris", "num_occluders", *PARTS)}
    leaves["light"] = {k: np.asarray(getattr(jscene.light, k))
                       for k in LIGHT_FIELDS}
    for name, fields in PARTS.items():
        part = getattr(jscene, name, None)
        if part is None:
            continue
        leaves[name] = {k: np.asarray(getattr(part, k)) for k in fields}
        if name == "prims":
            leaves[name]["kind"] = part.kind
        if name != "bvh":
            leaves[name]["occludes"] = part.occludes
    return leaves


def both_native() -> bool:
    """Whether both packages' loaders build their LBVH natively."""
    from tpu_pt import native as jnative
    from tpu_pt_torch import native
    return jnative.available() and native.available()


def assert_same_scene(tscene, jscene):
    for f in dataclasses.fields(SceneArrays):
        ours, ref = getattr(tscene, f.name), getattr(jscene, f.name)
        if f.name == "bvh":
            assert (ours is None) == (ref is None)
            if ours is None:
                continue
            assert ours.num_nodes == ref.num_nodes
            if both_native():
                for k in BVH_FIELDS:
                    a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref,
                                                                        k))
                    assert a.dtype == b.dtype, k
                    np.testing.assert_array_equal(a, b, err_msg=f"bvh.{k}")
        elif f.name in ("light", "prims", "curves"):
            assert (ours is None) == (ref is None), f.name
            if ours is None:
                continue
            for k in (LIGHT_FIELDS if f.name == "light" else PARTS[f.name]):
                a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            if f.name != "light":
                assert ours.occludes == ref.occludes
                assert ours.count == ref.count
            if f.name == "prims":
                assert ours.kind == ref.kind
        elif isinstance(ours, torch.Tensor):
            a, b = ours.numpy(), np.asarray(ref)
            assert a.dtype == b.dtype, (f.name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert ours == ref, (f.name, ours, ref)


@pytest.mark.parametrize("name", SCENES)
def test_load_scene_matches_reference(assets_dir, name):
    path = str(assets_dir / name)
    assert_same_scene(tp.load_scene(path, device="cpu"),
                      tpu_pt.load_scene(path))


def test_mixed_occluder_subset(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    assert scene.num_tris == 428 and scene.num_tris_padded == 512
    assert scene.num_occluders == 24
    assert scene.occ_index.shape[0] % 8 == 0


def test_scene_from_numpy_roundtrip(mixed_scene):
    scene = scene_from_numpy(numpy_leaves(mixed_scene), mixed_scene.num_tris,
                             mixed_scene.num_occluders, device="cpu")
    assert_same_scene(scene, mixed_scene)
    moved = scene.to("cpu")
    assert moved.device.type == "cpu" and moved.num_occluders == 24


def test_load_scene_defaults_to_the_card(assets_dir):
    """With no device, load_scene builds on the card; a torch without
    CUDA raises rather than quietly building on the CPU."""
    path = str(assets_dir / "cornell_box_mixed.obj")
    if torch.cuda.is_available():
        assert tp.load_scene(path).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tp.load_scene(path)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tp.init_accum(tp.RenderConfig(width=4, height=4))


def test_non_obj_scenes_not_ported(assets_dir):
    """Scene JSON and glTF load for the path tracer, and the native host
    LBVH build is ported too: on the scene JSON's triangles
    ``with_bvh(builder="native")`` gives the table the loader attached,
    equal to the JAX package's native build."""
    scene = tp.load_scene(str(assets_dir / "cornell_prims.json"),
                          device="cpu")
    assert scene.prims.count == 3 and scene.bvh is not None
    assert tp.load_scene(str(assets_dir / "pbr_test.gltf"),
                         device="cpu").num_tris == 806
    from tpu_pt.intersect import lbvh as jlbvh
    from tpu_pt_torch import native
    from tpu_pt_torch.intersect.lbvh import with_bvh
    if not native.available():
        pytest.skip("native toolchain unavailable")
    reference_native()
    again = with_bvh(dataclasses.replace(scene, bvh=None), builder="native")
    ref = jlbvh.build_lbvh_host(
        tpu_pt.load_scene(str(assets_dir / "cornell_prims.json"),
                          build_bvh=False))
    for k in BVH_FIELDS:
        assert torch.equal(getattr(again.bvh, k), getattr(scene.bvh, k)), k
        np.testing.assert_array_equal(getattr(again.bvh, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)


def test_vmath_is_exported():
    """``tpu_pt_torch.vmath``, the [N, 3] vector math under the JAX
    package's name, holds every function ``tpu_pt.vmath`` has, agreeing
    with it on random vectors."""
    import tpu_pt
    import jax.numpy as jnp
    names = [n for n in dir(tpu_pt.vmath)
             if callable(getattr(tpu_pt.vmath, n)) and not n.startswith("_")
             and n not in ("annotations", "jnp", "Vec3")]
    assert set(names) <= set(dir(tp.vmath)), set(names) - set(dir(tp.vmath))
    r = np.random.default_rng(3)
    a, b = (r.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    for name in ("dot", "cross", "length", "normalize", "reflect"):
        args = (a,) if name in ("length", "normalize") else (a, b)
        ours = getattr(tp.vmath, name)(*(torch.as_tensor(x) for x in args))
        ref = getattr(tpu_pt.vmath, name)(*(jnp.asarray(x) for x in args))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(
        tp.vmath.lerp(torch.as_tensor(a), torch.as_tensor(b), 0.25).numpy(),
        np.asarray(tpu_pt.vmath.lerp(jnp.asarray(a), jnp.asarray(b), 0.25)),
        rtol=1e-6)


def test_vmath_names_match_reference():
    """Every public name of ``tpu_pt.vmath`` but its JAX imports has a twin
    in ``tpu_pt_torch.vmath``: the functions, the ``Vec3`` alias (a
    tensor here) and ``EPS``, the squared length below which ``normalize``
    gives zero."""
    import tpu_pt
    ref = {n for n in vars(tpu_pt.vmath) if not n.startswith("_")} \
        - {"annotations", "jnp"}
    assert ref <= set(vars(tp.vmath)), ref - set(vars(tp.vmath))
    assert tp.vmath.EPS == tpu_pt.vmath.EPS == 1e-12
    assert tp.vmath.Vec3 is torch.Tensor
    tiny = torch.tensor([[1e-7, 0.0, 0.0], [2e-6, 0.0, 0.0]])
    assert tp.vmath.normalize(tiny).tolist() == [[0.0, 0.0, 0.0],
                                                 [1.0, 0.0, 0.0]]
