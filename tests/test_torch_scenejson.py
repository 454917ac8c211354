"""Port parity for scene JSON and the glTF path into the path tracer:
tpu_pt_torch.scene.scenejson / load_scene against tpu_pt's, leaf for leaf
and bit for bit (the LBVH by its size, tests/test_torch_lbvh.py holds its
tables), 32^2 frames against the JAX render within
tests/test_torch_render.py's bound, and the three committed goldens of
the analytic geometry at RMSE < 0.01 on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import render as jrender  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film  # noqa: E402
from tpu_pt_torch.render import CameraArrays, init_accum, render_frame  # noqa: E402
from tpu_pt_torch.scene import scene_from_numpy  # noqa: E402
from test_torch_render import BASE  # noqa: E402
from test_torch_scene import assert_same_scene, numpy_leaves  # noqa: E402
from test_torch_whitted import GOLDENS, PBR_CAM, _camera  # noqa: E402

JSON_SCENES = ["cornell_prims.json", "cornell_curves.json"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", JSON_SCENES + ["pbr_test.gltf"])
def test_load_scene_matches_reference(assets_dir, name):
    """Every leaf of the loaded scene equal: triangles, materials, the
    light (for the glTF asset the quad made from its first point light),
    the occluder subset, primitives and curves."""
    path = str(assets_dir / name)
    ours, ref = tp.load_scene(path, device="cpu"), tpu_pt.load_scene(path)
    assert_same_scene(ours, ref)
    assert ours.bvh is not None
    if name == "cornell_prims.json":
        assert ours.prims.count == 3 and ours.prims.occludes == (False, True,
                                                                 True)
    elif name == "cornell_curves.json":
        assert ours.curves.count == 8
    # The scene carries over as numpy, analytic parts and BVH included.
    carried = scene_from_numpy(numpy_leaves(ref), ref.num_tris,
                               ref.num_occluders, device="cpu")
    assert_same_scene(carried, ref)
    np.testing.assert_array_equal(carried.bvh.nodes.numpy(),
                                  np.asarray(ref.bvh.nodes))


def test_scene_json_options(assets_dir, tmp_path):
    """A light override, primitives without a mesh, and the errors."""
    doc = dict(materials=[dict(name="RefractiveBall", ior=1.4),
                          dict(name="Panel", diffuse=[0.2, 0.3, 0.4],
                               bsdf=1)],
               primitives=[dict(type="sphere", center=[0, 0, 0], radius=1.0,
                                material="RefractiveBall"),
                           dict(type="curve", basis="linear",
                                points=[[0, 0, 0], [1, 1, 1]], radii=0.1,
                                material=2)],
               light=dict(corner=[-1, 3, -1], v1=[2, 0, 0], v2=[0, 0, 2],
                          emission=[5, 5, 5]))
    path = tmp_path / "s.json"
    path.write_text(json.dumps(doc))
    ours, ref = tp.load_scene(str(path), device="cpu"), \
        tpu_pt.load_scene(str(path))
    assert_same_scene(ours, ref)
    assert ours.num_tris == 0 and ours.bvh is None
    assert ours.prims.occludes == (False,) and ours.curves.count == 1
    np.testing.assert_array_equal(ours.light.normal.numpy(), [0, -1, 0])
    for bad, msg in ((dict(primitives=[dict(type="cube")]), "primitive type"),
                     (dict(primitives=[dict(type="sphere", center=[0, 0, 0],
                                            radius=1, material="nope")]),
                      "unknown material")):
        path.write_text(json.dumps(bad))
        with pytest.raises(ValueError, match=msg):
            tp.load_scene(str(path), device="cpu")


@pytest.mark.parametrize("name", JSON_SCENES)
def test_frame_matches_reference(assets_dir, name):
    """A 32^2 x 4 spp frame (IS + NEE, depth 4) against the JAX render of
    the same file, within tests/test_torch_render.py's bound."""
    path = str(assets_dir / name)
    cfg = tp.RenderConfig(**BASE)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    accum, _, stats = render_frame(tp.load_scene(path, device="cpu"), cam,
                                   cfg, 0, init_accum(cfg, device="cpu"))
    jcfg = tpu_pt.RenderConfig(**BASE)
    jcam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    ref, _, ref_stats = jrender.render_frame(tpu_pt.load_scene(path), jcam,
                                             jcfg, 0,
                                             jrender.init_accum(jcfg))
    paths = BASE["width"] * BASE["height"] * BASE["spp"]
    assert int(stats.done_histogram[tp.render.NOT_DONE]) == 0
    delta = np.abs(np.asarray(stats.done_histogram, np.float64)
                   - np.asarray(ref_stats.done_histogram, np.float64))
    assert (delta <= 1e-3 * paths).all(), delta
    diff = np.abs(accum.numpy() - np.asarray(ref)).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01, np.sort(diff.ravel())[-12:]


@pytest.mark.parametrize("name, golden", [("cornell_prims.json", "primitives"),
                                          ("cornell_curves.json", "curves")])
def test_golden(assets_dir, name, golden):
    """tools/make_goldens.py's configuration (128^2, 32 spp, depth 4, IS +
    NEE, one frame) on the CPU, RMSE < 0.01 against the committed PNG."""
    scene = tp.load_scene(str(assets_dir / name), device="cpu")
    cfg = tp.RenderConfig(width=128, height=128, spp=32, max_depth=4,
                          use_importance_sampling=True,
                          use_direct_lighting=True)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    _, u8, stats = render_frame(scene, cam, cfg, 0,
                                init_accum(cfg, device="cpu"))
    assert int(stats.done_histogram[tp.render.NOT_DONE]) == 0
    want = film.read_png(str(GOLDENS / f"{golden}.png"))
    err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                    want.astype(np.float32) / 255.0)
    assert err < 0.01, err


def test_golden_whitted_prims_curves(assets_dir):
    """``pbr_prims.gltf`` (extras primitives and curves) through the
    Whitted pipeline at tools/make_goldens.py's configuration (128^2, 8
    spp, depth 8, two frames), RMSE < 0.01. The triangles take ``dense``
    (the plain versions of K1 and K2), as tests/test_torch_whitted.py's
    goldens do."""
    ws = tp.load_gltf(str(assets_dir / "pbr_prims.gltf"), device="cpu")
    cfg = tp.RenderConfig(width=128, height=128, spp=8, max_depth=8,
                          background=(0.1, 0.15, 0.25), intersector="dense")
    cam = CameraArrays.from_camera(_camera(PBR_CAM), device="cpu")
    accum = init_accum(cfg, device="cpu")
    for f in range(2):
        accum, u8, stats = tp.render_whitted_frame(ws, cam, cfg, f, accum)
    assert int(stats.done_histogram[tp.render.NOT_DONE]) == 0
    want = film.read_png(str(GOLDENS / "whitted-prims-curves.png"))
    err = film.rmse(tp.image_to_host(u8).astype(np.float32) / 255.0,
                    want.astype(np.float32) / 255.0)
    assert err < 0.01, err


def test_validate_and_cli_know_the_new_geometry(assets_dir, tmp_path):
    """``validate_frame`` accepts primitive and curve ids (past the padded
    triangles); the CLI renders a scene JSON through ``--intersector bvh``
    and a glTF asset through the path tracer."""
    from tpu_pt_torch import cli, debug
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    cfg = tp.RenderConfig(width=16, height=16, spp=1, max_depth=3,
                          use_direct_lighting=True)
    for name in JSON_SCENES:
        scene = tp.load_scene(str(assets_dir / name), device="cpu")
        _, u8, stats = debug.validate_frame(scene, cam, cfg)
        assert u8.shape == (16, 16, 3)
    ws = tp.load_gltf(str(assets_dir / "pbr_prims.gltf"), device="cpu")
    debug.validate_whitted_frame(
        ws, CameraArrays.from_camera(_camera(PBR_CAM), device="cpu"),
        cfg.with_(background=(0.1, 0.15, 0.25)))
    small = ["--width", "16", "--height", "16", "--spp", "1", "--depth", "2",
             "--device", "cpu", "--frames", "1"]
    out = tmp_path / "a.png"
    assert cli.main(["render", str(assets_dir / "cornell_prims.json"), "-o",
                     str(out), "--intersector", "bvh", *small]) == 0
    assert film.read_png(str(out)).shape == (16, 16, 3)
    assert cli.main(["render", str(assets_dir / "pbr_test.gltf"), "-o",
                     str(out), "--pipeline", "pathtrace", *small]) == 0
    assert film.read_png(str(out)).shape == (16, 16, 3)
