"""Port parity for the glTF / Whitted pipeline: tpu_pt_torch.load_gltf and
render_whitted_frame against tpu_pt.scene.gltf.load_gltf and
tpu_pt.whitted.render_whitted_frame.

Tolerances: every host-built table of a loaded scene is bitwise equal
(the loaders run the same numpy operations), textures exactly. Frames are
rendered from the identical scene (the JAX scene's leaves carried over by
whitted_scene_from_numpy) with the same camera and config; both packages
draw the same samples (counter RNG), so ray counts, shadow-ray counts and
the DoneReason histogram agree, up to a few paths, and pixels agree to
float noise except where a one-ulp difference flips a discrete decision
(a shadow ray grazing the surface it leaves, as in
tests/test_torch_render.py; the JAX package samples textures with bf16
split matmuls, the port with gathers). So: at most 0.5% of paths change
their outcome, at most 2% of pixels differ by more than 1e-3, and the mean
difference stays below 1e-3.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import render as jrender  # noqa: E402
from tpu_pt.scene import gltf as jgltf  # noqa: E402
from tpu_pt import whitted as jwhitted  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film  # noqa: E402
from tpu_pt_torch.camera import Camera  # noqa: E402
from tpu_pt_torch.render import CameraArrays, init_accum  # noqa: E402
from tpu_pt_torch.scene import SceneArrays, WhittedScene  # noqa: E402
from tpu_pt_torch.scene.gltf import whitted_scene_from_numpy  # noqa: E402
from tpu_pt_torch.whitted import render_whitted_wavefront  # noqa: E402
from test_torch_scene import assert_same_scene, numpy_leaves  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
GOLDENS = REPO / "tests" / "goldens"
PBR_CAM = dict(eye=(6.0, 4.5, 7.0), lookat=(0.0, 0.8, 0.0), fov_y=40.0)
ALPHA_CAM = dict(eye=(2.0, 6.0, 13.0), lookat=(0.0, 0.5, 0.0), fov_y=45.0)
# The goldens' configurations (tools/make_goldens.py).
GOLDEN_RUNS = {
    "whitted-pbr": ("pbr_test.gltf", PBR_CAM,
                    dict(width=128, height=128, spp=8, max_depth=8,
                         background=(0.1, 0.15, 0.25))),
    "whitted-alpha-shadow": ("alpha_shadow.gltf", ALPHA_CAM,
                             dict(width=160, height=120, spp=8, max_depth=6,
                                  background=(0.05, 0.07, 0.12))),
}
TABLES = ("vtx_attr", "base_color", "metallic", "roughness", "emissive",
          "kind", "alpha_mode", "alpha_cutoff", "ior", "phong_ks",
          "phong_exp", "phong_kr", "checker2", "tex_id", "tex_uvx",
          "ntex_id", "ntex_scale", "mrtex_id", "etex_id", "tri_tangent",
          "light_pos", "light_color", "ambient")
STATIC = ("tex_wrap", "has_normal_maps", "has_mr_tex", "has_emissive_tex",
          "camera")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs several test workers; one PyTorch thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forest60(tmp_path_factory):
    """tools/make_gltf_assets.py's forest with 60 trees (121 instances)."""
    sys.path.insert(0, str(REPO / "tools"))
    import make_gltf_assets
    out = tmp_path_factory.mktemp("forest60")
    make_gltf_assets.build_forest(str(out), n_trees=60)
    return str(out / "forest.gltf")


def _scene_path(name, assets_dir, forest60):
    return forest60 if name == "forest60" else str(assets_dir / name)


def _geom_leaves(g) -> dict:
    leaves = numpy_leaves(g)
    leaves.update(num_tris=g.num_tris, num_occluders=g.num_occluders)
    return leaves


def _table_leaves(t):
    if t is None:
        return None
    return dict(rows=np.asarray(t.rows), nrm=np.asarray(t.nrm),
                fwd=np.asarray(t.fwd), boxes=np.asarray(t.boxes),
                count=t.count, mesh_ranges=t.mesh_ranges)


def whitted_leaves(ws) -> dict:
    """A JAX WhittedScene's leaves as numpy, in whitted_scene_from_numpy's
    layout."""
    leaves = {k: np.asarray(getattr(ws, k)) for k in TABLES}
    leaves.update({k: getattr(ws, k) for k in STATIC})
    leaves["geom"] = _geom_leaves(ws.geom)
    leaves["textures"] = [np.asarray(x) for x in ws.textures]
    leaves["inst"] = _table_leaves(ws.inst)
    ao = ws.alpha_occ
    leaves["alpha_occ"] = None if ao is None else dict(
        occ_geom=_geom_leaves(ao.occ_geom), geom=_geom_leaves(ao.geom),
        uv=np.asarray(ao.uv), max_hits=ao.max_hits,
        occ_inst=_table_leaves(ao.occ_inst), inst=_table_leaves(ao.inst))
    return leaves


def _assert_same_table(ours, ref):
    if ref is None:
        assert ours is None
        return
    assert ours.count == ref.count and ours.mesh_ranges == ref.mesh_ranges
    for k in ("rows", "nrm", "fwd"):
        np.testing.assert_array_equal(getattr(ours, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    np.testing.assert_array_equal(ours.boxes.numpy()[:, :6],
                                  np.asarray(ref.boxes)[:, :6])


def assert_same_whitted(ours: WhittedScene, ref) -> None:
    """Every leaf equal: tables bitwise (dtype included), textures exactly,
    the static fields, the geometry (its analytic primitives and curves
    and its LBVH included: bitwise where both packages build it natively,
    else its size), instance tables and the alpha split."""
    assert_same_scene(ours.geom, ref.geom)
    for k in TABLES:
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=k)
    for k in STATIC:
        assert getattr(ours, k) == getattr(ref, k), k
    assert len(ours.textures) == len(ref.textures)
    for a, b in zip(ours.textures, ref.textures):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    _assert_same_table(ours.inst, ref.inst)
    if ref.alpha_occ is None:
        assert ours.alpha_occ is None
        return
    a, b = ours.alpha_occ, ref.alpha_occ
    assert a.max_hits == b.max_hits
    assert_same_scene(a.occ_geom, b.occ_geom)
    assert_same_scene(a.geom, b.geom)
    np.testing.assert_array_equal(a.uv.numpy(), np.asarray(b.uv))
    _assert_same_table(a.occ_inst, b.occ_inst)
    _assert_same_table(a.inst, b.inst)


@pytest.mark.parametrize("name", ["checker.png", "bumps.png", "mr.png",
                                  "alpha.png", "leaf.png"])
def test_read_png_rgba_matches_reference(assets_dir, name):
    """Every texture of the committed glTF assets decodes to the same
    uint8 RGBA array as tpu_pt.film.read_png_rgba."""
    from tpu_pt import film as jfilm
    path = str(assets_dir / name)
    ours, ref = film.read_png_rgba(path), jfilm.read_png_rgba(path)
    assert ours.dtype == ref.dtype == np.uint8 and ours.shape[2] == 4
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("name", ["pbr_test.gltf", "pbr_test.glb",
                                  "alpha_shadow.gltf", "forest60"])
def test_load_gltf_matches_reference(assets_dir, forest60, name):
    path = _scene_path(name, assets_dir, forest60)
    ours, ref = tp.load_gltf(path, device="cpu"), jgltf.load_gltf(path)
    assert_same_whitted(ours, ref)
    # And the scene carried over from the JAX leaves is the same scene.
    assert_same_whitted(
        whitted_scene_from_numpy(whitted_leaves(ref), device="cpu"), ref)


@pytest.mark.parametrize("name,instanced", [
    ("forest.gltf", True), ("foliage.gltf", False), ("pbr_test.gltf", False),
    ("alpha_shadow.gltf", False), ("forest60", True)])
def test_auto_contract_matches_reference(assets_dir, forest60, name,
                                         instanced):
    """``auto`` keeps the instances exactly where the JAX loader does:
    the forests (>= 8x amplification at >= 32k flattened triangles), not
    foliage (9,602 flattened triangles)."""
    path = _scene_path(name, assets_dir, forest60)
    ours = tp.load_gltf(path, device="cpu")
    assert (ours.inst is not None) is instanced
    assert (jgltf.load_gltf(path).inst is not None) is instanced
    if name == "forest.gltf":
        assert ours.inst.count == 1001 and ours.geom.num_tris == 986


def test_forest_flattens_under_tpt_instancing(assets_dir, monkeypatch):
    """Under TPT_INSTANCING=flatten both loaders flatten the forest that
    ``auto`` keeps instanced: 1,001 instances to 492,002 world-space
    triangles, the same count."""
    for name in ("TPT_MAX_FLAT_TRIS", "TPT_INST_AUTO_AMP",
                 "TPT_INST_AUTO_MIN"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("TPT_INSTANCING", "flatten")
    path = str(assets_dir / "forest.gltf")
    ours, ref = tp.load_gltf(path, device="cpu"), jgltf.load_gltf(path)
    assert ours.inst is None and ref.inst is None
    assert ours.geom.num_tris == ref.geom.num_tris == 492002


def test_instanced_alpha_split_matches_reference(assets_dir):
    """foliage.gltf loaded instanced: the unique meshes, the 601-instance
    table and the opaque / alpha subset instance tables are the JAX
    package's."""
    path = str(assets_dir / "foliage.gltf")
    ours = tp.load_gltf(path, instancing="instanced", device="cpu")
    ref = jgltf.load_gltf(path, instancing="instanced")
    assert ours.inst.count == 601 and ours.alpha_occ.inst is not None
    assert_same_whitted(ours, ref)


def test_unported_inputs_raise(assets_dir, tmp_path):
    """Nothing of these inputs is unported now (the name stays): a JPEG
    texture loads, equal to the JAX loader's; the extras analytic
    primitives and curves load, equal to the JAX loader's."""
    path = str(assets_dir / "pbr_prims.gltf")
    ours = tp.load_gltf(path, device="cpu")
    assert ours.geom.prims.count == 3 and ours.geom.curves.count == 3
    assert ours.inst is None
    assert_same_whitted(ours, jgltf.load_gltf(path))
    import json
    from tpu_pt_torch import jpeg
    doc = json.loads((assets_dir / "alpha_shadow.gltf").read_text())
    png = film.read_png(str(assets_dir / doc["images"][0]["uri"]))
    (tmp_path / "a.jpg").write_bytes(jpeg.encode_jpeg(png, quality=90))
    for img in doc["images"][1:]:
        (tmp_path / img["uri"]).write_bytes(
            (assets_dir / img["uri"]).read_bytes())
    for buf in doc["buffers"]:
        if "uri" in buf and not buf["uri"].startswith("data:"):
            (tmp_path / buf["uri"]).write_bytes(
                (assets_dir / buf["uri"]).read_bytes())
    doc["images"][0]["uri"] = "a.jpg"
    (tmp_path / "a.gltf").write_text(json.dumps(doc))
    ours = tp.load_gltf(str(tmp_path / "a.gltf"), device="cpu")
    ref = jgltf.load_gltf(str(tmp_path / "a.gltf"))
    assert ours.textures[0].shape[:2] == png.shape[:2]
    assert_same_whitted(ours, ref)


def _camera(spec):
    return Camera(eye=np.array(spec["eye"], np.float32),
                  lookat=np.array(spec["lookat"], np.float32),
                  fov_y=spec["fov_y"])


@pytest.mark.parametrize("golden", list(GOLDEN_RUNS))
def test_golden(assets_dir, golden):
    """The two Whitted goldens through the port on the CPU at their
    configurations (two progressive frames), RMSE < 0.01 as
    tests/test_goldens.py holds the JAX package. The reference renders
    them by brute force; here they take ``dense``, the plain versions of
    the kernels the card runs (K1 and K2), which also halves the CPU
    time."""
    scene, cam_spec, kw = GOLDEN_RUNS[golden]
    ws = tp.load_gltf(str(assets_dir / scene), device="cpu")
    cfg = tp.RenderConfig(intersector="dense", **kw)
    cam = CameraArrays.from_camera(_camera(cam_spec), device="cpu")
    accum = init_accum(cfg, device="cpu")
    for f in range(2):
        accum, img, stats = tp.render_whitted_frame(ws, cam, cfg, f, accum)
    ref = film.read_png(str(GOLDENS / f"{golden}.png")).astype(np.float32)
    ours = tp.image_to_host(img).astype(np.float32)
    assert film.rmse(ours / 255.0, ref / 255.0) < 0.01
    assert int(stats.done_histogram.sum()) == kw["width"] * kw["height"] \
        * kw["spp"]


def _jax_frame(jws, cam_spec, cfg):
    from tpu_pt.camera import Camera as JCamera
    jcam = jrender.CameraArrays.from_camera(JCamera(
        eye=np.array(cam_spec["eye"], np.float32),
        lookat=np.array(cam_spec["lookat"], np.float32),
        fov_y=cam_spec["fov_y"]))
    accum, _, stats = jwhitted.render_whitted_frame(
        jws, jcam, cfg, 0, jrender.init_accum(cfg))
    return np.asarray(accum), stats


def _stats(st):
    return np.concatenate([np.asarray(st.done_histogram, np.float64)[:3],
                           [float(st.rays_traced), float(st.shadow_rays)]])


@pytest.mark.parametrize("scene,cam_spec", [
    ("pbr_test.gltf", PBR_CAM), ("alpha_shadow.gltf", ALPHA_CAM)])
def test_frame_matches_reference(assets_dir, scene, cam_spec):
    """A 32^2 x 2 spp frame against tpu_pt.whitted.render_whitted_frame
    on the identical scene; the shadow-ray telemetry (``shadow_count``,
    one ray per lit light) included."""
    kw = dict(width=32, height=32, spp=2, max_depth=8,
              background=(0.1, 0.15, 0.25), intersector="bruteforce")
    jws = jgltf.load_gltf(str(assets_dir / scene))
    ref, ref_stats = _jax_frame(jws, cam_spec, tpu_pt.RenderConfig(**kw))
    ws = whitted_scene_from_numpy(whitted_leaves(jws), device="cpu")
    cfg = tp.RenderConfig(**kw)
    cam = CameraArrays.from_camera(_camera(cam_spec), device="cpu")
    accum, _, stats = tp.render_whitted_frame(ws, cam, cfg, 0,
                                              init_accum(cfg, device="cpu"))
    ours = accum.numpy()
    paths = 32 * 32 * 2
    assert int(stats.done_histogram.sum()) == paths
    assert float(stats.shadow_rays) > 0.3 * paths
    delta = np.abs(_stats(stats) - _stats(ref_stats))
    assert (delta <= 5e-3 * paths).all(), delta
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff > 1e-3).mean() <= 0.02, np.sort(diff.ravel())[-12:]


def test_pixelq_matches_wide_loop(assets_dir):
    """The pixelq scheduler traces the same paths as the wide depth loop
    (the counter RNG keys every draw by pixel, sample and depth): equal
    stats, radiance up to float add order."""
    ws = tp.load_gltf(str(assets_dir / "pbr_test.gltf"), device="cpu")
    cam = CameraArrays.from_camera(_camera(PBR_CAM), device="cpu")
    out = {}
    for s in ("pixelq", "scan"):
        cfg = tp.RenderConfig(width=24, height=24, spp=3, max_depth=6,
                              scheduler=s, background=(0.1, 0.15, 0.25),
                              intersector="bruteforce")
        out[s] = render_whitted_wavefront(ws, cam, cfg, 0, 24 * 24, 0)
    (a, sa), (b, sb) = out["pixelq"], out["scan"]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    assert int(sa.rays_traced) == int(sb.rays_traced)
    assert int(sa.shadow_rays) == int(sb.shadow_rays)
    assert torch.equal(sa.done_histogram, sb.done_histogram)


@pytest.mark.parametrize("scheduler", ["regen", "scan"])
def test_every_scheduler_but_pixelq_takes_the_wide_loop(assets_dir,
                                                        scheduler):
    """``regen`` (like ``scan``) renders through the wide depth loop, as
    tpu_pt.whitted does for every scheduler but ``pixelq``: the same
    frame as the JAX package's under that scheduler, and the same as the
    port's ``scan`` frame."""
    kw = dict(width=16, height=16, spp=2, max_depth=8,
              background=(0.1, 0.15, 0.25), intersector="bruteforce")
    jws = jgltf.load_gltf(str(assets_dir / "pbr_test.gltf"))
    ref, ref_stats = _jax_frame(jws, PBR_CAM,
                                tpu_pt.RenderConfig(scheduler=scheduler, **kw))
    ws = whitted_scene_from_numpy(whitted_leaves(jws), device="cpu")
    cam = CameraArrays.from_camera(_camera(PBR_CAM), device="cpu")
    out = {}
    for s in (scheduler, "scan"):
        cfg = tp.RenderConfig(scheduler=s, **kw)
        out[s] = tp.render_whitted_frame(ws, cam, cfg, 0,
                                         init_accum(cfg, device="cpu"))
    accum, _, stats = out[scheduler]
    assert torch.equal(accum, out["scan"][0])
    paths = 16 * 16 * 2
    assert int(stats.done_histogram.sum()) == paths
    delta = np.abs(_stats(stats) - _stats(ref_stats))
    assert (delta <= max(1.0, 5e-3 * paths)).all(), delta
    diff = np.abs(accum.numpy() - ref).max(axis=-1)
    assert diff.mean() < 1e-3, diff.mean()
    assert (diff > 1e-3).mean() <= 0.02, np.sort(diff.ravel())[-6:]


@pytest.mark.parametrize("scheduler", ["pixelq", "scan"])
def test_whitted_sample_offset(assets_dir, scheduler):
    """``render_whitted_wavefront(..., sample_offset=k)`` shifts the RNG's
    sample axis: two 1-spp calls at offsets 0 and 1 average to the 2-spp
    call (float add order), and agree with the JAX package's call at the
    same offset."""
    kw = dict(width=16, height=16, max_depth=8, scheduler=scheduler,
              background=(0.1, 0.15, 0.25), intersector="bruteforce")
    jws = jgltf.load_gltf(str(assets_dir / "pbr_test.gltf"))
    ws = whitted_scene_from_numpy(whitted_leaves(jws), device="cpu")
    cam = CameraArrays.from_camera(_camera(PBR_CAM), device="cpu")
    n = 16 * 16
    full, _ = render_whitted_wavefront(ws, cam, tp.RenderConfig(spp=2, **kw),
                                       0, n, 0)
    one = tp.RenderConfig(spp=1, **kw)
    a, _ = render_whitted_wavefront(ws, cam, one, 0, n, 0)
    b, sb = render_whitted_wavefront(ws, cam, one, 0, n, 0, sample_offset=1)
    np.testing.assert_allclose((0.5 * (a + b)).numpy(), full.numpy(), rtol=0,
                               atol=1e-6)
    assert float((a - b).abs().max()) > 1e-2
    from tpu_pt.camera import Camera as JCamera
    jcam = jrender.CameraArrays.from_camera(JCamera(
        eye=np.array(PBR_CAM["eye"], np.float32),
        lookat=np.array(PBR_CAM["lookat"], np.float32),
        fov_y=PBR_CAM["fov_y"]))
    ref, ref_stats = jwhitted.render_whitted_wavefront(
        jws, jcam, tpu_pt.RenderConfig(spp=1, **kw), 0, n, 0,
        sample_offset=1)
    diff = np.abs(b.numpy() - np.asarray(ref)).max(axis=-1)
    assert diff.mean() < 1e-3 and (diff > 1e-3).mean() <= 0.02
    assert abs(float(sb.rays_traced) - float(ref_stats.rays_traced)) <= 2


def test_scene_moves_between_devices(assets_dir):
    """``WhittedScene.to`` moves every tensor, nested tables included."""
    ws = tp.load_gltf(str(assets_dir / "foliage.gltf"),
                      instancing="instanced", device="cpu")
    moved = ws.to("cpu")
    assert moved.device.type == "cpu"
    assert isinstance(moved.geom, SceneArrays)
    assert moved.alpha_occ.inst.rows.device.type == "cpu"
    assert dataclasses.is_dataclass(moved.inst)
    lo, hi = moved.world_bounds()
    assert (hi > lo).all()
