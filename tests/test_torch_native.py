"""Port parity for the native host library: tpu_pt_torch.native (the OBJ
parser, the host LBVH build, PNG unfiltering) against the port's Python
paths and against tpu_pt.native (the cases of tests/test_native.py, on
the port).

Tolerances: the native and Python parses are equal (vertices to 1e-6
relative, as tests/test_native.py holds them; indices, material ids and
names exactly); the port's native LBVH node table is equal bit for bit to
the JAX package's native one (both run the same C++ on the same arrays);
the unfilters are equal byte for byte. The native and device trees break
Morton ties differently, so they are held to each other only through
their walks: hits equal, t to 1e-5 relative, and renders that differ by
more than 2e-5 on under 0.5% of pixel channels (tests/test_native.py's
bounds).
"""

import dataclasses
import pathlib
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import lbvh as jlbvh  # noqa: E402
from tpu_pt.scene import objloader as jobjloader  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film, native  # noqa: E402
from tpu_pt_torch.intersect import lbvh, moller  # noqa: E402
from tpu_pt_torch.render import CameraArrays, render_wavefront  # noqa: E402
from tpu_pt_torch.scene import objloader  # noqa: E402
from tpu_pt_torch.scene.objloader import (_load_obj_python,  # noqa: E402
                                          load_obj)
from torch_ref_native import reference_native  # noqa: E402

GOLDENS = sorted((pathlib.Path(__file__).parent / "goldens").glob("*.png"))
CORNELL = ["cornell_box.obj", "cornell_box_mixed.obj",
           "cornell_box_sphere.obj"]
BVH_FIELDS = ("nodes", "left", "skip", "tri")

needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native toolchain unavailable")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_mesh(a, b):
    np.testing.assert_allclose(a.vertices, b.vertices, rtol=1e-6)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.mat_indices, b.mat_indices)
    assert [m.name for m in a.materials] == [m.name for m in b.materials]
    for x, y in zip(a.materials, b.materials):
        np.testing.assert_allclose(x.diffuse, y.diffuse, rtol=1e-6)
        np.testing.assert_allclose(x.emission, y.emission, rtol=1e-6)
        assert x.bsdf == y.bsdf
        np.testing.assert_allclose(x.ior, y.ior, rtol=1e-6)


@needs_native
@pytest.mark.parametrize("asset", CORNELL)
def test_native_obj_matches_python(assets_dir, asset):
    """Native parse equal to the Python one, and to the JAX package's."""
    path = str(assets_dir / asset)
    nat = load_obj(path, use_native=True)
    _same_mesh(_load_obj_python(path), nat)
    reference_native()
    ref = jobjloader.load_obj(path, use_native=True)
    for k in ("vertices", "indices", "mat_indices"):
        np.testing.assert_array_equal(getattr(nat, k), getattr(ref, k))
    assert ([m.as_dict() for m in nat.materials]
            == [m.as_dict() for m in ref.materials])


@needs_native
def test_native_obj_quads_negative_indices(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n")
    py = _load_obj_python(str(p))
    nat = load_obj(str(p), use_native=True)
    np.testing.assert_array_equal(py.indices, nat.indices)
    assert nat.indices.shape == (2, 3)


@needs_native
def test_native_obj_missing_file():
    with pytest.raises(FileNotFoundError):
        native.load_obj_native("/nope/missing.obj")


@pytest.fixture(scope="module")
def port_mixed(assets_dir):
    return tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                         device="cpu", build_bvh=False)


@needs_native
def test_native_lbvh_matches_bruteforce(port_mixed):
    scene = port_mixed
    bvh = lbvh.build_lbvh_host(scene)
    n = scene.num_tris_padded
    tri = bvh.tri.numpy()
    # Leaves cover all triangles exactly once.
    np.testing.assert_array_equal(np.sort(tri[tri >= 0]), np.arange(n))
    # The skip-link walk reaches every node.
    left, skip = bvh.left.numpy(), bvh.skip.numpy()
    visited = np.zeros(2 * n - 1, bool)
    cur, steps = 0, 0
    while cur != -1 and steps < 8 * n:
        visited[cur] = True
        cur = skip[cur] if tri[cur] >= 0 else left[cur]
        steps += 1
    assert visited.all()

    r = np.random.RandomState(1)
    o = torch.from_numpy((r.rand(2048, 3) * 550).astype(np.float32))
    d = torch.from_numpy(r.randn(2048, 3).astype(np.float32))
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    ref = moller.intersect_closest(scene, o, d)
    out = lbvh.intersect_closest(scene, o, d, bvh=bvh)
    assert torch.equal(ref.hit, out.hit)
    np.testing.assert_allclose(ref.t.numpy(), out.t.numpy(), rtol=1e-5)


@needs_native
def test_native_vs_device_bvh_render(assets_dir):
    """Renders through the native-built and the device-built trees
    agree."""
    scene = tp.load_scene(str(assets_dir / "cornell_box.obj"), device="cpu",
                          build_bvh=False)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    cfg = tp.RenderConfig(width=32, height=32, spp=2, max_depth=3,
                          use_direct_lighting=True,
                          use_importance_sampling=True, intersector="bvh")
    s_nat = lbvh.with_bvh(scene, builder="native")
    s_dev = lbvh.with_bvh(scene, builder="device")
    assert not torch.equal(s_nat.bvh.left, s_dev.bvh.left)
    ra, _ = render_wavefront(s_nat, cam, cfg, 0, 32 * 32, 0)
    rb, _ = render_wavefront(s_dev, cam, cfg, 0, 32 * 32, 0)
    # Same samples; the trees may break exact-t ties differently.
    diff = (ra - rb).abs().numpy()
    assert np.mean(diff > 2e-5) < 0.005


@needs_native
@pytest.mark.parametrize("asset", CORNELL)
def test_native_lbvh_equals_jax_native(assets_dir, asset):
    """The port's native node table equals the JAX package's bit for bit:
    through both loaders (``with_bvh`` "auto" with the host arrays), and
    through ``build_lbvh_host`` reading the scene's arrays back."""
    path = str(assets_dir / asset)
    reference_native()
    ref = tpu_pt.load_scene(path, build_bvh=False)
    ref_bvh = jlbvh.build_lbvh_host(ref)
    loaded = tp.load_scene(path, device="cpu")
    read_back = lbvh.build_lbvh_host(dataclasses.replace(loaded, bvh=None))
    for ours in (loaded.bvh, read_back):
        for k in BVH_FIELDS:
            a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref_bvh, k))
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
    loader = tpu_pt.load_scene(path).bvh.nodes
    np.testing.assert_array_equal(loaded.bvh.nodes.numpy(), np.asarray(loader))


def test_reference_native_recovers_a_lost_race(assets_dir):
    """A worker whose reference loader lost the build race (a failed load
    cached: ``_tried`` True, ``_lib`` None) has no native LBVH build; the
    tests' ``reference_native`` reloads the loader and gets the library
    back, and the native node tables are then equal bit for bit."""
    from tpu_pt import native as jnative
    reference_native()           # the library is built; skips without g++
    # Set directly, not by monkeypatch: the reload below gives the module a
    # new ``_TptMesh`` and a library bound to it, and restoring the old
    # ``_lib`` afterwards would pair the old binding with the new class,
    # failing the reference's own native tests later in this worker.
    jnative._tried, jnative._lib = True, None
    try:
        assert not jnative.available()
        path = str(assets_dir / "cornell_box.obj")
        ref = tpu_pt.load_scene(path, build_bvh=False)
        with pytest.raises(RuntimeError, match="native library unavailable"):
            jlbvh.build_lbvh_host(ref)
        assert reference_native() is jnative and jnative.available()
    finally:
        reference_native()
    ref_bvh = jlbvh.build_lbvh_host(ref)
    loaded = tp.load_scene(path, device="cpu")
    for k in BVH_FIELDS:
        np.testing.assert_array_equal(getattr(loaded.bvh, k).numpy(),
                                      np.asarray(getattr(ref_bvh, k)),
                                      err_msg=k)


def _png_rows(path):
    """(IDAT bytes inflated, h, w, channels) of a non-interlaced 8-bit
    PNG."""
    import struct
    data = pathlib.Path(path).read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag, payload = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, _, ctype = struct.unpack(">IIBB", payload[:10])
            channels = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
    return zlib.decompress(idat), h, w, channels


@needs_native
@pytest.mark.parametrize("png", GOLDENS, ids=[p.name for p in GOLDENS])
def test_unfilter_native_matches_python(png, monkeypatch):
    """Every golden PNG unfiltered natively and in numpy: equal; and
    ``film.read_png`` goes through the native scan."""
    raw, h, w, c = _png_rows(png)
    nat = native.unfilter_png_native(raw, h, w * c, c)
    np.testing.assert_array_equal(nat, film._unfilter_python(raw, h, w, c))
    calls = []
    scan = native.unfilter_png_native
    monkeypatch.setattr(native, "unfilter_png_native",
                        lambda *a: calls.append(a) or scan(*a))
    img = film.read_png(str(png))
    assert len(calls) == 1
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(img, film.read_png(str(png)))
    assert len(calls) == 1


@needs_native
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_unfilter_every_filter(channels):
    """Rows of every filter type (None, Sub, Up, Average, Paeth), random
    bytes: the native scan equals numpy's; an unknown filter raises in
    both."""
    r = np.random.default_rng(channels)
    h, w = 40, 13
    stride = w * channels
    rows = r.integers(0, 256, (h, stride + 1), dtype=np.uint8)
    rows[:, 0] = np.arange(h) % 5
    raw = rows.tobytes()
    np.testing.assert_array_equal(
        native.unfilter_png_native(raw, h, stride, channels),
        film._unfilter_python(raw, h, w, channels))
    rows[7, 0] = 5
    with pytest.raises(ValueError):
        native.unfilter_png_native(rows.tobytes(), h, stride, channels)
    with pytest.raises(ValueError):
        film._unfilter_python(rows.tobytes(), h, w, channels)


@needs_native
def test_with_bvh_builders(port_mixed):
    """``"native"`` builds on the host (the table of ``build_lbvh_host``),
    ``"auto"`` is ``"native"`` when the library is available,
    ``"device"`` is ``build_lbvh``; an unknown builder raises."""
    nat = lbvh.with_bvh(port_mixed, builder="native")
    want = lbvh.build_lbvh_host(port_mixed)
    for builder in ("native", "auto"):
        got = lbvh.with_bvh(port_mixed, builder=builder).bvh
        for k in BVH_FIELDS:
            assert torch.equal(getattr(got, k), getattr(want, k)), k
    dev = lbvh.with_bvh(port_mixed, builder="device").bvh
    assert torch.equal(dev.nodes, lbvh.build_lbvh(port_mixed).nodes)
    assert nat.bvh.num_nodes == dev.num_nodes == 2 * 512 - 1
    with pytest.raises(ValueError, match="unknown LBVH builder"):
        lbvh.with_bvh(port_mixed, builder="gpu")


def test_no_native_env_honoured(assets_dir, monkeypatch):
    """``TPU_PT_NO_NATIVE=1`` (or ``use_native=False``) parses in Python;
    the mesh is the same."""
    path = str(assets_dir / "cornell_box_mixed.obj")
    calls = []
    real = objloader._mesh_from_native
    monkeypatch.setattr(objloader, "_mesh_from_native",
                        lambda p: calls.append(p) or real(p))
    monkeypatch.setenv("TPU_PT_NO_NATIVE", "1")
    py = load_obj(path)
    assert calls == []
    assert load_obj(path, use_native=False).indices.shape == py.indices.shape
    assert calls == []
    monkeypatch.delenv("TPU_PT_NO_NATIVE")
    if native.available():
        _same_mesh(py, load_obj(path))
        assert calls == [path]


def test_without_the_library_python_paths(assets_dir, monkeypatch):
    """Without the native library (no g++, or a failed build) the loaders
    parse in Python, ``with_bvh`` "auto" builds on the device and PNGs
    unfilter in numpy; ``"native"`` raises."""
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert not native.available()
    path = str(assets_dir / "cornell_box_mixed.obj")
    scene = tp.load_scene(path, device="cpu")
    bare = tp.load_scene(path, device="cpu", build_bvh=False)
    assert torch.equal(scene.bvh.nodes, lbvh.build_lbvh(bare).nodes)
    assert film.read_png(str(GOLDENS[0])).shape[2] == 3
    with pytest.raises(RuntimeError, match="unavailable"):
        lbvh.with_bvh(bare, builder="native")


def test_library_built_under_build_dir(monkeypatch, tmp_path):
    """The library goes to build/tpu_pt_torch/ under a name that hashes the
    source and the flags, through a temporary file renamed into place."""
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "tpu_pt_torch")
    monkeypatch.setattr(native, "CXX_FLAGS", native.CXX_FLAGS + ("-g0",))
    assert native.library_path() != path
    if native.available():
        target = tmp_path / path.name
        assert native._build(target) and target.exists()
        assert sorted(p.name for p in tmp_path.iterdir()) == [path.name]
