"""The port's debugging and profiling tools on the CPU (counterparts of
``tests/test_debug.py`` and ``tpu_pt.profiling``): ``trace_pixel``
against ``tpu_pt.debug.trace_pixel`` and against the port's own frame,
``validate_frame`` / ``validate_whitted_frame`` and their checks, and the
``RenderProfiler`` report.

``trace_pixel`` records of the two packages agree on the DoneReasons and,
within 1e-5, on the per-bounce contributions: both trace the same sample
(bitwise counter RNG) through the same transition, up to the float noise
of tests/test_torch_render.py.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import debug as jdebug, render as jrender  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import debug, profiling  # noqa: E402
from tpu_pt_torch.intersect import Hit, dense  # noqa: E402
from tpu_pt_torch.render import (CameraArrays, init_accum,  # noqa: E402
                                 render_frame, render_wavefront)
from tpu_pt_torch.whitted import render_whitted_frame  # noqa: E402

CFG = dict(width=16, height=16, spp=1, max_depth=4,
           use_direct_lighting=True, use_importance_sampling=True)
PIXELS = [(8, 8), (3, 12), (13, 2)]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    return scene, cam


@pytest.mark.parametrize("fused", [False, True])
def test_trace_pixel_matches_reference(mixed_scene, port, fused):
    """Unfused: brute force in both packages; fused: the port's plain K4
    against tpu_pt's fused Pallas kernel in interpret mode."""
    scene, cam = port
    jcam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    extra = dict(fused_nee=True, intersector="dense") if fused else {}
    jextra = dict(extra, intersector="pallas") if fused else {}
    cfg = tp.RenderConfig(**CFG, **extra)
    jcfg = tpu_pt.RenderConfig(**CFG, **jextra)
    for x, y in PIXELS:
        ours = debug.trace_pixel(scene, cam, cfg, x, y)
        ref = jdebug.trace_pixel(mixed_scene, jcam, jcfg, x, y)
        assert [r["reason"] for r in ours] == [r["reason"] for r in ref]
        for a, b in zip(ours, ref):
            assert a["depth"] == b["depth"] and a["done"] == b["done"]
            np.testing.assert_allclose(a["contrib"], b["contrib"], atol=1e-5)
            np.testing.assert_allclose(a["atten"], b["atten"], atol=1e-5)
    assert "d0:" in debug.format_trace(ours)


def test_trace_pixel_sums_to_frame_fused(port):
    """Under fused_nee (the plain K4 here), each pixel's per-bounce
    contributions sum to its radiance in a 1-spp frame."""
    scene, cam = port
    cfg = tp.RenderConfig(**CFG, fused_nee=True, intersector="dense")
    radiance, _ = render_wavefront(scene, cam, cfg, 0, 16 * 16, 0)
    for x, y in PIXELS:
        records = debug.trace_pixel(scene, cam, cfg, x, y)
        assert records[-1]["done"] and records[-1]["reason"] != "NOT_DONE"
        total = torch.tensor([r["contrib"] for r in records]).sum(0)
        torch.testing.assert_close(total, radiance[y * 16 + x], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("extra", [dict(), dict(fused_nee=True,
                                                 intersector="dense")])
def test_validate_frame_clean_and_equal(port, extra):
    """A healthy frame passes every check and equals render_frame's."""
    scene, cam = port
    cfg = tp.RenderConfig(**{**CFG, "spp": 2}, **extra)
    accum, img, stats = debug.validate_frame(scene, cam, cfg)
    _, ref_img, _ = render_frame(scene, cam, cfg, 0,
                                 init_accum(cfg, device="cpu"))
    assert torch.equal(img, ref_img) and int(stats.rays_traced) > 0


def test_validate_frame_raises_on_nan(port):
    scene, cam = port
    bad = dataclasses.replace(scene,
                              mat_diffuse=scene.mat_diffuse * float("nan"))
    with pytest.raises(debug.ValidationError, match="NaN"):
        debug.validate_frame(bad, cam, tp.RenderConfig(**CFG))


def test_hit_checks_name_the_failure(port):
    """Out-of-range ids and non-finite hits raise with the check's name."""
    scene, _ = port
    n = 4
    good = Hit(t=torch.ones(n), tri=torch.zeros(n, dtype=torch.int32),
               hit=torch.ones(n, dtype=torch.bool), normal=torch.ones(n, 3),
               mat=torch.zeros(n, dtype=torch.int32), u=torch.zeros(n),
               v=torch.zeros(n), inst=torch.zeros(n, dtype=torch.int32))
    closest, _, _ = debug._checked(lambda o, d: hit, None, scene, n_inst=2)
    o = torch.zeros(n, 3)
    for field, value, name in (
            ("mat", scene.num_materials, "material id"),
            ("tri", -1, "row id"), ("inst", 2, "instance id"),
            ("t", float("inf"), "hit t")):
        col = getattr(good, field).clone()
        col[1] = value
        hit = dataclasses.replace(good, **{field: col})
        with pytest.raises(debug.ValidationError, match=name):
            closest(o, o)
    hit = dataclasses.replace(good, mat=torch.full((n,), 99, dtype=torch.int32),
                              hit=torch.zeros(n, dtype=torch.bool))
    closest(o, o)                          # ids of miss lanes are not read


def test_validate_whitted_frame(assets_dir):
    ws = tp.load_gltf(str(assets_dir / "pbr_test.gltf"), device="cpu")
    cam = CameraArrays.from_camera(tp.Camera(
        eye=np.array([6.0, 4.5, 7.0], np.float32),
        lookat=np.array([0.0, 0.8, 0.0], np.float32), fov_y=40.0),
        device="cpu")
    cfg = tp.RenderConfig(width=16, height=16, spp=1, max_depth=3,
                          background=(0.1, 0.15, 0.25))
    _, img, _ = debug.validate_whitted_frame(ws, cam, cfg)
    _, ref, _ = render_whitted_frame(ws, cam, cfg, 0,
                                     init_accum(cfg, device="cpu"))
    assert torch.equal(img, ref)


def test_render_profiler_report(port, tmp_path):
    scene, cam = port
    cfg = tp.RenderConfig(**CFG)
    prof = profiling.RenderProfiler(lanes=cfg.lanes)
    accum = init_accum(cfg, device="cpu")
    for f in range(2):
        with prof.frame():
            accum, img, stats = render_frame(scene, cam, cfg, f, accum)
            profiling.device_barrier(img)
        rec = prof.record(stats)
        assert rec.ms > 0 and rec.rays == float(stats.rays_traced)
    hist = prof.termination_histogram()
    assert sum(hist.values()) == 2 * 16 * 16 and hist["NOT_DONE"] == 0
    text = prof.report()
    assert "frames rendered : 2" in text and "Mrays/s" in text
    assert "occupancy" in text and "RUSSIAN_ROULETTE=" in text
    assert prof.mrays_per_sec > 0 and 0 < prof.occupancy() < 1
    assert profiling.barrier_rtt(img) >= 0
    with profiling.device_trace(str(tmp_path / "trace")) as p:
        dense._closest_plain(torch.zeros(4, 3), torch.ones(4, 3),
                             dense.prepare(scene).rows, 0.01)
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert len(p.key_averages()) > 0
