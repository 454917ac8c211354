"""Port parity for the slice as a whole: tpu_pt_torch.render_frame against
tpu_pt.render_frame on the identical scene (the JAX scene's leaves carried
over with scene_from_numpy), same camera, same config.

Both packages draw the same samples (bitwise counter RNG), so the DoneReason
histogram and ray counts agree and the frames agree to float noise, except
where a one-ulp difference flips a discrete decision. XLA and PyTorch round
rsqrt, sin and cos differently on the CPU (and XLA fuses multiply-adds),
and the reference algorithm has shadow-ray self-intersection at grazing
angles (a point on a wall, a light direction almost in its plane) whose
outcome turns on that ulp. Measured at 32x32 x 4 spp: 0 of 4,096 paths
change their DoneReason, 4 of 1,024 pixels differ by more than 1e-4 (the
largest, 0.0195, is one NEE sample occluded on one side only). So: counts
may differ on at most 0.1% of paths, and at most 1% of pixels may differ
by more than 1e-4; the mean difference stays below 1e-4.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import render as jrender  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film  # noqa: E402
from tpu_pt_torch.render import (CameraArrays, NUM_DONE_REASONS,  # noqa: E402
                                 NOT_DONE, init_accum, render_frame,
                                 render_wavefront)
from tpu_pt_torch.scene import scene_from_numpy  # noqa: E402
from test_torch_scene import numpy_leaves  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
BASE = dict(width=32, height=32, spp=4, max_depth=4,
            use_direct_lighting=True, use_importance_sampling=True,
            intersector="bruteforce")
PATHS = BASE["width"] * BASE["height"] * BASE["spp"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers on the machine's cores, and PyTorch's
    intra-op threads spin against them: with the default thread count the
    128^2 golden took 75 s there (11 s alone), on one thread 32 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_scene(mixed_scene):
    return scene_from_numpy(numpy_leaves(mixed_scene), mixed_scene.num_tris,
                            mixed_scene.num_occluders)


def _port_frame(scene, **overrides):
    cfg = tp.RenderConfig(**{**BASE, **overrides})
    cam = CameraArrays.from_camera(tp.cornell_default_camera())
    accum, u8, stats = render_frame(scene, cam, cfg, 0, init_accum(cfg))
    return accum.numpy(), u8, stats


@pytest.fixture(scope="module")
def port_frames(port_scene):
    return {s: _port_frame(port_scene, scheduler=s)
            for s in ("scan", "pixelq")}


def _stats_vector(st):
    return np.concatenate([np.asarray(st.done_histogram, np.float64),
                           [float(st.rays_traced), float(st.shadow_rays)]])


@pytest.mark.parametrize("scheduler", ["scan", "pixelq"])
def test_frame_matches_reference(mixed_scene, port_frames, scheduler):
    cfg = tpu_pt.RenderConfig(scheduler=scheduler, **BASE)
    cam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    ref, _, ref_stats = jrender.render_frame(mixed_scene, cam, cfg, 0,
                                             jrender.init_accum(cfg))
    ref = np.asarray(ref)
    ours, u8, stats = port_frames[scheduler]

    assert int(stats.done_histogram.sum()) == PATHS
    assert int(stats.done_histogram[NOT_DONE]) == 0
    assert stats.done_histogram.shape == (NUM_DONE_REASONS,)
    delta = np.abs(_stats_vector(stats) - _stats_vector(ref_stats))
    assert (delta <= 1e-3 * PATHS).all(), delta

    assert ours.shape == ref.shape and np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01, np.sort(diff.ravel())[-12:]
    assert u8.dtype == torch.uint8 and tuple(u8.shape) == ref.shape


def test_scan_matches_pixelq(port_frames):
    scan, _, scan_stats = port_frames["scan"]
    pixq, _, pixq_stats = port_frames["pixelq"]
    np.testing.assert_allclose(pixq, scan, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_stats_vector(pixq_stats),
                                  _stats_vector(scan_stats))


def test_pixelq_progressive_accumulation(port_scene):
    """Frame k folds into the accumulator in place as the running mean."""
    cfg = tp.RenderConfig(**{**BASE, "width": 16, "height": 16, "spp": 2})
    cam = CameraArrays.from_camera(tp.cornell_default_camera())
    accum = init_accum(cfg)
    frames = []
    for k in range(3):
        radiance, _ = render_wavefront(port_scene, cam, cfg, 0, 16 * 16, k)
        frames.append(radiance.reshape(16, 16, 3))
        same, _, _ = render_frame(port_scene, cam, cfg, k, accum)
        assert same is accum
    np.testing.assert_allclose(accum.numpy(),
                               torch.stack(frames).mean(0).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_golden_importance_with_direct(assets_dir):
    """The README golden mode at its pinned configuration
    (tools/make_goldens.py: 128^2, 32 spp, depth 4, 1 frame), rendered by
    the port's pixelq scheduler through the dense intersector (the plain
    versions of the CUDA kernels, on the CPU)."""
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"))
    cfg = tp.RenderConfig(width=128, height=128, spp=32, max_depth=4,
                          use_importance_sampling=True,
                          use_direct_lighting=True, intersector="dense")
    cam = CameraArrays.from_camera(tp.cornell_default_camera())
    _, u8, stats = render_frame(scene, cam, cfg, 0, init_accum(cfg))
    assert int(stats.done_histogram[NOT_DONE]) == 0
    golden = film.read_png(str(REPO / "tests" / "goldens"
                               / "importance-with-direct.png"))
    ours = tp.image_to_host(u8).astype(np.float32) / 255.0
    err = film.rmse(ours, golden.astype(np.float32) / 255.0)
    assert err < 0.01, err


def test_port_imports_neither_jax_nor_reference():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['tpu_pt'] = None; sys.modules['flax'] = None; "
            "import tpu_pt_torch, tpu_pt_torch.render, "
            "tpu_pt_torch.intersect.dense, tpu_pt_torch._kernels")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
