"""The port's entry points on the CPU: checkpoint / resume, the CLI and
the bench (counterparts of ``tests/test_cli_checkpoint.py``).

The CLI runs in process through ``tpu_pt_torch.cli.main`` with
``--device cpu`` (one test runs ``python -m tpu_pt_torch.cli`` itself).
Resumed renders must equal straight ones bit for bit: the counter RNG
keys every sample by (pixel, sample, frame). A ``tpu_pt`` checkpoint
resumed by the port is held to ``tests/test_torch_render.py``'s bounds
against ``tpu_pt``'s own frames (the packages round differently).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import checkpoint as jcheckpoint, render as jrender  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import bench, cli, film  # noqa: E402
from tpu_pt_torch.checkpoint import (checkpoint_instancing,  # noqa: E402
                                     load_checkpoint, save_checkpoint)
from tpu_pt_torch.render import (CameraArrays, init_accum,  # noqa: E402
                                 render_frame)
from test_instanced import _write_instanced_city  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = dict(width=32, height=32, spp=2, max_depth=3,
           use_direct_lighting=True, use_importance_sampling=True)
SMALL = ["--width", "24", "--height", "24", "--spp", "1", "--depth", "2",
         "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def port_cornell(assets_dir):
    return tp.load_scene(str(assets_dir / "cornell_box.obj"), device="cpu")


def _frames(scene, cam, cfg, frames, accum):
    for f in frames:
        accum, _, _ = render_frame(scene, cam, cfg, f, accum)
    return accum


def test_checkpoint_roundtrip(tmp_path, port_cornell):
    cfg = tp.RenderConfig(**CFG)
    camera = tp.cornell_default_camera()
    cam = CameraArrays.from_camera(camera, device="cpu")
    accum = _frames(port_cornell, cam, cfg, range(2),
                    init_accum(cfg, device="cpu"))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, accum, 2, cfg, camera)
    accum2, fidx, cfg2, camera2 = load_checkpoint(p, device="cpu")
    assert fidx == 2 and cfg2 == cfg
    assert torch.equal(accum, accum2)
    np.testing.assert_array_equal(camera2.eye, camera.eye)
    assert camera2.fov_y == camera.fov_y
    assert checkpoint_instancing(p) is None
    # tpu_pt reads the port's checkpoints too.
    jaccum, jfidx, jcfg, _ = jcheckpoint.load_checkpoint(p)
    assert jfidx == 2 and jcfg.spp == cfg.spp
    np.testing.assert_array_equal(np.asarray(jaccum), accum.numpy())


def test_checkpoint_resume_bit_exact(tmp_path, port_cornell):
    """2 frames + checkpoint + 2 frames == 4 straight frames, bitwise."""
    cfg = tp.RenderConfig(**CFG)
    camera = tp.cornell_default_camera()
    cam = CameraArrays.from_camera(camera, device="cpu")
    a = _frames(port_cornell, cam, cfg, range(4),
                init_accum(cfg, device="cpu"))
    b = _frames(port_cornell, cam, cfg, range(2),
                init_accum(cfg, device="cpu"))
    p = str(tmp_path / "ck.npz")
    save_checkpoint(p, b, 2, cfg, camera)
    b2, fidx, cfg2, camera2 = load_checkpoint(p, device="cpu")
    cam2 = CameraArrays.from_camera(camera2, device="cpu")
    b2 = _frames(port_cornell, cam2, cfg2, range(fidx, fidx + 2), b2)
    assert torch.equal(a, b2)


def test_resumes_tpu_pt_checkpoint(tmp_path, cornell_scene, port_cornell):
    """A checkpoint written by tpu_pt after two frames, resumed by the port
    for two more, matches tpu_pt's own four frames within the render
    bound."""
    jcfg = tpu_pt.RenderConfig(**CFG)
    camera = tpu_pt.cornell_default_camera()
    jcam = jrender.CameraArrays.from_camera(camera)
    ja = jrender.init_accum(jcfg)
    for f in range(4):
        ja, _, _ = jrender.render_frame(cornell_scene, jcam, jcfg, f, ja)
        if f == 1:
            p = str(tmp_path / "jck.npz")
            jcheckpoint.save_checkpoint(p, ja, 2, jcfg, camera)
    accum, fidx, cfg, camera2 = load_checkpoint(p, device="cpu")
    assert fidx == 2 and accum.device.type == "cpu"
    cam = CameraArrays.from_camera(camera2, device="cpu")
    ours = _frames(port_cornell, cam, cfg, range(2, 4), accum).numpy()
    diff = np.abs(ours - np.asarray(ja)).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01


@pytest.mark.parametrize("ext", ["png", "ppm", "exr"])
def test_cli_render_outputs(tmp_path, assets_dir, capsys, ext):
    out = tmp_path / f"out.{ext}"
    assert cli.main(["render", str(assets_dir / "cornell_box.obj"), "-o",
                     str(out), "--direct-lighting", "--importance-sampling",
                     "--stats", *SMALL]) == 0
    text = capsys.readouterr().out
    assert "Total Samples: 576" in text and "Mrays/s" in text
    if ext == "exr":
        img = film.read_exr(str(out))
        assert img.dtype == np.float32 and np.isfinite(img).all()
    else:
        img = (film.read_ppm if ext == "ppm" else film.read_png)(str(out))
    assert img.shape == (24, 24, 3) and img.max() > 0


def test_cli_checkpoint_resume_bit_exact(tmp_path, assets_dir):
    """--checkpoint after one frame, --resume for one more, against two
    straight frames: the same accumulator, bit for bit."""
    scene = str(assets_dir / "cornell_box_mixed.obj")
    flags = SMALL + ["--direct-lighting", "--intersector", "dense"]
    cli.main(["render", scene, "-o", str(tmp_path / "a.png"),
              "--checkpoint", str(tmp_path / "one.npz"), *flags])
    cli.main(["render", scene, "-o", str(tmp_path / "b.png"), "--resume",
              str(tmp_path / "one.npz"), "--checkpoint",
              str(tmp_path / "resumed.npz"), "--device", "cpu"])
    cli.main(["render", scene, "-o", str(tmp_path / "c.png"), "--frames",
              "2", "--checkpoint", str(tmp_path / "two.npz"), *flags])
    a, fa, _, _ = load_checkpoint(str(tmp_path / "resumed.npz"), "cpu")
    b, fb, _, _ = load_checkpoint(str(tmp_path / "two.npz"), "cpu")
    assert fa == fb == 2 and torch.equal(a, b)
    np.testing.assert_array_equal(film.read_png(str(tmp_path / "b.png")),
                                  film.read_png(str(tmp_path / "c.png")))


def test_cli_whitted_stats_checkpoint_resume_validate(tmp_path, assets_dir,
                                                      capsys):
    """The Whitted route with --stats, --checkpoint and --validate, then
    --resume, equals a straight two-frame render."""
    scene = str(assets_dir / "pbr_test.gltf")
    ck = tmp_path / "w.npz"
    cli.main(["render", scene, "-o", str(tmp_path / "a.png"), "--stats",
              "--validate", "--checkpoint", str(ck), *SMALL])
    text = capsys.readouterr().out
    assert "Mrays/s" in text and "done(miss/depth/absorbed)" in text
    assert checkpoint_instancing(str(ck)) == "flatten"
    cli.main(["render", scene, "-o", str(tmp_path / "b.png"), "--resume",
              str(ck), "--device", "cpu"])
    cli.main(["render", scene, "-o", str(tmp_path / "c.png"), "--frames",
              "2", *SMALL])
    np.testing.assert_array_equal(film.read_png(str(tmp_path / "b.png")),
                                  film.read_png(str(tmp_path / "c.png")))


def test_cli_whitted_regen_scheduler_and_resume(tmp_path, assets_dir):
    """``render scene.gltf --scheduler regen`` renders (the wide loop, as
    in the JAX package), and a checkpoint whose config says ``regen``
    resumes: two frames that way equal two straight frames and two
    ``scan`` frames."""
    scene = str(assets_dir / "pbr_test.gltf")
    ck = tmp_path / "r.npz"
    cli.main(["render", scene, "-o", str(tmp_path / "a.png"), "--scheduler",
              "regen", "--checkpoint", str(ck), *SMALL])
    cli.main(["render", scene, "-o", str(tmp_path / "b.png"), "--resume",
              str(ck), "--device", "cpu"])
    cli.main(["render", scene, "-o", str(tmp_path / "c.png"), "--frames",
              "2", "--scheduler", "regen", *SMALL])
    cli.main(["render", scene, "-o", str(tmp_path / "d.png"), "--frames",
              "2", "--scheduler", "scan", *SMALL])
    b = film.read_png(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(b, film.read_png(str(tmp_path / "c.png")))
    np.testing.assert_array_equal(b, film.read_png(str(tmp_path / "d.png")))
    assert b.std() > 5


def test_resume_restores_instancing(tmp_path):
    """A checkpoint records the glTF contract and a resume without
    --instancing reloads the scene with it (tpu_pt's CLI does not record
    it, and would resume this scene flattened: auto flattens it); a
    conflicting --instancing is refused."""
    scene = _write_instanced_city(tmp_path)
    ck = tmp_path / "i.npz"
    flags = SMALL + ["--instancing", "instanced"]
    cli.main(["render", scene, "-o", str(tmp_path / "a.png"),
              "--checkpoint", str(ck), *flags])
    assert checkpoint_instancing(str(ck)) == "instanced"
    cli.main(["render", scene, "-o", str(tmp_path / "b.png"), "--resume",
              str(ck), "--device", "cpu"])
    cli.main(["render", scene, "-o", str(tmp_path / "c.png"), "--frames",
              "2", *flags])
    np.testing.assert_array_equal(film.read_png(str(tmp_path / "b.png")),
                                  film.read_png(str(tmp_path / "c.png")))
    with pytest.raises(SystemExit, match="differs"):
        cli.main(["render", scene, "--resume", str(ck), "--instancing",
                  "flatten", "--device", "cpu"])


def test_cli_missing_scene_errors(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-m", "tpu_pt_torch.cli", "render"],
                       capture_output=True, text=True, cwd=str(tmp_path),
                       timeout=300, env=env)
    assert r.returncode != 0 and "scene path required" in r.stderr


def test_cli_view_not_ported(assets_dir):
    with pytest.raises(NotImplementedError, match="item 16"):
        cli.main(["view", str(assets_dir / "cornell_box.obj")])


def test_exr_piz_not_ported(tmp_path):
    """PIZ is ported now (the name stays): ``write_exr(..., "piz")``
    writes, and a PIZ file written by tpu_pt (a flat image compresses, so
    its blocks are PIZ-coded, not stored raw) reads back exactly."""
    film.write_exr(str(tmp_path / "a.exr"), np.zeros((4, 4, 3)),
                   compression="piz")
    np.testing.assert_array_equal(film.read_exr(str(tmp_path / "a.exr")),
                                  np.zeros((4, 4, 3), np.float32))
    from tpu_pt import film as jfilm
    jfilm.write_exr(str(tmp_path / "b.exr"), np.ones((40, 8, 3)),
                    compression="piz")
    raw = (tmp_path / "b.exr").read_bytes()
    assert len(raw) < 40 * 8 * 12          # PIZ-coded blocks, not raw ones
    np.testing.assert_array_equal(film.read_exr(str(tmp_path / "b.exr")),
                                  np.ones((40, 8, 3), np.float32))


def test_bench_cpu_shrink(monkeypatch, capsys):
    for k, v in dict(BENCH_SIZE="16", BENCH_SPP="1", BENCH_FRAMES="1").items():
        monkeypatch.setenv(k, v)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "Mrays/s" and out["device"] == "cpu"
    assert out["value"] > 0 and out["rays_per_frame"] > 256
    assert "16x16" in out["metric"] and out["ms_per_frame"] > 0


def test_cli_bench_on_the_cpu(tmp_path):
    """``python -m tpu_pt_torch.cli bench --device cpu`` prints the bench's
    one JSON line, with the CLI's size flags passed through."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "tpu_pt_torch.cli", "bench",
                        "--device", "cpu", "--width", "16", "--spp", "1",
                        "--frames", "1"], capture_output=True, text=True,
                       cwd=str(tmp_path), timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-800:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert "16x16" in out["metric"] and out["device"] == "cpu"
