"""Port parity for multi-device rendering: tpu_pt_torch.dist against the
port's single-device frames and against tpu_pt.dist.

The twins of tests/test_dist.py and tests/multihost_worker.py. One gloo
world of four CPU ranks (tests/torch_dist_worker.py, spawned once for the
module under a wall-clock limit) stands in for the reference's eight
virtual devices: it renders every sharded case and writes its arrays, and
the tests compare them with frames rendered here. Meshes (4, 1), (2, 2)
and (1, 4) take the place of (8, 1), (4, 2), (2, 4) and (1, 8).

Bounds are the reference's: a sharded frame within 1e-5 of the
single-device one with equal counts (the pixelq work queue is per rank,
so a pixel's samples are added in another order); tile-only sharding on
the ``scan`` scheduler bit for bit; three progressive frames max < 1e-3,
mean < 1e-6. Against tpu_pt.dist's (2, 2) frame: tests/test_torch_render.py's
bound between the packages (counts within 0.1% of paths, at most 1% of
pixels off by more than 1e-4, mean below 1e-4).
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import tpu_pt  # noqa: E402
from tpu_pt import dist as jdist  # noqa: E402
from tpu_pt import render as jrender  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import dist  # noqa: E402
from tpu_pt_torch.camera import Camera  # noqa: E402
from tpu_pt_torch.render import (CameraArrays, init_accum,  # noqa: E402
                                 render_frame)
from tpu_pt_torch.whitted import render_whitted_frame  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import torch_dist_worker as worker  # noqa: E402

WORLD = 4
WORLD_LIMIT_S = 420      # the spawned world's wall-clock limit
BASE = worker.BASE
PATHS = BASE["width"] * BASE["height"] * BASE["spp"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Tier-1 runs six test workers on the machine's cores, and PyTorch's
    intra-op threads spin against them (tests/test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class World:
    """The spawned ranks; ``ranks()`` waits for them once (killing them
    all when the limit passes) and returns each rank's arrays."""

    def __init__(self, out):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = {**os.environ, "LOCAL_WORLD_SIZE": "2",
               "GLOO_SOCKET_IFNAME": "lo", "OMP_NUM_THREADS": "1"}
        self.out = out
        self.deadline = time.monotonic() + WORLD_LIMIT_S
        self.procs = []
        for rank in range(WORLD):
            with open(out / f"rank{rank}.log", "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable,
                     os.path.join(HERE, "torch_dist_worker.py"), str(rank),
                     str(WORLD), str(port), str(out)],
                    env=env, stdout=log, stderr=subprocess.STDOUT))
        self._ranks = None

    def ranks(self) -> list:
        if self._ranks is None:
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, self.deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill()
                pytest.fail(f"the gloo world passed its {WORLD_LIMIT_S} s "
                            "limit")
            for rank, p in enumerate(self.procs):
                log = (self.out / f"rank{rank}.log").read_text()
                assert p.returncode == 0, f"rank {rank} failed:\n{log}"
            self._ranks = [dict(np.load(self.out / f"rank{r}.npz"))
                           for r in range(WORLD)]
        return self._ranks

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()


@pytest.fixture(scope="module", autouse=True)
def world(tmp_path_factory, assets_dir):
    """Started with the module, so that it renders while the frames it is
    held against are rendered here: each test renders its references
    before it waits for the world."""
    w = World(tmp_path_factory.mktemp("torch_dist"))
    yield w
    w.kill()


@pytest.fixture(scope="module")
def scene(assets_dir):
    return tp.load_scene(str(assets_dir / "cornell_box.obj"), device="cpu")


@pytest.fixture(scope="module")
def cam():
    return CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")


def _cfg(**kw):
    return tp.RenderConfig(**{**BASE, **kw})


def _single(scene, cam, cfg, frames=1, fn=render_frame):
    accum = init_accum(cfg, device="cpu")
    for f in range(frames):
        accum, u8, stats = fn(scene, cam, cfg, f, accum)
    return accum.numpy(), u8.numpy(), stats


@pytest.fixture(scope="module")
def whitted(assets_dir):
    if not (assets_dir / "pbr_test.gltf").exists():
        subprocess.run([sys.executable, str(assets_dir.parent / "tools" /
                                            "make_gltf_assets.py")],
                       check=True)
    view = worker.WHITTED_VIEW
    wcam = CameraArrays.from_camera(Camera(
        eye=np.array(view["eye"], np.float32),
        lookat=np.array(view["lookat"], np.float32), fov_y=view["fov_y"]),
        device="cpu")
    return tp.load_gltf(str(assets_dir / "pbr_test.gltf"), device="cpu"), wcam


def _assert_counts(rank, prefix, stats, shadow=False):
    assert int(rank[f"{prefix}.rays"]) == int(stats.rays_traced)
    np.testing.assert_array_equal(rank[f"{prefix}.hist"],
                                  stats.done_histogram.numpy())
    if shadow:
        assert int(rank[f"{prefix}.shadow"]) == int(stats.shadow_rays)


# -- no world ---------------------------------------------------------------

@pytest.mark.parametrize("n,n_tile,n_spp,shape", [
    (8, None, None, (4, 2)), (8, 8, 1, (8, 1)), (8, 2, 4, (2, 4)),
    (8, None, 4, (2, 4)), (4, None, None, (2, 2)), (1, None, None, (1, 1)),
    (3, None, None, (3, 1))])
def test_mesh_shape(n, n_tile, n_spp, shape):
    """tests/test_dist.py:29-35's factory rule, without a world: 2-way spp
    when the count is even and above 1, tiles take the rest."""
    assert dist.mesh_shape(n, n_tile, n_spp) == shape


def test_mesh_size_not_the_world_raises():
    with pytest.raises(ValueError):
        dist.mesh_shape(8, 3, 2)
    with pytest.raises(ValueError):
        dist.mesh_shape(4, n_tile=3)


def test_height_not_split_raises():
    with pytest.raises(ValueError):
        dist.local_config(_cfg(height=30), 4, 1)


def test_spp_not_split_raises():
    with pytest.raises(ValueError):
        dist.local_config(_cfg(spp=6), 1, 4)


def test_local_config():
    cfg_local, pixels = dist.local_config(_cfg(), 2, 4)
    assert (cfg_local.spp, pixels) == (2, 32 * 16)
    assert cfg_local.with_(spp=8) == _cfg()


def test_card_world_without_card_raises():
    """NCCL needs the card: nothing falls back to gloo or to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        dist.init_multihost("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


# -- the world --------------------------------------------------------------

def test_port_matches_reference_sharded(world, cornell_scene):
    """The port's (2, 2) frame against tpu_pt.dist's (2, 2) frame on four
    of the reference's virtual devices, on the same scene (the loaders
    agree bit for bit: tests/test_torch_scene.py)."""
    cfg = tpu_pt.RenderConfig(**BASE)
    mesh = jdist.device_mesh(2, 2, devices=jax.devices()[:4])
    step = jdist.make_sharded_renderer(cornell_scene, cfg, mesh)
    jcam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    ref, _, ref_stats = step(jcam, 0, jdist.init_accum_sharded(cfg, mesh))
    ref = np.asarray(ref)
    ref_counts = np.concatenate([np.asarray(ref_stats.done_histogram),
                                 [float(ref_stats.rays_traced),
                                  float(ref_stats.shadow_rays)]])
    for rank in world.ranks():
        counts = np.concatenate([rank["pt.2x2.hist"],
                                 [rank["pt.2x2.rays"], rank["pt.2x2.shadow"]]])
        delta = np.abs(counts - ref_counts)
        assert (delta <= 1e-3 * PATHS).all(), delta
        ours = rank["pt.2x2.accum"]
        assert ours.shape == ref.shape and np.isfinite(ours).all()
        diff = np.abs(ours - ref).max(axis=-1)
        assert diff.mean() < 1e-4, diff.mean()
        assert (diff > 1e-4).mean() <= 0.01, np.sort(diff.ravel())[-12:]



def test_world_present(world):
    for rank in world.ranks():
        assert int(rank["world"]) == WORLD
        assert str(rank["backend"]) == "gloo"


def test_mesh_factory(world):
    for rank in world.ranks():
        assert tuple(rank["mesh.default"]) == (2, 2)
        assert tuple(rank["mesh.tile4"]) == (4, 1)
        assert tuple(rank["mesh.spp4"]) == (1, 4)
        assert tuple(rank["mesh.4x1"]) == (4, 1)
        assert tuple(rank["mesh.1x4"]) == (1, 4)


@pytest.mark.parametrize("what", ["mesh_size", "multihost_spp", "height",
                                  "spp"])
def test_errors_raise_in_the_world(world, what):
    """device_mesh(3, 1) over four ranks, multihost_mesh(4) over two-rank
    hosts, and make_sharded_renderer on a height or spp that does not
    split, each raise on every rank."""
    for rank in world.ranks():
        assert int(rank[f"error.{what}"]) == 1


@pytest.fixture(scope="module")
def single(world, scene, cam):
    return _single(scene, cam, _cfg())


@pytest.mark.parametrize("n_tile,n_spp", worker.SHAPES)
def test_sharded_matches_single_device(world, single, n_tile, n_spp):
    ref_accum, _, ref_stats = single
    for rank in world.ranks():
        prefix = f"pt.{n_tile}x{n_spp}"
        np.testing.assert_allclose(rank[f"{prefix}.accum"], ref_accum,
                                   atol=1e-5, rtol=1e-5)
        _assert_counts(rank, prefix, ref_stats)


def test_tile_sharding_bitwise_with_scan_scheduler(world, scene, cam):
    ref_accum, ref_u8, _ = _single(scene, cam, _cfg(scheduler="scan"))
    for rank in world.ranks():
        np.testing.assert_array_equal(rank["scan.accum"], ref_accum)
        np.testing.assert_array_equal(rank["scan.u8"], ref_u8)


def test_sharded_progressive_frames(world, scene, cam):
    ref_accum, _, _ = _single(scene, cam, _cfg(spp=2), frames=3)
    for rank in world.ranks():
        d = np.abs(rank["progressive.accum"] - ref_accum)
        assert d.max() < 1e-3, f"max {d.max()}"
        assert d.mean() < 1e-6, f"mean {d.mean()}"


@pytest.mark.parametrize("n_spp", [1, 2])
def test_multihost_two_hosts(world, scene, cam, n_spp):
    """LOCAL_WORLD_SIZE=2 makes the four ranks two hosts: multihost_mesh
    keeps each spp group inside one, and gather_frame hands every rank the
    whole frame."""
    cfg = tp.RenderConfig(**{**BASE, **worker.MULTIHOST})
    ref_accum, _, ref_stats = _single(scene, cam, cfg)
    for rank in world.ranks():
        prefix = f"multihost{n_spp}"
        assert tuple(rank[f"{prefix}.shape"]) == (WORLD // n_spp, n_spp)
        assert rank[f"{prefix}.accum"].shape == (cfg.height, cfg.width, 3)
        np.testing.assert_allclose(rank[f"{prefix}.accum"], ref_accum,
                                   atol=1e-5, rtol=1e-5)
        _assert_counts(rank, prefix, ref_stats)


@pytest.mark.parametrize("n_spp", [1, 2])
def test_multihost_two_hosts_whitted(world, whitted, n_spp):
    ws, wcam = whitted
    cfg = tp.RenderConfig(**worker.MULTIHOST, intersector="bruteforce")
    ref_accum, _, ref_stats = _single(ws, wcam, cfg,
                                      fn=render_whitted_frame)
    for rank in world.ranks():
        prefix = f"multihost{n_spp}.whitted"
        np.testing.assert_allclose(rank[f"{prefix}.accum"], ref_accum,
                                   atol=1e-5, rtol=1e-5)
        assert int(rank[f"{prefix}.rays"]) == int(ref_stats.rays_traced)


def test_accum_stays_sharded(world):
    for rank in world.ranks():
        assert tuple(rank["sharded.block_shape"]) == (
            BASE["height"] // 4, BASE["width"], 3)


@pytest.fixture(scope="module")
def whitted_single(world, whitted):
    return _single(*whitted, _cfg(intersector="bruteforce"),
                   fn=render_whitted_frame)


@pytest.mark.parametrize("n_tile,n_spp", worker.WHITTED_SHAPES)
def test_sharded_whitted_matches_single_device(world, whitted_single, n_tile,
                                               n_spp):
    ref_accum, _, ref_stats = whitted_single
    for rank in world.ranks():
        prefix = f"whitted.{n_tile}x{n_spp}"
        np.testing.assert_allclose(rank[f"{prefix}.accum"], ref_accum,
                                   atol=1e-5, rtol=1e-5)
        _assert_counts(rank, prefix, ref_stats, shadow=True)
