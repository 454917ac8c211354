"""Port parity for the fused closest-hit + NEE kernels K4 / K5
(``RenderConfig.fused_nee``): the plain versions in
``tpu_pt_torch.intersect.dense`` against ``tpu_pt``'s
``pallas_bf.intersect_closest_nee`` (its Pallas kernels in interpret mode)
on the same numpy rays and light samples, the dispatch of
``get_fused_closest_nee``, and fused frames against ``tpu_pt``'s.

Tolerances: hit, triangle, normal and material equal; t within 1e-6
relative (the same plane test, rounded with and without fused
multiply-adds). The shadow ray's 1/|to_light| is an IEEE square root and
division in the port and XLA's rsqrt in the JAX kernel, about an ulp
apart, and grazing shadow rays in the axis-aligned Cornell box flip on
that ulp, so the occlusion flags of hit lanes agree on >= 99%
(``tests/test_pallas_bf.py``'s bound between the JAX package's own fused
and two-kernel paths). Frames use ``tests/test_torch_render.py``'s bounds.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import render as jrender, rng as jrng  # noqa: E402
from tpu_pt.intersect import pallas_bf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import film  # noqa: E402
from tpu_pt_torch.config import Quirks  # noqa: E402
from tpu_pt_torch.intersect import dense, get_fused_closest_nee  # noqa: E402
from tpu_pt_torch.render import (CameraArrays, NOT_DONE,  # noqa: E402
                                 init_accum, render_frame)

REPO = pathlib.Path(__file__).resolve().parent.parent
N_RAYS = 2048


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rays():
    """tests/test_pallas_bf.py's 2,048 camera rays, and light samples from
    a seeded numpy generator."""
    cam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    pix = jnp.arange(N_RAYS, dtype=jnp.uint32) * 97 % (64 * 64)
    jx, jy = jrng.uniform2(pix, 0, 0, 0)
    o, d = jrender.camera_rays(cam, pix, 64, 64, jx, jy)
    r = np.random.default_rng(4)
    return (np.asarray(o.to_array()), np.asarray(d.to_array()),
            r.random(N_RAYS).astype(np.float32),
            r.random(N_RAYS).astype(np.float32))


@pytest.fixture(scope="module")
def scenes(assets_dir):
    out = {}
    for name in ("mixed", "sphere"):
        path = str(assets_dir / f"cornell_box_{name}.obj")
        out[name] = (tpu_pt.load_scene(path), tp.load_scene(path,
                                                            device="cpu"))
    return out


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("name,lean_max,kernel", [
    ("mixed", None, "closest_nee_lean"),
    ("sphere", None, "closest_nee_full"),
    ("mixed", 256, "closest_nee_full")])
def test_plain_fused_matches_pallas(scenes, rays, monkeypatch, name,
                                    lean_max, kernel):
    """K4 on the mixed box (432 rows), K5 on the sphere box (2,280 rows)
    and on the mixed box with LEAN_MAX_TRIS lowered below its rows."""
    if lean_max is not None:
        monkeypatch.setattr(pallas_bf, "LEAN_MAX_TRIS", lean_max)
        monkeypatch.setattr(dense, "LEAN_MAX_TRIS", lean_max)
    jscene, tscene = scenes[name]
    o, d, lz1, lz2 = rays
    rows = dense.prepare(tscene).rows.shape[0]
    assert (rows <= dense.LEAN_MAX_TRIS) == (kernel == "closest_nee_lean")
    jh, jocc = pallas_bf.intersect_closest_nee(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lz1),
        jnp.asarray(lz2))
    th, tocc = dense.intersect_closest_nee(tscene, _t(o), _t(d), _t(lz1),
                                           _t(lz2))
    hit = np.asarray(jh.hit)
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.tri.numpy(), np.asarray(jh.tri))
    np.testing.assert_array_equal(th.mat.numpy(), np.asarray(jh.mat))
    np.testing.assert_array_equal(th.normal.numpy(),
                                  np.asarray(jh.normal.to_array()))
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=1e-6)
    agree = tocc.numpy()[hit] == np.asarray(jocc)[hit]
    assert agree.mean() >= 0.99, agree.mean()
    assert 0.05 < tocc.numpy()[hit].mean() < 0.95


@pytest.mark.parametrize("name", ["mixed", "sphere"])
def test_fused_matches_own_two_kernel_path(scenes, rays, name):
    """The fused call is the port's closest hit plus its any-hit sweep of
    the same shadow ray (over the occluder subset for K4, every row for
    K5), bit for bit."""
    _, tscene = scenes[name]
    o, d, lz1, lz2 = (_t(a) for a in rays)
    tables, light = dense.prepare(tscene), dense.light_vector(tscene)
    hit, occ = dense.closest_nee_hit(tables, light, o, d, lz1, lz2)
    ref = dense.closest_hit(tables, o, d, want_uv=False)
    for f in ("t", "tri", "hit", "normal", "mat", "u", "v"):
        assert torch.equal(getattr(hit, f), getattr(ref, f)), f
    so, sd, stmax = dense._shadow_rays(o, d, hit.t, lz1, lz2, light)
    occ_rows = tables.occ_rows if name == "mixed" else tables.rows
    assert torch.equal(occ, dense.occluded(so, sd, stmax, occ_rows, 0.01))


def test_wrappers_check_inputs(scenes):
    _, tscene = scenes["mixed"]
    tables, light = dense.prepare(tscene), dense.light_vector(tscene)
    meta = torch.empty((4, 3), device="meta")
    lz = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense.closest_nee_lean(meta, meta, lz, lz, tables.rows,
                               tables.occ_rows, light, 0.01)
    good = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="lz1"):
        dense._check_nee(good, torch.zeros(5), torch.zeros(4), light)
    with pytest.raises(ValueError, match="light"):
        dense._check_nee(good, torch.zeros(4), torch.zeros(4), light[:6])


def test_fused_dispatch_mirrors_reference(scenes, monkeypatch):
    """get_fused_closest_nee fuses only where the JAX package does, and
    returns None (the two-kernel path) in each of its five cases."""
    _, tscene = scenes["mixed"]
    cfg = tp.RenderConfig(width=8, height=8, spp=1, intersector="dense",
                          fused_nee=True)
    fused = get_fused_closest_nee(tscene, cfg)
    assert fused.func is dense.closest_nee_hit
    assert fused.keywords == dict(tmin=cfg.t_min, tmax=cfg.t_max)
    assert get_fused_closest_nee(tscene, cfg.with_(fused_nee=False)) is None
    for backend in ("bruteforce", "auto"):      # auto is brute force here
        assert get_fused_closest_nee(
            tscene, cfg.with_(intersector=backend)) is None
    assert get_fused_closest_nee(dataclasses.replace(tscene, light=None),
                                 cfg) is None
    assert get_fused_closest_nee(
        tscene, cfg.with_(quirks=Quirks(occlusion_first_hit_only=True))) \
        is None
    monkeypatch.setattr(dense, "TRI_SLAB", 256)  # 512 padded rows above it
    assert get_fused_closest_nee(tscene, cfg) is None


FRAME = dict(width=16, height=16, spp=2, max_depth=3, fused_nee=True,
             use_direct_lighting=True, use_importance_sampling=True)


@pytest.mark.parametrize("scheduler", ["pixelq", "regen"])
def test_fused_frame_matches_reference(mixed_scene, scenes, scheduler):
    """A fused frame of the port (dense: the plain K4) against tpu_pt's
    (pallas: its fused kernel in interpret mode), within
    tests/test_torch_render.py's bounds."""
    paths = FRAME["width"] * FRAME["height"] * FRAME["spp"]
    jcfg = tpu_pt.RenderConfig(intersector="pallas", scheduler=scheduler,
                               **FRAME)
    jcam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    ref, _, ref_stats = jrender.render_frame(mixed_scene, jcam, jcfg, 0,
                                             jrender.init_accum(jcfg))
    ref = np.asarray(ref)
    _, tscene = scenes["mixed"]
    cfg = tp.RenderConfig(intersector="dense", scheduler=scheduler, **FRAME)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    before = dict(dense.LAUNCHES)
    accum, _, stats = render_frame(tscene, cam, cfg, 0,
                                   init_accum(cfg, device="cpu"))
    assert dense.LAUNCHES == before            # CPU tensors: plain versions
    ours = accum.numpy()
    assert int(stats.done_histogram.sum()) == paths
    assert int(stats.done_histogram[NOT_DONE]) == 0
    vec = [np.concatenate([np.asarray(s.done_histogram, np.float64),
                           [float(s.rays_traced), float(s.shadow_rays)]])
           for s in (stats, ref_stats)]
    assert (np.abs(vec[0] - vec[1]) <= 1e-3 * paths).all(), vec
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01, np.sort(diff.ravel())[-12:]


def test_golden_importance_with_direct_fused(assets_dir):
    """The importance-with-direct golden (tools/make_goldens.py: 128^2,
    32 spp, depth 4) rendered under fused_nee through the plain K4."""
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    cfg = tp.RenderConfig(width=128, height=128, spp=32, max_depth=4,
                          use_importance_sampling=True,
                          use_direct_lighting=True, intersector="dense",
                          fused_nee=True)
    assert get_fused_closest_nee(scene, cfg) is not None
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    _, u8, stats = render_frame(scene, cam, cfg, 0,
                                init_accum(cfg, device="cpu"))
    assert int(stats.done_histogram[NOT_DONE]) == 0
    golden = film.read_png(str(REPO / "tests" / "goldens"
                               / "importance-with-direct.png"))
    ours = tp.image_to_host(u8).astype(np.float32) / 255.0
    assert film.rmse(ours, golden.astype(np.float32) / 255.0) < 0.01
