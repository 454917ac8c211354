"""Port parity for the LBVH: tpu_pt_torch.intersect.lbvh against
tpu_pt.intersect.lbvh on the same numpy scene.

Tolerances: the node table of the device build (boxes, links, leaf
payload) and the i32 ``left`` / ``skip`` / ``tri`` arrays are equal to
``jax.jit(build_lbvh)``'s; closest hits agree with the port's brute force
on hit / miss and triangle id (a mismatch must be a tie in t), t to 1e-5
relative, u and v to 1e-4; occlusion flags are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import lbvh as jlbvh  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import intersect as tintersect  # noqa: E402
from tpu_pt_torch.intersect import lbvh, moller  # noqa: E402
from tpu_pt_torch.render import CameraArrays, init_accum, render_frame  # noqa: E402
from tpu_pt_torch.scene import scene_from_numpy  # noqa: E402
from test_torch_clustered import sphere_arrays  # noqa: E402,F401
from test_torch_intersect import _rays, _t  # noqa: E402
from test_torch_render import BASE  # noqa: E402
from test_torch_scene import numpy_leaves  # noqa: E402
from torch_ref_native import reference_native  # noqa: E402


@pytest.fixture(scope="module")
def sphere_box(assets_dir):
    """The sphere box (2,264 triangles, 2,304 padded) in both packages,
    the port's scene carried over leaf for leaf (without a BVH)."""
    jscene = tpu_pt.load_scene(str(assets_dir / "cornell_box_sphere.obj"),
                               build_bvh=False)
    return jscene, scene_from_numpy(numpy_leaves(jscene), jscene.num_tris,
                                    jscene.num_occluders, device="cpu")


@pytest.fixture(scope="module")
def sphere_bvh(sphere_box):
    jscene, tscene = sphere_box
    return jax.jit(jlbvh.build_lbvh)(jscene), lbvh.build_lbvh(tscene)


def test_morton3d_matches_reference():
    p = np.random.default_rng(1).random((4096, 3)).astype(np.float32)
    p[:4] = [[0, 0, 0], [1, 1, 1], [1, 0, 0.5], [0.25, 1, 0]]
    ours = lbvh.morton3d(_t(p)).numpy()
    np.testing.assert_array_equal(ours, np.asarray(jlbvh.morton3d(p)))
    assert ours.max() < 1 << 30


def test_clz32():
    x = np.array([0, 1, 2, 3, 255, 256, 2 ** 31, 2 ** 32 - 1, 12345678],
                 np.int64)
    want = [32 - int(v).bit_length() for v in x]
    assert lbvh._clz32(torch.from_numpy(x)).tolist() == want


def test_build_matches_reference(sphere_bvh):
    """Node table, ``left`` / ``skip`` / ``tri`` equal to the jitted JAX
    build on the sphere box."""
    ref, ours = sphere_bvh
    n = 2304
    assert ours.num_nodes == ref.num_nodes == 2 * n - 1
    for k in ("left", "skip", "tri"):
        a, b = getattr(ours, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(ours.nodes.numpy(), np.asarray(ref.nodes))
    tri = ours.tri.numpy()
    assert sorted(tri[tri >= 0].tolist()) == list(range(n))


def test_closest_and_occluded_match_bruteforce(sphere_box, sphere_bvh):
    jscene, tscene = sphere_box
    ref_bvh, bvh = sphere_bvh
    o, d, p, ld, tmax = _rays(jscene, 512, seed=21)
    h = lbvh.intersect_closest(tscene, _t(o), _t(d), bvh=bvh)
    b = moller.intersect_closest(tscene, _t(o), _t(d))
    assert torch.equal(h.hit, b.hit) and 0.5 < float(b.hit.float().mean())
    np.testing.assert_allclose(h.t.numpy(), b.t.numpy(), rtol=1e-5)
    differ = h.tri != b.tri
    assert float(differ.float().mean()) <= 0.01
    same = ~differ
    assert torch.equal(h.mat[same], b.mat[same])
    assert torch.equal(h.normal[same], b.normal[same])
    np.testing.assert_allclose(h.u[same].numpy(), b.u[same].numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(h.v[same].numpy(), b.v[same].numpy(),
                               atol=1e-4)
    # ... and with the JAX walk over the JAX tree.
    j = jlbvh.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                bvh=ref_bvh)
    np.testing.assert_array_equal(h.hit.numpy(), np.asarray(j.hit))
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_allclose(h.t.numpy(), np.asarray(j.t), rtol=1e-5)
    # A finite tmax clips.
    h600 = lbvh.intersect_closest(tscene, _t(o), _t(d), tmax=1200.0, bvh=bvh)
    assert torch.equal(h600.hit, b.hit & (b.t < 1200.0))

    tm = tmax.copy()
    tm[:8] = 0.0                                     # parked shadow rays
    occ = lbvh.intersect_occluded(tscene, _t(p), _t(ld), _t(tm), bvh=bvh)
    ref = moller.intersect_occluded(tscene, _t(p), _t(ld), _t(tm))
    assert torch.equal(occ, ref) and not occ[:8].any()
    assert 0.05 < float(occ.float().mean()) < 0.95
    j_occ = jlbvh.intersect_occluded(jscene, jnp.asarray(p), jnp.asarray(ld),
                                     jnp.asarray(tm), bvh=ref_bvh)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(j_occ))
    quirk = lbvh.intersect_occluded(tscene, _t(p), _t(ld), _t(tm), bvh=bvh,
                                    quirk_first_hit=True)
    assert torch.equal(quirk, moller.intersect_occluded(
        tscene, _t(p), _t(ld), _t(tm), quirk_first_hit=True))


def test_walk_end_test_every_few_steps(sphere_box, sphere_bvh):
    """Testing for the walk's end every 8 steps (as on a CUDA device)
    changes no result; zero-length directions never walk."""
    jscene, tscene = sphere_box
    o, d, p, ld, tmax = _rays(jscene, 256, seed=22)
    d = d.copy()
    d[:4] = 0.0
    bvh = sphere_bvh[1]
    a = lbvh._traverse(bvh, _t(o), _t(d), 0.01, 1e16, "closest",
                       check_every=1)
    b = lbvh._traverse(bvh, _t(o), _t(d), 0.01, 1e16, "closest",
                       check_every=8)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert bool((a["best_t"][:4] >= 1e16).all())
    oa = lbvh._traverse(bvh, _t(p), _t(ld), 0.01, 1e16, "occluded",
                        tmax_per_ray=_t(tmax), check_every=1)
    ob = lbvh._traverse(bvh, _t(p), _t(ld), 0.01, 1e16, "occluded",
                        tmax_per_ray=_t(tmax), check_every=8)
    assert torch.equal(oa, ob)


def test_auto_picks_bvh_above_crossover(sphere_arrays, sphere_box):  # noqa: F811
    """``auto`` on the CPU is ``bvh`` above 4,096 padded triangles when the
    scene has a BVH, else brute force (the JAX package's rule); below the
    crossover it stays brute force."""
    verts, tris = sphere_arrays
    scene = tp.scene.build_scene_arrays(
        verts, tris, np.zeros(tris.shape[0], np.int64), [], device="cpu")
    cfg = tp.RenderConfig(width=8, height=8, spp=1)
    assert scene.num_tris_padded == 4992 and scene.bvh is None
    assert tintersect._resolve(scene, cfg) == "bruteforce"
    with pytest.raises(ValueError, match="no BVH"):
        tintersect.get_intersectors(scene, cfg.with_(intersector="bvh"))[0](
            torch.zeros(1, 3), torch.ones(1, 3))
    bare = scene
    scene = lbvh.with_bvh(scene, builder="device")
    assert tintersect._resolve(scene, cfg) == "bvh"
    # The JAX package's signature: "device" builds on the scene's device
    # (``host`` unused), "native" on the host, equal to the JAX package's
    # native build of the same arrays, and "auto" is "native" when the
    # library is available.
    again = lbvh.with_bvh(bare, builder="device", host={})
    assert torch.equal(again.bvh.nodes, scene.bvh.nodes)
    from tpu_pt_torch import native
    if native.available():
        nat = lbvh.with_bvh(bare, builder="native")
        reference_native()
        ref = jlbvh.build_lbvh_host(tpu_pt.scene.build_scene_arrays(
            verts, tris, np.zeros(tris.shape[0], np.int64), []))
        for k in ("nodes", "left", "skip", "tri"):
            np.testing.assert_array_equal(getattr(nat.bvh, k).numpy(),
                                          np.asarray(getattr(ref, k)),
                                          err_msg=k)
        assert torch.equal(lbvh.with_bvh(bare).bvh.nodes, nat.bvh.nodes)
    with pytest.raises(ValueError, match="unknown LBVH builder"):
        lbvh.with_bvh(bare, builder="gpu")
    closest, occluded = tintersect.get_intersectors(scene, cfg)
    assert closest.func is lbvh.intersect_closest
    assert occluded.func is lbvh.intersect_occluded
    assert scene.to("cpu").bvh.num_nodes == 2 * 4992 - 1
    small = lbvh.with_bvh(sphere_box[1])
    assert tintersect._resolve(small, cfg) == "bruteforce"
    assert tintersect.BVH_CROSSOVER_TRIS == 4096
    assert tintersect.TPU_BVH_CROSSOVER_TRIS == 1 << 20


def test_loaders_attach_bvh(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    assert scene.bvh.num_nodes == 2 * 512 - 1
    assert tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                         device="cpu", build_bvh=False).bvh is None
    ws = tp.load_gltf(str(assets_dir / "alpha_shadow.gltf"), device="cpu")
    assert ws.geom.bvh is not None and ws.alpha_occ.occ_geom.bvh is not None


def test_render_with_bvh_matches_bruteforce(assets_dir):
    """A 32^2 x 4 spp frame of the mixed box through ``bvh`` against brute
    force, within tests/test_torch_render.py's bound."""
    scene = tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"),
                          device="cpu")
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        frames = []
        for backend in ("bvh", "bruteforce"):
            cfg = tp.RenderConfig(**{**BASE, "intersector": backend})
            accum, _, stats = render_frame(scene, cam, cfg, 0,
                                           init_accum(cfg, device="cpu"))
            assert int(stats.done_histogram[tp.render.NOT_DONE]) == 0
            frames.append(accum.numpy().copy())
    finally:
        torch.set_num_threads(n)
    diff = np.abs(frames[0] - frames[1]).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01
