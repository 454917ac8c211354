"""Port parity: tpu_pt_torch's intersectors against tpu_pt's on the same
numpy rays.

The dense module's plain versions (the CPU path of the three CUDA kernels)
are held against ``tpu_pt.intersect.pallas_bf``, whose Pallas kernels run
in interpret mode here, on the mixed Cornell box (432 rows: the lean K1
path) and the sphere box (2,264 triangles, above LEAN_MAX_TRIS: the
full-carry K3 path).

Tolerances: hit/miss, winning triangle, material, normal and occlusion
flags are equal. t is the plane distance d0 - n.o (an f32 difference of
values near 550, so noise ~1e-4 absolute, ``pallas_bf.py:28-34``) over
the cosine n.d, so the test holds |dt| * |n.d| within 1e-4 plus 4e-6 of
t. The two packages round differently: the JAX package runs on the CPU
with fused multiply-adds (XLA contracts a*b + c), the port without, and
camera rays reach t = 1,100-1,500, where one f32 ulp is 1.2e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import moller as jmoller, pallas_bf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import dense, get_intersectors  # noqa: E402
from tpu_pt_torch.intersect import moller as tmoller  # noqa: E402

T_ATOL, T_RTOL = 1e-4, 4e-6
LIGHT = np.array([278.0, 547.0, 279.5], np.float32)


def _rays(jscene, n: int, seed: int):
    """n camera rays through jittered pixels of the Cornell camera, then n
    rays leaving the surfaces those hit in random directions, then n
    shadow rays from the same points to random points of the light."""
    r = np.random.default_rng(seed)
    u, v, w = tpu_pt.cornell_default_camera().uvw_frame()
    eye = np.array([278.0, 273.0, -900.0], np.float32)
    xy = r.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    d = xy[:, :1] * u + xy[:, 1:] * v + w
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.broadcast_to(eye, (n, 3)).astype(np.float32)
    hit = jmoller.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d))
    t = np.where(np.asarray(hit.hit), np.asarray(hit.t), 0.0)
    nrm = np.asarray(hit.normal.to_array())
    nrm = np.where((nrm * d).sum(1, keepdims=True) > 0, -nrm, nrm)
    p = (o + d * t[:, None] + 1e-3 * nrm).astype(np.float32)
    rd = r.normal(size=(n, 3)).astype(np.float32)
    rd = np.where((rd * nrm).sum(1, keepdims=True) < 0, -rd, rd)
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    lp = LIGHT + r.uniform(-60.0, 60.0, (n, 3)).astype(np.float32) * [1, 0, 1]
    tl = (lp - p).astype(np.float32)
    dist = np.linalg.norm(tl, axis=1).astype(np.float32)
    ld = (tl / dist[:, None]).astype(np.float32)
    return (np.concatenate([o, p]), np.concatenate([d, rd]),
            p, ld, (dist - 0.01).astype(np.float32))


@pytest.fixture(scope="module")
def sphere_scene(assets_dir):
    return tpu_pt.load_scene(str(assets_dir / "cornell_box_sphere.obj"))


@pytest.fixture(scope="module")
def scenes(mixed_scene, sphere_scene, assets_dir):
    return {"mixed": (mixed_scene,
                      tp.load_scene(str(assets_dir / "cornell_box_mixed.obj"))),
            "sphere": (sphere_scene,
                       tp.load_scene(str(assets_dir / "cornell_box_sphere.obj")))}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_same_hit(j, t, d, uv_atol=None):
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(t.hit.numpy(), hit)
    np.testing.assert_array_equal(t.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_array_equal(t.mat.numpy(), np.asarray(j.mat))
    normal = np.asarray(j.normal.to_array())
    np.testing.assert_array_equal(t.normal.numpy(), normal)
    jt, tt = np.asarray(j.t), t.t.numpy()
    np.testing.assert_array_equal(tt[~hit], jt[~hit])
    cos = np.abs((normal * d).sum(1))
    plane_err = np.abs(tt - jt) * cos
    assert (plane_err[hit] <= T_ATOL + T_RTOL * jt[hit]).all(), \
        plane_err[hit].max()
    if uv_atol is not None:
        np.testing.assert_allclose(t.u.numpy(), np.asarray(j.u), atol=uv_atol)
        np.testing.assert_allclose(t.v.numpy(), np.asarray(j.v), atol=uv_atol)
    return hit


@pytest.mark.parametrize("name,rows,kernel",
                         [("mixed", 432, "closest_lean"),
                          ("sphere", 2280, "closest_full")])
def test_dense_closest_matches_pallas(scenes, name, rows, kernel):
    jscene, tscene = scenes[name]
    o, d, _, _, _ = _rays(jscene, 1024, seed=1)
    rows_seen = dense.prepare(tscene).rows.shape[0]
    assert rows_seen == rows
    assert (rows_seen <= dense.LEAN_MAX_TRIS) == (kernel == "closest_lean")
    before = dict(dense.LAUNCHES)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=True)
    t = dense.intersect_closest(tscene, _t(o), _t(d), want_uv=True)
    hit = assert_same_hit(j, t, d, uv_atol=5e-4)
    assert 0.5 < hit.mean() < 1.0             # hits and misses both occur
    assert dense.LAUNCHES == before           # CPU tensors: plain version


@pytest.mark.parametrize("name", ["mixed", "sphere"])
def test_dense_closest_finite_tmax_matches_pallas(scenes, name):
    """A finite tmax takes the full-carry kernel (K3) at any size."""
    jscene, tscene = scenes[name]
    o, d, _, _, _ = _rays(jscene, 1024, seed=2)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    tmax=600.0, want_uv=True)
    t = dense.intersect_closest(tscene, _t(o), _t(d), tmax=600.0,
                                want_uv=True)
    hit = assert_same_hit(j, t, d, uv_atol=5e-4)
    assert 0.1 < hit.mean() < 0.9
    assert t.t.numpy()[hit].max() < 600.0


@pytest.mark.parametrize("name", ["mixed", "sphere"])
def test_dense_occluded_matches_pallas(scenes, name):
    jscene, tscene = scenes[name]
    _, _, p, ld, tmax = _rays(jscene, 2048, seed=3)
    j = np.asarray(pallas_bf.intersect_occluded(
        jscene, jnp.asarray(p), jnp.asarray(ld), jnp.asarray(tmax)))
    t = dense.intersect_occluded(tscene, _t(p), _t(ld), _t(tmax)).numpy()
    np.testing.assert_array_equal(t, j)
    assert 0.05 < j.mean() < 0.95


def test_dense_occluded_quirk_matches_pallas(scenes):
    jscene, tscene = scenes["mixed"]
    o, d, _, _, _ = _rays(jscene, 1024, seed=4)
    tmax = np.full(o.shape[0], 900.0, np.float32)
    j = pallas_bf.intersect_occluded(jscene, jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(tmax), quirk_first_hit=True)
    t = dense.intersect_occluded(tscene, _t(o), _t(d), _t(tmax),
                                 quirk_first_hit=True)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name", ["mixed", "sphere"])
def test_moller_matches_reference(scenes, name):
    jscene, tscene = scenes[name]
    o, d, p, ld, tmax = _rays(jscene, 1024, seed=5)
    j = jmoller.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d))
    t = tmoller.intersect_closest(tscene, _t(o), _t(d))
    assert_same_hit(j, t, d, uv_atol=5e-4)
    jo = jmoller.intersect_occluded(jscene, jnp.asarray(p), jnp.asarray(ld),
                                    jnp.asarray(tmax))
    to = tmoller.intersect_occluded(tscene, _t(p), _t(ld), _t(tmax))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


def test_lean_and_full_plain_versions_agree(scenes):
    """K1 + gather and K3 compute one function: same t, row, normal, mat."""
    jscene, tscene = scenes["mixed"]
    o, d, _, _, _ = _rays(jscene, 512, seed=6)
    tables = dense.prepare(tscene)
    t1, r1 = dense.closest_lean(_t(o), _t(d), tables.rows, 0.01)
    t3, r3, n3, m3, u3, v3 = dense.closest_full(_t(o), _t(d), tables.rows,
                                                0.01, 1e16, True)
    assert torch.equal(t1, t3) and torch.equal(r1, r3)
    lean = dense._lean_resolve(tables.rows, _t(o), _t(d), t1, r1, True)
    assert torch.equal(lean.normal, n3) and torch.equal(lean.mat, m3)
    np.testing.assert_allclose(lean.u.numpy(), u3.numpy(), atol=1e-6)


def test_wrappers_check_devices_and_inputs(scenes):
    _, tscene = scenes["mixed"]
    rows = dense.prepare(tscene).rows
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        dense.closest_lean(meta, meta, rows.to("meta"), 0.01)
    good = torch.zeros((4, 3))
    with pytest.raises(ValueError):
        dense._check_inputs(good, good.double(), rows)
    with pytest.raises(ValueError):
        dense._check_inputs(good, good, rows[:, :15])
    with pytest.raises(ValueError):
        dense._check_inputs(good.t().contiguous().t(), good, rows)
    assert dense._check_inputs(good, good, rows) == (4, rows.shape[0])


def test_above_tri_slab_raises():
    r = np.random.default_rng(7)
    n = dense.TRI_SLAB + 1
    verts = r.uniform(0.0, 100.0, (3 * n, 3)).astype(np.float32)
    scene = tp.scene.build_scene_arrays(
        verts, np.arange(3 * n).reshape(n, 3), np.zeros(n, np.int64), [])
    with pytest.raises(NotImplementedError, match="TRI_SLAB"):
        dense.prepare(scene)


def test_get_intersectors_resolution(scenes):
    _, tscene = scenes["mixed"]
    cfg = tp.RenderConfig(width=8, height=8, spp=1)
    closest, _ = get_intersectors(tscene, cfg)
    assert closest.func is tmoller.intersect_closest   # auto on the CPU
    closest, _ = get_intersectors(tscene, cfg.with_(intersector="dense"))
    assert closest.func is dense.closest_hit
    for bad in (cfg.with_(intersector="bvh"), cfg.with_(fused_nee=True)):
        with pytest.raises(NotImplementedError):
            get_intersectors(tscene, bad)
