"""Port parity for the big-scene path: tpu_pt_torch.intersect.clustered
(the CPU path of the clustered CUDA kernels K6, K6f, K7, K8 and K8b)
against tpu_pt.intersect.pallas_bf's clustered path, run in interpret
mode, under the same ``TPT_LEAN_BIG`` / ``TPT_LEAN_UV`` / ``TPT_INKB``
variables.

Scenes here are small, so the size knobs are shrunk by monkeypatch as
``tests/test_pallas_bf.py`` does: ``TRI_SLAB`` (both packages) sends the
mixed Cornell box (512 packed rows) to the clustered path, and
``CLUSTER`` cuts it into several clusters.

Tolerances: hit mask, occlusion flags and every scene-build array are
equal; t is held as in ``test_torch_intersect.py`` (|dt| * |n.d| within
T_ATOL + T_RTOL * t). The winning triangle, its material and normal are
equal except on ties: the JAX kernels keep the first cluster they visit
among equal t, the port the lowest packed row, so a mismatch must be a
second triangle hit at the same t within that tolerance. The full carry's
u and v agree with the JAX kernels' to UV_ATOL = 1e-4 where the triangles
do: u = wu . p + cu, and the packed cu (hundreds in the Cornell box, one
ulp 3e-5) itself differs by up to 2e-4 between the packages, since XLA
fuses ``pack_tris``' multiply-adds (see the packing test below; 1.3e-5 is
the most seen here). Within the port, the full carry against the lean
kernel and its gather, they agree to 1e-5, the JAX package's own bound
between its two (tests/test_pallas_bf.py).
"""

import importlib.util

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt import render as jrender  # noqa: E402
from tpu_pt.intersect import moller as jmoller, pallas_bf  # noqa: E402
from tpu_pt.scene import arrays as jarrays  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import (clustered, dense,  # noqa: E402
                                    get_intersectors, kernel_module)
from tpu_pt_torch.render import CameraArrays, init_accum, render_frame  # noqa: E402
from tpu_pt_torch.scene import scene_from_numpy  # noqa: E402
from test_torch_intersect import T_ATOL, T_RTOL, _rays, _t  # noqa: E402
from test_torch_render import BASE  # noqa: E402
from test_torch_scene import numpy_leaves  # noqa: E402


@pytest.fixture(scope="module")
def sphere_arrays(assets_dir):
    """A 4,900-triangle displaced sphere (tools/make_assets.py's big-mesh
    generator at 50 x 50) inside nothing: vertices and triangles."""
    spec = importlib.util.spec_from_file_location(
        "make_assets", assets_dir.parent / "tools" / "make_assets.py")
    make_assets = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(make_assets)
    verts, tris = make_assets.displaced_sphere(278, 220, 280, 160, 50, 50)
    return np.array(verts, np.float32), np.array(tris, np.int64)


@pytest.fixture(scope="module")
def sphere_scenes(sphere_arrays):
    verts, tris = sphere_arrays
    mats = np.zeros(tris.shape[0], np.int64)
    return (jarrays.build_scene_arrays(verts, tris, mats, []),
            tp.scene.build_scene_arrays(verts, tris, mats, [], device="cpu"))


@pytest.fixture(scope="module")
def unit_sphere_scene(sphere_arrays):
    """The displaced sphere moved to the origin and shrunk to radius ~1."""
    verts, tris = sphere_arrays
    unit = ((verts - np.float32([278, 220, 280])) / np.float32(160.0))
    return tp.scene.build_scene_arrays(unit.astype(np.float32), tris,
                                       np.zeros(tris.shape[0], np.int64), [],
                                       device="cpu")


@pytest.fixture(scope="module")
def mixed_scenes(mixed_scene):
    return mixed_scene, scene_from_numpy(numpy_leaves(mixed_scene),
                                         mixed_scene.num_tris,
                                         mixed_scene.num_occluders,
                                         device="cpu")


def _shrink(monkeypatch, tri_slab=256, cluster=64):
    """The mixed box (512 packed rows) on the clustered path of both
    packages, in clusters of ``cluster`` rows."""
    monkeypatch.setattr(pallas_bf, "TRI_SLAB", tri_slab)
    monkeypatch.setattr(pallas_bf, "CLUSTERED_SLAB", 256)
    monkeypatch.setattr(pallas_bf, "CLUSTER", cluster)
    monkeypatch.setattr(pallas_bf, "SUPER", 2)
    monkeypatch.setattr(dense, "TRI_SLAB", tri_slab)
    monkeypatch.setattr(clustered, "CLUSTER", cluster)


def test_median_split_order_matches_reference(sphere_arrays, sphere_scenes):
    verts, tris = sphere_arrays
    jscene, tscene = sphere_scenes
    assert tscene.num_tris_padded == 4992
    host = [np.asarray(getattr(jscene, k))
            for k in ("tri_v0", "tri_e1", "tri_e2", "tri_valid")]
    ref = jarrays.median_split_order(*host, leaf=128)
    ours = tp.scene.median_split_order(*host, leaf=128)
    np.testing.assert_array_equal(ours, ref)
    assert sorted(ours.tolist()) == list(range(4992))
    np.testing.assert_array_equal(tscene.cluster_order.numpy(),
                                  np.asarray(jscene.cluster_order))


@pytest.mark.parametrize("cluster", [128, 64])
def test_pack_tris_clustered_matches_reference(sphere_scenes, monkeypatch,
                                               cluster):
    """Same cluster_order in, the same row order and bitwise-equal boxes
    out. Plane columns (n, d0) and the valid / refractive / material / id
    columns are bitwise equal; the edge-function columns (wu, cu, wv, cv)
    differ by the rounding of the multiply-adds XLA fuses in the JAX
    package's ``pack_tris`` (a few ulps). The JAX table pads to a multiple
    of 8 clusters, the port's to one cluster; the extra JAX rows are zero
    rows in empty (far-point) clusters."""
    jscene, tscene = sphere_scenes
    monkeypatch.setattr(pallas_bf, "CLUSTER", cluster)
    monkeypatch.setattr(pallas_bf, "SUPER", 1)
    monkeypatch.setattr(clustered, "CLUSTER", cluster)
    jrows, jboxes, _ = pallas_bf.pack_tris_clustered(jscene)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    jrows, jboxes = np.asarray(jrows), np.asarray(jboxes)
    n, c = rows.shape[0], boxes.shape[0]
    assert n == c * cluster and n >= tscene.num_tris_padded
    ours = rows.numpy()
    for cols in (slice(0, 4), slice(12, 16)):
        np.testing.assert_array_equal(ours[:, cols], jrows[:n, cols])
    for w in (slice(4, 7), slice(8, 11)):          # wu, wv
        np.testing.assert_allclose(ours[:, w], jrows[:n, w], rtol=1e-5,
                                   atol=1e-6)
    for c0 in (7, 11):                             # cu, cv: sums of ~100s
        np.testing.assert_allclose(ours[:, c0], jrows[:n, c0], rtol=0,
                                   atol=2e-4)
    np.testing.assert_array_equal(boxes.numpy(), jboxes[:c])
    assert not jrows[n:].any()
    assert (jboxes[c:, :6] == clustered.EMPTY_BOX).all()
    # The culling margin's scene scale is the largest coordinate magnitude
    # of a valid triangle's vertices.
    valid = tscene.tri_valid.numpy().astype(bool)
    v0, e1, e2 = (getattr(tscene, k).numpy()[valid]
                  for k in ("tri_v0", "tri_e1", "tri_e2"))
    corners = np.abs(np.stack([v0, v0 + e1, v0 + e2]))
    assert clustered.box_scale(boxes) == float(corners.max())


def _assert_same_clustered_hit(j, t, o, d, tscene):
    """Hit mask equal; t within tolerance; tri / mat / normal equal except
    on ties, where the port's winner must be hit at the JAX winner's t."""
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal(t.hit.numpy(), hit)
    jt, tt = np.asarray(j.t), t.t.numpy()
    np.testing.assert_array_equal(tt[~hit], jt[~hit])
    normal = np.asarray(j.normal.to_array())
    cos = np.abs((normal * d).sum(1))
    assert ((np.abs(tt - jt) * cos)[hit] <= T_ATOL + T_RTOL * jt[hit]).all()
    jtri = np.asarray(j.tri)
    differ = t.tri.numpy() != jtri
    assert differ.mean() <= 0.01, differ.sum()
    same = ~differ
    np.testing.assert_array_equal(t.mat.numpy()[same], np.asarray(j.mat)[same])
    np.testing.assert_array_equal(t.normal.numpy()[same], normal[same])
    if differ.any():
        # The JAX winner, tested by the port's own plane + edge test, is
        # hit at the port's t: a tie.
        rows = dense.pack_tris(tscene)[torch.as_tensor(jtri[differ]).long()]
        oo, dd = _t(o[differ]), _t(d[differ])
        t_j = torch.stack([dense._pe_block(oo[k:k + 1], dd[k:k + 1],
                                           rows[k:k + 1], 0.01)[0][0, 0]
                           for k in range(rows.shape[0])])
        gap = (t_j - t.t[differ]).abs().numpy() * cos[differ]
        assert (gap <= T_ATOL + T_RTOL * tt[differ]).all(), gap.max()
    return hit


def test_clustered_closest_matches_pallas(mixed_scenes, monkeypatch):
    """K6's plain version against the clustered Pallas path (interpret
    mode) on 1,024 camera and 1,024 bounce rays of the mixed box."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    o, d, _, _, _ = _rays(jscene, 1024, seed=11)
    assert kernel_module(tscene) is clustered
    tables = clustered.prepare(tscene)
    assert tables.rows.shape[0] == 512 and tables.boxes.shape[0] == 8
    before = dict(clustered.LAUNCHES)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    t = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    hit = _assert_same_clustered_hit(j, t, o, d, tscene)
    assert 0.5 < hit.mean() < 1.0
    assert clustered.LAUNCHES == before        # CPU tensors: plain version
    # A finite tmax clips hits as the dense path does.
    t600 = clustered.closest_hit(tables, _t(o), _t(d), tmax=600.0)
    ref600 = dense.intersect_closest(tscene, _t(o), _t(d), tmax=600.0)
    assert torch.equal(t600.t, ref600.t) and torch.equal(t600.tri, ref600.tri)
    assert torch.equal(t600.mat, ref600.mat)
    np.testing.assert_allclose(t600.u.numpy(), ref600.u.numpy(), atol=1e-5)


def test_clustered_occluded_matches_pallas(mixed_scenes, monkeypatch):
    """K8's plain version against ``_intersect_occluded_tiled`` (the
    clustered any-hit over the whole table, interpret mode)."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    _, _, p, ld, tmax = _rays(jscene, 2048, seed=12)
    j = np.asarray(pallas_bf._intersect_occluded_tiled(
        jscene, jnp.asarray(p), jnp.asarray(ld), jnp.asarray(tmax)))
    tables = clustered.prepare(tscene)
    ours = clustered.occluded_clustered(_t(p), _t(ld), _t(tmax), tables.rows,
                                        tables.boxes, tables.scale, 0.01)
    np.testing.assert_array_equal(ours.numpy(), j)
    assert 0.05 < j.mean() < 0.95
    # The 24-row occluder subset fits one slab: shadow rays take K2 there,
    # with the same flags.
    assert tables.occ_rows is not None and tables.occ_rows.shape[0] == 24
    assert torch.equal(clustered.occluded_hit(tables, _t(p), _t(ld),
                                              _t(tmax)), ours)


def _slab(o, d, boxes, scale):
    """The kernels' slab test ([R] rays x [C] boxes, each box grown by the
    ray's culling margin): (tnear, tfar)."""
    g = torch.where(d.abs() > 1e-12, d,
                    torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype))
    inv = 1.0 / g
    m = (clustered.BOX_MARGIN * (scale + o.abs().amax(1)))[:, None, None]
    t0 = (boxes[None, :, 0:3] - m - o[:, None]) * inv[:, None]
    t1 = (boxes[None, :, 3:6] + m - o[:, None]) * inv[:, None]
    return (torch.minimum(t0, t1).amax(2), torch.maximum(t0, t1).amin(2))


def _culling_rays(jscene, seed):
    """Camera, bounce and shadow rays, plus axis-parallel rays from inside
    the Cornell box (they hit the flat wall boxes through the guarded
    reciprocal) and parked lanes."""
    o, d, p, ld, _ = _rays(jscene, 512, seed=seed)
    axes = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)
    r = np.random.default_rng(seed)
    inside = r.uniform(20.0, 530.0, (64, 3)).astype(np.float32)
    ao = np.repeat(inside, 6, axis=0)
    ad = np.tile(axes, (64, 1))
    park_o = np.full((8, 3), 3.0e7, np.float32)
    park_d = np.full((8, 3), 0.5773503, np.float32)
    return (np.concatenate([o, p, ao, park_o]),
            np.concatenate([d, ld, ad, park_d]))


def _far_rays(seed, n=512, dist=1.0e5):
    """Rays from origins ``dist`` from the centre of a unit-scale scene,
    aimed at points within 0.8 of it."""
    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3))
    o *= dist / np.linalg.norm(o, axis=1, keepdims=True)
    d = r.uniform(-0.8, 0.8, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("scene_name", ["mixed", "sphere", "far"])
def test_culling_boxes_are_conservative(mixed_scenes, sphere_scenes,
                                        unit_sphere_scene, monkeypatch,
                                        scene_name):
    """Every (ray, row) pair the plane + edge test accepts lies inside the
    slab interval of its cluster's culling box, which is what makes the
    kernels' box culling exact (clustered_intersect.cu). On the mixed box
    the walls and blocks give flat, axis-aligned boxes; ``far`` looks at
    the unit-radius sphere from 100,000 radii away, where the rounding of
    the hit point dwarfs a margin taken from the scene's size alone (with
    the margin 1e-4 of the scene's scale, 19 of its ~1,000 pairs fall
    outside their boxes)."""
    monkeypatch.setattr(clustered, "CLUSTER", 32)
    if scene_name == "far":
        tscene = unit_sphere_scene
        o, d = (_t(a) for a in _far_rays(seed=16))
    else:
        tscene = (mixed_scenes if scene_name == "mixed" else sphere_scenes)[1]
        o, d = (_t(a) for a in _culling_rays(mixed_scenes[0], seed=13))
    rows, boxes = clustered.pack_tris_clustered(tscene)
    tn, tf = _slab(o, d, boxes, clustered.box_scale(boxes))
    t, _, _ = dense._pe_block(o, d, rows, 0.01)
    ray, row = torch.nonzero(t < 1e15, as_tuple=True)
    assert ray.numel() > 500
    c = row // 32
    th = t[ray, row]
    assert bool((tn[ray, c] <= tf[ray, c]).all())
    assert bool((tf[ray, c] > 0.01).all())
    assert bool((tn[ray, c] < th).all() and (th < tf[ray, c]).all())
    if scene_name == "far":
        return
    # Parked lanes pass no box: real boxes lie behind them, and the
    # collapsed empty box at 3e37 lies beyond T_FAR.
    passes = (tn <= tf) & (tf > 0.01) & (tn <= 1e16)
    assert not bool(passes[-8:].any())
    assert bool((boxes[:, 0] > 1e30).any())     # padding: an empty box


def test_routing_above_tri_slab(sphere_scenes, monkeypatch):
    """A scene above TRI_SLAB whose occluder subset is also too big sends
    shadow rays to K8 over the whole clustered table; ``auto`` on the CPU
    stays brute force and ``dense`` takes the clustered entry points."""
    _, tscene = sphere_scenes
    monkeypatch.setattr(dense, "TRI_SLAB", 1024)
    assert kernel_module(tscene) is clustered
    tables = clustered.prepare(tscene)
    assert tables.occ_rows is None and tscene.num_occluders == 4900
    cfg = tp.RenderConfig(width=8, height=8, spp=1)
    closest, occluded_fn = get_intersectors(tscene, cfg)
    assert closest.func is tp.intersect.moller.intersect_closest
    closest, occluded_fn = get_intersectors(tscene,
                                            cfg.with_(intersector="dense"))
    assert closest.func is clustered.closest_hit
    assert occluded_fn.func is clustered.occluded_hit
    # Shadow rays across the sphere, and parked ones (tmax 0).
    r = np.random.default_rng(14)
    a = r.uniform(-1, 1, (256, 3)) * 300 + [278, 220, 280]
    b = r.uniform(-1, 1, (256, 3)) * 300 + [278, 220, 280]
    dist = np.linalg.norm(b - a, axis=1)
    ld = ((b - a) / dist[:, None]).astype(np.float32)
    tmax = (dist - 0.01).astype(np.float32)
    tmax[:8] = 0.0
    occ = occluded_fn(_t(a.astype(np.float32)), _t(ld), _t(tmax))
    ref = tp.intersect.moller.intersect_occluded(
        tscene, _t(a.astype(np.float32)), _t(ld), _t(tmax))
    assert torch.equal(occ, ref) and not occ[:8].any()
    assert 0.1 < float(occ.float().mean()) < 0.9


def test_render_clustered_matches_reference(mixed_scene, mixed_scenes,
                                            monkeypatch):
    """A 32^2 x 4 spp frame of the mixed box with K6 and K8 forced (TRI_SLAB
    below the 24-row occluder subset), against the JAX render, within
    ``test_torch_render.py``'s bound."""
    _, tscene = mixed_scenes
    monkeypatch.setattr(dense, "TRI_SLAB", 16)
    monkeypatch.setattr(clustered, "CLUSTER", 64)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = tp.RenderConfig(**{**BASE, "intersector": "dense"})
        closest, occluded_fn = get_intersectors(tscene, cfg)
        assert closest.func is clustered.closest_hit
        assert occluded_fn.keywords["quirk_first_hit"] is False
        assert clustered.prepare(tscene).occ_rows is None
        cam = CameraArrays.from_camera(tp.cornell_default_camera(),
                                       device="cpu")
        accum, _, stats = render_frame(tscene, cam, cfg, 0,
                                       init_accum(cfg, device="cpu"))
    finally:
        torch.set_num_threads(n)
    jcfg = tpu_pt.RenderConfig(**BASE)
    jcam = jrender.CameraArrays.from_camera(tpu_pt.cornell_default_camera())
    ref, _, ref_stats = jrender.render_frame(mixed_scene, jcam, jcfg, 0,
                                             jrender.init_accum(jcfg))
    ours, ref = accum.numpy(), np.asarray(ref)
    paths = BASE["width"] * BASE["height"] * BASE["spp"]
    assert int(stats.done_histogram.sum()) == paths
    assert int(stats.done_histogram[tp.render.NOT_DONE]) == 0
    hist_delta = np.abs(np.asarray(stats.done_histogram, np.float64)
                        - np.asarray(ref_stats.done_histogram, np.float64))
    assert (hist_delta <= 1e-3 * paths).all(), hist_delta
    assert np.isfinite(ours).all()
    diff = np.abs(ours - ref).max(axis=-1)
    assert diff.mean() < 1e-4, diff.mean()
    assert (diff > 1e-4).mean() <= 0.01, np.sort(diff.ravel())[-12:]


def test_clustered_resolve_reads_original_ids(sphere_scenes):
    """``Hit.tri`` is the original triangle id (packed column 15), not the
    clustered row: on the kd-ordered displaced sphere the port's clustered
    hits match the JAX brute force, u/v included."""
    jscene, tscene = sphere_scenes
    order = tscene.cluster_order.long()
    assert not torch.equal(order, torch.arange(order.shape[0]))
    o, d, _, _, _ = _rays(jscene, 512, seed=15)
    j = jmoller.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d))
    t = clustered.closest_hit(clustered.prepare(tscene), _t(o), _t(d),
                              want_uv=True)
    hit = _assert_same_clustered_hit(j, t, o, d, tscene)
    assert hit.sum() > 50
    same = t.tri.numpy() == np.asarray(j.tri)
    np.testing.assert_allclose(t.u.numpy()[same], np.asarray(j.u)[same],
                               atol=5e-4)


def _spy(monkeypatch, module, names):
    """Count the calls of ``module``'s wrappers ``names`` while they run."""
    calls = dict.fromkeys(names, 0)
    for name in names:
        def counted(*a, _fn=getattr(module, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(module, name, counted)
    return calls


UV_ATOL = 1e-4
CLOSEST_WRAPPERS = ("closest_clustered", "closest_clustered_full",
                    "closest_clustered_b", "closest_clustered_full_b")


@pytest.mark.parametrize("env, want_uv", [({"TPT_LEAN_BIG": "0"}, False),
                                          ({"TPT_LEAN_BIG": "0"}, True),
                                          ({"TPT_LEAN_UV": "0"}, True)])
def test_full_carry_matches_pallas(mixed_scenes, monkeypatch, env, want_uv):
    """K6f's plain version, taken by ``closest_hit`` under the JAX
    package's variables, against the full-carry clustered Pallas kernels
    under the same variables: hit, t, id, material and normal as K6's
    test holds them, u and v to UV_ATOL."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    calls = _spy(monkeypatch, clustered, CLOSEST_WRAPPERS)
    o, d, _, _, _ = _rays(jscene, 512, seed=17)
    tables = clustered.prepare(tscene)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=want_uv)
    t = clustered.closest_hit(tables, _t(o), _t(d), want_uv=want_uv)
    assert calls == {**dict.fromkeys(CLOSEST_WRAPPERS, 0),
                     "closest_clustered_full": 1}
    hit = _assert_same_clustered_hit(j, t, o, d, tscene)
    assert 0.5 < hit.mean() < 1.0
    same = t.tri.numpy() == np.asarray(j.tri)
    if want_uv:
        np.testing.assert_allclose(t.u.numpy()[same], np.asarray(j.u)[same],
                                   atol=UV_ATOL)
        np.testing.assert_allclose(t.v.numpy()[same], np.asarray(j.v)[same],
                                   atol=UV_ATOL)
        assert t.u.numpy()[hit].any()
    else:
        assert not t.u.any() and not t.v.any()
    # The full carry equals the lean kernel and its gather, u and v to
    # float association.
    for k in env:
        monkeypatch.delenv(k)
    lean = clustered.closest_hit(tables, _t(o), _t(d), want_uv=want_uv)
    assert calls["closest_clustered"] == 1
    for k in ("t", "tri", "hit", "normal", "mat"):
        assert torch.equal(getattr(t, k), getattr(lean, k)), k
    np.testing.assert_allclose(t.u.numpy(), lean.u.numpy(), atol=1e-5)
    np.testing.assert_allclose(t.v.numpy(), lean.v.numpy(), atol=1e-5)


@pytest.mark.parametrize("lean_big", ["1", "0"])
def test_inkb_dispatch_matches_pallas(mixed_scenes, monkeypatch, lean_big):
    """``TPT_INKB=1`` sends the clustered calls to the kernels that build
    their work list (K7 lean or full, K8b); on the CPU their plain
    versions, held against the JAX package under the same variable."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setenv("TPT_INKB", "1")
    monkeypatch.setenv("TPT_LEAN_BIG", lean_big)
    names = CLOSEST_WRAPPERS + ("occluded_clustered", "occluded_clustered_b")
    calls = _spy(monkeypatch, clustered, names)
    monkeypatch.setattr(dense, "TRI_SLAB", 16)      # shadow rays take K8(b)
    o, d, p, ld, tmax = _rays(jscene, 512, seed=18)
    tables = clustered.prepare(tscene)
    assert tables.occ_rows is None
    before = dict(clustered.LAUNCHES)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    t = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    _assert_same_clustered_hit(j, t, o, d, tscene)
    occ = clustered.occluded_hit(tables, _t(p), _t(ld), _t(tmax))
    jocc = pallas_bf._intersect_occluded_tiled(
        jscene, jnp.asarray(p), jnp.asarray(ld), jnp.asarray(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))
    taken = ("closest_clustered_b" if lean_big == "1"
             else "closest_clustered_full_b")
    assert calls == {**dict.fromkeys(names, 0), taken: 1,
                     "occluded_clustered_b": 1}
    assert clustered.LAUNCHES == before         # CPU tensors: plain versions
    assert set(names) == set(clustered.LAUNCHES)


def test_variables_are_read_at_call_time(mixed_scenes, monkeypatch):
    """The intersectors made once switch kernels when a variable changes
    between two calls."""
    _, tscene = mixed_scenes
    _shrink(monkeypatch)
    for k in ("TPT_LEAN_BIG", "TPT_LEAN_UV", "TPT_INKB"):
        monkeypatch.delenv(k, raising=False)
    assert clustered.variant(True) == clustered.variant(False) == (False,
                                                                   False)
    calls = _spy(monkeypatch, clustered, CLOSEST_WRAPPERS)
    cfg = tp.RenderConfig(width=8, height=8, spp=1, intersector="dense")
    closest, _ = get_intersectors(tscene, cfg, want_uv=True)
    o = torch.tensor([[278.0, 273.0, -800.0]])
    d = torch.tensor([[0.0, 0.0, 1.0]])
    closest(o, d)
    monkeypatch.setenv("TPT_LEAN_UV", "0")
    assert clustered.variant(True) == (True, False)
    assert clustered.variant(False) == (False, False)
    closest(o, d)
    monkeypatch.setenv("TPT_INKB", "1")
    assert clustered.variant(True) == (True, True)
    closest(o, d)
    monkeypatch.setenv("TPT_LEAN_UV", "1")
    closest(o, d)
    assert calls == dict.fromkeys(CLOSEST_WRAPPERS, 1)
    monkeypatch.setenv("TPT_LEAN_BIG", "0")
    assert clustered.variant(False) == (True, True)


def test_lean_uv0_single_slab_takes_full_kernel(mixed_scenes, monkeypatch):
    """On a single-slab scene ``TPT_LEAN_UV=0`` sends a call that wants
    u, v to K3 instead of K1 and its gather, as the JAX package does (on
    the mixed box, whose table has a kd copy, their walks); u and v agree
    with the JAX full-carry kernel to UV_ATOL."""
    jscene, tscene = mixed_scenes
    calls = _spy(monkeypatch, dense, ("closest_lean_tree",
                                      "closest_full_tree"))
    tables = dense.prepare(tscene)
    o, d, _, _, _ = _rays(jscene, 512, seed=19)
    lean = dense.closest_hit(tables, _t(o), _t(d), want_uv=True)
    monkeypatch.setenv("TPT_LEAN_UV", "0")
    dense.closest_hit(tables, _t(o), _t(d), want_uv=False)
    assert calls == {"closest_lean_tree": 2, "closest_full_tree": 0}
    full = dense.closest_hit(tables, _t(o), _t(d), want_uv=True)
    assert calls == {"closest_lean_tree": 2, "closest_full_tree": 1}
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=True)
    for k in ("t", "tri", "hit", "normal", "mat"):
        assert torch.equal(getattr(full, k), getattr(lean, k)), k
    np.testing.assert_array_equal(full.tri.numpy(), np.asarray(j.tri))
    np.testing.assert_allclose(full.u.numpy(), np.asarray(j.u), atol=UV_ATOL)
    np.testing.assert_allclose(full.v.numpy(), np.asarray(j.v), atol=UV_ATOL)
    np.testing.assert_allclose(full.u.numpy(), lean.u.numpy(), atol=1e-5)
