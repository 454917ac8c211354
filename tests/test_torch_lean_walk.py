"""K1 and K4 as walks of kd copies (``tpu_pt_torch.intersect.dense``:
``closest_lean_tree`` and ``closest_nee_lean_tree`` over
``DenseTables.kd``, K4's shadow ray over ``DenseTables.occ_kd`` or the
occluder subset's rows; their plain versions ``_closest_lean_kd_plain``
and ``_closest_nee_lean_kd_plain``), on the CPU at the mixed and monkey
boxes' real sizes.

A table of at most ``LEAN_MAX_TRIS`` rows gets a kd copy when at least
one cluster of its triangles is left outside the top rows (the triangles
that span the room): the mixed box's 432-row table (32 top rows, the
sphere's 396 in 4 clusters) but not its 24 occluders, the monkey box's
table and its 1,232 occluders, neither of ``cornell_box.obj``'s 32 rows.
The tests hold:

- ``prepare``'s copies to that rule, each a bitwise permutation of its
  table's real rows;
- the plain versions bit for bit to the dense plain versions
  (``_closest_plain``, ``_closest_nee_plain``) on camera, bounce and
  shared-edge rays, where rows tie on t and the lowest dense row must win;
- a plain walk of each tree (the top rows, then the clusters
  ``clustered._tree_leaves_plain`` reaches at the walk's bound) to the
  same answers;
- ``intersect_closest`` / ``intersect_closest_nee`` on the mixed box
  against ``pallas_bf`` (interpret mode) within
  ``tests/test_torch_intersect.py``'s and ``tests/test_torch_fused_nee.py``'s
  tolerances;
- 32^2 x 2 spp frames, unfused and ``fused_nee``, bitwise equal to the
  same frames with the kd copies removed, the walks called once per round
  and the dense bodies never (and the other way round without copies);
- the walks' wrappers' input checks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import pallas_bf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import clustered, dense  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from tpu_pt_torch.render import CameraArrays, init_accum  # noqa: E402
from tpu_pt_torch.render import render_frame  # noqa: E402
from test_torch_dense_tree import _edge_rays, _ties  # noqa: E402
from test_torch_fused_nee import rays  # noqa: E402,F401
from test_torch_intersect import _rays, assert_same_hit  # noqa: E402

TMIN = 0.01
EYE = (278.0, 273.0, -800.0)
FILES = {"mixed": "cornell_box_mixed.obj", "monkey": "cornell_box_monkey.obj",
         "cornell": "cornell_box.obj"}
WRAPPERS = ("closest_lean", "closest_lean_tree", "closest_full",
            "closest_full_tree", "occluded", "occluded_tree",
            "closest_nee_lean", "closest_nee_lean_tree")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boxes(assets_dir):
    """name -> (path, port scene, tables, light) of the three boxes."""
    out = {}
    for name, f in FILES.items():
        path = str(assets_dir / f)
        scene = tp.load_scene(path, device="cpu")
        out[name] = (path, scene, dense.prepare(scene),
                     dense.light_vector(scene))
    return out


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _box_rays(scene, tables, kind: str, n: int, seed: int):
    """n rays and light samples (lz1, lz2): ``camera`` rays from the Cornell
    eye toward random points in the box, ``bounce`` rays leaving the
    surfaces those hit (lifted 1e-3 off them) in random directions of the
    facing hemisphere, ``edges`` rays aimed at shared edges."""
    if kind == "edges":
        return _edge_rays(scene, n, seed)
    r = np.random.default_rng(seed)
    target = r.uniform([0, 0, 0], [556, 548, 559], (n, 3))
    o = np.broadcast_to(np.array(EYE), (n, 3))
    d = (target - o) / np.linalg.norm(target - o, axis=1, keepdims=True)
    o, d = _t(o), _t(d)
    lz = _t(r.random((2, n)))
    if kind == "bounce":
        t, row = dense._closest_plain(o, d, tables.rows, TMIN)
        hit = t < T_FAR
        nrm = tables.rows[row.long(), 0:3]
        nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0, -nrm, nrm)
        o = torch.where(hit[:, None], o + d * t[:, None] + 1e-3 * nrm, o)
        rd = _t(r.normal(size=(n, 3)))
        rd = torch.where((rd * nrm).sum(1, keepdim=True) < 0, -rd, rd)
        d = rd / rd.norm(dim=1, keepdim=True)
    return o.contiguous(), d.contiguous(), lz[0].contiguous(), \
        lz[1].contiguous()


def _subset(tables):
    """The occluder subset as ``closest_nee_lean_tree`` takes it."""
    occ_kd = tables.occ_kd
    if occ_kd is None:
        return (tables.occ_rows, tables.occ_rows.shape[0], None, None, 0.0)
    return (occ_kd.rows, occ_kd.top, occ_kd.boxes, occ_kd.nodes,
            occ_kd.scale)


def _reached(o, d, kd, bound):
    """[N, kd rows] mask of a plain walk: every ray takes the top rows and
    the rows of each cluster ``clustered._tree_leaves_plain`` reaches at
    its ``bound``."""
    cluster = (kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]
    reached, _ = clustered._tree_leaves_plain(o, d, kd.nodes, kd.boxes,
                                              kd.scale, TMIN, bound)
    top = torch.ones((o.shape[0], kd.top), dtype=torch.bool)
    return torch.cat([top, reached.repeat_interleave(cluster, 1)], 1)


class _Spy:
    """Counts the calls of dense's K1-K4 wrappers (dense bodies and walks)
    and keeps their arguments, while they run as usual."""

    def __init__(self, monkeypatch):
        self.calls = {k: [] for k in WRAPPERS}
        for k in WRAPPERS:
            monkeypatch.setattr(dense, k, self._spy(k, getattr(dense, k)))

    def _spy(self, name, real):
        def call(*args, **kw):
            self.calls[name].append(args)
            return real(*args, **kw)
        return call

    def counts(self):
        return {k: len(v) for k, v in self.calls.items() if v}


@pytest.mark.parametrize("name,kd_shape,occ_shape", [
    ("mixed", (32, 4), None),
    ("monkey", (32, 11), (24, 10)),
    ("cornell", None, None)])
def test_prepare_builds_the_lean_copies(boxes, name, kd_shape, occ_shape):
    """The mixed box's table gets a kd copy (32 top rows, the sphere's 396
    rows in 4 clusters) and its 24 occluders none (all top rows); the
    monkey box's table and its occluder subset each get one;
    ``cornell_box.obj``'s 32 rows, all spanning the room, get neither.
    Each copy holds its table's real rows bit for bit, once each (column
    15 names the dense row), its tree and scale as ``clustered`` builds
    them."""
    _, scene, tables, _ = boxes[name]
    assert tables.rows.shape[0] <= dense.LEAN_MAX_TRIS
    assert tables.occ_rows.shape[0] == scene.num_occluders
    for kd, shape, table in ((tables.kd, kd_shape, tables.rows),
                             (tables.occ_kd, occ_shape, tables.occ_rows)):
        if shape is None:
            assert kd is None
            continue
        top, n_c = shape
        assert (kd.top, kd.boxes.shape[0]) == (top, n_c)
        assert kd.rows.shape == (top + n_c * clustered.CLUSTER, 16)
        assert torch.equal(kd.nodes, clustered.cluster_tree(kd.boxes))
        assert kd.scale == clustered.box_scale(kd.boxes)
        mine = kd.rows[:, 0:12].any(1)
        real = table[table[:, 0:12].any(1)]
        ids = kd.rows[mine][:, 15]
        assert torch.equal(kd.rows[mine][torch.argsort(ids)],
                           real[torch.argsort(real[:, 15])])
        assert not bool(kd.rows[~mine].any())


@pytest.mark.parametrize("kind", ["camera", "bounce", "edges"])
@pytest.mark.parametrize("name", ["mixed", "monkey"])
def test_k1_kd_plain_is_the_dense_plain_version(boxes, name, kind):
    """K1's plain version on the kd copy gives ``_closest_plain`` on the
    dense table bit for bit, (t, row); on rays aimed at shared edges rows
    tie on t, and the lowest dense row wins."""
    _, scene, tables, _ = boxes[name]
    kd = tables.kd
    o, d, _, _ = _box_rays(scene, tables, kind, 1024, seed=51)
    want = dense._closest_plain(o, d, tables.rows, TMIN)
    hit = want[0] < T_FAR
    assert 0.3 < float(hit.float().mean()) <= 1.0
    got = dense.closest_lean_tree(o, d, kd.rows, kd.top, kd.boxes, kd.nodes,
                                  kd.scale, TMIN)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if kind == "edges":
        tie = _ties(o, d, tables.rows)
        assert int(tie.sum()) > 10
        t, _, _ = dense._pe_block(o, d, tables.rows, TMIN)
        iota = torch.arange(tables.rows.shape[0], dtype=torch.int32)
        low = torch.where(t == want[0][:, None], iota,
                          tables.rows.shape[0]).min(1).values
        assert torch.equal(got[1][tie], low[tie])


@pytest.mark.parametrize("kind", ["camera", "bounce", "edges"])
@pytest.mark.parametrize("name", ["mixed", "monkey"])
def test_k4_kd_plain_is_the_dense_plain_version(boxes, name, kind):
    """K4's plain version on the kd copies gives ``_closest_nee_plain`` on
    the dense tables bit for bit: (t, row), and the occlusion flag of the
    shadow ray from each hit toward its light sample, on hit lanes and
    (the same rows any-hit, in another order) on miss lanes too."""
    _, scene, tables, light = boxes[name]
    kd = tables.kd
    o, d, lz1, lz2 = _box_rays(scene, tables, kind, 1024, seed=52)
    want = dense._closest_nee_plain(o, d, lz1, lz2, tables.rows,
                                    tables.occ_rows, light, TMIN)
    got = dense.closest_nee_lean_tree(o, d, lz1, lz2, kd.rows, kd.top,
                                      kd.boxes, kd.nodes, kd.scale,
                                      *_subset(tables), light, TMIN)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    hit = want[0] < T_FAR
    assert 0.02 < float(want[2][hit].float().mean()) < 0.98


@pytest.mark.parametrize("name,part", [("mixed", "K1"), ("monkey", "K1"),
                                       ("monkey", "K4's shadow ray")])
def test_plain_walks_reach_the_dense_answer(boxes, name, part):
    """A plain walk of each tree: K1 over the top rows and the clusters
    reached at each ray's final bound, folded on (t, id), gives the dense
    closest hit; K4's shadow ray over the top rows and the clusters of the
    subset's copy reached at its own tmax gives the dense flags. So the
    culls drop no winning and no blocking row."""
    _, scene, tables, light = boxes[name]
    o, d, lz1, lz2 = _box_rays(scene, tables, "bounce", 1024, seed=53)
    want = dense._closest_nee_plain(o, d, lz1, lz2, tables.rows,
                                    tables.occ_rows, light, TMIN)
    if part == "K1":
        kd = tables.kd
        t, _, _ = dense._pe_block(o, d, kd.rows, TMIN)
        t = torch.where(_reached(o, d, kd, want[0]), t, T_FAR)
        best = t.min(1).values
        ids = kd.rows[:, 15].to(torch.int32)
        low = torch.where(t == best[:, None], ids,
                          torch.iinfo(torch.int32).max).min(1).values
        assert torch.equal(best, want[0])
        assert torch.equal(torch.where(best < T_FAR, low, 0), want[1])
        return
    kd = tables.occ_kd
    so, sd, stmax = dense._shadow_rays(o, d, want[0], lz1, lz2, light)
    t, _, _ = dense._pe_block(so, sd, kd.rows, TMIN)
    block = (t < stmax[:, None]) & (kd.rows[None, :, 13] < 0.5)
    got = (block & _reached(so, sd, kd, stmax)).any(1)
    hit = want[0] < T_FAR
    assert 0.02 < float(want[2][hit].float().mean()) < 0.98
    assert torch.equal(got[hit], want[2][hit])


@pytest.mark.parametrize("call", ["closest", "closest_nee"])
def test_mixed_walks_match_pallas(boxes, rays, monkeypatch, call):
    """The port's entry points on the mixed box, through the kd copy,
    against the JAX package's kernels in interpret mode:
    ``intersect_closest`` at tests/test_torch_intersect.py's tolerances
    (camera and bounce rays), ``intersect_closest_nee`` at
    tests/test_torch_fused_nee.py's (hit, triangle, material, normal equal,
    t within 1e-6 relative, occlusion of hit lanes equal on >= 99%)."""
    path, scene, _, _ = boxes["mixed"]
    jscene = tpu_pt.load_scene(path)
    spy = _Spy(monkeypatch)
    if call == "closest":
        o, d, _, _, _ = _rays(jscene, 1024, seed=54)
        j = pallas_bf.intersect_closest(jscene, jnp.asarray(o),
                                        jnp.asarray(d), want_uv=True)
        t = dense.intersect_closest(scene, _t(o), _t(d), want_uv=True)
        hit = assert_same_hit(j, t, d, uv_atol=5e-4)
        assert 0.5 < hit.mean() <= 1.0
        assert spy.counts() == {"closest_lean_tree": 1}
        return
    o, d, lz1, lz2 = rays
    jh, jocc = pallas_bf.intersect_closest_nee(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lz1),
        jnp.asarray(lz2))
    th, tocc = dense.intersect_closest_nee(scene, _t(o), _t(d), _t(lz1),
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
    assert spy.counts() == {"closest_nee_lean_tree": 1}


@pytest.mark.parametrize("name,fused", [("mixed", False), ("mixed", True),
                                        ("monkey", True)])
def test_frame_equals_the_frame_without_kd_copies(boxes, monkeypatch, name,
                                                  fused):
    """A 32^2 x 2 spp frame (depth 4, IS + NEE, ``intersector="dense"``),
    unfused or ``fused_nee``, through the walks' plain versions is bitwise
    the frame with the kd copies removed (the dense bodies' plain
    versions). The first calls only the walks, once per round (the mixed
    box's unfused shadow rays take K2's dense body: its subset has no
    copy), the second only the dense bodies."""
    _, scene, _, _ = boxes[name]
    cfg = tp.RenderConfig(width=32, height=32, spp=2, max_depth=4,
                          use_direct_lighting=True,
                          use_importance_sampling=True, intersector="dense",
                          fused_nee=fused)
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    prepare = dense.prepare
    out = []
    for strip in (False, True):
        with monkeypatch.context() as m:
            spy = _Spy(m)
            if strip:
                m.setattr(dense, "prepare", lambda s: dataclasses.replace(
                    prepare(s), kd=None, occ_kd=None))
            accum, _, stats = render_frame(scene, cam, cfg, 0,
                                           init_accum(cfg, device="cpu"))
            out.append((accum, spy.counts(),
                        int(stats.wavefront_iterations)))
    (walk, walk_calls, rounds), (dense_frame, dense_calls, _) = out
    assert bool(torch.isfinite(walk).all()) and float(walk.sum()) > 0.0
    assert torch.equal(walk, dense_frame)
    if fused:
        assert walk_calls == {"closest_nee_lean_tree": rounds}
        assert dense_calls == {"closest_nee_lean": rounds}
    else:
        assert walk_calls == {"closest_lean_tree": rounds,
                              "occluded": rounds}
        assert dense_calls == {"closest_lean": rounds, "occluded": rounds}


def test_lean_walk_wrappers_check_inputs(boxes):
    """The walks' wrappers refuse a device other than the CPU or CUDA, run
    their plain versions on CPU tensors without counting a launch, and
    refuse a kd copy whose top rows do not fit, or a subset swept whole
    whose top rows are not all its rows."""
    _, scene, tables, light = boxes["mixed"]
    kd = tables.kd
    meta = torch.empty((4, 3), device="meta")
    lz = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense.closest_lean_tree(meta, meta, kd.rows, kd.top, kd.boxes,
                                kd.nodes, kd.scale, TMIN)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense.closest_nee_lean_tree(meta, meta, lz, lz, kd.rows, kd.top,
                                    kd.boxes, kd.nodes, kd.scale,
                                    *_subset(tables), light, TMIN)
    before = dict(dense.LAUNCHES)
    o, d, lz1, lz2 = _box_rays(scene, tables, "camera", 16, seed=55)
    dense.closest_lean_tree(o, d, kd.rows, kd.top, kd.boxes, kd.nodes,
                            kd.scale, TMIN)
    dense.closest_nee_lean_tree(o, d, lz1, lz2, kd.rows, kd.top, kd.boxes,
                                kd.nodes, kd.scale, *_subset(tables), light,
                                TMIN)
    assert dense.LAUNCHES == before            # CPU tensors: plain versions
    occ = tables.occ_rows
    with pytest.raises(ValueError, match="no clusters"):
        dense._kd_launch_args(occ, occ.shape[0] - 1, None, None, 0.0,
                              occ.device)
    assert dense._kd_launch_args(occ, occ.shape[0], None, None, 0.0,
                                 occ.device)[1:] == (occ.shape[0], None,
                                                     None, 0, 0, 0.0)
    with pytest.raises(ValueError):
        dense._kd_launch_args(kd.rows, kd.top + 1, kd.boxes, kd.nodes,
                              kd.scale, kd.rows.device)
