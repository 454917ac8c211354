"""K3 and K2 as walks of kd copies (``tpu_pt_torch.intersect.dense``:
``closest_full_tree`` over ``DenseTables.kd``, ``occluded_tree`` over
``DenseTables.occ_kd``, their plain versions ``_closest_full_kd_plain``
and ``_occluded_kd_plain``), on the CPU at the sphere box's real size.

K3 walks the kd copy K5 walks (the table's rows, the room-wide triangles
first); K2's function is any-hit over the NEE occluder subset, so it walks
a kd copy of the subset, built by the same rule. The tests hold:

- the subset's copy to a bitwise permutation of the subset's real rows;
- the plain versions bit for bit to the dense plain versions
  (``_closest_plain(full=True, want_uv=True)``, ``_occluded_plain`` over
  ``occ_rows``), at tmax = T_FAR and at a finite tmax, on rays aimed at
  shared edges (rows tie on t and the lowest dense row must win) and on
  shadow rays from hit points to light samples, blocked and unblocked;
- a plain walk of each tree (the top rows, then the clusters
  ``clustered._tree_leaves_plain`` reaches at the walk's bound) to the
  same answers;
- the routing: the sphere and monkey boxes to the walks, the mixed box's
  closest hits to the walks and its shadow rays (24 occluders, no copy)
  to K2's dense body, ``cornell_box.obj`` (no copy) to the dense bodies,
  and a clustered scene whose occluder subset has more than
  ``LEAN_MAX_TRIS`` rows (foliage, flattened) to K2's walk;
- the port's ``closest_hit`` / ``occluded_hit`` on the sphere box against
  ``pallas_bf.intersect_closest`` / ``intersect_occluded`` (interpret
  mode) within ``tests/test_torch_intersect.py``'s tolerances: hit,
  triangle, material, normal and flags equal, |dt| * |n.d| within 1e-4
  plus 4e-6 of t, u and v within 5e-4;
- a 32^2 x 2 spp unfused sphere-box frame bitwise equal to the same frame
  with the kd copies removed.
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
from test_torch_intersect import _rays, assert_same_hit  # noqa: E402

TMIN = 0.01
WRAPPERS = ("closest_lean", "closest_lean_tree", "closest_full",
            "closest_full_tree", "occluded", "occluded_tree")
# K1 and K3 by their dense bodies' names, and their walks
WALK_OF = {"closest_lean": "closest_lean_tree",
           "closest_full": "closest_full_tree"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def boxes(assets_dir):
    """name -> (JAX scene, port scene, port tables) of the four boxes."""
    out = {}
    for name in ("sphere", "mixed", "monkey", "cornell"):
        path = str(assets_dir / ("cornell_box.obj" if name == "cornell"
                                 else f"cornell_box_{name}.obj"))
        scene = tp.load_scene(path, device="cpu")
        out[name] = (tpu_pt.load_scene(path), scene, dense.prepare(scene))
    return out


@pytest.fixture(scope="module")
def sphere_rays(boxes):
    """test_torch_intersect.py's rays in the sphere box: 1,024 camera rays
    and 1,024 leaving the surfaces they hit, then shadow rays from those
    points to points of the light."""
    o, d, p, ld, tmax = _rays(boxes["sphere"][0], 1024, seed=21)
    return o, d, p, ld, tmax


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _occ_ids(scene):
    return scene.occ_index[:scene.num_occluders].long()


def _reached(o, d, kd, bound):
    """[N, kd rows] mask of a plain walk: every ray takes the top rows and
    the rows of each cluster ``clustered._tree_leaves_plain`` reaches at
    its ``bound``."""
    cluster = (kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]
    reached, _ = clustered._tree_leaves_plain(o, d, kd.nodes, kd.boxes,
                                              kd.scale, TMIN, bound)
    top = torch.ones((o.shape[0], kd.top), dtype=torch.bool)
    return torch.cat([top, reached.repeat_interleave(cluster, 1)], 1)


def test_prepare_builds_the_subset_copy_above_lean_max(boxes):
    """The sphere box's occluder subset (2,256 of its 2,264 triangles: the
    floor, ceiling, back and left walls bound every shadow segment, so
    they are not in it) has more than LEAN_MAX_TRIS rows, so it gets a
    kd copy of its own beside the table's. Below LEAN_MAX_TRIS a copy
    needs a cluster of rows outside the top rows: the mixed box's table
    gets one and its 24 occluders (all top rows) none, the monkey box's
    table and its 1,232 occluders one each."""
    _, scene, tables = boxes["sphere"]
    assert scene.num_occluders == 2256 and tables.occ_rows.shape[0] == 2256
    occ_kd = tables.occ_kd
    assert occ_kd is not None and occ_kd is not tables.kd
    assert occ_kd.top == 24
    assert occ_kd.boxes.shape == (18, 8)
    assert occ_kd.rows.shape == (24 + 18 * clustered.CLUSTER, 16)
    assert torch.equal(occ_kd.nodes, clustered.cluster_tree(occ_kd.boxes))
    assert occ_kd.scale == clustered.box_scale(occ_kd.boxes)
    for name, has_occ_kd in (("mixed", False), ("monkey", True)):
        _, scene, tables = boxes[name]
        assert tables.kd is not None
        assert (tables.occ_kd is not None) == has_occ_kd
        assert tables.occ_rows.shape[0] == scene.num_occluders


def test_subset_copy_is_a_permutation_of_the_subset(boxes):
    """Every real row of the occluder subset appears once in its kd copy,
    bit for bit (column 15 names the triangle), and nothing else does; the
    other kd rows are zero padding. The top rows span more than 1 / 8 of
    the subset's extent, and each cluster box holds its triangles."""
    _, scene, tables = boxes["sphere"]
    kd = tables.occ_kd
    ids = kd.rows[:, 15].long()
    mine = kd.rows[:, 0:12].any(1)
    real = tables.occ_rows[tables.occ_rows[:, 0:12].any(1)]
    assert torch.equal(torch.sort(ids[mine]).values,
                       torch.sort(_occ_ids(scene)).values)
    by_id = torch.argsort(real[:, 15])
    assert torch.equal(kd.rows[mine][torch.argsort(ids[mine])], real[by_id])
    assert not bool(kd.rows[~mine].any())
    v0 = scene.tri_v0
    pts = torch.stack([v0, v0 + scene.tri_e1, v0 + scene.tri_e2], 1)
    ext = (pts.amax(1) - pts.amin(1)).amax(1)
    sub = pts[_occ_ids(scene)]
    span = float((sub.amax((0, 1)) - sub.amin((0, 1))).max())
    assert bool((ext[ids[:kd.top]] > span / dense.TOP_SPAN).all())
    assert not bool((ext[ids[kd.top:][mine[kd.top:]]]
                     > span / dense.TOP_SPAN).any())
    cluster = clustered.CLUSTER
    for c in range(kd.boxes.shape[0]):
        part = slice(kd.top + c * cluster, kd.top + (c + 1) * cluster)
        p = pts[ids[part][mine[part]]]
        assert bool((p >= kd.boxes[c, 0:3]).all())
        assert bool((p <= kd.boxes[c, 3:6]).all())


@pytest.mark.parametrize("rays_of", ["camera", "edges"])
@pytest.mark.parametrize("tmax", [T_FAR, 1100.0])
def test_closest_full_kd_plain_is_the_dense_plain_version(boxes, sphere_rays,
                                                          rays_of, tmax):
    """K3's plain version on the kd copy gives ``_closest_plain(full=True,
    want_uv=True)`` on the dense table bit for bit: t, dense row, normal,
    material, u and v (without ``want_uv``, zero u and v). On rays aimed
    at shared edges rows tie on t, and the lowest dense row wins."""
    _, scene, tables = boxes["sphere"]
    if rays_of == "camera":
        o, d = _t(sphere_rays[0]), _t(sphere_rays[1])
    else:
        o, d, _, _ = _edge_rays(scene, 2048, seed=41)
        assert int(_ties(o, d, tables.rows).sum()) > 10
    want = dense._closest_plain(o, d, tables.rows, TMIN, tmax, full=True,
                                want_uv=True)
    hit = want[0] < T_FAR
    assert 0.0 < float(hit.float().mean()) <= 1.0
    assert float(want[4][hit].abs().sum()) > 0.0
    got = dense._closest_full_kd_plain(o, d, tables.kd.rows, TMIN, tmax,
                                       want_uv=True)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    lean = dense._closest_full_kd_plain(o, d, tables.kd.rows, TMIN, tmax)
    for x, y in zip(lean[:4], want[:4]):
        assert torch.equal(x, y)
    assert not bool(lean[4].any()) and not bool(lean[5].any())


def _light_shadow_rays(o, d, scene, tables, seed: int):
    """Shadow rays from the points the rays (o, d) hit (lifted 1e-3 off
    the surface toward the ray) to random points of the area light, tmax
    the distance less 0.01; a lane that misses gets tmax 0."""
    t, row = dense._closest_plain(o, d, tables.rows, TMIN)
    hit = t < T_FAR
    nrm = tables.rows[row.long(), 0:3]
    nrm = torch.where((nrm * d).sum(1, keepdim=True) > 0, -nrm, nrm)
    p = o + d * torch.where(hit, t, 0.0)[:, None] + 1e-3 * nrm
    ab = _t(np.random.default_rng(seed).random((o.shape[0], 2),
                                               dtype=np.float32))
    light = scene.light
    lp = light.corner + light.v1 * ab[:, :1] + light.v2 * ab[:, 1:]
    to_l = lp - p
    dist = to_l.norm(dim=1)
    return (p.contiguous(), (to_l / dist[:, None]).contiguous(),
            torch.where(hit, dist - 0.01, 0.0).contiguous())


@pytest.mark.parametrize("origin", ["camera", "bounce"])
def test_occluded_kd_plain_is_the_dense_plain_version(boxes, sphere_rays,
                                                      origin):
    """K2's plain version on the subset's kd copy gives ``_occluded_plain``
    over ``occ_rows`` bit for bit, on shadow rays from the hit points of
    camera rays or of rays leaving surfaces to light samples, blocked and
    unblocked (lanes that missed have an empty range)."""
    _, scene, tables = boxes["sphere"]
    part = slice(0, 1024) if origin == "camera" else slice(1024, 2048)
    so, sd, stmax = _light_shadow_rays(_t(sphere_rays[0][part]),
                                       _t(sphere_rays[1][part]), scene,
                                       tables, seed=42)
    want = dense._occluded_plain(so, sd, stmax, tables.occ_rows, TMIN)
    assert 0.05 < float(want.float().mean()) < 0.95
    got = dense._occluded_kd_plain(so, sd, stmax, tables.occ_kd.rows, TMIN)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kernel", ["K3", "K2"])
def test_plain_walks_reach_the_dense_answer(boxes, sphere_rays, kernel):
    """A plain walk of each tree: K3 over the top rows and the clusters
    reached at each ray's final bound, folded on (t, id), gives the dense
    closest hit; K2 over the top rows and the clusters reached at each
    shadow ray's own tmax gives the dense flags. So the cull of the
    subset's copy, with each shadow ray's own margin, drops no blocking
    row."""
    _, scene, tables = boxes["sphere"]
    o, d = _t(sphere_rays[0]), _t(sphere_rays[1])
    if kernel == "K3":
        kd = tables.kd
        want = dense._closest_plain(o, d, tables.rows, TMIN)
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
    so, sd, stmax = _light_shadow_rays(o, d, scene, tables, seed=43)
    want = dense._occluded_plain(so, sd, stmax, tables.occ_rows, TMIN)
    t, _, _ = dense._pe_block(so, sd, kd.rows, TMIN)
    block = (t < stmax[:, None]) & (kd.rows[None, :, 13] < 0.5)
    got = (block & _reached(so, sd, kd, stmax)).any(1)
    assert 0.05 < float(want.float().mean()) < 0.95
    assert torch.equal(got, want)


class _Spy:
    """Counts the calls of dense's K1, K3 and K2 wrappers (dense bodies and
    walks) and keeps their arguments, while they run as usual."""

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


@pytest.mark.parametrize("name,tmax,lean_uv,closest", [
    ("sphere", T_FAR, "1", "closest_full_tree"),
    ("sphere", 600.0, "1", "closest_full_tree"),
    ("mixed", T_FAR, "1", "closest_lean"),
    ("mixed", 600.0, "1", "closest_full"),
    ("mixed", T_FAR, "0", "closest_full"),
    ("monkey", T_FAR, "1", "closest_lean"),
    ("cornell", T_FAR, "1", "closest_lean")])
def test_routing(boxes, sphere_rays, monkeypatch, name, tmax, lean_uv,
                 closest):
    """``closest_hit`` / ``occluded_hit`` take K1 at tmax = T_FAR, else K3
    (a finite tmax, or TPT_LEAN_UV=0), as ``closest`` names it (by its
    dense body or its walk), and K2 over the subset; each as the walk of
    its table's prepared kd copy where there is one (the sphere, mixed
    and monkey boxes' tables; the sphere and monkey boxes' subsets), else
    as its dense body (``cornell_box.obj``; the mixed box's 24
    occluders)."""
    monkeypatch.setenv("TPT_LEAN_UV", lean_uv)
    spy = _Spy(monkeypatch)
    _, _, tables = boxes[name]
    o, d = _t(sphere_rays[0][:256]), _t(sphere_rays[1][:256])
    dense.closest_hit(tables, o, d, tmax=tmax, want_uv=True)
    dense.occluded_hit(tables, _t(sphere_rays[2][:256]),
                       _t(sphere_rays[3][:256]), _t(sphere_rays[4][:256]))
    kd, occ_kd = tables.kd, tables.occ_kd
    assert (kd is None) == (name == "cornell")
    if kd is not None:
        closest = WALK_OF.get(closest, closest)
    occluded = "occluded" if occ_kd is None else "occluded_tree"
    assert spy.counts() == {closest: 1, occluded: 1}
    if kd is not None:
        args = spy.calls[closest][0]
        assert args[2] is kd.rows and args[4] is kd.boxes
        assert args[5] is kd.nodes and (args[3], args[6]) == (kd.top,
                                                              kd.scale)
    if occ_kd is not None:
        args = spy.calls[occluded][0]
        assert args[3] is occ_kd.rows and args[5] is occ_kd.boxes
        assert args[6] is occ_kd.nodes and (args[4], args[7]) == (
            occ_kd.top, occ_kd.scale)
    else:
        assert spy.calls[occluded][0][3] is tables.occ_rows


def test_clustered_subset_takes_the_walk(assets_dir, monkeypatch):
    """A clustered scene whose occluder subset has more than LEAN_MAX_TRIS
    but at most TRI_SLAB rows (foliage flattened: 9,602 triangles, 6,600
    occluders) gets the subset's kd copy, and ``clustered.occluded_hit``
    walks it, bit for bit the dense sweep of the subset."""
    ws = tp.load_gltf(str(assets_dir / "foliage.gltf"), instancing="auto",
                      device="cpu")
    tables = clustered.prepare(ws.geom)
    kd = tables.occ_kd
    assert tables.occ_rows.shape[0] == 6600 and kd is not None
    spy = _Spy(monkeypatch)
    r = np.random.default_rng(44)
    lo, hi = ws.geom.tri_v0.amin(0).numpy(), ws.geom.tri_v0.amax(0).numpy()
    o = _t(r.uniform(lo, hi, (512, 3)).astype(np.float32))
    d = _t(r.normal(size=(512, 3)).astype(np.float32))
    d = (d / d.norm(dim=1, keepdim=True)).contiguous()
    tmax = _t(r.uniform(0.0, float((hi - lo).max()), 512).astype(np.float32))
    got = clustered.occluded_hit(tables, o, d, tmax)
    assert spy.counts() == {"occluded_tree": 1}
    assert spy.calls["occluded_tree"][0][3] is kd.rows
    want = dense._occluded_plain(o, d, tmax, tables.occ_rows, TMIN)
    assert 0.02 < float(want.float().mean()) < 0.98
    assert torch.equal(got, want)


@pytest.mark.parametrize("call", ["closest", "closest at tmax 600",
                                  "occluded"])
def test_sphere_walks_match_pallas(boxes, sphere_rays, monkeypatch, call):
    """The port's entry points on the sphere box, through the kd copies,
    against the JAX package's kernels in interpret mode, at
    tests/test_torch_intersect.py's tolerances."""
    jscene, scene, _ = boxes["sphere"]
    spy = _Spy(monkeypatch)
    o, d, p, ld, tmax = sphere_rays
    if call == "occluded":
        j = np.asarray(pallas_bf.intersect_occluded(
            jscene, jnp.asarray(p), jnp.asarray(ld), jnp.asarray(tmax)))
        t = dense.intersect_occluded(scene, _t(p), _t(ld), _t(tmax)).numpy()
        np.testing.assert_array_equal(t, j)
        assert 0.05 < j.mean() < 0.95
        assert spy.counts() == {"occluded_tree": 1}
        return
    far = 600.0 if call.endswith("600") else T_FAR
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    tmax=far, want_uv=True)
    t = dense.intersect_closest(scene, _t(o), _t(d), tmax=far, want_uv=True)
    hit = assert_same_hit(j, t, d, uv_atol=5e-4)
    assert 0.1 < hit.mean() <= 1.0
    assert spy.counts() == {"closest_full_tree": 1}


def test_sphere_frame_equals_the_frame_without_kd_copies(boxes, monkeypatch):
    """A 32^2 x 2 spp unfused sphere-box frame (depth 4, IS + NEE,
    ``intersector="dense"``) through the walks' plain versions is bitwise
    the frame with the kd copies removed (the dense bodies' plain
    versions); the first calls only the walks, the second only the dense
    bodies."""
    _, scene, _ = boxes["sphere"]
    cfg = tp.RenderConfig(width=32, height=32, spp=2, max_depth=4,
                          use_direct_lighting=True,
                          use_importance_sampling=True, intersector="dense")
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
    assert walk_calls == {"closest_full_tree": rounds,
                          "occluded_tree": rounds}
    assert dense_calls == {"closest_full": rounds, "occluded": rounds}


@pytest.mark.parametrize("copy", ["kd", "occ_kd"])
def test_walk_depth_fits_the_stack(boxes, copy):
    """Each kd tree of the sphere box is shallow (18 clusters: 5 levels),
    well inside the walk's shared-memory stack (csrc/walk.cuh kStack)."""
    kd = getattr(boxes["sphere"][2], copy)
    assert clustered.tree_depth(kd.boxes.shape[0]) == 5
    assert clustered.tree_depth(kd.boxes.shape[0]) <= clustered.TREE_MAX_DEPTH


@pytest.mark.parametrize("pick", ["full_walk_group", "occ_walk_group"])
@pytest.mark.parametrize("n_rays", [1, 65536, 65537, 262144])
def test_walk_widths_are_built_widths(pick, n_rays):
    """K3's and K2's lanes a ray at any ray count are widths the kernels
    are built for (csrc/walk.cuh, with_group)."""
    assert getattr(dense, pick)(n_rays) in (4, 8, 16, 32)


def test_walk_wrappers_check_inputs(boxes):
    """The walks' wrappers refuse a device other than the CPU or CUDA, and
    a kd copy whose top rows or tables do not fit."""
    _, _, tables = boxes["sphere"]
    kd = tables.kd
    meta = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense.closest_full_tree(meta, meta, kd.rows, kd.top, kd.boxes,
                                kd.nodes, kd.scale, TMIN, T_FAR, True)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        dense.occluded_tree(meta, meta, torch.empty(4, device="meta"),
                            kd.rows, kd.top, kd.boxes, kd.nodes, kd.scale,
                            TMIN)
    with pytest.raises(ValueError, match="top rows"):
        dense._check_kd(kd.rows, kd.rows.shape[0] + 1, kd.boxes, kd.nodes,
                        kd.rows.device)
    with pytest.raises(ValueError):
        dense._check_kd(kd.rows, kd.top + 1, kd.boxes, kd.nodes,
                        kd.rows.device)
