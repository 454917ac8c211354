"""K5's kd copy of the dense table and its walk
(``tpu_pt_torch.intersect.dense``: ``kd_tables``, ``_closest_nee_kd_plain``),
on the CPU.

The fused closest-hit + NEE kernel K5 (``csrc/dense_intersect.cu``) walks
a kd copy of the sphere box's table: the rows of the triangles that span
the room first (every ray sweeps them), then the rest in 128-row clusters
in balanced-kd order with boxes and their ``cluster_tree``. The tests hold
the copy to a bitwise permutation of the dense table's real rows whose
column 15 names the dense row, and a plain walk of it (the top rows and
the clusters ``clustered._tree_leaves_plain`` reaches, folded on (t, id))
to the dense plain version ``_closest_nee_plain`` bit for bit, on rays
aimed at shared edges too, where two rows tie on t and the lowest dense
row must win (a fold on the kd row picks another one there). Against the
JAX package's fused path (``pallas_bf.intersect_closest_nee``, interpret
mode) the walk holds ``tests/test_torch_fused_nee.py``'s bounds: hit,
triangle, normal and material equal, t within 1e-6 relative, occlusion
of hit lanes equal on >= 99%.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import clustered, dense  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from test_torch_fused_nee import rays, scenes  # noqa: E402,F401

TMIN = 0.01
EYE = (278.0, 273.0, -800.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sphere(assets_dir):
    scene = tp.load_scene(str(assets_dir / "cornell_box_sphere.obj"),
                          device="cpu")
    return scene, dense.prepare(scene), dense.light_vector(scene)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _edge_rays(scene, n: int, seed: int):
    """Rays aimed at points of edges that two triangles share (the sphere's
    and the walls' diagonals), half from the camera's eye, half from
    random points in the box; plus light samples."""
    v0 = scene.tri_v0.numpy()
    corners = [v0, v0 + scene.tri_e1.numpy(), v0 + scene.tri_e2.numpy()]
    owners = {}
    for i in range(scene.num_tris):
        pts = [tuple(c[i]) for c in corners]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            owners.setdefault(tuple(sorted((pts[a], pts[b]))), []).append(i)
    shared = np.array([k for k, v in owners.items() if len(v) == 2],
                      np.float32)
    r = np.random.default_rng(seed)
    pick = shared[r.integers(0, len(shared), n)]
    w = r.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    target = pick[:, 0] + (pick[:, 1] - pick[:, 0]) * w
    o = np.broadcast_to(np.array(EYE, np.float32), (n, 3)).copy()
    o[n // 2:] = r.uniform([0, 0, 0], [556, 548, 559], (n - n // 2, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    lz = r.random((2, n)).astype(np.float32)
    return _t(o), _t(d), _t(lz[0]), _t(lz[1])


def _ties(o, d, rows):
    """Rays whose closest hit is shared by two or more rows at equal t."""
    t, _, _ = dense._pe_block(o, d, rows, TMIN)
    best = t.min(1).values
    return ((t == best[:, None]).sum(1) > 1) & (best < T_FAR)


def _walk_closest_nee(o, d, lz1, lz2, kd, light, tmax=T_FAR, final=None):
    """A plain walk of the kd tree: the closest hit over the rows of the
    clusters reached at ``tmax`` (or, with ``final``, at each ray's final
    bound), folded on (t, id) with the kd row carried; then the shadow ray
    any-hit over the clusters reached at its own tmax. Returns K5's
    (t, id, normal, mat, occluded)."""
    cluster = (kd.rows.shape[0] - kd.top) // kd.boxes.shape[0]

    def swept(oo, dd, bound):
        reached, _ = clustered._tree_leaves_plain(oo, dd, kd.nodes, kd.boxes,
                                                  kd.scale, TMIN, bound)
        top = torch.ones((oo.shape[0], kd.top), dtype=torch.bool)
        return torch.cat([top, reached.repeat_interleave(cluster, 1)], 1)
    bound = tmax if final is None else final
    t, _, _ = dense._pe_block(o, d, kd.rows, TMIN)
    t = torch.where(swept(o, d, bound) & (t < tmax), t, T_FAR)
    best = t.min(1).values
    ids = kd.rows[:, 15].to(torch.int32)
    big = torch.iinfo(torch.int32).max
    at_best = t == best[:, None]
    low = torch.where(at_best, ids, big).min(1).values
    row = torch.where(at_best & (ids == low[:, None]),
                      torch.arange(kd.rows.shape[0], dtype=torch.int32),
                      big).min(1).values
    hit = best < T_FAR
    won = kd.rows[torch.where(hit, row, 0).long()]
    normal = torch.where(hit[:, None], won[:, 0:3], 0.0)
    mat = torch.where(hit, won[:, 14], 0.0).to(torch.int32)
    so, sd, stmax = dense._shadow_rays(o, d, best, lz1, lz2, light)
    ts, _, _ = dense._pe_block(so, sd, kd.rows, TMIN)
    block = (ts < stmax[:, None]) & (kd.rows[None, :, 13] < 0.5)
    occ = (block & swept(so, sd, stmax)).any(1)
    return best, torch.where(hit, low, 0), normal, mat, occ


def test_prepare_builds_the_kd_copy_above_lean_max(scenes):
    """The kd copy exists for a table above LEAN_MAX_TRIS rows (the K3 /
    K5 side: the sphere box's 2,280) and not below (the mixed box's 432,
    which K4 sweeps). On the sphere box the 32 triangles that span the room
    (walls, floor, ceiling, light, blocks) lead it, and the sphere's 2,232
    fill 18 clusters of 128 rows whose boxes stay near the sphere."""
    assert dense.prepare(scenes["mixed"][1]).kd is None
    scene = scenes["sphere"][1]
    kd = dense.prepare(scene).kd
    assert kd is not None and scene.num_tris == 2264
    assert kd.top == 32
    assert kd.boxes.shape == (18, 8)
    assert kd.rows.shape == (32 + 18 * clustered.CLUSTER, 16)
    assert kd.nodes.shape == (17, 8)
    assert bool((kd.boxes[:, 0] < 1e30).all())
    span = (kd.boxes[:, 3:6] - kd.boxes[:, 0:3]).amax(1)
    assert float(span.max()) < 559.2 / 2      # no cluster spans the room
    assert kd.scale == clustered.box_scale(kd.boxes)
    assert torch.equal(kd.nodes, clustered.cluster_tree(kd.boxes))


@pytest.mark.parametrize("name", ["sphere", "mixed"])
def test_kd_rows_are_a_permutation_of_the_dense_rows(scenes, name):
    """Every real row of the dense table appears once in the kd copy, bit
    for bit, at the kd row whose column 15 is its index; the other kd rows
    are zero padding that no ray hits. Each cluster box holds the three
    vertices of each of its triangles."""
    scene = scenes[name][1]
    rows = dense.prepare(scene).rows
    kd = dense.kd_tables(scene)
    ids = kd.rows[:, 15].long()
    assert torch.equal(kd.rows[:, 15], ids.to(torch.float32))
    mine = kd.rows[:, 0:12].any(1)
    assert torch.equal(torch.sort(ids[mine]).values,
                       torch.arange(scene.num_tris))
    assert torch.equal(kd.rows[mine], rows[ids[mine]])
    assert not bool(kd.rows[~mine].any())
    assert bool(mine[:kd.top].all())
    cluster = clustered.CLUSTER
    v0 = scene.tri_v0
    pts = torch.stack([v0, v0 + scene.tri_e1, v0 + scene.tri_e2], 1)
    for c in range(kd.boxes.shape[0]):
        part = slice(kd.top + c * cluster, kd.top + (c + 1) * cluster)
        p = pts[ids[part][mine[part]]]
        assert bool((p >= kd.boxes[c, 0:3]).all())
        assert bool((p <= kd.boxes[c, 3:6]).all())


def test_edge_rays_tie(sphere):
    """Rays aimed at shared edges tie: two rows at the same t, in kd rows
    whose order is not the dense rows' order, so a fold on the kd row
    (K6's compare) would answer another row than the dense sweep."""
    scene, tables, _ = sphere
    kd = tables.kd
    o, d, _, _ = _edge_rays(scene, 4096, seed=31)
    ties = _ties(o, d, tables.rows)
    assert int(ties.sum()) > 20
    t, row = dense._closest_plain(o, d, tables.rows, TMIN)
    tk, rk = dense._closest_plain(o, d, kd.rows, TMIN)
    assert torch.equal(t, tk)
    by_kd_row = torch.where(tk < T_FAR, kd.rows[rk.long(), 15], 0.0)
    assert int((by_kd_row.to(torch.int32) != row).sum()) > 0


@pytest.mark.parametrize("rays_of", ["camera", "edges"])
@pytest.mark.parametrize("bound", ["tmax", "final"])
def test_walk_is_the_dense_plain_version(sphere, rays, rays_of, bound):
    """The plain walk (clusters reached at tmax, or at each ray's final
    bound, folded on (t, id)) and K5's CPU path give
    ``_closest_nee_plain`` over the dense table bit for bit: t, dense row,
    normal, material and the occlusion flag of every lane."""
    scene, tables, light = sphere
    if rays_of == "camera":
        o, d, lz1, lz2 = (_t(a) for a in rays)
    else:
        o, d, lz1, lz2 = _edge_rays(scene, 2048, seed=32)
        assert int(_ties(o, d, tables.rows).sum()) > 10
    want = dense._closest_nee_plain(o, d, lz1, lz2, tables.rows, tables.rows,
                                    light, TMIN, T_FAR, full=True)
    assert 0.05 < float(want[4][want[0] < T_FAR].float().mean()) < 0.95
    final = want[0] if bound == "final" else None
    got = _walk_closest_nee(o, d, lz1, lz2, tables.kd, light, final=final)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    kd = tables.kd
    wrapped = dense.closest_nee_full(o, d, lz1, lz2, kd.rows, kd.top,
                                     kd.boxes, kd.nodes, kd.scale, light,
                                     TMIN, T_FAR)
    for x, y in zip(wrapped, want):
        assert torch.equal(x, y)


@pytest.mark.parametrize("tmax", [1100.0, 1400.0])
def test_walk_clips_at_a_finite_tmax(sphere, rays, tmax):
    """With a finite tmax the walk's bound starts there: still the dense
    plain version bit for bit."""
    _, tables, light = sphere
    o, d, lz1, lz2 = (_t(a) for a in rays)
    want = dense._closest_nee_plain(o, d, lz1, lz2, tables.rows, tables.rows,
                                    light, TMIN, tmax, full=True)
    assert 0.0 < float((want[0] < T_FAR).float().mean()) < 1.0
    got = _walk_closest_nee(o, d, lz1, lz2, tables.kd, light, tmax=tmax)
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_walk_matches_pallas(scenes, rays, sphere):
    """The plain walk against the JAX package's fused path in interpret
    mode, within tests/test_torch_fused_nee.py's bounds."""
    jscene, _ = scenes["sphere"]
    _, tables, light = sphere
    o, d, lz1, lz2 = rays
    jh, jocc = pallas_bf.intersect_closest_nee(
        jscene, jnp.asarray(o), jnp.asarray(d), jnp.asarray(lz1),
        jnp.asarray(lz2))
    t, row, normal, mat, occ = _walk_closest_nee(
        _t(o), _t(d), _t(lz1), _t(lz2), tables.kd, light)
    hit = np.asarray(jh.hit)
    assert 0.5 < hit.mean() < 1.0
    np.testing.assert_array_equal((t < T_FAR).numpy(), hit)
    np.testing.assert_array_equal(row.numpy(), np.asarray(jh.tri))
    np.testing.assert_array_equal(mat.numpy(), np.asarray(jh.mat))
    np.testing.assert_array_equal(normal.numpy(),
                                  np.asarray(jh.normal.to_array()))
    np.testing.assert_allclose(t.numpy(), np.asarray(jh.t), rtol=1e-6)
    agree = occ.numpy()[hit] == np.asarray(jocc)[hit]
    assert agree.mean() >= 0.99, agree.mean()


def test_fused_entry_point_hands_the_kd_copy_to_k5(sphere, monkeypatch):
    """``closest_nee_hit`` calls K5 with the prepared kd copy (rows,
    boxes, nodes, scale), never the dense yardstick."""
    _, tables, light = sphere
    seen = []
    real = dense.closest_nee_full

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(dense, "closest_nee_full", spy)
    monkeypatch.setattr(dense, "closest_nee_full_dense", None)
    o, d, lz1, lz2 = _edge_rays(sphere[0], 64, seed=33)
    dense.closest_nee_hit(tables, light, o, d, lz1, lz2)
    assert len(seen) == 1
    kd = tables.kd
    rows, top, boxes, nodes, scale = seen[0][4:9]
    assert rows is kd.rows and boxes is kd.boxes and nodes is kd.nodes
    assert (top, scale) == (kd.top, kd.scale)


def test_k5_walk_depth_fits_the_stack(sphere):
    """The kd tree of the sphere box is shallow (18 clusters: 5 levels)."""
    kd = sphere[1].kd
    assert clustered.tree_depth(kd.boxes.shape[0]) == 5
    assert clustered.tree_depth(kd.boxes.shape[0]) <= clustered.TREE_MAX_DEPTH


def test_k5_walk_width_is_a_built_width():
    """K5's lanes a ray is one of the widths the kernels are built for
    (csrc/walk.cuh, with_group)."""
    assert dense.NEE_WALK_GROUP in (4, 8, 16, 32)
