"""The row split that K2's dense body sweeps (``dense.row_split``) and the
plain form of its culled sweep (``dense._occluded_split_plain``), on the
CPU.

A split keeps the opaque rows that can hit: those every ray sweeps
first, then groups of a few rows with a box each, which a ray sweeps only
when its interval meets the box grown by its margin. The CUDA kernels
(``csrc/dense_intersect.cu``: K2 and K4's shadow ray) sweep the split
and are held bit for bit to ``_occluded_plain`` on the card
(chip_smoke.py). Here:

- the split itself: its rows are the table's opaque rows that can hit,
  each once, bit for bit; each group's box holds the triangle of each of
  its rows; the tiles cover it; it is built once per table;
- the plain form of the culled sweep against ``_occluded_plain``, bit for
  bit, and against the JAX package's K2 (``pallas_bf._occluded_call``,
  interpret mode) within tests/test_torch_dense_small.py's tolerances
  (the two packages round t, u and v apart by a few ulps, so on the
  boundary rays only the port's plain version is the reference);
- on the tables the sweep gets (the mixed box's 24-row NEE occluder
  subset, ``cornell_box.obj``'s 32 rows), on a seeded random table (small
  and large triangles, refractive, zero and degenerate rows), on a table
  with no group and on one with a single group;
- with the rays at the culling's edges: rays that graze a group's box
  face (running in its plane), rays that run nearly in a row's plane
  (where t cancels), rays aimed at edges that two rows share, shadow rays
  whose tmax is bit for bit a blocking row's t (and one float above it),
  and shadow rays with an empty range, a tmax past T_FAR or NaN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import dense  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from test_torch_intersect import _rays, T_ATOL, T_RTOL  # noqa: E402
from test_torch_dense_small import (_edge_pairs, _edge_rays,  # noqa: E402
                                    _pallas_occluded)

TMIN = 0.01
N_RAYS = 512
ROOM = (np.zeros(3), np.array([556.0, 548.8, 559.2]))
TABLES = ["24 rows", "32 rows", "random", "no group", "one group"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _packed(verts: np.ndarray) -> torch.Tensor:
    """Packed rows [T, 16] of triangles ``verts`` [T, 3, 3]."""
    n = verts.shape[0]
    scene = tp.scene.build_scene_arrays(
        verts.reshape(-1, 3).astype(np.float32),
        np.arange(3 * n).reshape(n, 3), np.zeros(n, np.int64), [],
        device="cpu")
    return dense.pack_tris(scene)[:n].clone()


def _spanning(r, n: int) -> np.ndarray:
    """n triangles whose boxes are the room's: two opposite corners and a
    point of the room."""
    lo, hi = ROOM
    corner = r.integers(0, 2, (n, 3)).astype(bool)
    a = np.where(corner, hi, lo)
    b = np.where(corner, lo, hi)
    return np.stack([a, b, r.uniform(lo, hi, (n, 3))], 1)


def _random_table(seed: int) -> torch.Tensor:
    """200 triangles in the room, a tenth of them large, with two
    refractive rows, a zero row, a row with a zero normal and one whose
    edge functions stand for no triangle (its box is not finite)."""
    r = np.random.default_rng(seed)
    n = 200
    centre = r.uniform(*ROOM, (n, 3))
    size = np.where(r.uniform(size=(n, 1)) < 0.1, 400.0,
                    r.uniform(2.0, 60.0, (n, 1)))
    table = _packed(centre[:, None, :]
                    + r.normal(size=(n, 3, 3)) * size[:, :, None] / 2)
    table[5, 13] = 1.0
    table[17, 13] = 1.0
    table[8] = 0.0
    table[9, 0:3] = 0.0
    table[11, 8:12] = table[11, 4:8]
    return table.contiguous()


@pytest.fixture(scope="module")
def tables(assets_dir):
    """name -> (table, rays (o, d, shadow o, d, tmax) in the Cornell box,
    the scene its shared edges come from, or None)."""
    out = {}
    for name, obj, seed in (("24 rows", "cornell_box_mixed.obj", 51),
                            ("32 rows", "cornell_box.obj", 52)):
        path = str(assets_dir / obj)
        scene = tp.load_scene(path, device="cpu")
        prepared = dense.prepare(scene)
        table = prepared.occ_rows if name == "24 rows" else prepared.rows
        out[name] = (table.contiguous(),
                     _rays(tpu_pt.load_scene(path), N_RAYS, seed), scene)
    rays = _rays(tpu_pt.load_scene(str(assets_dir / "cornell_box.obj")),
                 N_RAYS, 53)
    r = np.random.default_rng(54)
    small = r.uniform(20.0, 60.0, (10, 1, 3)) + r.uniform(
        0.0, 15.0, (10, 3, 3))
    out["random"] = (_random_table(55), rays, None)
    out["no group"] = (_packed(_spanning(r, 12)).contiguous(), rays, None)
    out["one group"] = (torch.cat([_packed(_spanning(r, 6)),
                                   _packed(small)]).contiguous(), rays, None)
    return out


def _box_rays(table, split, n: int, seed: int):
    """n rays that graze the split's group boxes (with no group, its rows'
    boxes): each starts on the plane of a face of a box (at a point of the
    face grown by a tenth of the box, so some start on its edges and
    outside it) and runs in that plane, in either sense."""
    r = np.random.default_rng(seed)
    box = split.groups[:, 0:6].numpy().astype(np.float64)
    if box.shape[0] == 0:
        box = np.concatenate(dense._row_boxes(split.rows.double().numpy()),
                             1)
    g = r.integers(0, box.shape[0], n)
    lo, hi = box[g, 0:3], box[g, 3:6]
    ext = hi - lo
    o = r.uniform(lo - 0.1 * ext, hi + 0.1 * ext)
    axis = r.integers(0, 3, n)
    side = np.where(r.integers(0, 2, (n, 1)) == 0, lo, hi)
    o[np.arange(n), axis] = side[np.arange(n), axis]
    d = r.normal(size=(n, 3))
    d[np.arange(n), axis] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = o - d * r.uniform(0.0, 300.0, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _plane_rays(table, n: int, seed: int):
    """n rays that run nearly in the plane of a row: from a point of its
    triangle moved off the plane by up to 1e-4 (a few ulps of the room's
    coordinates), along the plane with a normal component of up to 1e-6,
    backed off along the ray so that t is in range."""
    r = np.random.default_rng(seed)
    host = table.double().numpy()
    verts = dense._row_vertices(host)
    ok = np.isfinite(verts).all((0, 2)) & (host[:, 0:3] != 0).any(1)
    pick = np.nonzero(ok)[0][r.integers(0, int(ok.sum()), n)]
    a, b = r.uniform(0.0, 1.0, (2, n, 1))
    a, b = np.where(a + b > 1.0, 1.0 - a, a), np.where(a + b > 1.0, 1.0 - b, b)
    v0, v1, v2 = verts[:, pick]
    nrm = host[pick, 0:3]
    p = v0 + a * (v1 - v0) + b * (v2 - v0)
    p = p + nrm * r.uniform(-1e-4, 1e-4, (n, 1))
    d = np.cross(nrm, r.normal(size=(n, 3)))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d = d + nrm * r.uniform(-1e-6, 1e-6, (n, 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = p - d * r.uniform(1.0, 200.0, (n, 1))
    return o.astype(np.float32), d.astype(np.float32)


def _shadow_set(kind, table, rays, scene):
    """(origins, dirs, tmax) of an any-hit ray set."""
    if kind == "edges":
        o, d, tmax = _edge_rays(scene, table, N_RAYS, 64)
        return _t(o), _t(d), _t(tmax)
    if kind in ("graze boxes", "in plane"):
        o, d = (_box_rays(table, dense.row_split(table), N_RAYS, 65)
                if kind == "graze boxes" else _plane_rays(table, N_RAYS, 66))
        tmax = np.random.default_rng(67).uniform(0.0, 800.0, N_RAYS)
        return _t(o), _t(d), _t(tmax)
    p, ld, tmax = _t(rays[2]), _t(rays[3]), _t(rays[4])
    t, _, _ = dense._pe_block(p, ld, table, TMIN)
    t = torch.where(table[None, :, 13] < 0.5, t, T_FAR)
    near = t.min(1).values
    hit = near < 1e15
    if kind == "tmax above t":
        near = torch.nextafter(near, torch.full_like(near, float("inf")))
    tmax = torch.where(hit, near, tmax)
    if kind == "empty and far":
        # A quarter parked (tmax 0), a quarter past T_FAR (a miss blocks),
        # a quarter NaN.
        q = N_RAYS // 4
        tmax = tmax.clone()
        tmax[:q] = 0.0
        tmax[q:2 * q] = 2e16
        tmax[2 * q:3 * q] = float("nan")
    return p, ld, tmax.contiguous()


def _spans(split):
    return dense._split_spans(split)


@pytest.mark.parametrize("name", TABLES)
def test_row_split_layout(tables, name):
    """The split's rows are the table's opaque rows with a nonzero normal,
    each once, bit for bit but for column 15, the row's index; the rows every ray sweeps come first in
    ascending order, then each group's, ascending, at most SPLIT_GROUP of
    them; each group's f32 box holds the triangle each of its rows solves
    to; the tiles cover the rows in order, at most SPLIT_TILE rows and
    SPLIT_TILE_GROUPS groups each, every group inside one."""
    table = tables[name][0]
    split = dense.row_split(table)
    host = table.numpy()
    keep = (host[:, 0:3] != 0).any(1) & (host[:, 13] < 0.5)
    ids = split.rows[:, 15].long().numpy()
    assert sorted(ids.tolist()) == np.nonzero(keep)[0].tolist()
    assert np.array_equal(split.rows.numpy()[:, :15].view(np.int32),
                          host[ids, :15].view(np.int32))
    assert np.array_equal(ids[:split.n_all], np.sort(ids[:split.n_all]))
    lo, hi = dense._row_boxes(host.astype(np.float64))
    first = split.n_all
    box = split.groups.numpy()
    for g, (start, count) in enumerate(_spans(split)):
        assert start == first and 0 < count <= dense.SPLIT_GROUP
        members = ids[start:start + count]
        assert np.array_equal(members, np.sort(members))
        assert (box[g, 0:3] <= lo[members]).all()
        assert (box[g, 3:6] >= hi[members]).all()
        first += count
    assert first == ids.size
    assert split.scale == (float(np.abs(box[:, 0:6]).max()) if box.size
                           else 0.0)
    covered, group = 0, 0
    for start, count, g0, n_g in split.tiles.tolist():
        assert start == covered and 0 < count <= dense.SPLIT_TILE
        assert n_g <= dense.SPLIT_TILE_GROUPS
        if n_g:
            assert g0 == group and start >= split.n_all
            spans = _spans(split)[g0:g0 + n_g]
            assert spans[0][0] == start
            assert sum(c for _, c in spans) == count
            group += n_g
        else:
            assert start + count <= split.n_all
        covered += count
    assert covered == ids.size and group == box.shape[0]
    n_groups = {"24 rows": 4, "32 rows": 8, "no group": 0,
                "one group": 1}.get(name)
    if n_groups is not None:
        assert box.shape[0] == n_groups
    if name == "random":
        # Row 11 has no finite box; rows 5 and 17 are refractive, 8 and 9
        # have a zero normal.
        assert split.n_all >= 1 and box.shape[0] > 5
        assert 11 in ids[:split.n_all].tolist()
        assert not {5, 8, 9, 17} & set(ids.tolist())


def test_row_split_cache(tables):
    """A split is kept for its tensor while it is not written to, and a new
    tensor with the same bytes gets the same split without a rebuild."""
    table = tables["random"][0].clone()
    first = dense.row_split(table)
    assert dense.row_split(table) is first
    assert dense.row_split(table.clone()) is first
    table[3, 3] += 1.0
    again = dense.row_split(table)
    assert again is not first
    assert not torch.equal(again.rows, first.rows)


def _cases(kinds):
    """(table, ray set) pairs: shared edges only on the scenes' tables
    (random triangles share none)."""
    return [(name, kind) for name in TABLES for kind in kinds
            if kind != "edges" or name in ("24 rows", "32 rows")]


ANY_HIT_RAYS = ["tmax at t", "tmax above t", "empty and far", "edges",
                "graze boxes", "in plane"]


@pytest.mark.parametrize("name,kind", _cases(ANY_HIT_RAYS))
def test_occluded_split_plain_is_plain(tables, name, kind):
    """The culled any-hit sweep gives ``_occluded_plain``'s flags bit for
    bit: at tmax exactly a blocking row's t (not blocked) and one float
    above it (blocked), with an empty range (never blocked), past T_FAR
    (where a miss blocks: the split's left-out rows count) and NaN."""
    table, rays, scene = tables[name]
    o, d, tmax = _shadow_set(kind, table, rays, scene)
    split = dense.row_split(table)
    want = dense._occluded_plain(o, d, tmax, table, TMIN)
    got, pairs, boxes = dense._occluded_split_plain(o, d, tmax, table, split,
                                                    TMIN, counts=True)
    assert torch.equal(got, want)
    if kind.startswith("tmax"):
        t, _, _ = dense._pe_block(o, d, table, TMIN)
        t = torch.where(table[None, :, 13] < 0.5, t, T_FAR)
        nearest = t.min(1).values < 1e15
        assert int(nearest.sum()) > N_RAYS // 8
        assert bool((got[nearest] == (kind == "tmax above t")).all())
    if kind == "empty and far":
        q = N_RAYS // 4
        assert not bool(got[:q].any()) and not bool(got[2 * q:3 * q].any())
        assert bool(got[q:2 * q].all())
    if name in ("24 rows", "32 rows") and kind.startswith("tmax"):
        assert pairs < 0.5 * o.shape[0] * table.shape[0]


@pytest.mark.parametrize("name", ["24 rows", "32 rows", "random"])
def test_split_plain_matches_pallas(tables, name):
    """The culled sweep against the JAX package's K2 (interpret mode) on
    shadow rays from camera and bounce hits to the light: the flags equal
    off the boundary (tests/test_torch_dense_small.py's tolerances)."""
    table, rays, _ = tables[name]
    p, ld, tmax = _t(rays[2]), _t(rays[3]), _t(rays[4])
    got = dense._occluded_split_plain(p, ld, tmax, table,
                                      dense.row_split(table), TMIN)
    want = torch.from_numpy(_pallas_occluded(p.numpy(), ld.numpy(),
                                             tmax.numpy(), table))
    t, _, _ = dense._pe_block(p, ld, table, TMIN)
    tm = tmax[:, None]
    tol = T_ATOL + T_RTOL * tm.abs()
    opaque = table[None, :, 13] < 0.5
    boundary = (((t < 1e15) & opaque & ((t - tm).abs() <= tol))
                | (opaque & _edge_pairs(p, ld, table, TMIN, tm + tol))).any(1)
    assert not bool(((got != want) & ~boundary).any())
    assert 0.02 < float(got.float().mean()) < 0.98
