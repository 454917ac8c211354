"""The closest sweeps' plain versions at their edges (``dense._closest_plain``
for K1 and K3, ``dense._closest_nee_plain`` for K4), on the CPU.

The CUDA dense bodies are held bit for bit to these plain versions on the
card (chip_smoke.py's ``_check_dense_bodies``), on the same edges: K3's
tmax clip, parked lanes, zero rows past the table's end and rays aimed at
edges that two rows share. Here the plain versions' answers there are
checked bit for bit against their own rules, on ``cornell_box.obj``'s 32
rows, the mixed box's 432, a 2,048-row table of the sphere box (the
largest with no kd copy) and a seeded random table (refractive, zero and
degenerate rows): a ray whose nearest hit lies exactly at tmax misses and
every other ray keeps its unclipped hit; a parked lane misses and leaves
the live lanes as they were; zero rows change nothing; a tie goes to the
lowest row, and K3's u and v are that row's. K3's clip is also held to the
JAX package's K3 (``pallas_bf._closest_call``, interpret mode) within
tests/test_torch_dense_small.py's tolerances: hit and miss and the winning
row equal off the boundary rays, t within the plane noise; a ray with a
hit within that noise of tmax is a boundary ray too.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
import tpu_pt  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import dense  # noqa: E402
from tpu_pt_torch.render import PARK_COORD, PARK_DIR  # noqa: E402
from test_torch_intersect import _rays, T_ATOL, T_RTOL  # noqa: E402
from test_torch_dense_small import (_edge_pairs, _edge_rays,  # noqa: E402
                                    _pallas_rays, _t, _tb)
from test_torch_dense_split import _random_table  # noqa: E402
import jax.numpy as jnp  # noqa: E402

TMIN = 0.01
N_RAYS = 256           # camera rays a table; as many bounce rays
TABLES = ["32 rows", "432 rows", "2048 rows", "random"]
SCENE_TABLES = TABLES[:3]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tables(assets_dir):
    """name -> (table [rows, 16], (origins, dirs) of camera and bounce rays
    in the box it comes from, the port's scene, its light and occluder
    subset)."""
    out = {}
    for name, obj, seed in (("32 rows", "cornell_box.obj", 81),
                            ("432 rows", "cornell_box_mixed.obj", 82),
                            ("2048 rows", "cornell_box_sphere.obj", 83)):
        path = str(assets_dir / obj)
        scene = tp.load_scene(path, device="cpu")
        prepared = dense.prepare(scene)
        rays = _rays(tpu_pt.load_scene(path), N_RAYS, seed)
        out[name] = (prepared.rows[:dense.LEAN_MAX_TRIS].contiguous(),
                     (_t(rays[0]), _t(rays[1])), scene,
                     dense.light_vector(scene), prepared.occ_rows.contiguous())
    cornell = out["32 rows"]
    rays = _rays(tpu_pt.load_scene(str(assets_dir / "cornell_box.obj")),
                 N_RAYS, 84)
    out["random"] = (_random_table(85), (_t(rays[0]), _t(rays[1])), None,
                     cornell[3], cornell[4])
    return out


def _median_hit(o, d, table):
    """The median of the rays' unclipped hits, bit for bit one ray's t."""
    t, _ = dense._closest_plain(o, d, table, TMIN)
    return float(t[t < 1e15].median())


def _full(o, d, table, tmax=dense.T_FAR):
    """K3's plain version with u and v: (t, row, normal, mat, u, v)."""
    return dense._closest_plain(o, d, table, TMIN, tmax, True, True)


def _equal(got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _lanes(out, keep):
    return tuple(x[keep] for x in out)


@pytest.mark.parametrize("name", TABLES)
def test_clip_at_a_hit_misses(tables, name):
    """K3 at a tmax that is bit for bit the median hit's t: a ray whose
    nearest hit lies there misses (the clip is strict), one whose hit lies
    past it misses too, and every ray whose hit lies before it keeps its
    unclipped answer, bit for bit."""
    table, (o, d) = tables[name][:2]
    tmax = _median_hit(o, d, table)
    free, clipped = _full(o, d, table), _full(o, d, table, tmax)
    before = free[0] < tmax
    assert int((free[0] == tmax).sum()) >= 1
    assert _equal(_lanes(clipped, before), _lanes(free, before))
    # A miss: t = T_FAR, row 0, and zeros.
    t, row, normal, mat, u, v = _lanes(clipped, ~before)
    assert bool((t == dense.T_FAR).all()) and not bool(row.any())
    assert not bool(normal.any() or mat.any() or u.any() or v.any())
    hit = free[0] < 1e15
    assert 0.3 < float(before.sum() / hit.sum()) < 0.7


@pytest.mark.parametrize("tmax_kind", ["600", "median hit"])
@pytest.mark.parametrize("name", SCENE_TABLES)
def test_clip_matches_pallas(tables, name, tmax_kind):
    """K3's plain version against the JAX package's K3 at a finite tmax:
    hit and miss and the winning row equal off the boundary rays, t within
    the plane noise where both hit (module docstring)."""
    table, (o, d) = tables[name][:2]
    tmax = 600.0 if tmax_kind == "600" else _median_hit(o, d, table)
    got_t, got_row = _full(o, d, table, tmax)[:2]
    out, row = pallas_bf._closest_call(
        _pallas_rays(o.numpy(), d.numpy()), jnp.asarray(table.numpy()),
        table.shape[0], TMIN, tmax, tb=_tb(table.shape[0]))
    want_t = torch.from_numpy(np.array(out)[0, :o.shape[0]])
    want_row = torch.from_numpy(np.array(row)[0, :o.shape[0]])
    hit = got_t < 1e15
    tol = T_ATOL + T_RTOL * torch.where(hit, got_t, 0.0)
    t, _, _ = dense._pe_block(o, d, table, TMIN)
    near_tmax = ((t - tmax).abs() <= T_ATOL + T_RTOL * tmax) & (t < 1e15)
    boundary = (_edge_pairs(o, d, table, TMIN, (got_t + tol)[:, None]).any(1)
                | near_tmax.any(1))
    both = hit & (want_t < 1e15)
    assert not bool(((hit != (want_t < 1e15)) & ~boundary).any())
    assert 0.2 < float(hit.float().mean())
    cos = (table[got_row.long(), 0:3] * d).sum(1).abs()
    assert bool(((got_t - want_t).abs() * cos <= tol)[both & ~boundary].all())
    tied = (((t - got_t[:, None]).abs() <= tol[:, None]) & (t < 1e15)).sum(1)
    differ = (got_row != want_row) & both
    assert not bool((differ & (tied < 2) & ~boundary).any())
    if tmax_kind == "median hit":
        assert bool(boundary[got_t == tmax].all())
        assert float(boundary.float().mean()) < 0.05


@pytest.mark.parametrize("name", TABLES)
def test_parked_lanes_miss(tables, name):
    """One lane in eight parked as the wavefront parks it (render.py):
    the parked lanes miss in K1's, K3's and K4's plain versions, and the
    live lanes answer bit for bit as they do with no lane parked."""
    table, (o, d), _, light, occ = tables[name]
    park = torch.arange(o.shape[0]) % 8 == 0
    po = torch.where(park[:, None], PARK_COORD, o).contiguous()
    pd = torch.where(park[:, None], PARK_DIR, d).contiguous()
    r = np.random.default_rng(86)
    lz1, lz2 = (_t(r.random(o.shape[0])) for _ in range(2))
    for form in (lambda o, d: _full(o, d, table),
                 lambda o, d: dense._closest_nee_plain(
                     o, d, lz1, lz2, table, occ, light, TMIN)):
        live, parked = form(o, d), form(po, pd)
        assert _equal(_lanes(parked, ~park), _lanes(live, ~park))
        assert bool((parked[0][park] == dense.T_FAR).all())
    assert 0.2 < float((live[0][~park] < 1e15).float().mean())


@pytest.mark.parametrize("form", ["K1", "K3", "K4"])
@pytest.mark.parametrize("name", TABLES)
def test_zero_rows_change_nothing(tables, name, form):
    """The table with zero rows appended up to the next multiple of 512
    (``dense.pack_tris``' untrimmed table: cornell_box.obj's 32 rows and
    480 zero rows, a second tile all zeros) answers bit for bit as the
    table does."""
    table, (o, d), _, light, occ = tables[name]
    pad = -table.shape[0] % 512 or 512
    padded = torch.cat([table, torch.zeros((pad, 16))]).contiguous()
    r = np.random.default_rng(87)
    lz1, lz2 = (_t(r.random(o.shape[0])) for _ in range(2))
    call = {"K1": lambda tb: dense._closest_plain(o, d, tb, TMIN),
            "K3": lambda tb: _full(o, d, tb, 600.0),
            "K4": lambda tb: dense._closest_nee_plain(o, d, lz1, lz2, tb,
                                                      occ, light, TMIN)}[form]
    want = call(table)
    assert _equal(call(padded), want)
    assert 0.2 < float((want[0] < 1e15).float().mean())


@pytest.mark.parametrize("name", SCENE_TABLES)
def test_ties_keep_the_lowest_row(tables, name):
    """Rays aimed at edges that two rows share: K3's (t, row) is K1's, the
    row is the lowest among the rows at the winning t, and u and v are
    that row's, bit for bit."""
    table, _, scene = tables[name][:3]
    eo, ed, _ = _edge_rays(scene, table, 2 * N_RAYS, 88)
    o, d = _t(eo), _t(ed)
    t, row, _, _, u, v = _full(o, d, table)
    lean = dense._closest_plain(o, d, table, TMIN)
    assert torch.equal(t, lean[0]) and torch.equal(row, lean[1])
    pt, pu, pv = dense._pe_block(o, d, table, TMIN)
    hit = t < 1e15
    rows = torch.arange(table.shape[0], dtype=torch.int32)
    lowest = torch.where(pt == t[:, None], rows, table.shape[0]).min(1).values
    assert torch.equal(row[hit], lowest[hit])
    at = row.long()[:, None]
    assert torch.equal(u[hit], pu.gather(1, at)[hit, 0])
    assert torch.equal(v[hit], pv.gather(1, at)[hit, 0])
    tied = ((pt == t[:, None]).sum(1) > 1) & hit
    assert int(tied.sum()) > o.shape[0] // 100
