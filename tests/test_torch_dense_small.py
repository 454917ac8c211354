"""K2's and K1's dense bodies on the tables their paths hand them
(``tpu_pt_torch.intersect.dense``: ``occluded`` and ``closest_lean``, the
sweeps of the tables with no kd copy), on the CPU.

The CUDA kernels (``csrc/dense_intersect.cu``) are held bit for bit to
their plain versions, ``_occluded_plain`` and ``_closest_plain``, on the
card (chip_smoke.py). Here the plain versions are held to the JAX
package's K2 / K1 (``pallas_bf._occluded_call`` / ``_closest_call_lean``,
interpret mode) on the three kinds of table those sweeps get: the mixed
box's 24-row NEE occluder subset (every shadow ray of the flagship
frames), ``cornell_box.obj``'s 32 rows (its every closest hit) and a
2,048-row subset (the sphere box's first occluder rows: the largest a
clustered scene hands K2 without a kd copy). The rays are the sweeps'
edges: shadow rays whose tmax is the plain version's t of their nearest
blocking row, bit for bit, or one float above it; rays aimed at edges
that two triangles share (rows tie on t); and camera and bounce rays over
the tables padded with zero rows to a multiple of 8.

Tolerances. The JAX package runs on the CPU with fused multiply-adds (XLA
contracts a * b + c) and the port without, so the two round t, u and v
apart by a few ulps (tests/test_torch_intersect.py). Where a pair sits on
a boundary, within that noise, the two may answer it differently: a
shadow ray's tmax within |dt| <= 1e-4 + 4e-6 t of a blocking row's t, an
edge function within 1e-4 of 0 or 1 at a t in range (hit or not), two
rows within that |dt| of each other for the closest hit (coplanar rows
carry their own rounded planes, so a tie in one package need not be one
in the other). So the flags, hit and miss and the winning rows are held
equal on every other ray, and t within |dt| * |n.d| <= 1e-4 + 4e-6 t
where both hit; on the boundary rays only the plain version is the
reference, and its own answers there are checked: tmax at t does not
block, one float above it does, and a tie goes to the lowest row among
equal t.

Also: the routing (the mixed box's shadow rays, ``cornell_box.obj``'s and
the scene-JSON scenes' closest hits and shadow rays reach ``occluded`` /
``closest_lean``, counted by ``LAUNCHES``), and the arguments the
wrappers hand the kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
import tpu_pt  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch import _kernels  # noqa: E402
from tpu_pt_torch.intersect import dense  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from test_torch_intersect import _rays, T_ATOL, T_RTOL  # noqa: E402

TMIN = 0.01
N_RAYS = 1024          # camera (and shadow) rays a table; bounce rays too
# An edge function this close to 0 or 1 is a boundary: its terms reach ~50
# at the sphere's small triangles, ~1e-5 apart once the two round them.
EDGE_EPS = 1e-4
SUBSET_ROWS = 2048     # dense.LEAN_MAX_TRIS


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.fixture(scope="module")
def tables(assets_dir):
    """name -> (table [rows, 16], rays (o, d, shadow o, d, tmax) in the
    box it comes from, the port's scene)."""
    out = {}
    for name, obj, seed in (("24 rows", "cornell_box_mixed.obj", 31),
                            ("32 rows", "cornell_box.obj", 32),
                            ("2048 rows", "cornell_box_sphere.obj", 33)):
        path = str(assets_dir / obj)
        scene = tp.load_scene(path, device="cpu")
        prepared = dense.prepare(scene)
        table = {"24 rows": prepared.occ_rows, "32 rows": prepared.rows,
                 "2048 rows": prepared.occ_rows[:SUBSET_ROWS]}[name]
        out[name] = (table.contiguous(),
                     _rays(tpu_pt.load_scene(path), N_RAYS, seed), scene)
    return out


def _edge_rays(scene, table, n: int, seed: int):
    """n rays aimed at points of edges that two triangles of ``table``
    share (its rows' column 15 is the scene triangle), half from the
    Cornell camera's eye, half from random points in the box, and a tmax
    for each."""
    real = table[:, 0:3].abs().sum(1) > 0
    ids = table[real, 15].long().numpy()
    v0 = scene.tri_v0.numpy()[ids]
    corners = [v0, v0 + scene.tri_e1.numpy()[ids],
               v0 + scene.tri_e2.numpy()[ids]]
    owners = {}
    for i in range(ids.size):
        pts = [tuple(c[i]) for c in corners]
        for a, b in ((0, 1), (1, 2), (2, 0)):
            owners.setdefault(tuple(sorted((pts[a], pts[b]))), []).append(i)
    shared = np.array([k for k, v in owners.items() if len(v) == 2],
                      np.float32)
    r = np.random.default_rng(seed)
    pick = shared[r.integers(0, len(shared), n)]
    w = r.uniform(0.05, 0.95, (n, 1)).astype(np.float32)
    target = pick[:, 0] + (pick[:, 1] - pick[:, 0]) * w
    o = np.broadcast_to(np.array([278.0, 273.0, -800.0], np.float32),
                        (n, 3)).copy()
    o[n // 2:] = r.uniform([0, 0, 0], [556, 548, 559], (n - n // 2, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = r.uniform(1.0, 2000.0, n).astype(np.float32)
    return o.astype(np.float32), d.astype(np.float32), tmax


def _padded(table):
    """The table with zero rows padding it to a multiple of 8: its last
    three rows zeroed, or eight zero rows appended to a table of 32."""
    if table.shape[0] % 8 == 0 and table.shape[0] == 32:
        return torch.cat([table, torch.zeros((8, 16))]).contiguous()
    padded = table.clone()
    padded[-3:] = 0.0
    return padded


def _tb(rows: int) -> int:
    return rows if rows <= 512 else 512


def _pallas_rays(o, d, extras=()):
    n = o.shape[0]
    n_pad = pallas_bf._pad_to(n, pallas_bf.RAY_TILE)
    return pallas_bf.ray_rows(pallas_bf.as_v3(jnp.asarray(o)),
                              pallas_bf.as_v3(jnp.asarray(d)), n_pad,
                              extras=tuple(jnp.asarray(x) for x in extras))


def _pallas_occluded(o, d, tmax, table):
    """The JAX package's K2 on ``table`` (interpret mode)."""
    occ = pallas_bf._occluded_call(_pallas_rays(o, d, (tmax,)),
                                   jnp.asarray(table.numpy()),
                                   table.shape[0], TMIN,
                                   tb=_tb(table.shape[0]))
    return np.asarray(occ)[0, :o.shape[0]] > 0


def _pallas_closest(o, d, table):
    """The JAX package's K1 on ``table`` (interpret mode): (t, row)."""
    t, row = pallas_bf._closest_call_lean(_pallas_rays(o, d),
                                          jnp.asarray(table.numpy()),
                                          table.shape[0], TMIN,
                                          tb=_tb(table.shape[0]))
    n = o.shape[0]
    return np.asarray(t)[0, :n], np.asarray(row)[0, :n]


def _edge_pairs(o, d, table, lo, hi):
    """[N, rows]: pairs whose plane t (hit or not, as dense._pe_block
    rounds it) lies in (lo, hi) with an edge function within EDGE_EPS of
    0 or 1, where the two packages may answer the pair differently."""
    c = [table[None, :, k] for k in range(4)]
    nd = c[0] * d[:, 0:1] + c[1] * d[:, 1:2] + c[2] * d[:, 2:3]
    num = c[3] - (c[0] * o[:, 0:1] + c[1] * o[:, 1:2] + c[2] * o[:, 2:3])
    t = num * (1.0 / nd)
    _, u, v = dense._pe_block(o, d, table, TMIN)
    edge = ((u.abs() <= EDGE_EPS) | (v.abs() <= EDGE_EPS)
            | ((1.0 - u - v).abs() <= EDGE_EPS))
    return edge & (t > lo) & (t < hi)


def _shadow_set(kind, table, rays, scene):
    """(origins, dirs, tmax) of a K2 ray set."""
    o, d, p, ld, tmax = rays
    if kind == "edges":
        return _edge_rays(scene, table, N_RAYS, 41)
    p, ld, tmax = _t(p), _t(ld), _t(tmax)
    if kind == "padded":
        return p.numpy(), ld.numpy(), tmax.numpy()
    t, _, _ = dense._pe_block(p, ld, table, TMIN)
    t = torch.where(table[None, :, 13] < 0.5, t, T_FAR)
    near, first = t.min(1)
    hit = near < 1e15
    if kind == "tmax above t":
        near = torch.nextafter(near, torch.full_like(near, float("inf")))
    elif kind in ("tmax 2 tol below t", "tmax 2 tol above t"):
        # Twice the plane tolerance (module docstring) from the nearest
        # blocking row's t, measured along the ray: 2 tol / |n.d|.
        cos = (table[first, 0:3] * ld).sum(1).abs()
        step = 2.0 * (T_ATOL + T_RTOL * near.abs()) / cos.clamp_min(1e-6)
        near = near - step if kind == "tmax 2 tol below t" else near + step
    return p.numpy(), ld.numpy(), torch.where(hit, near, tmax).numpy()


@pytest.mark.parametrize("kind", ["tmax at t", "tmax above t",
                                  "tmax 2 tol below t", "tmax 2 tol above t",
                                  "edges", "padded"])
@pytest.mark.parametrize("name", ["24 rows", "32 rows", "2048 rows"])
def test_occluded_plain_matches_pallas(tables, name, kind):
    """K2's plain version against the JAX package's K2: flags equal on
    every ray off the boundary (module docstring); on the tmax-at-t sets
    the plain version's own answer at the boundary (not blocked at t,
    blocked one float above); with tmax twice the tolerance below or
    above each ray's nearest blocking t, those rays lie off the boundary,
    so their flags (none blocked below, all above) are held to the JAX
    package's too."""
    table, rays, scene = tables[name]
    if kind == "padded":
        table = _padded(table)
    o, d, tmax = _shadow_set(kind, table, rays, scene)
    got = dense._occluded_plain(_t(o), _t(d), _t(tmax), table, TMIN)
    want = torch.from_numpy(_pallas_occluded(o, d, tmax, table))
    t, _, _ = dense._pe_block(_t(o), _t(d), table, TMIN)
    tm = _t(tmax)[:, None]
    tol = T_ATOL + T_RTOL * tm.abs()
    opaque = table[None, :, 13] < 0.5
    near_t = (t < 1e15) & opaque & ((t - tm).abs() <= tol)
    near_edge = opaque & _edge_pairs(_t(o), _t(d), table, TMIN, tm + tol)
    boundary = (near_t | near_edge).any(1)
    differ = got != want
    assert not bool((differ & ~boundary).any()), int((differ & ~boundary).sum())
    if kind.startswith("tmax"):
        nearest = (t.masked_fill(~opaque, T_FAR).min(1).values < 1e15)
        assert int(nearest.sum()) > N_RAYS // 4
        assert bool((got[nearest] == kind.endswith("above t")).all())
        if kind.startswith("tmax 2 tol"):
            held = nearest & ~boundary
            assert int(held.sum()) >= 0.9 * int(nearest.sum())
            assert torch.equal(want[held], got[held])
    else:
        assert 0.02 < float(got.float().mean()) < 0.98
    if kind == "padded":
        assert float(boundary.float().mean()) < 0.05


@pytest.mark.parametrize("kind", ["camera and bounce", "edges", "padded"])
@pytest.mark.parametrize("name", ["24 rows", "32 rows", "2048 rows"])
def test_closest_plain_matches_pallas(tables, name, kind):
    """K1's plain version against the JAX package's K1: hit and miss
    equal, t within the plane noise, the winning row equal but where two
    rows tie within that noise (module docstring)."""
    table, rays, scene = tables[name]
    if kind == "padded":
        table = _padded(table)
    if kind == "edges":
        o, d, _ = _edge_rays(scene, table, N_RAYS, 42)
    else:
        o, d = rays[0], rays[1]
    got_t, got_row = dense._closest_plain(_t(o), _t(d), table, TMIN)
    want_t, want_row = (torch.from_numpy(np.array(x)) for x in
                        _pallas_closest(o, d, table))
    hit = got_t < 1e15
    tol = T_ATOL + T_RTOL * torch.where(hit, got_t, 0.0)
    boundary = _edge_pairs(_t(o), _t(d), table, TMIN,
                           (got_t + tol)[:, None]).any(1)
    both = hit & (want_t < 1e15)
    assert not bool(((hit != (want_t < 1e15)) & ~boundary).any())
    assert 0.2 < float(hit.float().mean())
    cos = (table[got_row.long(), 0:3] * _t(d)).sum(1).abs()
    assert bool(((got_t - want_t).abs() * cos <= tol)[both & ~boundary].all())
    t, _, _ = dense._pe_block(_t(o), _t(d), table, TMIN)
    # The plain version's own rule: the lowest row among equal t.
    rows = torch.arange(table.shape[0], dtype=torch.int32)
    lowest = torch.where(t == got_t[:, None], rows, table.shape[0]).min(1)
    assert torch.equal(got_row[hit], lowest.values[hit])
    tied = (((t - got_t[:, None]).abs() <= tol[:, None]) & (t < 1e15)).sum(1)
    differ = (got_row != want_row) & both
    assert not bool((differ & (tied < 2) & ~boundary).any())
    if kind == "edges":
        assert int((tied >= 2).sum()) > N_RAYS // 50
    else:
        assert float(boundary.float().mean()) < 0.05


class _ZeroedOutputs:
    """``torch`` as dense sees it, with ``empty`` zero-filled: a kernel
    that is not run leaves its outputs as zeros, which the callers of the
    wrappers can gather from."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def empty(*args, **kw):
        return torch.zeros(*args, **kw)


def _fake_card(monkeypatch):
    """The wrappers' card side on CPU tensors: every tensor counts as on
    the card, each launch is recorded as (entry point, arguments) and not
    run (its outputs zeros), and the launch counters are a copy."""
    calls = []
    monkeypatch.setattr(dense, "torch", _ZeroedOutputs())
    monkeypatch.setattr(dense, "_on_cpu", lambda x: False)
    monkeypatch.setattr(dense, "_stream", lambda dev: None)
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(dense, "LAUNCHES", dict.fromkeys(dense.LAUNCHES, 0))
    return calls


@pytest.mark.parametrize("scene_file,closest", [
    ("cornell_box_mixed.obj", "closest_lean_tree"),
    ("cornell_box.obj", "closest_lean"),
    ("cornell_prims.json", "closest_lean"),
    ("cornell_curves.json", "closest_lean")])
def test_routing_reaches_the_dense_bodies(assets_dir, monkeypatch,
                                          scene_file, closest):
    """The flagship box's shadow rays (its 24 occluders have no kd copy)
    and ``cornell_box.obj``'s and the scene-JSON scenes' closest hits and
    shadow rays reach the dense bodies, one launch each, counted by
    LAUNCHES; the mixed box's closest hits take K1's walk."""
    scene = tp.load_scene(str(assets_dir / scene_file), device="cpu")
    prepared = dense.prepare(scene)
    calls = _fake_card(monkeypatch)
    o, d = torch.zeros((96, 3)), torch.ones((96, 3))
    dense.closest_hit(prepared, o, d, want_uv=True)
    dense.occluded_hit(prepared, o, d, torch.ones(96))
    assert prepared.occ_kd is None
    assert {k: n for k, n in dense.LAUNCHES.items() if n} == {
        closest: 1, "occluded": 1}
    assert [c[0] for c in calls] == ["tpt_" + closest, "tpt_occluded"]


@pytest.mark.parametrize("n", [1, 300, 65537, 131072])
@pytest.mark.parametrize("name", ["closest_lean", "occluded"])
def test_dense_launch_matches_signature(monkeypatch, tables, name, n):
    """K1's and K2's wrappers launch their entry point once, with as many
    arguments as ``_kernels`` declares for it, the counts in its int
    slots, and count the launch: K1 and K2 below OCC_SPLIT_MIN_RAYS rays
    the rays and the table's rows; K2 from there its split's entry point,
    with the table's rows, the tiles of its ``row_split`` and the rays,
    and the split in its pointer slots."""
    tris = tables["24 rows"][0]
    calls = _fake_card(monkeypatch)
    o, d = torch.zeros((n, 3)), torch.ones((n, 3))
    args = (o, d, tris, TMIN) if name == "closest_lean" else (
        o, d, torch.ones(n), tris, TMIN)
    getattr(dense, name)(*args)
    (called, launched), = calls
    signature = _kernels._SIGNATURES["dense_intersect"][called]
    split_call = name == "occluded" and n >= dense.OCC_SPLIT_MIN_RAYS
    assert called == "tpt_" + name + ("_split" if split_call else "")
    assert len(launched) == len(signature)
    ints = [a for a, kind in zip(launched, signature) if kind is _kernels._I]
    if split_call:
        split = dense.row_split(tris)
        assert split.tiles.shape[0] == 1 and ints == [24, 1, n]
        for part in (split.rows, split.groups, split.tiles):
            assert part.data_ptr() in launched
    else:
        assert ints == [n, 24]
    assert dense.LAUNCHES[name] == 1
