"""Port parity for the pair-binned scheduler of
``tpu_pt/intersect/pallas_ablations.py`` (K14): the schedule
``ablations._pair_schedule``, the plain versions of ``closest_binned`` /
``occluded_binned`` and their paths, and ``TPT_BINNED``'s place in the
dispatch of ``clustered``.

(a) The schedule against the JAX function on the same numpy-seeded rays
    and the same un-grown boxes: with the port's culling margin at 0 each
    ray's set of clusters, ``next_tn`` and ``overflow`` are the reference's;
    with the margin on, each set may only grow.
(b) The plain paths against the dense sweep ``dense._closest_plain`` /
    ``_occluded_plain``, bit for bit, at k = 2 (most lanes through the
    completion pass) and k = 12, and against the JAX package's
    ``intersect_closest_binned`` / ``intersect_occluded_binned`` (interpret
    mode): triangle ids and flags equal, as ``test_binned_matches_reference``
    asks, and t under ``test_torch_clustered.py``'s bound (|dt| |n.d| <=
    1e-4 + 4e-6 t), not its rtol 1e-6: XLA on the CPU fuses multiply-adds,
    and a t of ~100 moves by 1e-4.
(c) 16^2 x 4 spp pixelq frames under ``TPT_BINNED=1`` / ``closest`` /
    ``occ`` bitwise equal to the lean frame; the precedence of the
    variable, read at call time.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_ablations, pallas_bf  # noqa: E402
from tpu_pt_torch.intersect import (SLAB_UNKNOWN, ablations,  # noqa: E402
                                    clustered, dense, get_intersectors)
import tpu_pt_torch as tp  # noqa: E402
from test_torch_ablations import (_clean_env, _frame, _rays8,  # noqa: E402,F401
                                  _shrink, _test_rays, mixed_scenes,
                                  one_torch_thread)
from test_torch_clustered import _assert_same_clustered_hit  # noqa: E402
from test_torch_intersect import _t  # noqa: E402


@pytest.fixture(autouse=True)
def _binned_env(monkeypatch):
    for name in ("TPT_BINNED", "TPT_PAIR_K", "TPT_GRP"):
        monkeypatch.delenv(name, raising=False)


def _pairs_per_ray(pair_ray, tile_sid, n):
    """{ray: set of clusters} from a slot -> ray layout."""
    sets = [set() for _ in range(n)]
    for slot, r in enumerate(pair_ray.tolist()):
        if r >= 0:
            sets[r].add(int(tile_sid[slot // ablations.PAIR_TILE]))
    return sets


def _jax_pairs_per_ray(idx_buf, tile_sid, n, k, ns):
    """The same sets from the reference's layout: slot -> original pair
    index ray * k + rank, in tiles whose id is below ns (dropped pairs sink
    to the dead tail)."""
    idx_buf, tile_sid = np.asarray(idx_buf), np.asarray(tile_sid)
    sets = [set() for _ in range(n)]
    for slot in np.nonzero(idx_buf < n * k)[0]:
        sid = int(tile_sid[slot // ablations.PAIR_TILE])
        if sid < ns:
            sets[idx_buf[slot] // k].add(sid)
    return sets


# --------------------------------------------------------------------------
# (a) the schedule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 12])
def test_pair_schedule_matches_reference(mixed_scenes, monkeypatch, k):
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    monkeypatch.setattr(clustered, "BOX_MARGIN", 0.0)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    ns = boxes.shape[0]
    o, d, so, sd, st = _test_rays(jscene, 256, seed=41)
    for rays8, tmax_j, tmax_t in ((_rays8(o, d, 1e16), 1e16, 1e16),
                                  (_rays8(so, sd, st), jnp.asarray(st),
                                   _t(st))):
        n = rays8.shape[0]
        s = ablations._pair_schedule(rays8, boxes, clustered.box_scale(boxes),
                                     k, 0.01, tmax_t)
        _, jtile, jidx, jnext, jovf = pallas_ablations._pair_schedule(
            jnp.asarray(rays8.numpy().T), jnp.asarray(boxes.numpy()), k, 0.01,
            tmax_j)
        ref = _jax_pairs_per_ray(jidx, jtile, n, k, ns)
        assert _pairs_per_ray(s.pair_ray, s.tile_sid, n) == ref
        np.testing.assert_array_equal(s.next_tn.numpy(), np.asarray(jnext))
        np.testing.assert_array_equal(s.overflow.numpy(), np.asarray(jovf))
        share = float(s.overflow.float().mean())
        assert (0.05 < share < 0.95) if k == 2 else share < 0.05
        assert bool((s.next_tn[s.overflow] < 1e16).all())
        # Every tile holds one cluster's pairs, each cluster's run in
        # whole tiles in ascending cluster order, the dead tail last.
        live = s.tile_sid < ns
        assert bool((s.tile_sid[1:] >= s.tile_sid[:-1]).all())
        assert int(live.sum()) == sum(-(-len([r for r in ref if c in r])
                                        // ablations.PAIR_TILE)
                                      for c in range(ns))
        assert bool((s.pair_ray.view(-1, ablations.PAIR_TILE)[~live]
                     == -1).all())
        assert s.tile_sid.shape[0] == -(-n * k // ablations.PAIR_TILE) + ns


def test_pair_schedule_grows_with_margin(mixed_scenes, monkeypatch):
    """With the margin on, a ray's k nearest are nearest by the grown
    boxes' entries: the set it pierces may only grow, so a ray the
    reference does not overflow may overflow here, never the reverse."""
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    o, d, *_ = _test_rays(jscene, 256, seed=42)
    rays8 = _rays8(o, d, 1e16)
    ns = boxes.shape[0]
    s = ablations._pair_schedule(rays8, boxes, clustered.box_scale(boxes),
                                 ns, 0.01, 1e16)
    _, jtile, jidx, _, jovf = pallas_ablations._pair_schedule(
        jnp.asarray(rays8.numpy().T), jnp.asarray(boxes.numpy()), ns, 0.01,
        1e16)
    assert not bool(s.overflow.any()) and not np.asarray(jovf).any()
    ours = _pairs_per_ray(s.pair_ray, s.tile_sid, rays8.shape[0])
    ref = _jax_pairs_per_ray(jidx, jtile, len(ours), ns, ns)
    k2 = ablations._pair_schedule(rays8, boxes, clustered.box_scale(boxes),
                                  2, 0.01, 1e16)
    assert all(r <= o for r, o in zip(ref, ours))
    assert sum(len(o) - len(r) for r, o in zip(ref, ours)) \
        <= 0.02 * sum(len(o) for o in ours)
    counts = torch.tensor([len(x) for x in ours])
    assert torch.equal(k2.overflow, counts > 2)


def test_reduce_pairs_is_the_lexicographic_minimum():
    """The int64 key fold keeps the smallest t and, among equal t, the
    lowest row; rays without a hit keep T_FAR and row 0."""
    rng = np.random.default_rng(3)
    n, p = 50, 600
    ray = torch.as_tensor(rng.integers(-1, n - 5, p))
    t = torch.as_tensor(rng.choice([0.5, 1.25, 7.0, 1e16], p).astype(
        np.float32))
    row = torch.as_tensor(rng.integers(0, 10_000, p).astype(np.int32))
    bt, br = ablations._reduce_pairs(ray, t, row, n)
    for r in range(n):
        mine = [(float(t[i]), int(row[i])) for i in range(p)
                if int(ray[i]) == r and float(t[i]) < 1e16]
        want = min(mine) if mine else (1e16, 0)
        assert (float(bt[r]), int(br[r])) == (np.float32(want[0]), want[1])
    occ = ablations._reduce_pairs_occ(ray, t < 1.0, n)
    assert occ.tolist() == [bool(((ray == r) & (t < 1.0)).any())
                            for r in range(n)]


# --------------------------------------------------------------------------
# (b) the paths against the dense sweep and the JAX package
# --------------------------------------------------------------------------

def _binned_tables(tscene, monkeypatch):
    _shrink(monkeypatch)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None                  # shadow rays over the table
    return tables


@pytest.mark.parametrize("k", [2, 12])
def test_binned_matches_dense_and_reference(mixed_scenes, monkeypatch, k):
    jscene, tscene = mixed_scenes
    tables = _binned_tables(tscene, monkeypatch)
    monkeypatch.setattr(ablations, "PAIR_K", k)
    monkeypatch.setenv("TPT_BINNED", "1")
    o, d, so, sd, st = _test_rays(jscene, 384, seed=43)
    ref_t, ref_row = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
    ref_occ = dense._occluded_plain(_t(so), _t(sd), _t(st), tables.rows, 0.01)
    h, slab = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False,
                                    want_slab=True)
    occ = clustered.occluded_hit(tables, _t(so), _t(sd), _t(st))
    assert torch.equal(h.t, ref_t) and torch.equal(occ, ref_occ)
    assert torch.equal(h.tri, torch.where(
        h.hit, tables.rows[ref_row.long(), 15], 0.0).int())
    assert bool((slab == SLAB_UNKNOWN).all())
    # A finite tmax clips as the dense sweep does.
    h6 = clustered.closest_hit(tables, _t(o), _t(d), tmax=600.0,
                               want_uv=False)
    assert torch.equal(h6.t, dense._closest_plain(_t(o), _t(d), tables.rows,
                                                  0.01, 600.0)[0])
    # How many lanes the completion pass carries.
    rays8 = ablations.pack_rays(_t(o), _t(d), 1e16, o.shape[0])
    s = ablations._pair_schedule(rays8, tables.boxes, tables.scale, k, 0.01,
                                 1e16)
    share = float(s.overflow.float().mean())
    assert (share > 0.5) if k == 2 else (share < 0.2)
    # The wrappers' plain versions alone: a ray's fold over its own pairs.
    t_k, row_k = ablations.closest_binned(rays8, tables.rows, s.pair_ray,
                                          s.tile_sid, 64, 0.01)
    exact = ~s.overflow
    assert torch.equal(t_k[exact], ref_t[exact])
    assert torch.equal(row_k[exact], ref_row[exact])
    # The JAX package's binned paths (its superclusters of 128 rows).
    j = pallas_ablations.intersect_closest_binned(
        jscene, jnp.asarray(o), jnp.asarray(d), want_uv=False, k=k)
    jocc = pallas_ablations.intersect_occluded_binned(
        jscene, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(st), k=k)
    np.testing.assert_array_equal(h.tri.numpy(), np.asarray(j.tri))
    _assert_same_clustered_hit(j, h, o, d, tscene)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_binned_paths_alone(mixed_scenes, monkeypatch):
    """The two paths with their default completion (K6 / K8's plain
    versions) give the dense sweep's answers, at a ray count that is no
    multiple of anything."""
    jscene, tscene = mixed_scenes
    tables = _binned_tables(tscene, monkeypatch)
    o, d, so, sd, st = _test_rays(jscene, 77, seed=44)
    table = (tables.rows, tables.boxes, tables.scale, 0.01)
    h = ablations.closest_binned_path(_t(o), _t(d), *table, k=3)
    ref_t, _ = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
    assert torch.equal(h.t, ref_t) and h.t.shape == (154,)
    occ = ablations.occluded_binned_path(_t(so), _t(sd), _t(st), *table, k=3)
    assert torch.equal(occ, dense._occluded_plain(_t(so), _t(sd), _t(st),
                                                  tables.rows, 0.01))


# --------------------------------------------------------------------------
# (c) frames and precedence
# --------------------------------------------------------------------------

@pytest.mark.parametrize("value", ["1", "closest", "occ"])
def test_binned_frame_bitwise(mixed_scenes, monkeypatch, value):
    _, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    tscene = tscene.to("cpu")
    tscene.num_occluders = -1               # shadow rays over the table
    base, stats = _frame(tscene)
    assert int(stats.done_histogram[4]) == 0
    calls = []
    for name in ("closest_binned_path", "occluded_binned_path"):
        fn = getattr(ablations, name)
        monkeypatch.setattr(ablations, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            (calls.append(_n), _fn(*a, **kw))[1])
    monkeypatch.setenv("TPT_BINNED", value)
    accum, _ = _frame(tscene)
    assert torch.equal(accum, base)
    want = {"1": {"closest_binned_path", "occluded_binned_path"},
            "closest": {"closest_binned_path"},
            "occ": {"occluded_binned_path"}}[value]
    assert set(calls) == want


def test_binned_precedence(mixed_scenes, monkeypatch):
    """TPT_BINNED comes before cbin, before the full carry
    (TPT_LEAN_BIG=0) and before the occluder subset's absence; it turns
    the landing-slab prediction off on the closest side; read at every
    call."""
    _, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None
    calls = []
    for name in ("closest_binned_path", "occluded_binned_path",
                 "closest_cbin_path", "occluded_cbin_path"):
        fn = getattr(ablations, name)
        monkeypatch.setattr(ablations, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            (calls.append(_n), _fn(*a, **kw))[1])
    jscene = mixed_scenes[0]
    o, d, so, sd, st = _test_rays(jscene, 32, seed=45)
    monkeypatch.setenv("TPT_CBIN", "1")
    monkeypatch.setenv("TPT_LEAN_BIG", "0")
    monkeypatch.setenv("TPT_BINNED", "1")
    ref = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)[0]
    assert torch.equal(clustered.closest_hit(tables, _t(o), _t(d)).t, ref)
    clustered.occluded_hit(tables, _t(so), _t(sd), _t(st))
    # The closest completion runs the full carry (no binned, no cbin on
    # the full carry); the any-hit completion may take cbin.
    assert calls[:2] == ["closest_binned_path", "occluded_binned_path"]
    assert "closest_cbin_path" not in calls
    calls.clear()
    monkeypatch.setenv("TPT_BINNED", "occ")
    monkeypatch.setenv("TPT_LEAN_BIG", "1")
    clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    assert calls == ["closest_cbin_path"]
    cfg = tp.RenderConfig(width=8, height=8, intersector="dense")
    for value, pred in (("occ", True), ("closest", False), ("1", False),
                        ("0", True)):
        monkeypatch.setenv("TPT_BINNED", value)
        monkeypatch.setenv("TPT_CBIN", "0")
        assert get_intersectors(tscene, cfg, want_uv=False)[0] \
            .supports_pred is pred
    assert ablations.binned_sides() == (False, False)
    monkeypatch.setenv("TPT_BINNED", "closest")
    assert ablations.binned_sides() == (True, False)
    # The quirk's first-hit occlusion and a small occluder subset come
    # first, as in the reference.
    small = clustered.prepare(tscene)
    assert small.occ_rows is not None
    monkeypatch.setenv("TPT_BINNED", "1")
    calls.clear()
    clustered.occluded_hit(small, _t(so), _t(sd), _t(st))
    assert calls == []


def test_binned_wrappers_take_cpu_or_cuda_only(mixed_scenes, monkeypatch):
    _, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 64)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    meta = torch.empty((64, 8), device="meta")
    idx = torch.zeros(ablations.PAIR_TILE, dtype=torch.int32)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ablations.closest_binned(meta, rows, idx, idx[:1], 64, 0.01)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ablations.occluded_binned(meta, rows, idx, idx[:1], 64, 0.01)
    assert not ablations.LAUNCHES["closest_binned"]
    assert not ablations.LAUNCHES["occluded_binned"]
    assert ablations.PAIR_TILE == pallas_ablations.PAIR_TILE
    assert ablations.PAIR_K == pallas_ablations.PAIR_K == 12
    assert isinstance(pallas_bf.TRI_SLAB, int)
