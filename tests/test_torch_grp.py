"""Port parity for the 8-lane group scheduler of
``tpu_pt/intersect/pallas_ablations.py`` (K15, ``TPT_GRP=1`` serial and
``2`` bundled): the group lists, the plain versions of ``closest_grp`` /
``occluded_grp`` and their paths, and ``TPT_GRP``'s place in the dispatch
of ``clustered``.

(a) The group lists are ``stream_candidates`` at a tile of 8 lanes: at
    margin 0 they equal the JAX function's at rt = 8.
(b) The plain paths, serial and bundled, against the dense sweep
    ``dense._closest_plain`` / ``_occluded_plain``, bit for bit, and
    against the JAX package under ``TPT_GRP=1`` / ``2`` (interpret mode),
    as ``test_grp_matches_tiled`` and ``test_grp_bundled_matches_tiled``
    set the tables up: hit / tri / mat equal and |dt| |n.d| <= 1e-4 +
    4e-6 t (``test_torch_clustered.py``'s bound), flags equal.
(c) 16^2 x 4 spp pixelq frames under ``TPT_GRP=1`` / ``2`` bitwise equal
    to the lean frame; the precedence of the variable.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_ablations, pallas_bf  # noqa: E402
from tpu_pt_torch.intersect import ablations, clustered, dense  # noqa: E402
from test_torch_ablations import (_clean_env, _frame,  # noqa: E402,F401
                                  _jax_stream_lists, _rays8, _shrink,
                                  _tables, _test_rays, fake_card,
                                  mixed_scenes, one_torch_thread)
from test_torch_clustered import _assert_same_clustered_hit  # noqa: E402
from test_torch_intersect import _t  # noqa: E402


@pytest.fixture(autouse=True)
def _grp_env(monkeypatch):
    for name in ("TPT_GRP", "TPT_BINNED"):
        monkeypatch.delenv(name, raising=False)


def test_group_lists_match_reference(mixed_scenes, monkeypatch):
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    monkeypatch.setattr(clustered, "BOX_MARGIN", 0.0)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    o, d, so, sd, st = _test_rays(jscene, 64, seed=51)
    for occluded, (oo, dd, tmax) in ((False, (o, d, 1e16)),
                                     (True, (so, sd, st))):
        rays8, build, _ = ablations.grp_steps(
            _t(oo), _t(dd), tmax if not occluded else _t(tmax), rows, boxes,
            0.0, 0.01, occluded)
        cand, keys, cnt, far = build()
        assert cand.shape == (rays8.shape[0] // ablations.GRP_LANES,
                              boxes.shape[0])
        jcnt, jorder, jkeys = _jax_stream_lists(
            rays8, boxes, ablations.GRP_LANES,
            jnp.asarray(st) if occluded else 1e16)
        np.testing.assert_array_equal(cnt.numpy(), jcnt)
        for g in range(cand.shape[0]):
            assert cand[g, :cnt[g]].tolist() == jorder[g, :jcnt[g]].tolist()
        assert 0 < int(cnt.sum()) < cand.numel()


def _grp_tables(tscene, monkeypatch):
    """The tables of test_grp_matches_tiled: clusters of 8 rows (16 in
    the JAX package's superclusters), slabs of 384 rows."""
    _shrink(monkeypatch, cluster=8, slab=384)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None                  # shadow rays over the table
    return tables


@pytest.mark.parametrize("mode", ["1", "2"])
def test_grp_matches_dense_and_reference(mixed_scenes, monkeypatch, mode):
    jscene, tscene = mixed_scenes
    tables = _grp_tables(tscene, monkeypatch)
    monkeypatch.setenv("TPT_GRP", mode)
    assert ablations._grp_bundled() is (mode == "2")
    calls = []
    for name in ("closest_grp_path", "occluded_grp_path"):
        fn = getattr(ablations, name)
        monkeypatch.setattr(ablations, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            (calls.append(_n), _fn(*a, **kw))[1])
    o, d, so, sd, st = _test_rays(jscene, 250, seed=52)
    ref_t, ref_row = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
    ref_occ = dense._occluded_plain(_t(so), _t(sd), _t(st), tables.rows, 0.01)
    h = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    occ = clustered.occluded_hit(tables, _t(so), _t(sd), _t(st))
    assert calls == ["closest_grp_path", "occluded_grp_path"]
    assert torch.equal(h.t, ref_t) and torch.equal(occ, ref_occ)
    assert torch.equal(h.tri, torch.where(
        h.hit, tables.rows[ref_row.long(), 15], 0.0).int())
    assert 0.05 < float(occ.float().mean()) < 0.95
    # A finite tmax clips as the dense sweep does; 500 rays are no
    # multiple of the group.
    t6, row6 = ablations.closest_grp_path(_t(o), _t(d), tables.rows,
                                          tables.boxes, tables.scale, 0.01,
                                          600.0)
    ref6 = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, 600.0)
    assert torch.equal(t6, ref6[0]) and torch.equal(row6, ref6[1])
    # The JAX package's group chain under the same variable.
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    jocc = pallas_bf.intersect_occluded(jscene, jnp.asarray(so),
                                        jnp.asarray(sd), jnp.asarray(st))
    _assert_same_clustered_hit(j, h, o, d, tscene)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_grp_break_cuts_work(mixed_scenes, monkeypatch):
    """The group break (first key beyond every lane's bound) and the skip
    of a candidate no lane's grown box passes really cut work: fewer
    (group, candidate) sweeps than the lists hold, the same hits."""
    jscene, tscene = mixed_scenes
    tables = _grp_tables(tscene, monkeypatch)
    o, d, *_ = _test_rays(jscene, 256, seed=53)
    rays8, build, _ = ablations.grp_steps(_t(o), _t(d), 1e16, tables.rows,
                                          tables.boxes, tables.scale, 0.01,
                                          False)
    lists = build()
    swept, real = [], ablations._pe_rows
    monkeypatch.setattr(ablations, "_pe_rows", lambda o, d, rows, tmin:
                        (swept.append(o.shape[0]), real(o, d, rows, tmin))[1])
    for bundled in (False, True):
        t, row = ablations.closest_grp(rays8, tables.rows, tables.boxes,
                                       tables.scale, lists, 0.01,
                                       bundled=bundled)
        ref = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
        assert torch.equal(t, ref[0]) and torch.equal(row, ref[1])
    assert 0 < sum(swept) < 0.95 * 2 * int(lists[2].sum())


@pytest.mark.parametrize("mode", ["1", "2"])
def test_grp_frame_bitwise(mixed_scenes, monkeypatch, mode):
    _, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    tscene = tscene.to("cpu")
    tscene.num_occluders = -1               # shadow rays over the table
    base, stats = _frame(tscene)
    assert int(stats.done_histogram[4]) == 0
    calls = []
    for name in ("closest_grp", "occluded_grp"):
        fn = getattr(ablations, name)
        monkeypatch.setattr(ablations, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            (calls.append((_n, a[-1])), _fn(*a, **kw))[1])
    monkeypatch.setenv("TPT_GRP", mode)
    accum, _ = _frame(tscene)
    assert torch.equal(accum, base)
    assert {c[0] for c in calls} == {"closest_grp", "occluded_grp"}
    assert {c[1] for c in calls} == {mode == "2"}      # bundled flag


def test_grp_precedence(monkeypatch):
    """closest: cbin > stream > rot > grp > chain, grp on the lean carry
    only; any-hit: cbin > stream > grp > chain, grp on any carry. Read at
    every call."""
    monkeypatch.setattr(clustered, "CLUSTERED_SLAB", 0)
    monkeypatch.setattr(clustered, "CLUSTERED_SLABS", 0)
    pick, occ = clustered.closest_scheduler, clustered.occluded_scheduler
    rows = 100352
    for mode in ("1", "2"):
        monkeypatch.setenv("TPT_GRP", mode)
        assert pick(False, True, rows) == "grp" and occ() == "grp"
    monkeypatch.setenv("TPT_GRP", "3")
    assert pick(False, True, rows) == "chain" and occ() == "chain"
    monkeypatch.setenv("TPT_GRP", "1")
    monkeypatch.setenv("TPT_SEED", "1")
    assert pick(False, True, rows) == "rot" and occ() == "grp"
    assert pick(False, False, rows) == "grp"            # no prediction
    monkeypatch.setenv("TPT_STREAM", "1")
    assert pick(False, True, rows) == "stream" and occ() == "stream"
    monkeypatch.setenv("TPT_CBIN", "1")
    assert pick(False, True, rows) == "cbin" and occ() == "cbin"
    assert occ(allow_cbin=False) == "stream"
    monkeypatch.setenv("TPT_STREAM", "0")
    assert occ(allow_cbin=False) == "grp"
    monkeypatch.setenv("TPT_CBIN", "0")
    monkeypatch.setenv("TPT_SEED", "0")
    monkeypatch.setenv("TPT_LEAN_BIG", "0")
    assert pick(False, True, rows) == "chain" and occ() == "grp"
    # The reference's 8 rays a list (its GRP_RT // 8 lists a program);
    # its block shapes (GRP_RT lanes a program, GRP_BUNDLE groups a bundle)
    # have no twin on the card.
    assert ablations.GRP_LANES == 8
    assert pallas_ablations.GRP_RT % ablations.GRP_LANES == 0


def test_grp_wrappers_take_cpu_or_cuda_only(mixed_scenes, monkeypatch):
    """A wrapper runs its plain version only for CPU tensors: a tensor on
    another device raises, and the launch counters stay 0 here."""
    _, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 64)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    meta = torch.empty((64, 8), device="meta")
    for bundled in (False, True):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ablations.closest_grp(meta, rows, boxes, 1.0, None, 0.01,
                                  bundled=bundled)
        with pytest.raises(ValueError, match="CPU or CUDA"):
            ablations.occluded_grp(meta, rows, boxes, 1.0, None, 0.01,
                                   bundled=bundled)
    assert not ablations.LAUNCHES["closest_grp"]
    assert not ablations.LAUNCHES["occluded_grp"]


@pytest.mark.parametrize("picker", ["grp_group", "grp_occ_group",
                                    "rotated_group",
                                    "stream_closest_group",
                                    "stream_occ_group"])
def test_group_pickers_return_built_widths(picker):
    """Every width a picker returns, at any ray count, is one the group
    kernels are built for (``clustered.GROUPS``: csrc/walk.cuh's
    with_group)."""
    pick = getattr(ablations, picker)
    counts = (0, 1, 8, 1000, 32768, 65536, 65537, 262144, 1 << 24)
    assert {pick(n) for n in counts} <= set(clustered.GROUPS)
    assert clustered.GROUPS == (4, 8, 16, 32)


@pytest.mark.parametrize("occluded", [False, True])
@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("group", [None, 4, 32])
def test_grp_launch_takes_width(fake_card, occluded, bundled, group):
    """K15's wrappers pass their lanes a ray (``grp_group`` /
    ``grp_occ_group`` when None) to the kernel, the same launch for either
    body, and raise before any launch on a width the kernels are not built
    for or rays that do not split into groups of GRP_LANES."""
    rows, boxes = _tables()
    n = 64
    rays = torch.zeros((n, 8))
    lists = (torch.zeros((n // 8, 4), dtype=torch.int32),
             torch.zeros((n // 8, 4)), torch.zeros(n // 8, dtype=torch.int32),
             torch.zeros(n))
    name = "occluded_grp" if occluded else "closest_grp"
    fn = getattr(ablations, name)
    pick = ablations.grp_occ_group if occluded else ablations.grp_group
    fn(rays, rows, boxes, 1.0, lists, 0.01, bundled=bundled, group=group)
    (entry, args), = fake_card
    assert entry == "tpt_" + name
    assert args[7:11] == (n, 4, 8, 1.0)
    assert args[-2] == (pick(n) if group is None else group)
    assert ablations.LAUNCHES[name] == 1
    for bad in (1, 12, 64):
        with pytest.raises(ValueError, match="lanes a ray"):
            fn(rays, rows, boxes, 1.0, lists, 0.01, bundled=bundled,
               group=bad)
    with pytest.raises(ValueError, match="groups of"):
        fn(rays[:60], rows, boxes, 1.0, lists, 0.01, bundled=bundled)
    assert len(fake_card) == 1
