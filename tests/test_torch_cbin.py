"""Port parity for K13, the cluster-binned scheduler of
``tpu_pt/intersect/pallas_ablations.py``, as the port builds it for the
card: the schedule ``ablations.cbin_schedule`` (``_cbin_schedule``, its
plain version, derived from ``cbin_pairs``), the folded sweeps
``closest_cbin`` / ``occluded_cbin`` (``_cbin_fold_plain``) at every job
width, and K12's closest hit at its own tile.

(a) At jobs of 64 and 128 lanes, under the settings of
    ``test_torch_ablations.py``'s ``test_cbin_pairs_match_reference`` (flat
    and two-level lists, the exact union and the interval test, g 1 and 8,
    starved caps): ``cbin_pairs`` against the JAX function at the same
    width (culling margin 0: job table, reduce targets and incomplete flags
    bitwise); the new layout against ``cbin_pairs`` (the same job table,
    incomplete flags and meta; each job's slots the groups whose lists hold
    its cluster, each complete group in a slot of every cluster of its
    list); the folded plain sweeps against the reference's reduces
    ``_cbin_reduce`` / ``_cbin_reduce_occ`` over ``_cbin_sweep_plain``, bit
    for bit on every lane; and the fold unchanged when the groups of each
    cluster's run are placed in another order (the card's atomics).
(b) The ``TPT_CBIN=1`` paths at every job width of ``CBIN_JOB_TILES``, and
    the ``TPT_STREAM=1`` closest path at ``STREAM_CLOSEST_TILE``, against
    the dense sweep (bitwise) and the JAX package's ``intersect_closest`` /
    ``intersect_occluded`` under the same variable (interpret mode: hit /
    tri / mat equal and |dt| * |n.d| <= 1e-4 + 4e-6 t, as
    ``test_torch_clustered.py`` states it).
(c) The card side of the wrappers, with the launch recorded, not run
    (``fake_card``): the arguments and buffers of ``tpt_cbin_schedule``,
    ``tpt_closest_cbin`` / ``tpt_occluded_cbin`` and
    ``tpt_closest_streamed``, and the ``ValueError`` for what the kernels
    do not take.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
from tpu_pt_torch.intersect import ablations, clustered, dense  # noqa: E402
from test_torch_ablations import (_cbin_knobs, _clean_env,  # noqa: E402,F401
                                  _jax_cbin, _rays8, _shrink, _test_rays,
                                  mixed_scenes, one_torch_thread)
from test_torch_ablations_paths import _dense, _jax_paths  # noqa: E402
from test_torch_clustered import _assert_same_clustered_hit  # noqa: E402
from test_torch_intersect import _t  # noqa: E402

# (group, lvl, exact, k_out, pair_mult): test_cbin_pairs_match_reference's.
SCHEDULE_CASES = [(1, 1, "1", 32, 12), (1, 2, "1", 32, 12),
                  (8, 1, "1", 32, 12), (8, 1, "0", 32, 12),
                  (8, 2, "1", 32, 12), (1, 1, "1", 2, 1), (1, 2, "1", 3, 12)]


@pytest.fixture(autouse=True)
def _cbin_env(monkeypatch):
    monkeypatch.delenv("TPT_CBIN_EXACT", raising=False)


def _groups_of_runs(schedule):
    """{(cluster, group)} of every used slot."""
    _, g, _ = schedule.meta
    per_job = schedule.rt // g
    out = set()
    for slot, q in enumerate(schedule.slot_group.tolist()):
        if q >= 0:
            out.add((int(schedule.jtab[slot // per_job]), q))
    return out


# --------------------------------------------------------------------------
# (a) the schedule and the fold at jobs of 64 and 128 lanes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("rt", [64, 128])
@pytest.mark.parametrize("group,lvl,exact,k_out,pair_mult", SCHEDULE_CASES)
def test_cbin_schedule_and_fold_at_job_width(mixed_scenes, monkeypatch, group,
                                             lvl, exact, k_out, pair_mult,
                                             rt):
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    monkeypatch.setattr(clustered, "BOX_MARGIN", 0.0)
    monkeypatch.setattr(pallas_bf, "RAY_TILE_C", rt)
    monkeypatch.setenv("TPT_CBIN_EXACT", exact)
    _cbin_knobs(monkeypatch, pair_mult, k_out, group, lvl)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    ns, cluster = boxes.shape[0], rows.shape[0] // boxes.shape[0]
    scale = clustered.box_scale(boxes)
    o, d, so, sd, st = _test_rays(jscene, 256, seed=61)
    for rays8, tmax_j, occluded in ((_rays8(o, d, 1e16), 1e16, False),
                                    (_rays8(so, sd, st), jnp.asarray(st),
                                     True)):
        n = rays8.shape[0]
        pair_rays, jtab, row_tgt, inc, meta = ablations.cbin_pairs(
            rays8, boxes, scale, 0.01, rt)
        jpair, jjtab, jtgt, jinc, jmeta = _jax_cbin(rays8, boxes, tmax_j)
        assert meta == tuple(int(x) for x in jmeta)
        assert jtab.shape == (pair_mult * n // rt,)
        np.testing.assert_array_equal(jtab.numpy(), np.asarray(jjtab)[:, 0])
        np.testing.assert_array_equal(row_tgt.numpy(), np.asarray(jtgt))
        np.testing.assert_array_equal(inc.numpy(), np.asarray(jinc))
        # The new layout (on CPU tensors, its plain version).
        s = ablations.cbin_schedule(rays8, boxes, scale, 0.01, rt)
        assert s.meta == meta and s.rt == rt
        assert torch.equal(s.jtab, jtab) and torch.equal(s.incomplete, inc)
        ng, g, k = meta
        assert s.slot_group.shape == (jtab.shape[0] * (rt // g),)
        c_list, valid, _ = ablations._cbin_lists(rays8, boxes, scale, 0.01, g,
                                                 k)
        placed = _groups_of_runs(s)
        listed = {(int(c), q) for q in range(ng)
                  for c in c_list[q][valid[q]].tolist() if c < ns}
        assert placed <= listed
        complete = ~inc.view(ng, g)[:, 0]
        assert {(c, q) for c, q in listed if complete[q]} <= placed
        assert int((jtab >= 0).sum()) > 0
        # The folded plain sweep is the reference's reduce over the
        # per-pair results, on every lane.
        res = ablations._cbin_sweep_plain(pair_rays, rows, jtab, cluster, rt,
                                          0.01, occluded)
        if occluded:
            want = (ablations._cbin_reduce_occ(res, row_tgt, n, ng, g, k),)
            got = (ablations.occluded_cbin(rays8, rows, s, cluster, 0.01),)
        else:
            want = ablations._cbin_reduce(*res, row_tgt, n, ng, g, k)
            got = ablations.closest_cbin(rays8, rows, s, cluster, 0.01)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        # The groups of each cluster's run in another order (as the card's
        # atomics may place them): the same fold.
        gen = torch.Generator().manual_seed(rt + group)
        slots = s.slot_group.clone()
        jt = s.jtab.repeat_interleave(rt // g)
        for c in s.jtab[s.jtab >= 0].unique().tolist():
            at = (jt == c).nonzero()[:, 0]
            slots[at] = slots[at][torch.randperm(at.numel(), generator=gen)]
        shuffled = s._replace(slot_group=slots)
        fold = (ablations.occluded_cbin if occluded
                else ablations.closest_cbin)(rays8, rows, shuffled, cluster,
                                             0.01)
        assert all(torch.equal(a, b) for a, b in zip(
            fold if not occluded else (fold,), got))


# --------------------------------------------------------------------------
# (b) the paths at every width
# --------------------------------------------------------------------------

@pytest.mark.parametrize("caps", [(12, 32, 1, 0), (1, 2, 8, 2)])
@pytest.mark.parametrize("rt", ablations.CBIN_JOB_TILES)
def test_cbin_paths_at_every_job_width(mixed_scenes, monkeypatch, rt, caps):
    """The default caps and starved ones (most lanes through the
    completion pass, groups of 8, the two-level lists)."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setenv("TPT_CBIN", "1")
    monkeypatch.setattr(ablations, "CBIN_JOB_TILE", rt)
    _cbin_knobs(monkeypatch, *caps)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None                  # shadow rays over the table
    o, d, so, sd, st = _test_rays(jscene, 300, seed=62)
    ref = _dense(tables, o, d, so, sd, st)
    h = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    occ = clustered.occluded_hit(tables, _t(so), _t(sd), _t(st))
    assert torch.equal(h.t, ref[0]) and torch.equal(occ, ref[2])
    assert torch.equal(h.tri, torch.where(
        h.hit, tables.rows[ref[1].long(), 15], 0.0).int())
    rays8 = ablations.pack_rays(_t(o), _t(d), 1e16,
                                ablations._pad_tile(o.shape[0], 256))
    share = float(ablations.cbin_schedule(
        rays8, tables.boxes, tables.scale, 0.01, rt).incomplete.float()
        .mean())
    assert (share > 0.5) if caps[0] == 1 else (share < 0.5)
    j, jocc = _jax_paths(jscene, o, d, so, sd, st)
    _assert_same_clustered_hit(j, h, o, d, tscene)
    np.testing.assert_array_equal(occ.numpy(), jocc)


@pytest.mark.parametrize("guard", ["1", "0"])
def test_streamed_closest_at_its_tile(mixed_scenes, monkeypatch, guard):
    """``TPT_STREAM=1``'s closest hit at the shipped STREAM_CLOSEST_TILE,
    with the guard on and off, and a finite tmax."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setenv("TPT_STREAM", "1")
    monkeypatch.setenv("TPT_STREAM_GUARD", guard)
    tables = clustered.prepare(tscene)
    o, d, so, sd, st = _test_rays(jscene, 300, seed=63)
    ref_t, ref_row = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
    args = (tables.rows, tables.boxes, tables.scale, 0.01)
    t, row = ablations.closest_stream_path(_t(o), _t(d), *args)
    assert torch.equal(t, ref_t) and torch.equal(row, ref_row)
    t6, row6 = ablations.closest_stream_path(_t(o), _t(d), *args, tmax=600.0)
    ref6 = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, 600.0)
    assert torch.equal(t6, ref6[0]) and torch.equal(row6, ref6[1])
    h = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    assert torch.equal(h.t, t)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    _assert_same_clustered_hit(j, h, o, d, tscene)


# --------------------------------------------------------------------------
# (c) the card side of the wrappers
# --------------------------------------------------------------------------

@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' card side on CPU tensors: every tensor counts as on
    the card, and each launch is recorded as (entry point, arguments), not
    run; the launch counters are a copy."""
    from tpu_pt_torch import _kernels
    calls = []
    monkeypatch.setattr(dense, "_on_cpu", lambda x: False)
    monkeypatch.setattr(dense, "_stream", lambda dev: None)
    monkeypatch.setattr(_kernels, "launch",
                        lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(ablations, "LAUNCHES",
                        dict.fromkeys(ablations.LAUNCHES, 0))
    return calls


@pytest.mark.parametrize("rt", ablations.CBIN_JOB_TILES)
@pytest.mark.parametrize("group,lvl,exact,ns,mode", [
    (1, 0, "1", 784, 2), (1, 0, "1", 100, 0), (1, 1, "1", 784, 0),
    (8, 0, "1", 784, 1), (8, 1, "0", 784, 0), (8, 2, "1", 40, 2),
    (32, 1, "1", 40, 1)])
def test_cbin_card_side_sizes(fake_card, monkeypatch, rt, group, lvl, exact,
                              ns, mode):
    """On the card, cbin_schedule launches tpt_cbin_schedule once with the
    group size, the list cap, the job width, the pair budget and the
    test of _cbin_lists (flat interval 0, flat exact union 1, two-level 2),
    into a job table of CBIN_PAIR_MULT n / rt jobs of rt / g slots; the
    folded kernels take the layout from it."""
    monkeypatch.setenv("TPT_CBIN_EXACT", exact)
    monkeypatch.setattr(ablations, "CBIN_GROUP", group)
    monkeypatch.setattr(ablations, "CBIN_LVL", lvl)
    n = 3 * 256
    rays, boxes = torch.zeros((n, 8)), torch.zeros((ns, 8))
    s = ablations.cbin_schedule(rays, boxes, 1.0, 0.01, rt)
    (name, args), = fake_card
    assert name == "tpt_cbin_schedule"
    j_cap, g = ablations.CBIN_PAIR_MULT * n // rt, min(group, rt)
    k1 = min(ablations.CBIN_K1, -(-ns // ablations.CBIN_FAN))
    lanes = max(g, ablations.CBIN_LIST_LANES)
    assert args[2:12] == (n, ns, g, ablations.CBIN_K_OUT, rt, j_cap, mode,
                          ablations.CBIN_FAN, k1, lanes)
    assert (args[15] is None) == (mode != 2)         # the parents' boxes
    assert s.meta == (n // g, g, ablations.CBIN_K_OUT) and s.rt == rt
    assert s.jtab.shape == (j_cap,) and s.jtab.dtype == torch.int32
    assert s.slot_group.shape == (j_cap * (rt // g),)
    assert s.incomplete.shape == (n,) and s.incomplete.dtype == torch.bool
    assert ablations.LAUNCHES["cbin_schedule"] == 1
    tris = torch.zeros((ns * 64, 16))
    t, row = ablations.closest_cbin(rays, tris, s, 64, 0.01)
    occ = ablations.occluded_cbin(rays, tris, s, 64, 0.01)
    assert t.shape == row.shape == occ.shape == (n,)
    assert [c[0] for c in fake_card[1:]] == ["tpt_closest_cbin",
                                             "tpt_occluded_cbin"]
    assert all(c[1][4:9] == (j_cap, rt, g, n, 64) for c in fake_card[1:])
    assert ablations.LAUNCHES["closest_cbin"] == 1
    assert ablations.LAUNCHES["occluded_cbin"] == 1
    ablations.cbin_schedule(rays, boxes, 1.0, 0.01, rt, lanes=32)
    assert fake_card[-1][1][11] == 32


def test_cbin_wrappers_raise_on_what_the_kernels_do_not_take(fake_card,
                                                             monkeypatch):
    """Job widths, groups, parent lists, list lanes and clusters past the
    kernels' caps, bad shapes and dtypes: a ValueError naming the limit,
    before any launch."""
    n = 256
    rays, boxes = torch.zeros((n, 8)), torch.zeros((40, 8))
    with pytest.raises(ValueError, match="jobs of 96"):
        ablations.cbin_schedule(rays, boxes, 1.0, 0.01, 96)
    with pytest.raises(ValueError, match="do not split into jobs"):
        ablations.cbin_schedule(rays[:200], boxes, 1.0, 0.01, 128)
    with pytest.raises(ValueError, match="at least one box"):
        ablations.cbin_schedule(rays, boxes[:0], 1.0, 0.01, 64)
    with pytest.raises(ValueError, match="lanes a group"):
        ablations.cbin_schedule(rays, boxes, 1.0, 0.01, 64, lanes=3)
    monkeypatch.setattr(ablations, "CBIN_GROUP", 64)
    with pytest.raises(ValueError, match="at most 32 rays"):
        ablations.cbin_schedule(rays, boxes, 1.0, 0.01, 128)
    monkeypatch.setattr(ablations, "CBIN_GROUP", 16)
    with pytest.raises(ValueError, match="lanes a group of 16"):
        ablations.cbin_schedule(rays, boxes, 1.0, 0.01, 128, lanes=8)
    monkeypatch.setattr(ablations, "CBIN_GROUP", 1)
    monkeypatch.setattr(ablations, "CBIN_LVL", 2)
    monkeypatch.setattr(ablations, "CBIN_FAN", 1)
    monkeypatch.setattr(ablations, "CBIN_K1", 65)
    with pytest.raises(ValueError, match="at most 64 parents"):
        ablations.cbin_schedule(rays, boxes.repeat(4, 1), 1.0, 0.01, 64)
    monkeypatch.setattr(ablations, "CBIN_K1", 16)
    with pytest.raises(ValueError, match="dtype"):
        ablations.cbin_schedule(rays.double(), boxes, 1.0, 0.01, 64)
    assert not fake_card
    s = ablations.cbin_schedule(rays, boxes, 1.0, 0.01, 64)
    tris = torch.zeros((40 * 64, 16))
    with pytest.raises(ValueError, match="at most 128"):
        ablations.closest_cbin(rays, torch.zeros((40 * 256, 16)), s, 256,
                               0.01)
    with pytest.raises(ValueError, match="jobs of 96"):
        ablations.occluded_cbin(rays, tris, s._replace(rt=96), 64, 0.01)
    with pytest.raises(ValueError, match="shape"):
        ablations.closest_cbin(rays, tris,
                               s._replace(slot_group=s.slot_group[:-1]), 64,
                               0.01)
    with pytest.raises(ValueError, match="dtype"):
        ablations.occluded_cbin(rays, tris, s._replace(jtab=s.jtab.long()),
                                64, 0.01)
    with pytest.raises(ValueError, match="groups of"):
        ablations.closest_cbin(rays[:128], tris, s, 64, 0.01)
    assert len(fake_card) == 1


@pytest.mark.parametrize("rt", [1, 3, 64, 128, 512])
def test_closest_streamed_takes_any_tile(fake_card, rt):
    """K12's closest hit on the card takes any tile width that divides the
    rays (no cap of 256), and a ray's lanes from stream_closest_group or
    the caller, one of the widths it is built for."""
    n, ns = 2 * rt * 32, 20
    rays, boxes = torch.zeros((n, 8)), torch.zeros((ns, 8))
    tris = torch.zeros((ns * 16, 16))
    lists = (torch.zeros((n // rt, ns), dtype=torch.int32),
             torch.zeros((n // rt, ns)), torch.zeros(n // rt, dtype=torch.int32),
             torch.zeros(n))
    t, row = ablations.closest_streamed(rays, tris, boxes, 1.0, lists, rt,
                                        0.01)
    assert t.shape == row.shape == (n,)
    (name, args), = fake_card
    assert name == "tpt_closest_streamed"
    assert args[7:11] == (n, ns, 16, rt)
    assert args[18] == ablations.stream_closest_group(n)
    for g in clustered.GROUPS:
        ablations.closest_streamed(rays, tris, boxes, 1.0, lists, rt, 0.01,
                                   group=g)
        assert fake_card[-1][1][18] == g
    with pytest.raises(ValueError, match="lanes a ray"):
        ablations.closest_streamed(rays, tris, boxes, 1.0, lists, rt, 0.01,
                                   group=2)
    with pytest.raises(ValueError, match="tiles of"):
        ablations.closest_streamed(rays[:n - 1], tris, boxes, 1.0, lists,
                                   n, 0.01)
    assert ablations.LAUNCHES["closest_streamed"] == 1 + len(clustered.GROUPS)


@pytest.mark.parametrize("n_rays", [1, 77, 32768, 65536, 65537, 262144])
def test_stream_closest_widths_are_built(n_rays):
    """K12's closest tile is one the list build takes and a divisor of
    K13's padding; its lanes a ray one of the widths it is built for."""
    assert ablations.stream_closest_group(n_rays) in clustered.GROUPS
    assert 1 <= ablations.STREAM_CLOSEST_TILE <= ablations.LIST_MAX_TILE
    assert ablations.CBIN_JOB_TILE in ablations.CBIN_JOB_TILES
    assert ablations.RAY_TILE_C == 256          # the reference's, unchanged
