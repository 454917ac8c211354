"""Port parity for the first three scheduler families of
``tpu_pt/intersect/pallas_ablations.py``: tpu_pt_torch.intersect.ablations
(the CPU path of the CUDA kernels K11 rotated, K12 streamed, K13
cluster-binned) and their dispatch in ``clustered``.

(a) The schedule builds (``stream_candidates``, ``cbin_pairs``,
    ``_interval_slab``, ``_clustered_slab_rows``, the slab-order rule)
    against the JAX functions on the same numpy-seeded rays and the same
    un-grown boxes. With the port's culling margin set to 0 the two test
    the same boxes and must agree exactly (counts, membership, job
    tables); with the margin on, the port's lists may only grow (a
    superset per tile).
(b) (in test_torch_ablations_paths.py, so that the two files run on
    two tier-1 workers) The plain versions, which follow the schedules
    step by step, against the dense sweep ``dense._closest_plain`` / ``_occluded_plain``, bit
    for bit, over the cases of ``tests/test_pallas_bf.py``'s
    ``test_streamed_matches_chained``, ``test_cbin_matches_chained`` and
    ``test_rotated_chain_exact_with_wrong_predictions``.
(c) (same file) The same entry points against the JAX package under the same
    variable, its kernels in interpret mode: hit / tri / mat equal and
    |dt| * |n.d| <= 1e-4 + 4e-6 t, as ``test_torch_clustered.py`` states
    it.
(d) A forced-clustered 16^2 x 4 spp pixelq frame under each variable, and
    under ``TPT_PRED=0``, bitwise equal to the default frame.
(e) The precedence of the variables, read at call time.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import tpu_pt  # noqa: E402
from tpu_pt.intersect import pallas_ablations, pallas_bf  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import (SLAB_UNKNOWN, ablations,  # noqa: E402
                                    clustered, dense, get_intersectors)
from tpu_pt_torch.render import CameraArrays, init_accum, render_frame  # noqa: E402
from tpu_pt_torch.scene import scene_from_numpy  # noqa: E402
from test_torch_intersect import _rays, _t  # noqa: E402
from test_torch_render import BASE  # noqa: E402
from test_torch_scene import numpy_leaves  # noqa: E402

VARIABLES = ("TPT_SEED", "TPT_STREAM", "TPT_CBIN", "TPT_PRED", "TPT_INKB",
             "TPT_LEAN_BIG", "TPT_LEAN_UV", "TPT_SORT_KEY", "TPT_CBIN_OCC",
             "TPT_CBIN_EXACT", "TPT_STREAM_GUARD")
CBIN_CASES = [(12, 32, 8, 1), (12, 32, 1, 1), (12, 48, 32, 1), (1, 2, 8, 1),
              (12, 32, 1, 2), (12, 32, 8, 2), (12, 3, 1, 2)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in VARIABLES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tier-1 workers share the machine's cores; PyTorch's intra-op
    threads would spin against them (see test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mixed_scenes(mixed_scene):
    return mixed_scene, scene_from_numpy(numpy_leaves(mixed_scene),
                                         mixed_scene.num_tris,
                                         mixed_scene.num_occluders,
                                         device="cpu")


def _shrink(monkeypatch, cluster=64, slab=256):
    """The mixed box (512 packed rows) on the clustered path of both
    packages: clusters of ``cluster`` rows (the JAX package pairs them
    into superclusters), slabs of ``slab`` rows."""
    monkeypatch.setattr(pallas_bf, "TRI_SLAB", 256)
    monkeypatch.setattr(pallas_bf, "CLUSTERED_SLAB", slab)
    monkeypatch.setattr(pallas_bf, "CLUSTER", cluster)
    monkeypatch.setattr(pallas_bf, "SUPER", 2)
    monkeypatch.setattr(dense, "TRI_SLAB", 256)
    monkeypatch.setattr(clustered, "CLUSTER", cluster)
    monkeypatch.setattr(clustered, "CLUSTERED_SLAB", slab)


def _cbin_knobs(monkeypatch, pair_mult, k_out, group, lvl):
    for module in (pallas_ablations, ablations):
        monkeypatch.setattr(module, "CBIN_PAIR_MULT", pair_mult)
        monkeypatch.setattr(module, "CBIN_K_OUT", k_out)
        monkeypatch.setattr(module, "CBIN_GROUP", group)
        monkeypatch.setattr(module, "CBIN_LVL", lvl)
        monkeypatch.setattr(module, "CBIN_FAN", 2)
        monkeypatch.setattr(module, "CBIN_K1", 3)


def _test_rays(jscene, n, seed):
    """2n closest rays and 2n shadow rays (n toward the light, n capped at
    2.5), each set with every eighth lane parked."""
    o, d, p, ld, tmax = _rays(jscene, n, seed=seed)
    so, sd = np.concatenate([p, o[n:]]), np.concatenate([ld, d[n:]])
    st = np.concatenate([tmax, np.full(n, 2.5, np.float32)])
    park = np.arange(2 * n) % 8 == 0
    o, so = (np.where(park[:, None], np.float32(3.0e7), x) for x in (o, so))
    d, sd = (np.where(park[:, None], np.float32(0.5773503), x)
             for x in (d, sd))
    return (o.astype(np.float32), d.astype(np.float32),
            so.astype(np.float32), sd.astype(np.float32),
            np.where(park, np.float32(0.0), st).astype(np.float32))


def _rays8(o, d, tmax):
    return ablations.pack_rays(_t(o), _t(d), tmax if np.isscalar(tmax)
                               else _t(tmax), o.shape[0])


# --------------------------------------------------------------------------
# (a) the schedule builds against the JAX functions
# --------------------------------------------------------------------------

def _jax_stream_lists(rays8, boxes, rt, tmax):
    ns = boxes.shape[0]
    tab, keys = pallas_ablations.stream_candidates(
        jnp.asarray(rays8.numpy().T), jnp.asarray(boxes.numpy()), rt, 0.01,
        tmax)
    tab = np.asarray(tab).reshape(rays8.shape[0] // rt, -1)
    keys = np.asarray(keys).reshape(tab.shape)
    return tab[:, 0], tab[:, 1:1 + ns], keys[:, 1:1 + ns]


@pytest.mark.parametrize("margin", [0.0, None])
def test_stream_candidates_match_reference(mixed_scenes, monkeypatch, margin):
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    if margin is not None:
        monkeypatch.setattr(clustered, "BOX_MARGIN", margin)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    scale = clustered.box_scale(boxes)
    o, d, so, sd, st = _test_rays(jscene, 256, seed=21)
    for rays8, tmax_j, tmax_t in (
            (_rays8(o, d, 1e16), 1e16, 1e16),
            (_rays8(so, sd, st), jnp.asarray(st), _t(st))):
        cand, keys, cnt, far = ablations.stream_candidates(
            rays8, boxes, scale, 64, 0.01, tmax_t)
        jcnt, jorder, jkeys = _jax_stream_lists(rays8, boxes, 64, tmax_j)
        assert cnt.shape == (8,) and 0 < int(cnt.sum()) < 8 * 32
        for tile in range(8):
            ours = set(cand[tile, :cnt[tile]].tolist())
            ref = set(jorder[tile, :jcnt[tile]].tolist())
            if margin == 0.0:
                # The same boxes, the same test: the same lists in the
                # same order (equal keys keep ascending box order).
                assert cand[tile, :cnt[tile]].tolist() \
                    == jorder[tile, :jcnt[tile]].tolist()
                np.testing.assert_array_equal(
                    keys[tile, :cnt[tile]].numpy(), jkeys[tile, :jcnt[tile]])
            else:
                # Boxes grown by the margin: the list may only grow.
                assert ref <= ours and len(ours) <= len(ref) + 4
        # Keys ascend; unlisted boxes carry T_FAR; far is the last entry
        # of a lane's own boxes.
        assert bool((keys[:, 1:] >= keys[:, :-1]).all())
        listed = torch.arange(32)[None] < cnt[:, None]
        assert bool((keys[~listed] == 1e16).all())
        assert bool((far.view(8, 64).amax(1) <= 1e16).all())
        assert bool((far[::8] < -1e38).all())           # parked lanes


def _jax_cbin(rays8, boxes, tmax):
    return pallas_ablations.cbin_pairs(
        jnp.asarray(rays8.numpy().T), jnp.asarray(boxes.numpy()), 0.01, tmax)


@pytest.mark.parametrize("group,lvl,exact,k_out,pair_mult", [
    (1, 1, "1", 32, 12), (1, 2, "1", 32, 12), (8, 1, "1", 32, 12),
    (8, 1, "0", 32, 12), (8, 2, "1", 32, 12), (1, 1, "1", 2, 1),
    (1, 2, "1", 3, 12)])
def test_cbin_pairs_match_reference(mixed_scenes, monkeypatch, group, lvl,
                                    exact, k_out, pair_mult):
    """At margin 0 the job table, the reduce targets, the pair rays and
    the incomplete flags equal the JAX function's, for the flat and the
    two-level lists, the exact union and the interval test, and starved
    caps."""
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    monkeypatch.setattr(clustered, "BOX_MARGIN", 0.0)
    monkeypatch.setenv("TPT_CBIN_EXACT", exact)
    _cbin_knobs(monkeypatch, pair_mult, k_out, group, lvl)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    o, d, so, sd, st = _test_rays(jscene, 256, seed=22)
    for rays8, tmax_j in ((_rays8(o, d, 1e16), 1e16),
                          (_rays8(so, sd, st), jnp.asarray(st))):
        pair_rays, jtab, row_tgt, inc, meta = ablations.cbin_pairs(
            rays8, boxes, clustered.box_scale(boxes), 0.01)
        jpair, jjtab, jtgt, jinc, jmeta = _jax_cbin(rays8, boxes, tmax_j)
        assert meta == tuple(int(x) for x in jmeta)
        np.testing.assert_array_equal(jtab.numpy(), np.asarray(jjtab)[:, 0])
        np.testing.assert_array_equal(row_tgt.numpy(), np.asarray(jtgt))
        np.testing.assert_array_equal(inc.numpy(), np.asarray(jinc))
        np.testing.assert_array_equal(pair_rays.numpy(), np.asarray(jpair).T)
        assert int((jtab >= 0).sum()) > 0
        if k_out <= 3:
            assert 0.2 < float(inc.float().mean()) < 1.0


def test_cbin_lists_grow_with_margin(mixed_scenes, monkeypatch):
    """With the margin on, a group's list holds at least the clusters the
    JAX lists hold (compared as sets per ray at g = 1)."""
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    _cbin_knobs(monkeypatch, 12, 32, 1, 1)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    o, d, *_ = _test_rays(jscene, 256, seed=23)
    rays8 = _rays8(o, d, 1e16)
    c_list, valid, inc = ablations._cbin_lists(
        rays8, boxes, clustered.box_scale(boxes), 0.01, 1, 32)
    jc, jvalid, jinc = pallas_ablations._cbin_lists(
        jnp.asarray(rays8.numpy().T), jnp.asarray(boxes.numpy()), 0.01, 1e16,
        1, 32)
    assert not bool(inc.any()) and not bool(np.asarray(jinc).any())
    jc = np.asarray(jc)
    extra = 0
    for r in range(rays8.shape[0]):
        ours = set(c_list[r][valid[r]].tolist())
        ref = set(jc[r][jc[r] >= 0].tolist())
        assert ref <= ours
        extra += len(ours) - len(ref)
    assert extra <= 0.02 * int(valid.sum())


@pytest.mark.parametrize("g", [1, 8])
def test_interval_slab_matches_reference(mixed_scenes, monkeypatch, g):
    jscene, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 16)
    monkeypatch.setattr(clustered, "BOX_MARGIN", 0.0)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    _, _, so, sd, st = _test_rays(jscene, 256, seed=24)
    rays8 = _rays8(so, sd, st)
    bounds = ablations._cbin_ray_bounds(rays8, clustered.box_scale(boxes), g)
    jbounds = pallas_ablations._cbin_ray_bounds(
        jnp.asarray(rays8.numpy().T), jnp.asarray(st), g)
    for ours, ref in zip(bounds[:4], jbounds[:4]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref).T)
    np.testing.assert_array_equal(bounds[4].numpy(), np.asarray(jbounds[4]))
    np.testing.assert_array_equal(bounds[5].numpy(), np.asarray(jbounds[5]))
    assert not bool(bounds[6].any())                      # margin 0
    ok = ablations._interval_slab(bounds, boxes[None, :, 0:3],
                                  boxes[None, :, 3:6], 0.01)
    jboxes = jnp.asarray(boxes.numpy())
    jok = pallas_ablations._interval_slab(jbounds, jboxes[None, :, 0:3],
                                          jboxes[None, :, 3:6], 0.01)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert 0.02 < float(ok.float().mean()) < 0.99


def test_slab_rows_and_order_match_reference(monkeypatch):
    monkeypatch.setattr(pallas_bf, "CLUSTER", 128)
    monkeypatch.setattr(pallas_bf, "SUPER", 1)
    for name, value in (("CLUSTERED_SLAB", 0), ("CLUSTERED_SLABS", 0)):
        monkeypatch.setattr(pallas_bf, name, value)
        monkeypatch.setattr(clustered, name, value)
    for n_rows in (8320, 100352, 492032, 1001472, 5_000_000):
        assert clustered._clustered_slab_rows(n_rows) \
            == pallas_bf._clustered_slab_rows(n_rows)
    assert clustered._clustered_slab_rows(100352) == 7168     # 14 slabs
    monkeypatch.setattr(pallas_bf, "CLUSTERED_SLABS", 5)
    monkeypatch.setattr(clustered, "CLUSTERED_SLABS", 5)
    assert clustered._clustered_slab_rows(100352) \
        == pallas_bf._clustered_slab_rows(100352)
    assert clustered.SLAB_UNKNOWN == tpu_pt.intersect.SLAB_UNKNOWN \
        == SLAB_UNKNOWN
    # The per-tile visit order, pallas_bf.py:2427-2434.
    s_count = 7
    tile_pred = np.array([0, 3, 6, 7, SLAB_UNKNOWN, 1], np.int32)
    order = ablations.rotated_slab_order(torch.as_tensor(tile_pred).long(),
                                         s_count).numpy()
    pred_eff = jnp.where(jnp.asarray(tile_pred) >= s_count, 0,
                         jnp.asarray(tile_pred))
    for j in range(s_count):
        sid_j = pred_eff if j == 0 else jnp.where(
            jnp.int32(j - 1) < pred_eff, jnp.int32(j - 1), jnp.int32(j))
        np.testing.assert_array_equal(order[j], np.asarray(sid_j))
    assert all(sorted(col) == list(range(s_count)) for col in order.T)
    # A tile's first slab: its lanes' most frequent prediction, ties to
    # the lowest slab, unknown and out-of-range ones as slab 0.
    pred = torch.tensor([3] * 20 + [5] * 12 + [2] * 16 + [4] * 16
                        + [SLAB_UNKNOWN] * 30 + [6, 6] + [1] * 5)
    assert ablations._tile_pred(pred, s_count, 32).tolist() == [3, 2, 0, 0]


# --------------------------------------------------------------------------
# (d) frames, (e) precedence
# --------------------------------------------------------------------------

def _frame(tscene, **cfg_kw):
    cfg = tp.RenderConfig(**{**BASE, **dict(
        width=16, height=16, spp=4, max_depth=4, use_direct_lighting=True,
        use_importance_sampling=True, intersector="dense",
        scheduler="pixelq"), **cfg_kw})
    cam = CameraArrays.from_camera(tp.cornell_default_camera(), device="cpu")
    accum, _, stats = render_frame(tscene, cam, cfg, 0,
                                   init_accum(cfg, device="cpu"))
    return accum.clone(), stats


@pytest.mark.parametrize("variable", ["TPT_SEED", "TPT_STREAM", "TPT_CBIN",
                                      "TPT_PRED"])
def test_frame_bitwise_invariant(mixed_scenes, monkeypatch, variable):
    """A forced-clustered pixelq frame: the schedulers and the landing-slab
    prediction order work only."""
    _, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    monkeypatch.setattr(ablations, "RAY_TILE_C", 64)
    tscene = tscene.to("cpu")
    tscene.num_occluders = -1               # shadow rays over the table
    base, stats = _frame(tscene)
    assert int(stats.done_histogram[4]) == 0 and float(base.mean()) > 0.01
    calls = []
    for name in ("closest_rotated", "closest_stream_path",
                 "occluded_stream_path", "closest_cbin_path",
                 "occluded_cbin_path"):
        fn = getattr(ablations, name)
        monkeypatch.setattr(ablations, name,
                            lambda *a, _fn=fn, _n=name, **kw:
                            (calls.append(_n), _fn(*a, **kw))[1])
    monkeypatch.setenv(variable, "0" if variable == "TPT_PRED" else "1")
    accum, _ = _frame(tscene)
    assert torch.equal(accum, base)
    expect = {"TPT_SEED": {"closest_rotated"},
              "TPT_STREAM": {"closest_stream_path", "occluded_stream_path"},
              "TPT_CBIN": {"closest_cbin_path", "occluded_cbin_path"},
              "TPT_PRED": set()}[variable]
    assert set(calls) == expect


def test_pred_is_carried(mixed_scenes, monkeypatch):
    """pixelq hands the clustered lean path real predictions: after the
    first round most live lanes predict a slab, and ``supports_pred``
    follows the reference's condition."""
    _, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    cfg = tp.RenderConfig(width=8, height=8, intersector="dense")
    closest, _ = get_intersectors(tscene, cfg, want_uv=False)
    assert closest.supports_pred
    assert not get_intersectors(tscene, cfg, want_uv=True)[0].supports_pred
    for name in ("TPT_PRED", "TPT_LEAN_BIG"):
        monkeypatch.setenv(name, "0")
        assert not get_intersectors(tscene, cfg,
                                    want_uv=False)[0].supports_pred
        monkeypatch.delenv(name)
    monkeypatch.setattr(dense, "TRI_SLAB", 8192)
    assert not getattr(get_intersectors(tscene, cfg, want_uv=False)[0],
                       "supports_pred", False)
    monkeypatch.setattr(dense, "TRI_SLAB", 256)
    seen = []
    real = clustered.closest_hit

    def spy(tables, o, d, **kw):
        if kw.get("pred") is not None:
            seen.append(kw["pred"].clone())
        return real(tables, o, d, **kw)
    monkeypatch.setattr(clustered, "closest_hit", spy)
    _frame(tscene)
    assert len(seen) > 4
    assert bool((seen[0] == SLAB_UNKNOWN).all())
    known = [float((p != SLAB_UNKNOWN).float().mean()) for p in seen[1:4]]
    assert min(known) > 0.3
    assert all(int(p[p != SLAB_UNKNOWN].max()) < 8 for p in seen[1:4])


def test_scheduler_precedence(monkeypatch):
    """closest: cbin > stream > rot > chain, all on the lean carry only;
    rot needs a prediction, the dir12 sort key and more than one slab.
    occluded: cbin (unless TPT_CBIN_OCC=0) > stream > chain. Read at every
    call."""
    monkeypatch.setattr(clustered, "CLUSTERED_SLAB", 0)
    monkeypatch.setattr(clustered, "CLUSTERED_SLABS", 0)
    pick, occ = clustered.closest_scheduler, clustered.occluded_scheduler
    rows = 100352
    assert pick(False, True, rows) == "chain" and occ() == "chain"
    monkeypatch.setenv("TPT_SEED", "1")
    assert pick(False, True, rows) == "rot" and occ() == "chain"
    assert pick(False, False, rows) == "chain"          # no prediction
    assert pick(False, True, 1024) == "chain"           # one slab
    monkeypatch.setenv("TPT_SORT_KEY", "morton")
    assert pick(False, True, rows) == "chain"
    monkeypatch.setenv("TPT_SORT_KEY", "dir12")
    assert pick(False, True, rows) == "rot"
    monkeypatch.setenv("TPT_STREAM", "1")
    assert pick(False, True, rows) == "stream" and occ() == "stream"
    monkeypatch.setenv("TPT_CBIN", "1")
    assert pick(False, True, rows) == "cbin" and occ() == "cbin"
    assert occ(allow_cbin=False) == "stream"
    monkeypatch.setenv("TPT_CBIN_OCC", "0")
    assert pick(False, True, rows) == "cbin" and occ() == "stream"
    monkeypatch.setenv("TPT_STREAM", "0")
    assert occ() == "chain"
    # The full carry takes none of them.
    monkeypatch.setenv("TPT_LEAN_BIG", "0")
    assert pick(False, True, rows) == "chain"
    monkeypatch.setenv("TPT_LEAN_BIG", "1")
    monkeypatch.setenv("TPT_LEAN_UV", "0")
    assert pick(True, True, rows) == "chain"
    assert pick(False, True, rows) == "cbin"
    assert clustered.variant(False) == (False, False)


def test_wrappers_take_cpu_or_cuda_only(mixed_scenes, monkeypatch):
    """A wrapper runs its plain version only for CPU tensors: a tensor on
    another device raises, and the launch counters stay 0 here."""
    _, tscene = mixed_scenes
    monkeypatch.setattr(clustered, "CLUSTER", 64)
    rows, boxes = clustered.pack_tris_clustered(tscene)
    meta = torch.empty((64, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ablations.closest_streamed(meta, rows, boxes, 1.0, None, 64, 0.01)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ablations.occluded_cbin(meta, rows, None, 64, 64, 0.01)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ablations.closest_rotated(meta[:, :3], meta[:, :3], rows, boxes, 1.0,
                                  None, 64, 0.01)
    assert set(ablations.LAUNCHES) == {
        "closest_rotated", "closest_streamed", "occluded_streamed",
        "closest_cbin", "occluded_cbin", "closest_binned", "occluded_binned",
        "closest_grp", "occluded_grp"}
    assert not any(ablations.LAUNCHES.values())
