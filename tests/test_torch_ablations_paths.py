"""Port parity for K11 rotated, K12 streamed and K13 cluster-binned,
whole paths: parts (b) and (c) of test_torch_ablations.py (its docstring
states the bounds), kept in a file of their own so that tier-1 runs the
two on two workers.

(b) The plain versions, which follow the schedules step by step, against
    the dense sweep ``dense._closest_plain`` / ``_occluded_plain``, bit
    for bit, over the cases of ``tests/test_pallas_bf.py``'s
    ``test_streamed_matches_chained``, ``test_cbin_matches_chained`` and
    ``test_rotated_chain_exact_with_wrong_predictions``.
(c) The same entry points against the JAX package under the same
    variable, its kernels in interpret mode: hit / tri / mat equal and
    |dt| * |n.d| <= 1e-4 + 4e-6 t, as ``test_torch_clustered.py`` states
    it.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
from tpu_pt_torch.intersect import (SLAB_UNKNOWN, ablations,  # noqa: E402
                                    clustered, dense)
from test_torch_ablations import (CBIN_CASES, _cbin_knobs,  # noqa: E402,F401
                                  _clean_env, _shrink, _test_rays,
                                  mixed_scenes, one_torch_thread)
from test_torch_clustered import _assert_same_clustered_hit  # noqa: E402
from test_torch_intersect import _t  # noqa: E402


# --------------------------------------------------------------------------
# (b) the plain versions against the dense sweep, (c) against the JAX
# package under the same variable
# --------------------------------------------------------------------------

def _dense(tables, o, d, so, sd, st, tmax=1e16):
    t, row = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, tmax)
    return t, row, dense._occluded_plain(_t(so), _t(sd), _t(st), tables.rows,
                                         0.01)


def _same_as_dense(tables, ref, t, row, occ):
    assert torch.equal(t, ref[0]) and torch.equal(row, ref[1])
    assert torch.equal(occ, ref[2])


def _jax_paths(jscene, o, d, so, sd, st):
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    jocc = pallas_bf._intersect_occluded_tiled(
        jscene, jnp.asarray(so), jnp.asarray(sd), jnp.asarray(st))
    return j, np.asarray(jocc)


@pytest.mark.parametrize("guard", ["1", "0"])
def test_streamed_matches_dense_and_reference(mixed_scenes, monkeypatch,
                                              guard):
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setattr(ablations, "RAY_TILE_C", 64)
    monkeypatch.setenv("TPT_STREAM", "1")
    monkeypatch.setenv("TPT_STREAM_GUARD", guard)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None                  # shadow rays over the table
    o, d, so, sd, st = _test_rays(jscene, 500, seed=31)
    ref = _dense(tables, o, d, so, sd, st)
    args = (tables.rows, tables.boxes, tables.scale, 0.01)
    t, row = ablations.closest_stream_path(_t(o), _t(d), *args)
    occ = ablations.occluded_stream_path(_t(so), _t(sd), _t(st), *args)
    _same_as_dense(tables, ref, t, row, occ)
    assert 0.3 < float((t < 1e15).float().mean()) < 1.0
    assert 0.05 < float(occ.float().mean()) < 0.95
    # A finite tmax clips as the dense sweep does.
    t6, row6 = ablations.closest_stream_path(_t(o), _t(d), *args, tmax=600.0)
    ref6 = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, 600.0)
    assert torch.equal(t6, ref6[0]) and torch.equal(row6, ref6[1])
    assert not torch.equal(t6, t)
    # The entry points take the same route, and agree with the JAX
    # package's streamed path (interpret mode).
    h = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False)
    assert torch.equal(h.t, t)
    assert torch.equal(clustered.occluded_hit(tables, _t(so), _t(sd),
                                              _t(st)), occ)
    j, jocc = _jax_paths(jscene, o, d, so, sd, st)
    _assert_same_clustered_hit(j, h, o, d, tscene)
    np.testing.assert_array_equal(occ.numpy(), jocc)
    # On finer clusters the break (and the guard) really cut work: fewer
    # (tile, candidate) sweeps than the lists hold, the same hits.
    monkeypatch.setattr(clustered, "CLUSTER", 8)
    fine = clustered.prepare(tscene)
    rays8 = ablations.pack_rays(_t(o), _t(d), 1e16, 1024)
    lists = ablations.stream_candidates(rays8, fine.boxes, fine.scale, 64,
                                        0.01, 1e16)
    swept, real = [], ablations._pe_rows
    monkeypatch.setattr(ablations, "_pe_rows", lambda o, d, rows, tmin:
                        (swept.append(o.shape[0]), real(o, d, rows, tmin))[1])
    tf, _ = ablations.closest_streamed(rays8, fine.rows, fine.boxes,
                                       fine.scale, lists, 64, 0.01,
                                       guard=guard == "1")
    assert 0 < sum(swept) < (0.8 if guard == "1" else 1.0) \
        * int(lists[2].sum())
    assert torch.equal(tf[:1000], t)


@pytest.mark.parametrize("pair_mult,k_out,group,lvl", CBIN_CASES)
def test_cbin_matches_dense_and_reference(mixed_scenes, monkeypatch,
                                          pair_mult, k_out, group, lvl):
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setenv("TPT_CBIN", "1")
    _cbin_knobs(monkeypatch, pair_mult, k_out, group, lvl)
    tables = clustered.prepare(tscene)
    tables.occ_rows = None
    o, d, so, sd, st = _test_rays(jscene, 384, seed=32)
    ref = _dense(tables, o, d, so, sd, st)
    h, slab = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False,
                                    want_slab=True)
    occ = clustered.occluded_hit(tables, _t(so), _t(sd), _t(st))
    assert torch.equal(h.t, ref[0]) and torch.equal(occ, ref[2])
    assert torch.equal(h.tri, tables.rows[ref[1].long(), 15].int()
                       * h.hit.int())
    assert torch.equal(slab, torch.where(h.hit, ref[1] // 256,
                                         SLAB_UNKNOWN).int())
    t6 = clustered.closest_hit(tables, _t(o), _t(d), tmax=600.0,
                               want_uv=False)
    ref6 = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, 600.0)
    assert torch.equal(t6.t, ref6[0])
    # Starved caps send most lanes through the completion pass.
    rays8 = ablations.pack_rays(_t(o), _t(d), 1e16, 768)
    inc = ablations.cbin_pairs(rays8, tables.boxes, tables.scale, 0.01)[3]
    if (pair_mult, k_out) == (1, 2):
        assert float(inc.float().mean()) > 0.5
    j, jocc = _jax_paths(jscene, o, d, so, sd, st)
    _assert_same_clustered_hit(j, h, o, d, tscene)
    np.testing.assert_array_equal(occ.numpy(), jocc)


@pytest.mark.parametrize("which", ["cycled", "unknown", "clamped"])
def test_rotated_matches_dense_and_reference(mixed_scenes, monkeypatch,
                                             which):
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch, cluster=8, slab=64)
    monkeypatch.setattr(pallas_bf, "TRI_SLAB", 128)
    monkeypatch.setattr(pallas_bf, "CLUSTERED_SLAB", 256)
    monkeypatch.setenv("TPT_SEED", "1")
    tables = clustered.prepare(tscene)
    o, d, so, sd, st = _test_rays(jscene, 500, seed=33)
    n = o.shape[0]
    pred = {"cycled": np.arange(n, dtype=np.int32) % 7,
            "unknown": np.full(n, SLAB_UNKNOWN, np.int32),
            "clamped": np.full(n, 10 ** 6, np.int32)}[which]
    ref = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01)
    assert clustered.closest_scheduler(False, True, 512) == "rot"
    h, slab = clustered.closest_hit(tables, _t(o), _t(d), want_uv=False,
                                    pred=torch.as_tensor(pred),
                                    want_slab=True)
    assert torch.equal(h.t, ref[0])
    assert torch.equal(slab, torch.where(h.hit, ref[1] // 64,
                                         SLAB_UNKNOWN).int())
    t, row = ablations.closest_rotated(
        _t(o), _t(d), tables.rows, tables.boxes, tables.scale,
        torch.as_tensor(pred), 64, 0.01, 600.0)
    ref6 = dense._closest_plain(_t(o), _t(d), tables.rows, 0.01, 600.0)
    assert torch.equal(t, ref6[0]) and torch.equal(row, ref6[1])
    j, slab_j = pallas_bf.intersect_closest(
        jscene, jnp.asarray(o), jnp.asarray(d), want_uv=False,
        pred=jnp.asarray(pred), want_slab=True)
    hit = _assert_same_clustered_hit(j, h, o, d, tscene)
    assert (np.asarray(slab_j)[~hit] == SLAB_UNKNOWN).all()


