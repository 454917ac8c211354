"""K9's and K10's tree over the instances
(``tpu_pt_torch.intersect.instanced``: ``instance_tree``, the plain walk
``_inst_tree_leaves_plain``), on the CPU.

The instanced kernel K9 (``csrc/instanced_intersect.cu``) walks a tree
over the real instances of an instance table, near first, before it moves
the ray into a reached instance's mesh space. The tests hold the tree to
what makes that exact: every real instance is one leaf and padding
instances are none; a node's box is the exact union of its children's and
its margin coefficients (a, b) their element-wise max, so it contains
each child's grown box; the instances the walk reaches at a bound are, bit
for bit, those the flat test of every instance box passes. A sweep of the
reached instances only equals the plain version ``_closest_inst_plain``
bit for bit and the JAX package's ``pallas_inst.intersect_closest``
(interpret mode) within ``tests/test_torch_instanced.py``'s bounds, and
no answer changes when the instances come in another order.

The shadow-ray kernel K10 walks the same tree at each ray's tmax, culls a
reached instance's clusters by their mesh-space boxes and stops at the
first cluster with a blocking row. Its plain twin here (the walk, then an
any-hit sweep of the reached instances' passing clusters) equals
``_occluded_inst_plain`` bit for bit, on subset tables of 0, 1 and 2
real instances too (foliage's opaque subset is such a table), and
``pallas_inst.intersect_occluded`` (interpret mode) on >= 99% of aimed
rays.

Scenes: ``tests/test_torch_instanced.py``'s fixture (a cube and a glass
tetrahedron instanced nine times, non-uniform scales and a mirror) and
the 1,001-instance forest (``assets/forest.gltf``).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_inst as pi  # noqa: E402
import tpu_pt_torch as tp  # noqa: E402
from tpu_pt_torch.intersect import clustered, dense, instanced  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from test_torch_instanced import (T_TOL, _aimed_rays, _t, _v3,  # noqa: E402
                                  fixture)  # noqa: F401

TMIN = 0.01
SCENES = ["fixture", "forest"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Six test workers share the machine's cores (test_torch_render.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def forest(assets_dir):
    ws = tp.load_gltf(str(assets_dir / "forest.gltf"), device="cpu")
    return ws, instanced.prepare(ws.geom, ws.inst)


def _forest_rays(n: int, seed: int):
    """Rays from above and inside the forest in random directions."""
    r = np.random.default_rng(seed)
    o = r.uniform(-60.0, 60.0, (n, 3)).astype(np.float32)
    o[:, 1] = r.uniform(0.5, 30.0, n)
    d = r.normal(size=(n, 3)).astype(np.float32)
    d[: n // 2, 1] = -np.abs(d[: n // 2, 1])        # half look down
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _t(o), _t(d)


def _scene(name, fixture, forest, n=256, seed=40):
    """(InstTables, origins, dirs) of a scene of SCENES."""
    if name == "fixture":
        tables = instanced.prepare(fixture["geom"], fixture["table"])
        o, d = _aimed_rays(fixture["instances"], n, seed=seed)
        return tables, _t(o), _t(d)
    o, d = _forest_rays(n, seed)
    return forest[1], o, d


def _walk_closest(o, d, tables, tmax=T_FAR, bound=None):
    """(t, packed row, instance) of a sweep of the instances the plain
    walk reaches at ``bound`` (default tmax) only, in table order, each
    replacing the best on a smaller t: ties to the lowest (instance,
    row)."""
    table = tables.table
    reached, _ = instanced._inst_tree_leaves_plain(
        o, d, tables.tree, table.boxes, TMIN, tmax if bound is None else bound)
    n = o.shape[0]
    t_out = torch.full((n,), T_FAR)
    row_out = torch.zeros(n, dtype=torch.int32)
    inst_out = torch.zeros(n, dtype=torch.int32)
    for i, s, e in instanced._instance_ranges(table.rows, clustered.CLUSTER):
        sel = reached[:, i].nonzero()[:, 0]
        if not sel.numel():
            continue
        om, dm = instanced._xform(table.rows[i:i + 1, 0:12], o[sel], d[sel])
        t, row = dense._closest_plain(om, dm, tables.tris[s:e], TMIN, tmax)
        better = t < t_out[sel]
        t_out[sel] = torch.where(better, t, t_out[sel])
        row_out[sel] = torch.where(better, row + s, row_out[sel])
        inst_out[sel] = torch.where(better, i, inst_out[sel])
    return t_out, row_out, inst_out


def _children(nodes, k):
    refs = nodes[k, 8:10].contiguous().view(torch.int32).tolist()
    return refs


@pytest.mark.parametrize("name", SCENES)
def test_node_table(name, fixture, forest):
    """Every real instance sits on one root-to-leaf path and no padding
    instance on any; a node's box is the exact min / max of its
    children's, its (a, b) their element-wise max, and each child's box
    and coefficients lie within it."""
    tables, _, _ = _scene(name, fixture, forest)
    boxes, tree = tables.table.boxes, tables.tree
    real = (boxes[:, 0:6].abs().amax(1) < 1e30).nonzero()[:, 0].tolist()
    count = tables.table.count
    assert real == list(range(count))
    assert boxes.shape[0] > count          # the table carries padding
    nodes = tree.nodes
    assert tree.root == 0 and nodes.shape == (count - 1, 12)
    assert not bool(nodes[:, 10:12].any())
    leaves, stack, depth = [], [(0, 1)], 0
    while stack:
        k, level = stack.pop()
        depth = max(depth, level)
        for ref in _children(nodes, k):
            if ref & 1:
                leaves.append(ref >> 1)
            else:
                stack.append((ref >> 1, level + 1))
    assert sorted(leaves) == real
    assert depth == clustered.tree_depth(count)
    for k in range(nodes.shape[0]):
        kids = [(boxes if r & 1 else nodes)[r >> 1, 0:8]
                for r in _children(nodes, k)]
        lo = torch.minimum(kids[0][0:3], kids[1][0:3])
        hi = torch.maximum(kids[0][3:6], kids[1][3:6])
        ab = torch.maximum(kids[0][6:8], kids[1][6:8])
        assert torch.equal(nodes[k, 0:3], lo)
        assert torch.equal(nodes[k, 3:6], hi)
        assert torch.equal(nodes[k, 6:8], ab)
        for kid in kids:
            assert bool((nodes[k, 0:3] <= kid[0:3]).all())
            assert bool((nodes[k, 3:6] >= kid[3:6]).all())
            assert bool((nodes[k, 6:8] >= kid[6:8]).all())


@pytest.mark.parametrize("n_real", [0, 1, 2, 3])
def test_small_trees(n_real):
    """A table of fewer than two real instances has no node: the walk
    starts at the one real instance (or at instance 0, a padding instance
    that no ray enters)."""
    boxes = torch.full((8, 8), clustered.EMPTY_BOX)
    for i in range(n_real):
        boxes[2 * i + 1] = torch.tensor([i, 0, 0, i + 1, 1, 1, 1e-4, 1e-3])
    tree = instanced.instance_tree(boxes)
    if n_real <= 1:
        assert tree.nodes.shape == (0, 12)
        assert tree.root == (3 if n_real else 1)
    else:
        assert tree.nodes.shape == (n_real - 1, 12) and tree.root == 0
    instanced._check_tree(tree, 8, torch.device("cpu"))


@pytest.mark.parametrize("name", SCENES)
def test_walk_reaches_the_flat_leaf_set(name, fixture, forest):
    """At the same bound the plain walk reaches exactly the instances the
    flat test of every instance box passes (the kernels' slab test, each
    box grown by its own a * max|o| + b), at T_FAR and at each ray's
    final bound; the forest's walk tests a fraction of its 1,001 boxes."""
    tables, o, d = _scene(name, fixture, forest,
                          n=512 if name == "fixture" else 256)
    boxes = tables.table.boxes
    final, _, inst = instanced._closest_inst_plain(
        o, d, tables.tris, clustered.CLUSTER, tables.table.rows, TMIN)
    hit = final < T_FAR
    assert int(hit.sum()) > 50
    n = o.shape[0]
    for bound in (torch.full((n,), T_FAR), final):
        reached, tests = instanced._inst_tree_leaves_plain(
            o, d, tables.tree, boxes, TMIN, bound)
        flat = instanced._inst_passes(o, d, boxes, TMIN, bound[:, None])
        assert torch.equal(reached, flat)
        assert bool((tests >= 1).all())
    assert bool(reached[hit, inst[hit].long()].all())
    if name == "forest":
        assert float(tests.float().mean()) < boxes.shape[0] / 10


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("bound", ["tmax", "final"])
def test_walk_is_the_plain_version(name, bound, fixture, forest):
    """A sweep of the reached instances only (at tmax, or at each ray's
    final bound) gives ``_closest_inst_plain`` bit for bit, at T_FAR and
    at a finite tmax."""
    tables, o, d = _scene(name, fixture, forest, seed=41)
    for tmax in (T_FAR, 9.0 if name == "fixture" else 40.0):
        want = instanced._closest_inst_plain(
            o, d, tables.tris, clustered.CLUSTER, tables.table.rows, TMIN,
            tmax)
        assert 0.0 < float((want[0] < T_FAR).float().mean()) < 1.0
        got = _walk_closest(o, d, tables, tmax,
                            want[0] if bound == "final" else None)
        for x, y in zip(got, want):
            assert torch.equal(x, y)


def test_walk_matches_pallas(fixture):
    """The walk's sweep against ``pallas_inst.intersect_closest`` on 512
    aimed rays, as tests/test_torch_instanced.py holds K9's plain
    version: equal hits, t within 1e-4, equal (instance, row) on >= 99%."""
    o, d = _aimed_rays(fixture["instances"], 512, seed=3)
    j = pi.intersect_closest(fixture["jgeom"], fixture["jtable"], _v3(o),
                             _v3(d))
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    t, row, inst = _walk_closest(_t(o), _t(d), tables)
    hit = np.asarray(j.hit)
    np.testing.assert_array_equal((t < T_FAR).numpy(), hit)
    assert hit.sum() > 200
    assert np.abs(t.numpy() - np.asarray(j.t))[hit].max() <= T_TOL
    tri = torch.where(t < T_FAR, tables.tris[row.long(), 15], 0.0)
    same = ((inst.numpy() == np.asarray(j.inst))
            & (tri.to(torch.int32).numpy() == np.asarray(j.tri)))
    assert same[hit].mean() >= 0.99


@pytest.mark.parametrize("name", SCENES)
def test_instance_order_changes_no_answer(name, fixture, forest):
    """The instances shuffled before the build (another table order, so
    another tree): the walk's t and row are the same bit for bit, and its
    instance is the same one (column 14 of the shuffled rows names it)."""
    tables, o, d = _scene(name, fixture, forest, seed=42)
    want = _walk_closest(o, d, tables)
    table = tables.table
    count = table.count
    perm = torch.as_tensor(np.random.default_rng(43).permutation(count))
    order = torch.cat([perm, torch.arange(count, table.rows.shape[0])])
    shuffled = instanced.InstTables(
        tris=tables.tris, boxes=tables.boxes, scale=tables.scale,
        table=type(table)(rows=table.rows[order], nrm=table.nrm[order],
                          fwd=table.fwd[order], boxes=table.boxes[order],
                          count=count, mesh_ranges=table.mesh_ranges),
        tree=instanced.instance_tree(table.boxes[order]))
    assert not torch.equal(shuffled.tree.nodes[:, 8:10], tables.tree.nodes[
        :, 8:10])
    t, row, inst = _walk_closest(o, d, shuffled)
    assert torch.equal(t, want[0]) and torch.equal(row, want[1])
    hit = t < T_FAR
    ids = shuffled.table.rows[inst.long(), 14].to(torch.int32)
    assert torch.equal(ids[hit], want[2][hit])


def _shadow_rays(name, fixture, forest, n=256, seed=50):
    """(InstTables, origins, dirs, tmax) of shadow rays of a scene of
    SCENES: the fixture's aimed rays, or the forest's rays, each with a
    random tmax; one ray in eight parked (tmax 0)."""
    tables, o, d = _scene(name, fixture, forest, n=n, seed=seed)
    r = np.random.default_rng(seed + 1)
    lo, hi = (2.0, 20.0) if name == "fixture" else (1.0, 60.0)
    tmax = r.uniform(lo, hi, n).astype(np.float32)
    tmax[::8] = 0.0
    return tables, o, d, _t(tmax)


def _cluster_passes(om, dm, cboxes, scale, tmin, bound):
    """The kernels' slab test of mesh-space rays [N] against cluster
    boxes [C, 8], each grown by BOX_MARGIN * (scale + max|o_m|): [N, C]."""
    from tpu_pt_torch.intersect import ablations
    m = clustered.BOX_MARGIN * (scale + om.abs().amax(1))
    tn, tf = ablations._near_far(om, ablations._ray_inv(dm), m, cboxes)
    return (tn <= tf) & (tf > tmin) & (tn <= bound[:, None])


def _walk_occluded(o, d, tmax, tables):
    """K10's plain twin: the instance walk at each ray's tmax, then, for
    each reached instance, its clusters culled by their mesh-space boxes
    and an any-hit sweep of the rest."""
    table = tables.table
    reached, _ = instanced._inst_tree_leaves_plain(
        o, d, tables.tree, table.boxes, TMIN, tmax)
    out = torch.zeros(o.shape[0], dtype=torch.bool)
    meta = table.rows[:, 12:14].round().long().tolist()
    for i, (clo, ncl) in enumerate(meta):
        sel = reached[:, i].nonzero()[:, 0]
        if ncl == 0 or not sel.numel():
            continue
        om, dm = instanced._xform(table.rows[i:i + 1, 0:12], o[sel], d[sel])
        passes = _cluster_passes(om, dm, tables.boxes[clo:clo + ncl],
                                 tables.scale, TMIN, tmax[sel])
        for k in range(ncl):
            hit = passes[:, k].nonzero()[:, 0]
            if not hit.numel():
                continue
            s = (clo + k) * clustered.CLUSTER
            rows = tables.tris[s:s + clustered.CLUSTER]
            out[sel[hit]] |= dense._occluded_plain(om[hit], dm[hit],
                                                   tmax[sel[hit]], rows, TMIN)
    return out


def _subset(tables, keep):
    """``tables`` with only the instances of ``keep`` real: the others
    get the far-point box and no clusters, as the empty meshes of an
    opaque subset have; the tree over what is left."""
    table = tables.table
    rows, boxes = table.rows.clone(), table.boxes.clone()
    drop = [i for i in range(table.count) if i not in keep]
    rows[drop, 13] = 0.0
    boxes[drop, 0:6] = clustered.EMPTY_BOX
    return instanced.InstTables(
        tris=tables.tris, boxes=tables.boxes, scale=tables.scale,
        table=dataclasses.replace(table, rows=rows, boxes=boxes),
        tree=instanced.instance_tree(boxes))


@pytest.mark.parametrize("name", SCENES)
def test_shadow_walk_reaches_the_flat_leaf_set(name, fixture, forest):
    """At each shadow ray's tmax (parked rays at 0) the plain walk
    reaches exactly the instances the flat test of every instance box
    passes."""
    tables, o, d, tmax = _shadow_rays(name, fixture, forest)
    boxes = tables.table.boxes
    reached, tests = instanced._inst_tree_leaves_plain(
        o, d, tables.tree, boxes, TMIN, tmax)
    flat = instanced._inst_passes(o, d, boxes, TMIN, tmax[:, None])
    assert torch.equal(reached, flat)
    assert int(reached.any(1).sum()) > 50
    if name == "forest":
        assert float(tests.float().mean()) < boxes.shape[0] / 10


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("shrink", [1.0, 0.6])
def test_shadow_walk_is_the_plain_version(name, shrink, fixture, forest):
    """The walk, then the any-hit sweep of the reached instances' passing
    clusters, gives ``_occluded_inst_plain`` bit for bit, at each ray's
    tmax and at 0.6 of it, with blocked and open rays both present; the
    wrapper on the CPU is the plain version."""
    tables, o, d, tmax = _shadow_rays(name, fixture, forest, seed=51)
    tmax = tmax * shrink
    want = instanced._occluded_inst_plain(
        o, d, tmax, tables.tris, clustered.CLUSTER, tables.table.rows, TMIN)
    assert 0.0 < float(want.float().mean()) < 1.0
    assert torch.equal(_walk_occluded(o, d, tmax, tables), want)
    assert torch.equal(instanced.occluded_hit(tables, o, d, tmax), want)


@pytest.mark.parametrize("n_real", [0, 1, 2])
def test_shadow_walk_on_a_subset_table(n_real, fixture, forest):
    """A subset table of 0, 1 or 2 real instances (a root leaf, or a
    single node): the walk and its sweep give ``_occluded_inst_plain``
    bit for bit, and the tree fits the wrapper's check."""
    tables, o, d, tmax = _shadow_rays("fixture", fixture, forest, n=512,
                                      seed=52)
    # Opaque cubes (even instances), so that some rays are blocked.
    sub = _subset(tables, [0, 2][:n_real])
    assert sub.tree.nodes.shape[0] == max(n_real - 1, 0)
    instanced._check_tree(sub.tree, sub.table.rows.shape[0],
                          torch.device("cpu"))
    want = instanced._occluded_inst_plain(
        o, d, tmax, sub.tris, clustered.CLUSTER, sub.table.rows, TMIN)
    assert bool(want.any()) == (n_real > 0)
    assert torch.equal(_walk_occluded(o, d, tmax, sub), want)


@pytest.mark.parametrize("name", SCENES)
def test_shadow_walk_ignores_instance_order(name, fixture, forest):
    """The instances shuffled before the build (another tree): the
    walk's flags are the same bit for bit."""
    tables, o, d, tmax = _shadow_rays(name, fixture, forest, seed=53)
    want = _walk_occluded(o, d, tmax, tables)
    table = tables.table
    count = table.count
    perm = torch.as_tensor(np.random.default_rng(54).permutation(count))
    order = torch.cat([perm, torch.arange(count, table.rows.shape[0])])
    shuffled = instanced.InstTables(
        tris=tables.tris, boxes=tables.boxes, scale=tables.scale,
        table=dataclasses.replace(table, rows=table.rows[order],
                                  nrm=table.nrm[order], fwd=table.fwd[order],
                                  boxes=table.boxes[order]),
        tree=instanced.instance_tree(table.boxes[order]))
    assert not torch.equal(shuffled.tree.nodes[:, 8:10],
                           tables.tree.nodes[:, 8:10])
    assert torch.equal(_walk_occluded(o, d, tmax, shuffled), want)


@pytest.mark.parametrize("tmax_v", [4.0, 14.0])
def test_shadow_walk_matches_pallas(fixture, tmax_v):
    """The walk's sweep against ``pallas_inst.intersect_occluded`` on 512
    aimed rays, as tests/test_torch_instanced.py holds K10's plain
    version: equal flags on >= 99% of them, parked rays (tmax 0) never
    blocked."""
    o, d = _aimed_rays(fixture["instances"], 512, seed=11)
    tmax = np.full(512, tmax_v, np.float32)
    tmax[:16] = 0.0
    j = np.asarray(pi.intersect_occluded(fixture["jgeom"], fixture["jtable"],
                                         _v3(o), _v3(d), jnp.asarray(tmax)))
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    ours = _walk_occluded(_t(o), _t(d), _t(tmax), tables).numpy()
    assert (ours == j).mean() >= 0.99
    assert not ours[:16].any()
    if tmax_v > 10:
        assert 0.2 < j.mean() < 0.9


def test_shadow_entry_point_hands_the_tree_to_k10(fixture, monkeypatch):
    """``occluded_hit`` calls K10 with the prepared instance tree, so the
    kernel never builds one per call."""
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    seen = []
    real = instanced.occluded_inst

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(instanced, "occluded_inst", spy)
    o, d = _aimed_rays(fixture["instances"], 64, seed=45)
    instanced.occluded_hit(tables, _t(o), _t(d), _t(np.full(64, 9.0)))
    assert len(seen) == 1 and seen[0][-1] is tables.tree


def test_entry_point_hands_the_tree_to_k9(fixture, monkeypatch):
    """``closest_hit`` calls K9 with the prepared instance tree; the
    wrapper refuses a tree that does not fit its table."""
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    seen = []
    real = instanced.closest_inst

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(instanced, "closest_inst", spy)
    o, d = _aimed_rays(fixture["instances"], 64, seed=44)
    instanced.closest_hit(tables, _t(o), _t(d))
    assert len(seen) == 1 and seen[0][-1] is tables.tree
    cpu = torch.device("cpu")
    n_inst = tables.table.rows.shape[0]
    instanced._check_tree(tables.tree, n_inst, cpu)
    for bad in (instanced.InstanceTree(tables.tree.nodes, 1),
                instanced.InstanceTree(tables.tree.nodes[:, :8].contiguous(),
                                       0),
                instanced.InstanceTree(tables.tree.nodes[:0], 2 * n_inst + 1)):
        with pytest.raises(ValueError):
            instanced._check_tree(bad, n_inst, cpu)


@pytest.mark.parametrize("n_rays", [1, 16384, 65536, 262144, 1 << 20])
def test_walk_group_is_a_built_width(n_rays):
    """K9's lanes a ray is one of the widths the kernels are built for
    (csrc/walk.cuh, with_group), whatever the ray count."""
    assert instanced.walk_group(n_rays) in (4, 8, 16, 32)


@pytest.mark.parametrize("n_rays", [1, 16384, 65536, 262144, 1 << 20])
def test_occluded_walk_group_is_a_built_width(n_rays):
    """K10's lanes a ray is one of the widths the kernels are built for,
    whatever the ray count."""
    assert instanced.occluded_walk_group(n_rays) in (4, 8, 16, 32)
