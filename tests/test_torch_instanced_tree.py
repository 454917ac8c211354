"""K9's tree over the instances (``tpu_pt_torch.intersect.instanced``:
``instance_tree``, the plain walk ``_inst_tree_leaves_plain``), on the CPU.

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

Scenes: ``tests/test_torch_instanced.py``'s fixture (a cube and a glass
tetrahedron instanced nine times, non-uniform scales and a mirror) and
the 1,001-instance forest (``assets/forest.gltf``).
"""

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


def test_entry_point_hands_the_tree_to_k9(fixture, monkeypatch):
    """``closest_hit`` calls K9 with the prepared instance tree, never the
    flat yardstick; the wrapper refuses a tree that does not fit its
    table."""
    tables = instanced.prepare(fixture["geom"], fixture["table"])
    seen = []
    real = instanced.closest_inst

    def spy(*a, **kw):
        seen.append(a)
        return real(*a, **kw)
    monkeypatch.setattr(instanced, "closest_inst", spy)
    monkeypatch.setattr(instanced, "closest_inst_flat", None)
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
