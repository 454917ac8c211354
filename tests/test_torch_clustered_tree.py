"""The cluster tree of the big-scene kernels K6, K6f and K8
(``tpu_pt_torch.intersect.clustered``: ``cluster_tree``, the plain walk
``_tree_leaves_plain``), on the CPU.

The walk of ``csrc/clustered_intersect.cu`` sweeps the clusters whose
grown box and every ancestor's pass the slab test within the bound. The
tests hold the tree to what makes that exact: each cluster is one leaf,
a node's box is the exact union of its children's (empty clusters left
out), and the clusters the walk reaches are, bit for bit, those the flat
test of every box passes, also for a tree that does not follow the rows'
kd order. A sweep restricted to the reached clusters equals the dense
plain versions bit for bit and the JAX package's clustered path (run in
interpret mode) within ``test_torch_clustered.py``'s bound.

Scenes as in ``test_torch_clustered.py``: the mixed Cornell box and the
4,900-triangle displaced sphere cut into small clusters by monkeypatch,
the unit sphere seen from 100,000 radii away, and a synthetic table of
784 boxes (the big mesh's count) with a run of empty clusters that
empties whole subtrees.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_pt.intersect import pallas_bf  # noqa: E402
from tpu_pt_torch.intersect import ablations, clustered, dense  # noqa: E402
from tpu_pt_torch.intersect.moller import T_FAR  # noqa: E402
from tpu_pt_torch.scene.arrays import median_split_order  # noqa: E402
from test_torch_clustered import (  # noqa: E402,F401
    _assert_same_clustered_hit, _culling_rays, _far_rays, _shrink,
    mixed_scenes, sphere_arrays, sphere_scenes, unit_sphere_scene)
from test_torch_intersect import _rays, _t  # noqa: E402

SCENES = ["mixed", "sphere", "far"]
N_SYNTH = 784            # the big mesh's cluster count
SYNTH_EMPTY = 40         # trailing empty clusters: whole subtrees empty


def _synthetic_boxes(seed=0, n=N_SYNTH, empty=SYNTH_EMPTY):
    """[n, 8] boxes of random size around random centres in kd order, the
    last ``empty`` collapsed to EMPTY_BOX as all-padding clusters are."""
    r = np.random.default_rng(seed)
    c = r.uniform(-50.0, 50.0, (n, 3)).astype(np.float32)
    h = r.uniform(0.1, 4.0, (n, 3)).astype(np.float32)
    # In the kd order of their centres, as the clusters of a packed table.
    zero = np.zeros_like(c)
    c = c[median_split_order(c, zero, zero, np.ones(n, bool), leaf=1)]
    boxes = np.concatenate([c - h, c + h, np.zeros((n, 2), np.float32)], 1)
    boxes[n - empty:, 0:6] = clustered.EMPTY_BOX
    return _t(boxes)


def _synthetic_rays(seed=1, n=1024):
    r = np.random.default_rng(seed)
    o = r.uniform(-80.0, 80.0, (n, 3)).astype(np.float32)
    d = r.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:32] = np.eye(3, dtype=np.float32)[np.arange(32) % 3]  # axis-parallel
    bound = r.uniform(0.0, 150.0, n).astype(np.float32)
    bound[::4] = T_FAR
    return _t(o), _t(d), _t(bound)


def _scene_tables(name, mixed_scenes, sphere_scenes, unit_sphere_scene,
                  monkeypatch, cluster=32):
    """(rows, boxes, nodes, scale, origins, dirs) of a scene of SCENES in
    clusters of ``cluster`` rows."""
    monkeypatch.setattr(clustered, "CLUSTER", cluster)
    if name == "far":
        tscene = unit_sphere_scene
        o, d = (_t(a) for a in _far_rays(seed=16))
    else:
        tscene = (mixed_scenes if name == "mixed" else sphere_scenes)[1]
        o, d = (_t(a) for a in _culling_rays(mixed_scenes[0], seed=13))
    rows, boxes = clustered.pack_tris_clustered(tscene)
    return (rows, boxes, clustered.cluster_tree(boxes),
            clustered.box_scale(boxes), o, d)


def _leaf_paths(links: np.ndarray, n_c: int):
    """The root-to-leaf paths of every cluster: {cluster: [paths]}, each
    path the list of nodes above it (depth first over ``links``)."""
    paths = {}
    if n_c == 1:
        return {0: [[]]}
    stack = [(0, [0])]
    while stack:
        node, path = stack.pop()
        for ref in links[node]:
            if ref & 1:
                paths.setdefault(int(ref >> 1), []).append(path)
            else:
                stack.append((int(ref >> 1), path + [int(ref >> 1)]))
    return paths


@pytest.mark.parametrize("table", ["synthetic", "mixed", "sphere", "c1", "c2",
                                   "c3", "c5"])
def test_node_table(table, mixed_scenes, sphere_scenes, monkeypatch):
    """Each cluster sits on exactly one root-to-leaf path, no deeper than
    ceil(log2 C); a node's box is the exact min / max of its children's
    real boxes and contains each of them; empty children are left out,
    and a node over empty clusters only is EMPTY_BOX itself."""
    if table == "synthetic":
        boxes = _synthetic_boxes()
    elif table in ("mixed", "sphere"):
        monkeypatch.setattr(clustered, "CLUSTER", 32)
        tscene = (mixed_scenes if table == "mixed" else sphere_scenes)[1]
        boxes = clustered.pack_tris_clustered(tscene)[1]
    else:
        boxes = _synthetic_boxes(seed=int(table[1:]), n=int(table[1:]),
                                 empty=0)
    n_c = boxes.shape[0]
    nodes = clustered.cluster_tree(boxes)
    assert nodes.shape == (n_c - 1, 8) and nodes.dtype == torch.float32
    links = nodes[:, 6:8].contiguous().view(torch.int32).numpy()
    paths = _leaf_paths(links, n_c)
    assert sorted(paths) == list(range(n_c))
    assert all(len(p) == 1 for p in paths.values())
    depth = max(len(p[0]) for p in paths.values())
    assert depth <= int(np.ceil(np.log2(n_c))) == clustered.tree_depth(n_c)
    assert depth <= clustered.TREE_MAX_DEPTH
    # Every node but the root is some node's child, once.
    kids = sorted(int(r >> 1) for r in links.reshape(-1) if not r & 1)
    assert kids == list(range(1, n_c - 1))
    for k in range(n_c - 1):
        kb = [(boxes if r & 1 else nodes)[r >> 1, 0:6].numpy()
              for r in links[k]]
        live = [b for b in kb if b[0] < 1e30]
        if not live:
            assert (nodes[k, 0:6] == clustered.EMPTY_BOX).all()
            continue
        lo = np.minimum.reduce([b[0:3] for b in live])
        hi = np.maximum.reduce([b[3:6] for b in live])
        np.testing.assert_array_equal(nodes[k, 0:3].numpy(), lo)
        np.testing.assert_array_equal(nodes[k, 3:6].numpy(), hi)
        for b in live:
            assert (nodes[k, 0:3].numpy() <= b[0:3]).all()
            assert (nodes[k, 3:6].numpy() >= b[3:6]).all()
    if table == "synthetic":
        empty_nodes = (nodes[:, 0] > 1e30).sum()
        assert int(empty_nodes) > 0     # a whole subtree of padding


def _flat(o, d, boxes, scale, tmin, bound):
    """The flat test of every box (``_slab_pass`` of chip_smoke.py, the
    kernels' slab test) at ``bound`` [N]."""
    inv = ablations._ray_inv(d)
    m = ablations._margin(o, scale)
    tn, tf = ablations._near_far(o, inv, m, boxes)
    return (tn <= tf) & (tf > tmin) & (tn <= bound[:, None])


@pytest.mark.parametrize("scene_name", SCENES + ["synthetic"])
def test_walk_reaches_the_flat_leaf_set(scene_name, mixed_scenes,
                                        sphere_scenes, unit_sphere_scene,
                                        monkeypatch):
    """At the same bound the plain walk reaches exactly the clusters the
    flat test passes, bit for bit: at T_FAR, and at each ray's final bound
    (its closest hit), where the winner's cluster is among them. Over the
    784 synthetic boxes the walk tests a fraction of the boxes."""
    if scene_name == "synthetic":
        boxes = _synthetic_boxes()
        nodes = clustered.cluster_tree(boxes)
        scale = clustered.box_scale(boxes)
        o, d, final = _synthetic_rays()
        rows = None
    else:
        rows, boxes, nodes, scale, o, d = _scene_tables(
            scene_name, mixed_scenes, sphere_scenes, unit_sphere_scene,
            monkeypatch)
        final, row = clustered._closest_clustered_plain(o, d, rows, 0.01)
    n = o.shape[0]
    for bound in (torch.full((n,), T_FAR), final):
        reached, tests = clustered._tree_leaves_plain(o, d, nodes, boxes,
                                                      scale, 0.01, bound)
        assert torch.equal(reached, _flat(o, d, boxes, scale, 0.01, bound))
        assert bool((tests >= 1).all())
        assert bool((tests <= 2 * boxes.shape[0] - 1).all())
    if rows is None:
        # 784 boxes: the walk at the final bound tests a fraction of them.
        assert int(tests.sum()) < n * boxes.shape[0] // 4
    else:
        hit = final < T_FAR
        assert int(hit.sum()) > 100
        cluster = rows.shape[0] // boxes.shape[0]
        assert bool(reached[hit, row[hit].long() // cluster].all())


@pytest.mark.parametrize("scene_name", SCENES)
def test_any_tree_shape_is_exact(scene_name, mixed_scenes, sphere_scenes,
                                 unit_sphere_scene, monkeypatch):
    """Rows packed in an order that is not the kd order (a scene may bring
    its own ``cluster_order``): the tree's boxes are loose, and the walk
    still reaches exactly the flat leaf set."""
    monkeypatch.setattr(clustered, "CLUSTER", 32)
    if scene_name == "far":
        tscene = unit_sphere_scene
        o, d = (_t(a) for a in _far_rays(seed=17))
    else:
        tscene = (mixed_scenes if scene_name == "mixed" else sphere_scenes)[1]
        o, d = (_t(a) for a in _culling_rays(mixed_scenes[0], seed=18))
    order = np.random.default_rng(19).permutation(tscene.num_tris_padded)
    shuffled = dataclasses.replace(
        tscene, cluster_order=torch.as_tensor(order, dtype=torch.int32))
    rows, boxes = clustered.pack_tris_clustered(shuffled)
    nodes, scale = clustered.cluster_tree(boxes), clustered.box_scale(boxes)
    final, _ = clustered._closest_clustered_plain(o, d, rows, 0.01)
    reached, _ = clustered._tree_leaves_plain(o, d, nodes, boxes, scale, 0.01,
                                              final)
    assert torch.equal(reached, _flat(o, d, boxes, scale, 0.01, final))


def _tree_closest(o, d, rows, boxes, nodes, scale, tmin=0.01, tmax=T_FAR):
    """(t, packed row) of a sweep of the clusters the walk reaches at
    tmax only: the closest hit with t < tmax, ties to the lowest row."""
    reached, _ = clustered._tree_leaves_plain(o, d, nodes, boxes, scale, tmin,
                                              tmax)
    cluster = rows.shape[0] // boxes.shape[0]
    t, _, _ = dense._pe_block(o, d, rows, tmin)
    t = torch.where(reached.repeat_interleave(cluster, 1) & (t < tmax), t,
                    T_FAR)
    best = t.min(1).values
    iota = torch.arange(rows.shape[0], dtype=torch.int32)
    row = torch.where(t == best[:, None], iota, rows.shape[0]).min(1).values
    return best, torch.where(best < T_FAR, row, 0).to(torch.int32)


def _tree_occluded(o, d, tmax, rows, boxes, nodes, scale, tmin=0.01):
    """Any non-refractive hit with tmin < t < tmax[i] among the rows of
    the clusters the walk reaches at tmax[i]."""
    reached, _ = clustered._tree_leaves_plain(o, d, nodes, boxes, scale, tmin,
                                              tmax)
    cluster = rows.shape[0] // boxes.shape[0]
    t, _, _ = dense._pe_block(o, d, rows, tmin)
    block = (t < tmax[:, None]) & (rows[None, :, 13] < 0.5)
    return (block & reached.repeat_interleave(cluster, 1)).any(1)


@pytest.mark.parametrize("scene_name", SCENES)
def test_tree_culled_sweep_is_the_plain_sweep(scene_name, mixed_scenes,
                                              sphere_scenes,
                                              unit_sphere_scene, monkeypatch):
    """Sweeping only the reached clusters gives K6's and K8's plain
    versions bit for bit (closest at T_FAR and at a finite tmax; any-hit
    on shadow rays toward points along each ray, some blocked)."""
    rows, boxes, nodes, scale, o, d = _scene_tables(
        scene_name, mixed_scenes, sphere_scenes, unit_sphere_scene,
        monkeypatch)
    for tmax in (T_FAR, 300.0 if scene_name != "far" else 1.0e5):
        t, row = _tree_closest(o, d, rows, boxes, nodes, scale, tmax=tmax)
        pt, prow = clustered._closest_clustered_plain(o, d, rows, 0.01, tmax)
        assert torch.equal(t, pt) and torch.equal(row, prow)
    r = np.random.default_rng(20)
    frac = _t(r.uniform(0.2, 1.6, o.shape[0]).astype(np.float32))
    reach = torch.where(pt < T_FAR, pt, 400.0 if scene_name != "far"
                        else 1.0e5)
    tmax = (reach * frac).contiguous()
    tmax[-8:] = 0.0                              # ineligible lanes
    occ = _tree_occluded(o, d, tmax, rows, boxes, nodes, scale)
    ref = clustered._occluded_clustered_plain(o, d, tmax, rows, 0.01)
    assert torch.equal(occ, ref)
    assert 0.05 < float(ref.float().mean()) < 0.95


@pytest.mark.parametrize("seed", [11, 21])
def test_tree_culled_sweep_matches_pallas(mixed_scenes, monkeypatch, seed):
    """The tree-culled sweep against the clustered Pallas path (interpret
    mode) on the mixed box's camera and bounce rays, as K6's plain version
    is held in ``test_torch_clustered.py``; and the any-hit on its shadow
    rays against ``_intersect_occluded_tiled``, flag for flag."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    o, d, p, ld, tmax = _rays(jscene, 512, seed=seed)
    tables = clustered.prepare(tscene)
    assert tables.nodes.shape == (tables.boxes.shape[0] - 1, 8)
    j = pallas_bf.intersect_closest(jscene, jnp.asarray(o), jnp.asarray(d),
                                    want_uv=False)
    t, row = _tree_closest(_t(o), _t(d), tables.rows, tables.boxes,
                           tables.nodes, tables.scale)
    hit = clustered._lean_resolve_packed(tables.rows, _t(o), _t(d), t, row,
                                         want_uv=False)
    assert _assert_same_clustered_hit(j, hit, o, d, tscene).mean() > 0.5
    jo = np.asarray(pallas_bf._intersect_occluded_tiled(
        jscene, jnp.asarray(p), jnp.asarray(ld), jnp.asarray(tmax)))
    occ = _tree_occluded(_t(p), _t(ld), _t(tmax), tables.rows, tables.boxes,
                         tables.nodes, tables.scale)
    np.testing.assert_array_equal(occ.numpy(), jo)


def _spy_args(monkeypatch, names):
    """Record the arguments of ``clustered``'s wrappers ``names``."""
    seen = {name: [] for name in names}
    for name in names:
        def spy(*a, _fn=getattr(clustered, name), _name=name, **kw):
            seen[_name].append((a, kw))
            return _fn(*a, **kw)
        monkeypatch.setattr(clustered, name, spy)
    return seen


def _nodes_arg(call):
    a, kw = call
    return kw.get("nodes", a[-1])


@pytest.mark.parametrize("how", ["lean", "full carry", "full carry, uv",
                                 "any-hit", "pair-binned", "first-hit quirk"])
def test_entry_points_hand_the_tree_to_the_kernels(mixed_scenes, monkeypatch,
                                                   how):
    """``closest_hit`` / ``occluded_hit`` pass ``tables.nodes`` to K6, K6f
    and K8 (and K14's completion passes reach them with it too)."""
    jscene, tscene = mixed_scenes
    _shrink(monkeypatch)
    monkeypatch.setattr(dense, "TRI_SLAB", 16)   # shadow rays take K8 too
    tables = clustered.prepare(tscene)
    assert tables.occ_rows is None
    o, d, p, ld, tmax = (_t(a) for a in _rays(jscene, 256, seed=22))
    seen = _spy_args(monkeypatch, ("closest_clustered",
                                   "closest_clustered_full",
                                   "occluded_clustered"))
    if how.startswith("full carry"):
        monkeypatch.setenv("TPT_LEAN_BIG", "0")
    if how == "pair-binned":
        monkeypatch.setenv("TPT_BINNED", "1")
    if how in ("lean", "full carry", "full carry, uv", "pair-binned"):
        clustered.closest_hit(tables, o, d, want_uv=how.endswith("uv"))
    if how in ("any-hit", "pair-binned"):
        clustered.occluded_hit(tables, p, ld, tmax)
    if how == "first-hit quirk":
        clustered.occluded_hit(tables, p, ld, tmax, quirk_first_hit=True)
    want = {"lean": ("closest_clustered",),
            "full carry": ("closest_clustered_full",),
            "full carry, uv": ("closest_clustered_full",),
            "any-hit": ("occluded_clustered",),
            "pair-binned": ("closest_clustered", "occluded_clustered"),
            "first-hit quirk": ("closest_clustered",)}[how]
    for name, calls in seen.items():
        assert bool(calls) == (name in want), (name, len(calls))
        for call in calls:
            assert _nodes_arg(call) is tables.nodes


def test_wrapper_tables(mixed_scenes, monkeypatch):
    """The launch arguments: K6 / K6f / K8 get the node table, built from
    the boxes when the caller hands none, and the walk's lanes a ray
    (``walk_group`` of the ray count unless given); the flat scans and
    K7 / K8b get neither; a table of the wrong shape is refused."""
    _, tscene = mixed_scenes
    _shrink(monkeypatch)
    tables = clustered.prepare(tscene)
    rows, boxes, cpu = tables.rows, tables.boxes, torch.device("cpu")
    handed, n_boxes, cluster, walk = clustered._tables(
        "closest_clustered", rows, boxes, tables.nodes, None, 32768, cpu)
    assert handed[0] is rows and handed[1] is boxes
    assert handed[2] is tables.nodes
    assert (n_boxes, cluster) == (8, 64)
    assert walk == (clustered.walk_group(32768),)
    handed, _, _, walk = clustered._tables("occluded_clustered", rows, boxes,
                                           None, 16, 5, cpu)
    assert len(handed) == 3 and walk == (16,)
    for name in ("closest_clustered_b", "occluded_clustered_b"):
        handed, _, _, walk = clustered._tables(name, rows, boxes, None, None,
                                               5, cpu)
        assert len(handed) == 2 and walk == ()
    with pytest.raises(ValueError):
        clustered._tables("closest_clustered_full", rows, boxes,
                          tables.nodes[:-1].contiguous(), None, 5, cpu)


@pytest.mark.parametrize("n_rays", [1, 4096, 32768, 65536, 131072, 262144,
                                    1 << 20])
def test_walk_group_is_a_built_width(n_rays):
    """The walk's lanes a ray is one of the widths the kernels are built
    for (csrc/clustered_intersect.cu, with_group), whatever the ray count."""
    assert clustered.walk_group(n_rays) in (4, 8, 16, 32)
