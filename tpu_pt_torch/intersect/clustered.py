"""Clustered ray-triangle intersection for scenes above ``TRI_SLAB``
packed rows: the port of the big-scene part of
``tpu_pt/intersect/pallas_bf.py``.

The packed rows are put in the scene's balanced-kd order
(``scene.cluster_order``, ``median_split_order``) and cut into clusters of
``CLUSTER`` rows, each with an axis-aligned box; ``cluster_tree`` stores
the kd tree over the clusters that this order is. Six kernels, each with
a wrapper, a plain PyTorch version and a launch counter (wrapper: the
kernel bodies of ``tpu_pt/intersect/pallas_bf.py`` it replaces, via their
call site; plain version):

- ``closest_clustered`` (K6): ``_closest_kernel_clustered_lean`` /
  ``_closest_kernel_chained_lean`` via ``_closest_call_clustered``;
  ``_closest_clustered_plain``;
- ``closest_clustered_full`` (K6f): ``_closest_kernel_clustered`` /
  ``_closest_kernel_chained`` via ``_closest_call_clustered(lean=False)``;
  ``_closest_clustered_full_plain``;
- ``occluded_clustered`` (K8): ``_occluded_kernel_clustered`` via
  ``_occluded_call_clustered``; ``_occluded_clustered_plain``;
- ``closest_clustered_b`` (K7 lean): ``_closest_kernel_clustered_lean_b`` /
  ``_closest_kernel_chained_lean_b`` via
  ``_closest_call_clustered(build=True)``; K6's plain version;
- ``closest_clustered_full_b`` (K7 full): ``_closest_kernel_clustered_b`` /
  ``_closest_kernel_chained_b``; K6f's plain version;
- ``occluded_clustered_b`` (K8b): ``_occluded_kernel_clustered_b`` via
  ``_occluded_call_clustered(build=True)``; K8's plain version.

Two designs. In ``csrc/clustered_intersect.cu`` (K6, K6f, K8) a group of
16 or 8 lanes (``walk_group``) walks the cluster tree for one ray, near
first, and sweeps the clusters it reaches together. In
``csrc/clustered_build.cu`` (K7, K8b) a thread block of 128 consecutive
lanes builds one shared work list, the boxes any of its rays pierces
within its bound, and sweeps the listed clusters in lockstep from shared
memory, as the TPU kernels with the in-kernel candidate build do. Either way one launch covers the table:
the TPU path's chained slabs and ray sort exist only because its table
had to fit in VMEM. The results are those of a dense sweep over every
row, which is what the plain versions compute. A wrapper runs the plain
version only for tensors on the CPU; for CUDA tensors it launches the
kernel, and for anything else it raises. The flat scans that K6, K6f and
K8 were until the tree walk (``*_flat``: each thread slab-tests every
box) stay as wrappers on no path, the yardstick ``chip_smoke.py`` holds
the walk against.

``closest_hit`` / ``occluded_hit`` pick among them as the JAX package does
(``variant``): ``TPT_LEAN_BIG=0``, or ``TPT_LEAN_UV=0`` on a call that wants
u, v, takes the full carry; ``TPT_INKB=1`` the kernels that build their
list. Ahead of those come the schedulers of ``ablations`` (K11-K13, K15,
``closest_scheduler`` / ``occluded_scheduler``): ``TPT_CBIN=1``, then
``TPT_STREAM=1``, then ``TPT_SEED=1``, then ``TPT_GRP=1`` / ``2``; and
ahead of everything, ``TPT_BINNED`` (K14). The variables are read at every
call.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from .. import vec3 as v3
from ..scene.arrays import BSDF_REFRACTION, SceneArrays, median_split_order
from . import dense
from .moller import T_FAR, Hit

CLUSTER = 128          # rows per cluster (read at call time)
EMPTY_BOX = 3e37       # all-padding clusters collapse to this far point
# The kernels cull each ray with every box grown on all sides by
#   m = BOX_MARGIN * (scale + max_k |o_k|),
# ``scale`` being the largest coordinate magnitude of the scene's boxes and
# o the ray's origin. A hit the plane + edge test accepts lies within a few
# tens of ulps of |o| + |p| + |v0| of its triangle (rounding of the plane
# distance, of the hit point p and of the edge functions), and every hit
# point lies in the scene, |p| <= scale: within ~100 eps (scale + |o|)
# with eps = 6e-8. The slab test's own rounding, a few ulps of
# |box - o|, is smaller still. A margin of 1e-4 is over ten times both, so
# the cull drops no hit that the dense sweep keeps, however far the ray
# starts from the scene.
#
# The cluster tree (``cluster_tree``) culls with the same test and drops
# nothing more. A node's box is the exact min / max of its children's, and
# each rounded step of the slab test, (lo - m - o) * inv, is monotone in
# the box coordinate, so a node's interval at margin m contains each
# descendant's: a node passes whenever a cluster under it passes, and the
# clusters a walk reaches at a bound are exactly those the flat test of
# every box passes at that bound.
BOX_MARGIN = 1e-4

# Kernel launches per wrapper (read by chip_smoke.py). Plain-version calls
# on CPU tensors do not count.
LAUNCHES = {"closest_clustered": 0, "occluded_clustered": 0,
            "closest_clustered_full": 0, "closest_clustered_b": 0,
            "closest_clustered_full_b": 0, "occluded_clustered_b": 0,
            "closest_clustered_flat": 0, "closest_clustered_full_flat": 0,
            "occluded_clustered_flat": 0}
# Ray counts up to which the walk runs 16 lanes a ray, not 8 (walk_group).
WALK_NARROW_RAYS = 65536
# Stack entries of the tree walk (csrc/clustered_intersect.cu, kStack): a
# tree deeper than this is refused.
TREE_MAX_DEPTH = 32
# Rows per cluster the list-building kernels' shared row buffers hold.
BUILD_MAX_CLUSTER = 128
# Landing-slab sentinel of the prediction-ordered scheduler: "no
# prediction" in, "slab not recoverable" (any miss) out; far above any
# slab count (``tpu_pt.intersect.SLAB_UNKNOWN``).
SLAB_UNKNOWN = 1 << 30
# The slabs the rotated chain (K11) visits and the landing-slab prediction
# counts in: TPT_CSLABS overrides their number, TPT_CSLAB their size.
CLUSTERED_SLABS = int(os.environ.get("TPT_CSLABS", 0))   # 0 = derive
CLUSTERED_SLAB = int(os.environ.get("TPT_CSLAB", 0))     # 0 = derive


def _clustered_slab_rows(n_rows: int) -> int:
    """Rows per slab of a clustered table of ``n_rows`` rows
    (``pallas_bf._clustered_slab_rows``): 16 * (rows / 100k)^0.3 slabs,
    between 4 and 64, each a multiple of 8 clusters."""
    if CLUSTERED_SLAB:
        return CLUSTERED_SLAB
    count = CLUSTERED_SLABS or max(4, min(64, round(
        16.0 * (n_rows / 1e5) ** 0.3)))
    quantum = 8 * CLUSTER
    per_slab = -(-n_rows // count)
    return max(quantum, -(-per_slab // quantum) * quantum)


def pack_tris_clustered(scene: SceneArrays):
    """Packed rows in cluster order and per-cluster boxes
    (``pallas_bf.pack_tris_clustered`` with SUPER = 1).

    Returns (rows [C * CLUSTER, 16], boxes [C, 8] with rows (min xyz,
    max xyz, 0, 0)). Rows follow ``scene.cluster_order`` (computed here
    with ``median_split_order`` when the scene has none), padded with zero
    rows to a whole number of clusters. A box spans the three vertices of
    its cluster's valid rows; an all-padding cluster collapses to the far
    point EMPTY_BOX, which every slab test fails."""
    cluster = CLUSTER
    packed = dense.pack_tris(scene)
    order = scene.cluster_order
    if order is None:
        order = torch.as_tensor(median_split_order(
            *(np.asarray(x.cpu()) for x in (scene.tri_v0, scene.tri_e1,
                                            scene.tri_e2, scene.tri_valid)),
            leaf=cluster).astype(np.int32))
    n = packed.shape[0]
    t_pad = dense._pad_to(n, cluster)
    idx = order.to(packed.device).long()
    idx = torch.cat([idx, torch.arange(idx.shape[0], t_pad,
                                       device=packed.device)])
    rows = torch.nn.functional.pad(packed, (0, 0, 0, t_pad - n))[idx]

    def corners(a):
        return torch.nn.functional.pad(a, (0, 0, 0, t_pad - a.shape[0]))[idx]

    v0 = scene.tri_v0
    pts = torch.stack([corners(v0), corners(v0 + scene.tri_e1),
                       corners(v0 + scene.tri_e2)])
    valid = (rows[:, 12:13] > 0.5)[None]
    big = 3e38
    n_c = t_pad // cluster
    lo = torch.where(valid, pts, big).amin(0).view(n_c, cluster, 3).amin(1)
    hi = torch.where(valid, pts, -big).amax(0).view(n_c, cluster, 3).amax(1)
    empty = (lo > hi).any(dim=1, keepdim=True)
    lo = torch.where(empty, EMPTY_BOX, lo)
    hi = torch.where(empty, EMPTY_BOX, hi)
    boxes = torch.cat([lo, hi, torch.zeros_like(lo[:, :2])], dim=1)
    return rows.contiguous(), boxes.contiguous()


def box_scale(boxes: torch.Tensor) -> float:
    """The largest coordinate magnitude of the real (not collapsed) boxes:
    the scene part of the kernels' culling margin (see BOX_MARGIN)."""
    real = boxes[:, 0:1] < 1e30
    return float(torch.where(real, boxes[:, 0:6].abs(), 0.0).max())


@functools.lru_cache(maxsize=16)
def _tree_links(n_clusters: int) -> tuple[np.ndarray, tuple[int, ...]]:
    """The kd tree over C clusters: children references [C - 1, 2] i32 of
    the internal nodes, breadth first (node 0 the root), and the index at
    which each level of nodes starts (a level's nodes are consecutive).
    The range arithmetic of ``median_split_order`` in cluster units: a
    run of k clusters splits into its first max(1, k // 2) and the rest.
    A reference is 2 * index + 1 for a cluster, 2 * index for a node."""
    links = np.zeros((max(n_clusters - 1, 0), 2), np.int32)
    spans = [(0, n_clusters, 0)] if n_clusters > 1 else []
    starts = [0]
    for node, (a, b, depth) in enumerate(spans):
        if depth == len(starts):
            starts.append(node)
        half = a + max(1, (b - a) // 2)
        for side, (lo, hi) in enumerate(((a, half), (half, b))):
            if hi - lo == 1:
                links[node, side] = 2 * lo + 1
            else:
                links[node, side] = 2 * len(spans)
                spans.append((lo, hi, depth + 1))
    links.flags.writeable = False          # shared by every caller
    return links, tuple(starts)


def cluster_tree(boxes: torch.Tensor) -> torch.Tensor:
    """The internal nodes [C - 1, 8] f32 of the kd tree over the clusters
    of ``boxes`` [C, 8] (``_tree_links``), on the boxes' device, laid out
    like a box: (min xyz, max xyz, the two children's references as int32
    bits). A node's box is the union of its children's, EMPTY_BOX children
    left out; a node with no real cluster under it is EMPTY_BOX itself.
    Host numpy over the C boxes, level by level, once per ``prepare``."""
    n_c = boxes.shape[0]
    links, starts = _tree_links(n_c)
    n_n = links.shape[0]
    host = boxes[:, 0:6].cpu().numpy()
    # Nodes then clusters in one table; an empty cluster is (+inf, -inf),
    # which min / max pass over.
    table = np.empty((n_n + n_c, 6), np.float32)
    empty = host[:, 0:1] > 1e30
    table[n_n:, 0:3] = np.where(empty, np.inf, host[:, 0:3])
    table[n_n:, 3:6] = np.where(empty, -np.inf, host[:, 3:6])
    row = np.where(links & 1, n_n + (links >> 1), links >> 1)
    # Deepest level first: a node's children are on the level below.
    for a, b in reversed(list(zip(starts, starts[1:] + (n_n,)))):
        k0, k1 = table[row[a:b, 0]], table[row[a:b, 1]]
        table[a:b, 0:3] = np.minimum(k0[:, 0:3], k1[:, 0:3])
        table[a:b, 3:6] = np.maximum(k0[:, 3:6], k1[:, 3:6])
    node = table[:n_n]
    node = np.where(node[:, 0:1] > node[:, 3:4], np.float32(EMPTY_BOX), node)
    out = np.concatenate([node, links.view(np.float32)], 1)
    return torch.as_tensor(out).to(boxes.device).contiguous()


def tree_depth(n_clusters: int) -> int:
    """Levels of internal nodes above the deepest cluster of
    ``_tree_links``: ceil(log2 C)."""
    return max(n_clusters - 1, 0).bit_length()


def _tree_leaves_plain(origins, dirs, nodes, boxes, scale: float,
                       tmin: float, bound):
    """Plain level-by-level walk of the cluster tree at a fixed bound
    ([N] or a float): (reached [N, C] bool, node tests [N] i64). A cluster
    is reached when its grown box and every ancestor's pass the kernels'
    slab test within (tmin, bound]; each opened node tests both children,
    and the root is tested once (``walk_tree`` of
    ``csrc/clustered_intersect.cu``, at its final bound)."""
    from . import ablations
    n, n_c = origins.shape[0], boxes.shape[0]
    bound = torch.as_tensor(bound, dtype=torch.float32,
                            device=origins.device).expand(n)[:, None]
    inv = ablations._ray_inv(dirs)
    m = ablations._margin(origins, scale)

    def passes(table):
        tn, tf = ablations._near_far(origins, inv, m, table)
        return (tn <= tf) & (tf > tmin) & (tn <= bound)

    box_ok = passes(boxes)
    if n_c == 1:
        return box_ok, torch.ones(n, dtype=torch.int64, device=origins.device)
    return _walk_levels(box_ok, passes(nodes),
                        nodes[:, 6:8].contiguous().view(torch.int32).long())


def _walk_levels(box_ok, node_ok, links):
    """The plain walk of a tree with nodes, level by level: (reached
    [N, L] bool, node tests [N] i64) from each ray's pass of every leaf
    (``box_ok`` [N, L]) and node (``node_ok`` [N, nodes]) and the
    children's references ``links`` [nodes, 2] (2 * leaf + 1 or
    2 * node). A leaf is reached when it and every ancestor pass; each
    opened node tests both children, and the root (node 0) is tested
    once."""
    tests = torch.ones(box_ok.shape[0], dtype=torch.int64,
                       device=box_ok.device)
    reached = torch.zeros_like(box_ok)
    level = links.new_zeros(1)               # the nodes of this level
    opened = node_ok[:, 0:1]                 # and which each ray opens
    while level.numel():
        tests += 2 * opened.sum(1)
        kids = links[level].reshape(-1)
        parent = torch.arange(level.numel(),
                              device=kids.device).repeat_interleave(2)
        leaf = (kids & 1) == 1
        lf, nd = kids[leaf] >> 1, kids[~leaf] >> 1
        reached[:, lf] = opened[:, parent[leaf]] & box_ok[:, lf]
        opened = opened[:, parent[~leaf]] & node_ok[:, nd]
        level = nd
    return reached, tests


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference): a dense
# exact sweep over every clustered row.
# --------------------------------------------------------------------------

# Plain version of K6: per ray, (t, packed row) of the closest hit with
# t < tmax over all rows; t = T_FAR and row 0 on a miss, ties to the
# lowest row.
_closest_clustered_plain = dense._closest_plain
# Plain version of K8: any hit with tmin < t < tmax[i] on a row whose
# refractive column is < 0.5 (the same function as K2's). bool [N].
_occluded_clustered_plain = dense._occluded_plain


def _closest_clustered_full_plain(origins, dirs, tris, tmin: float,
                                  tmax: float = T_FAR, want_uv: bool = True):
    """Plain version of K6f: K3's plain version (the dense full-carry
    sweep) over the clustered rows, with the winner's original triangle id
    read from column 15. Returns (t, id, normal, mat, u, v), zeros on a
    miss; u, v are zeros without ``want_uv``."""
    t, row, normal, mat, u, v = dense._closest_plain(
        origins, dirs, tris, tmin, tmax, full=True, want_uv=want_uv)
    tri = torch.where(t < T_FAR, tris[row.long(), 15], 0.0).to(torch.int32)
    return t, tri, normal, mat, u, v


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check_tables(tris: torch.Tensor, boxes: torch.Tensor,
                  device: torch.device) -> tuple[int, int]:
    n_boxes = boxes.shape[0]
    dense._check("boxes", boxes, torch.float32, (n_boxes, 8), device)
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (float4 loads)")
    if not n_boxes or tris.shape[0] % n_boxes:
        raise ValueError(f"{tris.shape[0]} rows do not split into "
                         f"{n_boxes} clusters")
    return n_boxes, tris.shape[0] // n_boxes


def _check_build(cluster: int) -> None:
    if cluster > BUILD_MAX_CLUSTER:
        raise ValueError(f"the list-building kernels hold clusters of at "
                         f"most {BUILD_MAX_CLUSTER} rows, not {cluster}")


def _check_nodes(nodes: torch.Tensor, n_boxes: int,
                 device: torch.device) -> None:
    """A node table of ``cluster_tree`` for ``n_boxes`` clusters, whose
    depth (``tree_depth``) the walk's stack holds."""
    dense._check("nodes", nodes, torch.float32, (n_boxes - 1, 8), device)
    if nodes.data_ptr() % 16:
        raise ValueError("nodes must be 16-byte aligned (float4 loads)")
    if tree_depth(n_boxes) > TREE_MAX_DEPTH:
        raise ValueError(f"a tree over {n_boxes} clusters is deeper than the "
                         f"walk's {TREE_MAX_DEPTH}-entry stack")


def walk_group(n_rays: int) -> int:
    """Lanes a ray of the tree walk (K6, K6f, K8) for a call of ``n_rays``
    rays: the width tools/clustered_group_trial.py measured fastest on the
    big mesh (PERF.md), 16 up to WALK_NARROW_RAYS (the big-mesh frame's
    32,768 lanes, pbr_big's 65,536), where fewer rays must fill the card,
    and 8 above (131,072 and 262,144)."""
    return 16 if n_rays <= WALK_NARROW_RAYS else 8


def _tables(name: str, tris, boxes, nodes, group, n: int, dev):
    """(the tables, n_boxes, cluster, the walk's group) of a clustered
    launch: the rows and boxes; for the walking kernels (K6, K6f, K8) the
    node table (built from the boxes when the caller has none) and the
    lanes a ray (``walk_group`` when None), else an empty tuple. The
    caller holds the tables until the launch is queued."""
    n_boxes, cluster = _check_tables(tris, boxes, dev)
    tables, walk = (tris, boxes), ()
    if name.endswith("_b"):
        _check_build(cluster)
    elif not name.endswith("_flat"):
        if nodes is None:
            nodes = cluster_tree(boxes)
        _check_nodes(nodes, n_boxes, dev)
        tables += (nodes,)
        walk = (walk_group(n) if group is None else int(group),)
    return tables, n_boxes, cluster, walk


def _launch_lean(name: str, origins, dirs, tris, boxes, scale, tmin, tmax,
                 nodes=None, group=None):
    """Launch a closest (t, packed row) kernel: K6, its flat scan or K7
    lean."""
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    tables, n_boxes, cluster, walk = _tables(name, tris, boxes, nodes, group,
                                             n, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _kernels.launch("tpt_" + name, origins.data_ptr(),
                        dirs.data_ptr(), *(x.data_ptr() for x in tables),
                        n, n_boxes, cluster, float(scale), BOX_MARGIN,
                        float(tmin), float(tmax),
                        t.data_ptr(), row.data_ptr(), *walk,
                        dense._stream(dev))
        LAUNCHES[name] += 1
    return t, row


def _launch_full(name: str, origins, dirs, tris, boxes, scale, tmin, tmax,
                 want_uv, nodes=None, group=None):
    """Launch a full-carry closest-hit kernel: K6f, its flat scan or K7
    full."""
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    tables, n_boxes, cluster, walk = _tables(name, tris, boxes, nodes, group,
                                             n, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    tri = torch.empty(n, dtype=torch.int32, device=dev)
    normal = torch.empty((n, 3), dtype=torch.float32, device=dev)
    mat = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        _kernels.launch("tpt_" + name, origins.data_ptr(),
                        dirs.data_ptr(), *(x.data_ptr() for x in tables),
                        n, n_boxes, cluster, float(scale), BOX_MARGIN,
                        float(tmin), float(tmax),
                        int(bool(want_uv)), t.data_ptr(), tri.data_ptr(),
                        normal.data_ptr(), mat.data_ptr(), u.data_ptr(),
                        v.data_ptr(), *walk, dense._stream(dev))
        LAUNCHES[name] += 1
    return t, tri, normal, mat, u, v


def _launch_occluded(name: str, origins, dirs, tmax, tris, boxes, scale,
                     tmin, nodes=None, group=None):
    """Launch a clustered any-hit kernel: K8, its flat scan or K8b."""
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    dense._check("tmax", tmax, torch.float32, (n,), dev)
    tables, n_boxes, cluster, walk = _tables(name, tris, boxes, nodes, group,
                                             n, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _kernels.launch("tpt_" + name, origins.data_ptr(),
                        dirs.data_ptr(), tmax.data_ptr(),
                        *(x.data_ptr() for x in tables), n, n_boxes,
                        cluster, float(scale), BOX_MARGIN, float(tmin),
                        out.data_ptr(), *walk, dense._stream(dev))
        LAUNCHES[name] += 1
    return out


def closest_clustered(origins: torch.Tensor, dirs: torch.Tensor,
                      tris: torch.Tensor, boxes: torch.Tensor, scale: float,
                      tmin: float, tmax: float = T_FAR,
                      nodes: torch.Tensor | None = None):
    """K6: per ray, (t, packed row) of the closest hit with t < tmax over
    all clustered ``tris`` rows (t = T_FAR and row 0 on a miss). Rays
    [N, 3] f32, rows [C * cluster, 16] f32, cluster boxes [C, 8] f32,
    their ``box_scale`` (the culling margin, BOX_MARGIN) and their
    ``cluster_tree`` (built here when None)."""
    if dense._on_cpu(origins):
        return _closest_clustered_plain(origins, dirs, tris, tmin, tmax)
    return _launch_lean("closest_clustered", origins, dirs, tris, boxes,
                        scale, tmin, tmax, nodes)


def closest_clustered_flat(origins: torch.Tensor, dirs: torch.Tensor,
                           tris: torch.Tensor, boxes: torch.Tensor,
                           scale: float, tmin: float, tmax: float = T_FAR):
    """K6's function through the flat scan (each thread slab-tests every
    box): on no path, the yardstick of the walk."""
    if dense._on_cpu(origins):
        return _closest_clustered_plain(origins, dirs, tris, tmin, tmax)
    return _launch_lean("closest_clustered_flat", origins, dirs, tris, boxes,
                        scale, tmin, tmax)


def closest_clustered_b(origins: torch.Tensor, dirs: torch.Tensor,
                        tris: torch.Tensor, boxes: torch.Tensor, scale: float,
                        tmin: float, tmax: float = T_FAR):
    """K7 lean: K6's function through the kernel whose thread blocks build
    and sweep a shared work list."""
    if dense._on_cpu(origins):
        return _closest_clustered_plain(origins, dirs, tris, tmin, tmax)
    return _launch_lean("closest_clustered_b", origins, dirs, tris, boxes,
                        scale, tmin, tmax)


def closest_clustered_full(origins: torch.Tensor, dirs: torch.Tensor,
                           tris: torch.Tensor, boxes: torch.Tensor,
                           scale: float, tmin: float, tmax: float = T_FAR,
                           want_uv: bool = True,
                           nodes: torch.Tensor | None = None):
    """K6f: K6 with the full carry. Per ray (t, original triangle id,
    normal [N, 3], material id, u, v) of the closest hit with t < tmax,
    zeros on a miss; u, v are the winning row's edge functions at the hit
    point, zeros without ``want_uv``."""
    if dense._on_cpu(origins):
        return _closest_clustered_full_plain(origins, dirs, tris, tmin, tmax,
                                             want_uv)
    return _launch_full("closest_clustered_full", origins, dirs, tris, boxes,
                        scale, tmin, tmax, want_uv, nodes)


def closest_clustered_full_flat(origins: torch.Tensor, dirs: torch.Tensor,
                                tris: torch.Tensor, boxes: torch.Tensor,
                                scale: float, tmin: float,
                                tmax: float = T_FAR, want_uv: bool = True):
    """K6f's function through the flat scan: on no path."""
    if dense._on_cpu(origins):
        return _closest_clustered_full_plain(origins, dirs, tris, tmin, tmax,
                                             want_uv)
    return _launch_full("closest_clustered_full_flat", origins, dirs, tris,
                        boxes, scale, tmin, tmax, want_uv)


def closest_clustered_full_b(origins: torch.Tensor, dirs: torch.Tensor,
                             tris: torch.Tensor, boxes: torch.Tensor,
                             scale: float, tmin: float, tmax: float = T_FAR,
                             want_uv: bool = True):
    """K7 full: K6f's function through the list-building kernel."""
    if dense._on_cpu(origins):
        return _closest_clustered_full_plain(origins, dirs, tris, tmin, tmax,
                                             want_uv)
    return _launch_full("closest_clustered_full_b", origins, dirs, tris,
                        boxes, scale, tmin, tmax, want_uv)


def occluded_clustered(origins: torch.Tensor, dirs: torch.Tensor,
                       tmax: torch.Tensor, tris: torch.Tensor,
                       boxes: torch.Tensor, scale: float, tmin: float,
                       nodes: torch.Tensor | None = None) -> torch.Tensor:
    """K8: per ray, is any non-refractive clustered row hit with
    tmin < t < tmax[i] (tmax[i] <= T_FAR)? Returns bool [N]."""
    if dense._on_cpu(origins):
        return _occluded_clustered_plain(origins, dirs, tmax, tris, tmin)
    return _launch_occluded("occluded_clustered", origins, dirs, tmax, tris,
                            boxes, scale, tmin, nodes)


def occluded_clustered_flat(origins: torch.Tensor, dirs: torch.Tensor,
                            tmax: torch.Tensor, tris: torch.Tensor,
                            boxes: torch.Tensor, scale: float,
                            tmin: float) -> torch.Tensor:
    """K8's function through the flat scan: on no path."""
    if dense._on_cpu(origins):
        return _occluded_clustered_plain(origins, dirs, tmax, tris, tmin)
    return _launch_occluded("occluded_clustered_flat", origins, dirs, tmax,
                            tris, boxes, scale, tmin)


def occluded_clustered_b(origins: torch.Tensor, dirs: torch.Tensor,
                         tmax: torch.Tensor, tris: torch.Tensor,
                         boxes: torch.Tensor, scale: float,
                         tmin: float) -> torch.Tensor:
    """K8b: K8's function through the list-building kernel, each block's
    list bounded by its rays' own tmax."""
    if dense._on_cpu(origins):
        return _occluded_clustered_plain(origins, dirs, tmax, tris, tmin)
    return _launch_occluded("occluded_clustered_b", origins, dirs, tmax, tris,
                            boxes, scale, tmin)


# --------------------------------------------------------------------------
# Intersector entry points
# --------------------------------------------------------------------------

@dataclasses.dataclass
class ClusteredTables:
    """A big scene's tables, built once per render."""
    rows: torch.Tensor            # K6 / K8 table, cluster order
    boxes: torch.Tensor           # [C, 8] cluster boxes
    nodes: torch.Tensor           # [C - 1, 8] their tree (cluster_tree)
    scale: float                  # their box_scale
    occ_rows: torch.Tensor | None  # K2 table (small occluder subset) or None
    mat_bsdf: torch.Tensor        # [M] i32, for the first-hit occlusion quirk


def prepare(scene: SceneArrays) -> ClusteredTables:
    """Clustered tables of ``scene``, the cluster tree included (one host
    sync). Shadow rays sweep the NEE occluder subset with K2 when it has at
    most TRI_SLAB rows, and the whole clustered table with K8 otherwise
    (``pallas_bf.intersect_occluded``)."""
    rows, boxes = pack_tris_clustered(scene)
    sub = dense._occ_subset(scene)
    occ_rows = None
    if sub is not None and sub[0].shape[0] <= dense.TRI_SLAB:
        occ_rows = dense._trim_rows(sub[1], sub[0]).contiguous()
    return ClusteredTables(rows=rows, boxes=boxes, nodes=cluster_tree(boxes),
                           scale=box_scale(boxes), occ_rows=occ_rows,
                           mat_bsdf=scene.mat_bsdf)


def _lean_resolve_packed(tris: torch.Tensor, origins, dirs, t, row,
                         want_uv: bool) -> Hit:
    """Hit from K6's (t, packed row) by a plain gather of the row
    (``pallas_bf._lean_resolve_packed``): normal from columns 0:3,
    material from 14, the original triangle id from 15, u/v from the edge
    functions (columns 4:12) at the hit point."""
    hit = t < T_FAR
    rows = torch.where(hit[:, None], tris[row.long()], 0.0)
    if want_uv:
        p = origins + t[:, None] * dirs
        u = torch.where(hit, v3.dot(rows[:, 4:7], p) + rows[:, 7], 0.0)
        v = torch.where(hit, v3.dot(rows[:, 8:11], p) + rows[:, 11], 0.0)
    else:
        u = v = torch.zeros_like(t)
    return Hit(t=t, tri=torch.round(rows[:, 15]).to(torch.int32), hit=hit,
               normal=rows[:, 0:3], mat=torch.round(rows[:, 14]).to(torch.int32),
               u=u, v=v)


def variant(want_uv: bool) -> tuple[bool, bool]:
    """(full carry?, list built in the kernel?) for a clustered call, from
    the JAX package's variables, read now: the lean (t, row) carry unless
    ``TPT_LEAN_BIG=0``, or ``TPT_LEAN_UV=0`` on a call that wants u, v
    (``pallas_bf.py:2354-2357``); the list-building kernels with
    ``TPT_INKB=1`` (``pallas_bf._inkb``; its supercluster limit is a
    bf16-exactness limit of the TPU's matmuls and has no twin)."""
    env = os.environ.get
    lean = ((not want_uv or env("TPT_LEAN_UV", "1") == "1")
            and env("TPT_LEAN_BIG", "1") == "1")
    return not lean, env("TPT_INKB", "0") == "1"


def closest_scheduler(want_uv: bool, has_pred: bool, n_rows: int) -> str:
    """Which scheduler a clustered closest-hit call takes
    (``pallas_bf.py:2354-2375``, ``:2442-2480``), the variables read now:
    ``"cbin"`` (``TPT_CBIN=1``) before ``"stream"`` (``TPT_STREAM=1``)
    before ``"rot"`` (``TPT_SEED=1``) before ``"grp"`` (``TPT_GRP=1`` or
    ``2``), else ``"chain"``: K6 / K7 or their full-carry twins by
    ``variant``. All four need the lean carry; ``rot`` also needs a
    prediction, ``TPT_SORT_KEY`` unset or ``dir12``, and a table of more
    than one slab. ``TPT_BINNED`` comes before all of them, in
    ``closest_hit``."""
    env = os.environ.get
    if variant(want_uv)[0]:
        return "chain"
    if env("TPT_CBIN", "0") == "1":
        return "cbin"
    if env("TPT_STREAM", "0") == "1":
        return "stream"
    if (has_pred and env("TPT_SEED", "0") == "1"
            and env("TPT_SORT_KEY", "dir12") == "dir12"
            and n_rows > _clustered_slab_rows(n_rows)):
        return "rot"
    if env("TPT_GRP", "0") in ("1", "2"):
        return "grp"
    return "chain"


def occluded_scheduler(allow_cbin: bool = True) -> str:
    """Which scheduler a clustered any-hit call takes
    (``pallas_bf.py:2609-2672``): ``"cbin"`` (``TPT_CBIN=1`` unless
    ``TPT_CBIN_OCC=0``) before ``"stream"`` before ``"grp"`` (``TPT_GRP=1``
    or ``2``, any carry) before ``"chain"`` (K8 / K8b)."""
    env = os.environ.get
    if (allow_cbin and env("TPT_CBIN", "0") == "1"
            and env("TPT_CBIN_OCC", "1") == "1"):
        return "cbin"
    if env("TPT_STREAM", "0") == "1":
        return "stream"
    if env("TPT_GRP", "0") in ("1", "2"):
        return "grp"
    return "chain"


def closest_hit(tables: ClusteredTables, origins: torch.Tensor,
                dirs: torch.Tensor, tmin: float = 0.01,
                tmax: float = T_FAR, want_uv: bool = True, pred=None,
                want_slab: bool = False, allow_binned: bool = True):
    """Closest hit (``pallas_bf.intersect_closest`` /
    ``_intersect_closest_tiled``, clustered branches): K6 (or K7 lean) and
    a gather of the winning rows, or with the full carry K6f (or K7 full)
    and no gather; ``variant`` chooses. ``closest_scheduler`` puts K13,
    K12, K11 or K15 in K6's place. ``TPT_BINNED`` in (``1``, ``closest``)
    takes K14 before all of them, whatever the carry, and finishes its
    overflow through this function with ``allow_binned=False``. ``pred``
    [N] i32 is each ray's predicted landing slab (it orders K11's slab
    visits and nothing else). With ``want_slab`` returns (Hit, slab [N]
    i32): the slab of the winning row on the lean carry, ``SLAB_UNKNOWN``
    on a miss, on the full carry and under K14."""
    args = (origins, dirs, tables.rows, tables.boxes, tables.scale, tmin,
            tmax)
    if allow_binned:
        from . import ablations
        if ablations.binned_sides()[0]:
            hit = ablations.closest_binned_path(
                *args, want_uv=want_uv,
                finish=lambda o, d: closest_hit(tables, o, d, tmin, tmax,
                                                want_uv, allow_binned=False),
                nodes=tables.nodes)
            if not want_slab:
                return hit
            return hit, torch.full((origins.shape[0],), SLAB_UNKNOWN,
                                   dtype=torch.int32, device=origins.device)
    full, build = variant(want_uv)
    if full:
        if build:
            t, tri, normal, mat, u, v = closest_clustered_full_b(*args,
                                                                 want_uv)
        else:
            t, tri, normal, mat, u, v = closest_clustered_full(
                *args, want_uv, tables.nodes)
        hit = Hit(t=t, tri=tri, hit=t < T_FAR, normal=normal, mat=mat, u=u,
                  v=v)
        if not want_slab:
            return hit
        return hit, torch.full((origins.shape[0],), SLAB_UNKNOWN,
                               dtype=torch.int32, device=origins.device)
    from . import ablations
    n_rows = tables.rows.shape[0]
    how = closest_scheduler(want_uv, pred is not None, n_rows)
    if how == "cbin":
        t, row = ablations.closest_cbin_path(*args)
    elif how == "stream":
        t, row = ablations.closest_stream_path(*args)
    elif how == "rot":
        t, row = ablations.closest_rotated(
            origins, dirs, tables.rows, tables.boxes, tables.scale,
            pred.to(torch.int32).contiguous(), _clustered_slab_rows(n_rows),
            tmin, tmax)
    elif how == "grp":
        t, row = ablations.closest_grp_path(*args)
    elif build:
        t, row = closest_clustered_b(*args)
    else:
        t, row = closest_clustered(*args, tables.nodes)
    hit = _lean_resolve_packed(tables.rows, origins, dirs, t, row, want_uv)
    if not want_slab:
        return hit
    # The lean carry's row is the packed row: its slab is a division.
    slab = torch.where(t < T_FAR, row // _clustered_slab_rows(n_rows),
                       SLAB_UNKNOWN).to(torch.int32)
    return hit, slab


def occluded_hit(tables: ClusteredTables, origins: torch.Tensor,
                 dirs: torch.Tensor, tmax: torch.Tensor, tmin: float = 0.01,
                 quirk_first_hit: bool = False, allow_cbin: bool = True,
                 allow_binned: bool = True) -> torch.Tensor:
    """Any-hit occlusion with per-ray tmax (``pallas_bf.intersect_occluded``):
    K2 over a small occluder subset, else over the clustered table K14
    (``TPT_BINNED`` in ``1``, ``occ``), K13, K12, K15
    (``occluded_scheduler``) or K8 (K8b with ``TPT_INKB=1``); refractive
    surfaces pass light. K14 finishes its overflow through this function
    with ``allow_binned=False``, K13 with ``allow_cbin=False``."""
    if quirk_first_hit:
        h = closest_hit(tables, origins, dirs, tmin=tmin, want_uv=False)
        in_range = h.hit & (h.t < tmax)
        return in_range & (tables.mat_bsdf[h.mat.long()] != BSDF_REFRACTION)
    if tables.occ_rows is not None:
        return dense.occluded(origins, dirs, tmax, tables.occ_rows, tmin)
    how = occluded_scheduler(allow_cbin)
    from . import ablations
    table = (tables.rows, tables.boxes, tables.scale, tmin)
    if allow_binned and ablations.binned_sides()[1]:
        return ablations.occluded_binned_path(
            origins, dirs, tmax, *table,
            finish=lambda o, d, tm: occluded_hit(
                tables, o, d, tm, tmin, allow_cbin=allow_cbin,
                allow_binned=False), nodes=tables.nodes)
    if how != "chain":
        if how == "stream":
            return ablations.occluded_stream_path(origins, dirs, tmax, *table)
        if how == "grp":
            return ablations.occluded_grp_path(origins, dirs, tmax, *table)
        return ablations.occluded_cbin_path(
            origins, dirs, tmax, *table,
            finish=lambda o, d, tm: occluded_hit(tables, o, d, tm, tmin,
                                                 allow_cbin=False,
                                                 allow_binned=False))
    if variant(False)[1]:
        return occluded_clustered_b(origins, dirs, tmax, tables.rows,
                                    tables.boxes, tables.scale, tmin)
    return occluded_clustered(origins, dirs, tmax, tables.rows, tables.boxes,
                              tables.scale, tmin, tables.nodes)
