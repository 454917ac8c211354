"""Instanced (two-level) ray-triangle intersection: the port of
``tpu_pt/intersect/pallas_inst.py``, the analogue of the reference's
GAS + IAS (``sutil/Scene.cpp:1134-1213``).

The unique meshes stay in mesh space, packed once per mesh into whole
clusters of ``clustered.CLUSTER`` rows with mesh-space cluster boxes
(``pack_tris_instanced``); instances are rows of an :class:`InstanceTable`
(inverse 3x4, cluster range, world box). Two kernels, each with a
wrapper, a plain PyTorch version and a launch counter:

==========================  ======================================  ===========================
wrapper                     replaces (``tpu_pt/intersect/...``)     plain version
==========================  ======================================  ===========================
``closest_inst`` (K9)       ``pallas_inst._closest_kernel_inst``     ``_closest_inst_plain``
                            via ``_closest_call_inst``
``occluded_inst`` (K10)     ``pallas_inst._occluded_kernel_inst``    ``_occluded_inst_plain``
                            via ``_occluded_call_inst``
==========================  ======================================  ===========================

The CUDA kernels are in ``csrc/instanced_intersect.cu``, one launch per
call. K9 gives a ray to a group of lanes (``walk_group``), which walks
a tree over the instances near first (``instance_tree``, built once per
``prepare``), then culls each reached instance's clusters by their
mesh-space boxes and sweeps the rest together. K10 traverses for its ray
in each thread (every instance by world box, then the clusters of each
pierced instance's mesh). K9's flat loop of that kind stays as
``closest_inst_flat``, on no path, the yardstick ``chip_smoke.py`` holds
the walk against. The TPU path's ray sort, per-tile candidate lists and
one-hot row selects exist only for the TPU; here the winning instance's
rows are gathers. A wrapper runs the plain version only for tensors on
the CPU; for CUDA tensors it launches the kernel, and for anything else
it raises.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch

from .. import vec3 as v3
from ..scene.arrays import SceneArrays, median_split_order
from . import clustered, dense
from .moller import T_FAR, Hit

# Eligibility bounds of the instanced contract, kept at the JAX package's
# values so that ``load_gltf(instancing="auto")`` picks the same contract
# for the same asset. They come from the TPU kernels keeping the whole
# mesh table (8,192 rows = 512 KB) and instance table (16,384 rows = 1 MB)
# in VMEM; the CUDA kernels read both from device memory and are bound by
# neither.
INST_MAX_ROWS = 8192
INST_MAX_INST = 16384
# The mesh table pads to whole groups of this many clusters
# (``pallas_inst.pack_tris_instanced``), and the eligibility bound counts
# the padding too.
TABLE_CLUSTERS = 8

# Kernel launches per wrapper (read by chip_smoke.py). Plain-version calls
# on CPU tensors do not count.
LAUNCHES = {"closest_inst": 0, "occluded_inst": 0, "closest_inst_flat": 0}
# Ray counts up to which K9's walk runs 16 lanes a ray, not 8
# (walk_group).
WALK_NARROW_RAYS = 65536


@dataclasses.dataclass
class InstanceTable:
    """Instances of the unique meshes (``pallas_inst.InstanceTable``).

    ``rows`` [I_pad, 16]: cols 0:12 the mesh-from-world (inverse) 3x4,
    row-major; col 12 the instance's first cluster in the packed mesh
    table, col 13 its cluster count, col 14 its id. ``nrm`` [I_pad, 9]:
    sign(det M) (M^-1)^T, mesh normal -> world (un-normalised).
    ``fwd`` [I_pad, 9]: the forward linear part M (tangents).
    ``boxes`` [I_pad, 8]: world boxes (min xyz, max xyz), then the two
    coefficients (a, b) of the kernels' world culling margin
    a * max|o| + b (the JAX table leaves cols 6:8 zero). Padding
    instances carry far-point boxes and no clusters."""
    rows: torch.Tensor
    nrm: torch.Tensor
    fwd: torch.Tensor
    boxes: torch.Tensor
    count: int
    mesh_ranges: tuple       # ((tri_lo, tri_hi), ...) per unique mesh

    def to(self, device) -> "InstanceTable":
        return dataclasses.replace(
            self, rows=self.rows.to(device), nrm=self.nrm.to(device),
            fwd=self.fwd.to(device), boxes=self.boxes.to(device))


def build_instance_table(mesh_ranges, mesh_aabbs, instances) -> InstanceTable:
    """Host build (``pallas_inst.build_instance_table``, the same rows,
    ``nrm``, ``fwd`` and world boxes).

    ``mesh_ranges``: [(tri_lo, tri_hi)] per unique mesh.
    ``mesh_aabbs``: [(min3, max3)] mesh-space boxes. ``instances``:
    [(mesh slot, world 4x4)]. Cluster offsets follow
    ``pack_tris_instanced``: each mesh padded to whole clusters, in
    order."""
    n = len(instances)
    if n == 0:
        raise ValueError("instanced scene with no instances")
    if n > INST_MAX_INST:
        raise ValueError(f"{n} instances exceeds the instanced-path bound "
                         f"{INST_MAX_INST}")
    cluster = clustered.CLUSTER
    c_lo, c_cnt, off = [], [], 0
    for lo, hi in mesh_ranges:
        cnt = dense._pad_to(hi - lo, cluster) // cluster
        c_lo.append(off)
        c_cnt.append(cnt)
        off += cnt
    i_pad = dense._pad_to(n, 8)
    rows = np.zeros((i_pad, 16), np.float32)
    nrm = np.zeros((i_pad, 9), np.float32)
    fwd = np.zeros((i_pad, 9), np.float32)
    boxes = np.full((i_pad, 8), clustered.EMPTY_BOX, np.float32)
    for i, (slot, m) in enumerate(instances):
        m = np.asarray(m, np.float64).reshape(4, 4)
        lin = m[:3, :3]
        inv = np.linalg.inv(m)
        rows[i, 0:12] = inv[:3, :4].reshape(-1).astype(np.float32)
        rows[i, 12] = c_lo[slot]
        rows[i, 13] = c_cnt[slot]
        rows[i, 14] = i
        det_sign = 1.0 if np.linalg.det(lin) >= 0 else -1.0
        nrm[i] = (det_sign * np.linalg.inv(lin).T).reshape(-1)
        fwd[i] = lin.reshape(-1).astype(np.float32)
        lo3, hi3 = mesh_aabbs[slot]
        corners = np.array([[x, y, z]
                            for x in (lo3[0], hi3[0])
                            for y in (lo3[1], hi3[1])
                            for z in (lo3[2], hi3[2])], np.float64)
        wc = corners @ lin.T + m[:3, 3]
        boxes[i, 0:3] = wc.min(axis=0)
        boxes[i, 3:6] = wc.max(axis=0)
    return InstanceTable(
        rows=torch.as_tensor(rows), nrm=torch.as_tensor(nrm),
        fwd=torch.as_tensor(fwd),
        boxes=torch.as_tensor(culling_margins(rows, fwd, boxes, n)),
        count=n,
        mesh_ranges=tuple(tuple(int(x) for x in r) for r in mesh_ranges))


def culling_margins(rows: np.ndarray, fwd: np.ndarray, boxes: np.ndarray,
                    count: int) -> np.ndarray:
    """``boxes`` with cols 6:8 set to each instance's world culling margin
    coefficients (a, b): the kernels grow instance c's world box by
    a * max|o| + b (csrc/instanced_intersect.cu, "Exact culling"), with
    a = BOX_MARGIN * K and b = BOX_MARGIN * (K * scale_w + ||M||inf
    * max|m3|): K = ||M||inf ||M^-1||inf, m3 the inverse's translation
    column and scale_w the largest coordinate magnitude of the real world
    boxes (an empty subset mesh's far-point box is not real). Computed in
    float64 from the f32 table, so a table carried over from the JAX
    package gets the same margins."""
    out = np.array(boxes, np.float32)
    out[:, 6:8] = 0.0
    mag = np.abs(out[:count, 0:6]).max(axis=1)
    real = mag < 1e30
    scale_w = float(mag[real].max()) if real.any() else 0.0
    inv = np.asarray(rows[:count, 0:12], np.float64).reshape(-1, 3, 4)
    lin = np.asarray(fwd[:count], np.float64).reshape(-1, 3, 3)
    norm_m = np.abs(lin).sum(axis=2).max(axis=1)
    k = norm_m * np.abs(inv[:, :, :3]).sum(axis=2).max(axis=1)
    a = clustered.BOX_MARGIN * k
    out[:count, 6] = a
    out[:count, 7] = a * scale_w + clustered.BOX_MARGIN * norm_m * np.abs(
        inv[:, :, 3]).max(axis=1)
    return out


@dataclasses.dataclass
class InstanceTree:
    """The tree K9 walks over the real instances of an instance table
    (``instance_tree``): ``nodes`` [n - 1, 12] f32 (min xyz, max xyz, the
    margin coefficients a, b, the two children's references as int32
    bits, 0, 0), and ``root``, the reference the walk starts from: node 0
    (reference 0), or with one real instance its leaf (2 * index + 1). A
    reference is 2 * index + 1 for instance ``index`` of the table,
    2 * index for node ``index``."""
    nodes: torch.Tensor
    root: int


def instance_tree(boxes: torch.Tensor) -> InstanceTree:
    """The tree over the instances of ``boxes`` [I, 8] (world box, then
    the margin coefficients a, b), on the boxes' device. The real
    instances (a box below 1e30: padding instances and empty subset
    meshes carry the far point 3e37 and stay out) are ordered by a
    median split of their box centres (``median_split_order`` at one
    instance a leaf), and ``clustered._tree_links`` splits that order: a
    node's box is the exact min / max union of its children's, and its
    (a, b) their element-wise max, so that the walk's cull is exact
    (``csrc/walk.cuh``). Leaves keep the instances' table indices. Host
    numpy, once per ``prepare``."""
    host = boxes.cpu().numpy().astype(np.float32)
    real = np.nonzero(np.abs(host[:, 0:6]).max(axis=1) < 1e30)[0]
    n = real.shape[0]
    empty = torch.zeros((0, 12), dtype=torch.float32, device=boxes.device)
    if n <= 1:
        # One leaf (or none: instance 0's far box fails every ray).
        return InstanceTree(nodes=empty, root=2 * int(real[0]) + 1 if n
                            else 1)
    centre = ((host[real, 0:3].astype(np.float64)
               + host[real, 3:6].astype(np.float64)) / 2.0)
    zero = np.zeros_like(centre)
    order = real[median_split_order(centre, zero, zero,
                                    np.ones(n, bool), leaf=1)]
    links, starts = clustered._tree_links(n)
    n_n = links.shape[0]
    # Nodes then leaves (in the split order) in one table.
    table = np.empty((n_n + n, 8), np.float32)
    table[n_n:] = host[order]
    row = np.where(links & 1, n_n + (links >> 1), links >> 1)
    # Deepest level first: a node's children are on the level below.
    for a, b in reversed(list(zip(starts, starts[1:] + (n_n,)))):
        k0, k1 = table[row[a:b, 0]], table[row[a:b, 1]]
        table[a:b, 0:3] = np.minimum(k0[:, 0:3], k1[:, 0:3])
        table[a:b, 3:8] = np.maximum(k0[:, 3:8], k1[:, 3:8])
    # Leaf references by table index.
    refs = np.where(links & 1, 2 * order[links >> 1] + 1, links)
    out = np.concatenate([table[:n_n], refs.astype(np.int32).view(np.float32),
                          np.zeros((n_n, 2), np.float32)], 1)
    return InstanceTree(nodes=torch.as_tensor(out).to(boxes.device)
                        .contiguous(), root=0)


def _inst_passes(origins, dirs, table, tmin: float, bound):
    """The kernels' slab test of rays [N] against world boxes ``table``
    [B, >= 8] (min, max, a, b), each grown by a * max|o| + b: [N, B]."""
    from . import ablations
    omax = origins.abs().amax(1)[:, None]
    m = table[None, :, 6] * omax + table[None, :, 7]
    tn, tf = ablations._near_far(origins, ablations._ray_inv(dirs), m, table)
    return (tn <= tf) & (tf > tmin) & (tn <= bound)


def _inst_tree_leaves_plain(origins, dirs, tree: InstanceTree, boxes,
                            tmin: float, bound):
    """Plain level-by-level walk of the instance tree at a fixed bound
    ([N] or a float): (reached [N, I] bool, by table index; node tests
    [N] i64), as ``clustered._tree_leaves_plain`` walks a cluster tree."""
    n = origins.shape[0]
    bound = torch.as_tensor(bound, dtype=torch.float32,
                            device=origins.device).expand(n)[:, None]
    box_ok = _inst_passes(origins, dirs, boxes, tmin, bound)
    if tree.nodes.shape[0] == 0:
        reached = torch.zeros_like(box_ok)
        reached[:, tree.root >> 1] = box_ok[:, tree.root >> 1]
        return reached, torch.ones(n, dtype=torch.int64,
                                   device=origins.device)
    return clustered._walk_levels(
        box_ok, _inst_passes(origins, dirs, tree.nodes, tmin, bound),
        tree.nodes[:, 8:10].contiguous().view(torch.int32).long())


def table_rows(mesh_tris) -> int:
    """Packed mesh-table rows for unique meshes of ``mesh_tris`` triangles
    each: every mesh padded to whole clusters, the total to whole groups
    of TABLE_CLUSTERS clusters (``pack_tris_instanced``'s layout, which
    the eligibility bound counts)."""
    cluster = clustered.CLUSTER
    rows = sum(dense._pad_to(t, cluster) for t in mesh_tris)
    return dense._pad_to(rows, TABLE_CLUSTERS * cluster)


def pack_tris_instanced(geom: SceneArrays, mesh_ranges):
    """Unique-mesh rows in mesh space, per mesh, no reordering
    (``pallas_inst.pack_tris_instanced``).

    Returns (tris [R, 16], cluster boxes [C, 8]): each mesh's rows in
    their original order, padded to whole clusters, so instance i
    addresses clusters ``[rows[i, 12], rows[i, 12] + rows[i, 13])``.
    Boxes span the three corners of a cluster's valid rows; all-padding
    clusters collapse to the far point EMPTY_BOX. Raises past
    INST_MAX_ROWS rows."""
    cluster = clustered.CLUSTER
    packed = dense.pack_tris(geom)
    pts_all = torch.stack([geom.tri_v0, geom.tri_v0 + geom.tri_e1,
                           geom.tri_v0 + geom.tri_e2])
    big = 3e38
    parts, box_parts = [], []
    for lo, hi in mesh_ranges:
        r_pad = dense._pad_to(hi - lo, cluster)
        parts.append(torch.nn.functional.pad(packed[lo:hi],
                                             (0, 0, 0, r_pad - (hi - lo))))
        vm = geom.tri_valid[lo:hi][None, :, None]
        pts = pts_all[:, lo:hi]

        def padc(a, fill):
            return torch.nn.functional.pad(a, (0, 0, 0, r_pad - (hi - lo)),
                                           value=fill)
        mins = padc(torch.where(vm, pts, big).amin(0), big)
        maxs = padc(torch.where(vm, pts, -big).amax(0), -big)
        mins = mins.view(-1, cluster, 3).amin(1)
        maxs = maxs.view(-1, cluster, 3).amax(1)
        empty = (mins > maxs).any(dim=1, keepdim=True)
        mins = torch.where(empty, clustered.EMPTY_BOX, mins)
        maxs = torch.where(empty, clustered.EMPTY_BOX, maxs)
        box_parts.append(torch.cat([mins, maxs, torch.zeros_like(mins[:, :2])],
                                   dim=1))
    tris = torch.cat(parts)
    boxes = torch.cat(box_parts)
    r_tot = table_rows([hi - lo for lo, hi in mesh_ranges])
    if r_tot != tris.shape[0]:
        tris = torch.nn.functional.pad(tris, (0, 0, 0, r_tot - tris.shape[0]))
        far = torch.full((r_tot // cluster - boxes.shape[0], 8),
                         clustered.EMPTY_BOX, device=boxes.device)
        boxes = torch.cat([boxes, far])
    if tris.shape[0] > INST_MAX_ROWS:
        raise ValueError(f"instanced mesh table has {tris.shape[0]} packed "
                         f"rows, past the bound {INST_MAX_ROWS}")
    return tris.contiguous(), boxes.contiguous()


# --------------------------------------------------------------------------
# Plain PyTorch versions (the CPU path and the kernels' reference): every
# instance's rays transformed, then a dense sweep over its mesh's rows.
# --------------------------------------------------------------------------

def _xform(m: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Rays [N, 3] into mesh space by inverse 3x4 rows ``m`` [N or 1, 12]
    (``pallas_inst._xform_ray``), in the kernels' operation order. The
    direction stays unnormalised, so t is the world parameter."""
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    c = [m[:, k] for k in range(12)]
    mo = torch.stack([c[0] * ox + c[1] * oy + c[2] * oz + c[3],
                      c[4] * ox + c[5] * oy + c[6] * oz + c[7],
                      c[8] * ox + c[9] * oy + c[10] * oz + c[11]], dim=1)
    md = torch.stack([c[0] * dx + c[1] * dy + c[2] * dz,
                      c[4] * dx + c[5] * dy + c[6] * dz,
                      c[8] * dx + c[9] * dy + c[10] * dz], dim=1)
    return mo, md


def _instance_ranges(inst_rows: torch.Tensor, cluster: int):
    """(instance, first row, end row) of every instance with rows."""
    meta = inst_rows[:, 12:14].round().long().tolist()
    return [(i, lo * cluster, (lo + cnt) * cluster)
            for i, (lo, cnt) in enumerate(meta) if cnt > 0]


def _closest_inst_plain(origins, dirs, tris, cluster: int, inst_rows,
                        tmin: float, tmax: float = T_FAR):
    """Plain version of K9: per ray, (t, packed row, instance) of the
    closest hit with t < tmax over every row of every instance;
    T_FAR / 0 / 0 on a miss. Instances in ascending order, each replacing
    the best only on a smaller t: ties go to the lowest (instance, row)."""
    n, dev = origins.shape[0], origins.device
    t_out = torch.full((n,), T_FAR, dtype=torch.float32, device=dev)
    row_out = torch.zeros(n, dtype=torch.int32, device=dev)
    inst_out = torch.zeros(n, dtype=torch.int32, device=dev)
    for i, s, e in _instance_ranges(inst_rows, cluster):
        om, dm = _xform(inst_rows[i:i + 1, 0:12], origins, dirs)
        t, row = dense._closest_plain(om, dm, tris[s:e], tmin, tmax)
        better = t < t_out
        t_out = torch.where(better, t, t_out)
        row_out = torch.where(better, row + s, row_out)
        inst_out = torch.where(better, i, inst_out)
    return t_out, row_out, inst_out


def _occluded_inst_plain(origins, dirs, tmax, tris, cluster: int, inst_rows,
                         tmin: float) -> torch.Tensor:
    """Plain version of K10: any hit with tmin < t < tmax[i] on a
    non-refractive row of any instance. Returns bool [N]."""
    out = torch.zeros(origins.shape[0], dtype=torch.bool,
                      device=origins.device)
    for i, s, e in _instance_ranges(inst_rows, cluster):
        om, dm = _xform(inst_rows[i:i + 1, 0:12], origins, dirs)
        out |= dense._occluded_plain(om, dm, tmax, tris[s:e], tmin)
    return out


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------

def _check_inst(tris, cboxes, inst_rows, inst_boxes, device):
    """(clusters, rows per cluster, instances) after the table checks."""
    n_c, cluster = clustered._check_tables(tris, cboxes, device)
    n_i = inst_rows.shape[0]
    dense._check("inst_rows", inst_rows, torch.float32, (n_i, 16), device)
    dense._check("inst_boxes", inst_boxes, torch.float32, (n_i, 8), device)
    if inst_rows.data_ptr() % 16 or inst_boxes.data_ptr() % 16:
        raise ValueError("instance tables must be 16-byte aligned "
                         "(float4 loads)")
    return n_c, cluster, n_i


def walk_group(n_rays: int) -> int:
    """Lanes a ray of K9's walk for a call of ``n_rays`` rays: 16 up to
    WALK_NARROW_RAYS (the forest's and foliage's 16,384 lanes), where few
    rays must fill the card, and 8 above."""
    return 16 if n_rays <= WALK_NARROW_RAYS else 8


def _check_tree(tree: InstanceTree, n_inst: int, device) -> None:
    """An ``instance_tree`` of a table of ``n_inst`` instances: a root
    leaf when it has no nodes, else node 0 and fewer nodes than
    instances."""
    n_n = tree.nodes.shape[0]
    dense._check("inst_nodes", tree.nodes, torch.float32, (n_n, 12), device)
    if tree.nodes.data_ptr() % 16:
        raise ValueError("inst_nodes must be 16-byte aligned (float4 loads)")
    fits = (tree.root == 0 and 0 < n_n < n_inst) if n_n else \
        (tree.root & 1 == 1 and tree.root >> 1 < n_inst)
    if not fits:
        raise ValueError(f"an instance tree of {n_n} nodes and root "
                         f"{tree.root} does not fit {n_inst} instances")
    if clustered.tree_depth(n_n + 1) > clustered.TREE_MAX_DEPTH:
        raise ValueError("the instance tree is deeper than the walk's stack")


def closest_inst(origins: torch.Tensor, dirs: torch.Tensor,
                 tris: torch.Tensor, cboxes: torch.Tensor, scale: float,
                 inst_rows: torch.Tensor, inst_boxes: torch.Tensor,
                 tmin: float, tmax: float = T_FAR,
                 tree: InstanceTree | None = None, group: int | None = None):
    """K9: per ray, (t, packed row, instance) of the closest hit with
    t < tmax (T_FAR / 0 / 0 on a miss). World rays [N, 3] f32; the mesh
    table ``tris`` [C * cluster, 16] with its cluster boxes ``cboxes``
    [C, 8] and their ``box_scale``; the instance table's rows and boxes
    [I, 16] / [I, 8] and its ``instance_tree`` (built here when None, a
    host sync: pass the prepared one), walked by ``group`` lanes a ray
    (``walk_group`` when None). Every instance's cluster range must lie in
    the mesh table (``prepare`` checks it)."""
    if dense._on_cpu(origins):
        cluster = tris.shape[0] // cboxes.shape[0]
        return _closest_inst_plain(origins, dirs, tris, cluster, inst_rows,
                                   tmin, tmax)
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    _, cluster, n_i = _check_inst(tris, cboxes, inst_rows, inst_boxes, dev)
    if tree is None:
        tree = instance_tree(inst_boxes)
    _check_tree(tree, n_i, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _kernels.launch("tpt_closest_inst", origins.data_ptr(),
                        dirs.data_ptr(), tris.data_ptr(), cboxes.data_ptr(),
                        inst_rows.data_ptr(), inst_boxes.data_ptr(),
                        tree.nodes.data_ptr(), int(tree.root), n, cluster,
                        float(scale), clustered.BOX_MARGIN, float(tmin),
                        float(tmax), t.data_ptr(), row.data_ptr(),
                        inst.data_ptr(),
                        walk_group(n) if group is None else int(group),
                        dense._stream(dev))
        LAUNCHES["closest_inst"] += 1
    return t, row, inst


def closest_inst_flat(origins: torch.Tensor, dirs: torch.Tensor,
                      tris: torch.Tensor, cboxes: torch.Tensor, scale: float,
                      inst_rows: torch.Tensor, inst_boxes: torch.Tensor,
                      tmin: float, tmax: float = T_FAR):
    """K9's function through its flat loop (a thread a ray, every
    instance box tested in table order): on no path, the yardstick of the
    walk."""
    if dense._on_cpu(origins):
        cluster = tris.shape[0] // cboxes.shape[0]
        return _closest_inst_plain(origins, dirs, tris, cluster, inst_rows,
                                   tmin, tmax)
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    _, cluster, n_i = _check_inst(tris, cboxes, inst_rows, inst_boxes, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    row = torch.empty(n, dtype=torch.int32, device=dev)
    inst = torch.empty(n, dtype=torch.int32, device=dev)
    if n:
        _kernels.launch("tpt_closest_inst_flat", origins.data_ptr(),
                        dirs.data_ptr(), tris.data_ptr(), cboxes.data_ptr(),
                        inst_rows.data_ptr(), inst_boxes.data_ptr(), n, n_i,
                        cluster, float(scale), clustered.BOX_MARGIN,
                        float(tmin), float(tmax), t.data_ptr(),
                        row.data_ptr(), inst.data_ptr(), dense._stream(dev))
        LAUNCHES["closest_inst_flat"] += 1
    return t, row, inst


def occluded_inst(origins: torch.Tensor, dirs: torch.Tensor,
                  tmax: torch.Tensor, tris: torch.Tensor,
                  cboxes: torch.Tensor, scale: float,
                  inst_rows: torch.Tensor, inst_boxes: torch.Tensor,
                  tmin: float) -> torch.Tensor:
    """K10: per ray, is any non-refractive row of any instance hit with
    tmin < t < tmax[i]? Returns bool [N]."""
    if dense._on_cpu(origins):
        cluster = tris.shape[0] // cboxes.shape[0]
        return _occluded_inst_plain(origins, dirs, tmax, tris, cluster,
                                    inst_rows, tmin)
    from .. import _kernels
    n, _ = dense._check_inputs(origins, dirs, tris)
    dev = origins.device
    dense._check("tmax", tmax, torch.float32, (n,), dev)
    _, cluster, n_i = _check_inst(tris, cboxes, inst_rows, inst_boxes, dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        _kernels.launch("tpt_occluded_inst", origins.data_ptr(),
                        dirs.data_ptr(), tmax.data_ptr(), tris.data_ptr(),
                        cboxes.data_ptr(), inst_rows.data_ptr(),
                        inst_boxes.data_ptr(), n, n_i, cluster, float(scale),
                        clustered.BOX_MARGIN, float(tmin), out.data_ptr(),
                        dense._stream(dev))
        LAUNCHES["occluded_inst"] += 1
    return out


# --------------------------------------------------------------------------
# Intersector entry points
# --------------------------------------------------------------------------

@dataclasses.dataclass
class InstTables:
    """An instanced scene's tables, packed once per render."""
    tris: torch.Tensor        # [R, 16] mesh-space rows
    boxes: torch.Tensor       # [C, 8] mesh-space cluster boxes
    scale: float              # their box_scale
    table: InstanceTable      # on the scene's device
    tree: InstanceTree        # K9's tree over the instances


def prepare(geom: SceneArrays, table: InstanceTable) -> InstTables:
    """Pack the unique meshes once, move the instance table to the
    scene's device and build its ``instance_tree``."""
    tris, boxes = pack_tris_instanced(geom, table.mesh_ranges)
    end = table.rows[:, 12] + table.rows[:, 13]
    if float(end.max()) > boxes.shape[0]:
        raise ValueError("an instance addresses clusters past the mesh table")
    on_device = table.to(geom.device)
    return InstTables(tris=tris, boxes=boxes,
                      scale=clustered.box_scale(boxes), table=on_device,
                      tree=instance_tree(on_device.boxes))


def _mesh_space_rays(table: InstanceTable, origins, dirs, inst):
    """Each ray in its winning instance's mesh space (the resolve's twin of
    the kernels' transform, by a gather of the instance rows)."""
    return _xform(table.rows[inst.long(), 0:12], origins, dirs)


def world_normal(table: InstanceTable, n_mesh: torch.Tensor,
                 inst: torch.Tensor, hit_mask: torch.Tensor) -> torch.Tensor:
    """Mesh-space normals [N, 3] -> world (``pallas_inst.world_normal``):
    the instance's orientation-corrected inverse transpose, normalised;
    misses stay 0."""
    nr = table.nrm[inst.long()]
    nx, ny, nz = n_mesh[:, 0], n_mesh[:, 1], n_mesh[:, 2]
    n = torch.stack([nr[:, 0] * nx + nr[:, 1] * ny + nr[:, 2] * nz,
                     nr[:, 3] * nx + nr[:, 4] * ny + nr[:, 5] * nz,
                     nr[:, 6] * nx + nr[:, 7] * ny + nr[:, 8] * nz], dim=1)
    scale = torch.where(hit_mask,
                        torch.rsqrt(torch.clamp_min(v3.dot(n, n), 1e-30)), 0.0)
    return n * scale[:, None]


def world_tangent(table: InstanceTable, t_mesh: torch.Tensor,
                  inst: torch.Tensor) -> torch.Tensor:
    """Mesh-space tangents [N, 3] -> world by the forward linear part
    (``pallas_inst.world_tangent``)."""
    fr = table.fwd[inst.long()]
    tx, ty, tz = t_mesh[:, 0], t_mesh[:, 1], t_mesh[:, 2]
    return torch.stack([fr[:, 0] * tx + fr[:, 1] * ty + fr[:, 2] * tz,
                        fr[:, 3] * tx + fr[:, 4] * ty + fr[:, 5] * tz,
                        fr[:, 6] * tx + fr[:, 7] * ty + fr[:, 8] * tz], dim=1)


def closest_hit(tables: InstTables, origins: torch.Tensor,
                dirs: torch.Tensor, tmin: float = 0.01, tmax: float = T_FAR,
                want_uv: bool = True) -> Hit:
    """Closest hit through K9 (``pallas_inst.intersect_closest``): ``tri``
    indexes the unique geometry, ``normal`` is the world geometric normal
    and ``inst`` the winning instance."""
    t, row, inst = closest_inst(origins, dirs, tables.tris, tables.boxes,
                                tables.scale, tables.table.rows,
                                tables.table.boxes, tmin, tmax, tables.tree)
    o, d = (_mesh_space_rays(tables.table, origins, dirs, inst) if want_uv
            else (origins, dirs))
    hit = clustered._lean_resolve_packed(tables.tris, o, d, t, row, want_uv)
    return dataclasses.replace(
        hit, normal=world_normal(tables.table, hit.normal, inst, hit.hit),
        inst=torch.where(hit.hit, inst, 0))


def occluded_hit(tables: InstTables, origins: torch.Tensor,
                 dirs: torch.Tensor, tmax: torch.Tensor,
                 tmin: float = 0.01) -> torch.Tensor:
    """Any-hit occlusion over the instances through K10
    (``pallas_inst.intersect_occluded``); refractive rows pass light."""
    return occluded_inst(origins, dirs, tmax, tables.tris, tables.boxes,
                         tables.scale, tables.table.rows, tables.table.boxes,
                         tmin)


def get_intersectors(geom: SceneArrays, table: InstanceTable, cfg):
    """(closest_fn(o, d) -> Hit, occluded_fn(o, d, tmax) -> bool) over an
    instanced scene (``pallas_inst.get_intersectors``)."""
    tables = prepare(geom, table)
    return (partial(closest_hit, tables, tmin=cfg.t_min, tmax=cfg.t_max),
            partial(occluded_hit, tables, tmin=cfg.t_min))
