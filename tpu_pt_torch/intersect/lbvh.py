"""LBVH: linear BVH build and stackless wavefront traversal in plain
PyTorch (counterpart of ``tpu_pt/intersect/lbvh.py``, which holds no
Pallas kernel either).

The replacement for the reference's hardware GAS (``optixAccelBuild``,
``PathTracerMain.cpp:260-398``): a binary radix tree over Morton-sorted
triangle centroids (Karras, "Maximally Parallel Construction of BVHs...",
HPG 2012; every step is a vectorised O(n) pass, so the build runs on
whatever device holds the scene), flattened to arrays and traversed with a
stackless skip-link walk: each node stores its first child and the node to
visit when its subtree is skipped, so a ray's traversal state is one
cursor and the whole wavefront advances one node per step with masked
lanes.

Node layout ([M = 2n - 1] arrays): internal nodes 0..n-2, leaves
n-1..2n-2 (leaf j holds Morton-sorted triangle j). ``left`` = first child
of an internal node; ``skip`` = next node after skipping the subtree;
``tri`` = original triangle id of a leaf (-1 for internal nodes).

The JAX package's ``build_lbvh_host`` runs in its native C++ library, which
is not ported: ``with_bvh`` always builds on the scene's device.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from .. import vec3 as v3
from ..scene.arrays import BSDF_REFRACTION, SceneArrays
from .moller import DET_EPS, T_FAR, Hit

END = -1
_MORTON_BITS = 10  # per axis -> 30-bit codes
# The walk ends when no lane has a node left. Reading that flag back costs
# a device synchronisation, so on a CUDA device it is read every this many
# steps (a step on finished lanes changes nothing).
CUDA_CHECK_EVERY = 8


@dataclasses.dataclass
class BVH:
    """Flattened skip-link BVH (``tpu_pt.intersect.lbvh.BVH``).

    A node's whole traversal payload (box, links and, for a leaf, the
    triangle with its shading attributes) is one row of ``nodes``, so a
    traversal step is a single row gather. Columns: 0-2 bmin, 3-5 bmax,
    6 left, 7 skip, 8-10 v0, 11-13 e1, 14-16 e2, 17 refractive, 18-20
    normal, 21 material id, 22 triangle id (-1 internal), 23 pad. Links
    and ids ride as f32 (exact below 2^24: 8M-triangle scenes).
    ``left`` / ``skip`` / ``tri`` are i32 duplicates for tests and
    inspection."""
    nodes: torch.Tensor    # [M, 24] f32
    left: torch.Tensor     # [M] i32 (first child; -1 for leaves)
    skip: torch.Tensor     # [M] i32 (next node when skipped; -1 = end)
    tri: torch.Tensor      # [M] i32 (triangle id of a leaf; -1 internal)

    @property
    def num_nodes(self) -> int:
        return self.left.shape[0]

    def to(self, device) -> "BVH":
        return BVH(*(getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)))


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of v (i64) so that two zero bits lie between
    each (32-bit arithmetic, kept by the masks)."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(p01: torch.Tensor) -> torch.Tensor:
    """[..., 3] coordinates in [0, 1] -> 30-bit Morton codes (i64)."""
    scale = float((1 << _MORTON_BITS) - 1)
    q = torch.clamp(p01 * scale, 0.0, scale).to(torch.int64)
    return ((_expand_bits(q[..., 0]) << 2) | (_expand_bits(q[..., 1]) << 1)
            | _expand_bits(q[..., 2]))


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of x as a 32-bit word (x i64 in [0, 2^32); 32 at 0)."""
    bits = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        y = x >> shift
        big = y != 0
        bits = bits + torch.where(big, shift, 0)
        x = torch.where(big, y, x)
    return 32 - (bits + (x != 0).to(x.dtype))


def build_lbvh(scene: SceneArrays) -> BVH:
    """LBVH over the scene's triangles, on the scene's device
    (``tpu_pt.intersect.lbvh.build_lbvh``, the same passes).

    Padding triangles get inverted boxes that never pass the slab test,
    so they are carried harmlessly as extra leaves."""
    v0, e1, e2 = scene.tri_v0, scene.tri_e1, scene.tri_e2
    n = v0.shape[0]
    dev = v0.device
    if n < 2:
        raise ValueError("the LBVH needs at least 2 triangles")

    p1 = v0 + e1
    p2 = v0 + e2
    tri_min = torch.minimum(v0, torch.minimum(p1, p2))
    tri_max = torch.maximum(v0, torch.maximum(p1, p2))
    # Padding triangles collapse to a far point: they sort to one end and
    # their inverted leaf boxes never hit.
    valid = scene.tri_valid[:, None]
    big = 3e30
    tri_min = torch.where(valid, tri_min, big)
    tri_max = torch.where(valid, tri_max, -big)

    centroid = 0.5 * (tri_min + tri_max)
    lo = torch.where(valid, centroid, math.inf).amin(dim=0)
    hi = torch.where(valid, centroid, -math.inf).amax(dim=0)
    extent = torch.clamp_min(hi - lo, 1e-9)
    unit = torch.where(valid, (centroid - lo) / extent, 1.0)

    codes = morton3d(unit)
    order = torch.argsort(codes, stable=True)
    codes = codes[order]

    # --- Karras radix-tree topology ---------------------------------------
    def delta(i, j):
        """Common-prefix length of keys i, j (ties broken by the index
        bits, which add 32); -1 when j is out of range."""
        in_range = (j >= 0) & (j <= n - 1)
        j_c = torch.clamp(j, 0, n - 1)
        i_c = torch.clamp(i, 0, n - 1)
        x = codes[i_c] ^ codes[j_c]
        d = torch.where(x == 0, 32 + _clz32(i ^ j_c), _clz32(x))
        return torch.where(in_range, d, -1)

    i = torch.arange(n - 1, dtype=torch.int64, device=dev)  # internal nodes
    d = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d)
    n_dbl = max(2, math.ceil(math.log2(max(n, 2))) + 2)

    # Upper bound of the range length, by doubling.
    lmax = torch.full_like(i, 2)
    for _ in range(n_dbl + 1):
        lmax = torch.where(delta(i, i + lmax * d) > delta_min, lmax * 2, lmax)

    # Binary search of the other end j = i + l d: steps lmax/2, ..., 1.
    length = torch.zeros_like(i)
    t = lmax // 2
    for _ in range(n_dbl + 3):
        live = t > 0
        cond = delta(i, i + (length + t) * d) > delta_min
        length = torch.where(live & cond, length + t, length)
        t = torch.where(live, t // 2, 0)
    j = i + length * d

    # Binary search of the split position (ceil-halving steps).
    delta_node = delta(i, j)
    s = torch.zeros_like(i)
    t = (length + 1) // 2
    for _ in range(n_dbl + 3):
        live = t > 0
        cond = delta(i, i + (s + t) * d) > delta_node
        s = torch.where(live & cond, s + t, s)
        t = torch.where(t > 1, (t + 1) // 2, 0)
    gamma = i + s * d + torch.clamp_max(d, 0)

    leaf_base = n - 1
    left_child = torch.where(torch.minimum(i, j) == gamma, leaf_base + gamma,
                             gamma)
    right_child = torch.where(torch.maximum(i, j) == gamma + 1,
                              leaf_base + gamma + 1, gamma + 1)

    m = 2 * n - 1
    parent = torch.full((m,), END, dtype=torch.int64, device=dev)
    parent[left_child] = i
    parent[right_child] = i
    is_left = torch.zeros(m, dtype=torch.bool, device=dev)
    is_left[left_child] = True

    # --- bottom-up boxes (a fixpoint sweep over the tree's depth) ----------
    bmin = torch.full((m, 3), big, dtype=torch.float32, device=dev)
    bmax = torch.full((m, 3), -big, dtype=torch.float32, device=dev)
    bmin[leaf_base:] = tri_min[order]
    bmax[leaf_base:] = tri_max[order]
    for _ in range(m):
        new_min = torch.minimum(bmin[left_child], bmin[right_child])
        new_max = torch.maximum(bmax[left_child], bmax[right_child])
        changed = bool((new_min != bmin[:n - 1]).any()
                       | (new_max != bmax[:n - 1]).any())
        bmin[:n - 1] = new_min
        bmax[:n - 1] = new_max
        if not changed:
            break

    # --- skip links (a top-down fixpoint) -----------------------------------
    # skip(v) = sibling(v) if v is a left child, else skip(parent(v)).
    sibling = torch.full((m,), END, dtype=torch.int64, device=dev)
    sibling[left_child] = right_child
    skip = torch.full((m,), END, dtype=torch.int64, device=dev)
    for _ in range(m):
        from_parent = torch.where(parent >= 0,
                                  skip[torch.clamp_min(parent, 0)], END)
        new = torch.where(is_left, sibling, from_parent)
        new[0] = END                       # the root has no parent
        changed = bool((new != skip).any())
        skip = new
        if not changed:
            break

    left = torch.cat([left_child,
                      torch.full((n,), END, dtype=torch.int64, device=dev)])
    tri = torch.cat([torch.full((n - 1,), END, dtype=torch.int64, device=dev),
                     order])

    # --- the single-gather node payload -------------------------------------
    refr = (scene.mat_bsdf[scene.mat_id.long()] == BSDF_REFRACTION)
    nodes = torch.zeros((m, 24), dtype=torch.float32, device=dev)
    nodes[:, 0:3] = bmin
    nodes[:, 3:6] = bmax
    nodes[:, 6] = left.to(torch.float32)
    nodes[:, 7] = skip.to(torch.float32)
    nodes[leaf_base:, 8:11] = v0[order]
    nodes[leaf_base:, 11:14] = e1[order]
    nodes[leaf_base:, 14:17] = e2[order]
    nodes[leaf_base:, 17] = refr[order].to(torch.float32)
    nodes[leaf_base:, 18:21] = scene.tri_normal[order]
    nodes[leaf_base:, 21] = scene.mat_id[order].to(torch.float32)
    nodes[:, 22] = tri.to(torch.float32)
    return BVH(nodes=nodes, left=left.to(torch.int32),
               skip=skip.to(torch.int32), tri=tri.to(torch.int32))


# ---------------------------------------------------------------------------
# Traversal
# ---------------------------------------------------------------------------

def _traverse(bvh: BVH, origins: torch.Tensor, dirs: torch.Tensor, tmin,
              tmax, mode: str, tmax_per_ray=None, check_every=None):
    """Wavefront skip-link walk. mode: 'closest' | 'occluded'
    (``tpu_pt.intersect.lbvh._traverse``). One [N, 24] row gather per step
    supplies the box, the links and the leaf's triangle with its shading
    attributes. The end of the walk is tested every ``check_every`` steps
    (default: every step on the CPU, CUDA_CHECK_EVERY on a CUDA device)."""
    n_rays, dev = origins.shape[0], origins.device
    inv_d = torch.where(dirs.abs() > 1e-20, 1.0 / dirs,
                        torch.where(dirs >= 0, 1e30, -1e30))
    zero_dir = (dirs == 0.0).all(dim=1)

    occl = mode == "occluded"
    limit = tmax_per_ray if occl else torch.full((n_rays,), tmax,
                                                 dtype=torch.float32,
                                                 device=dev)
    cursor = torch.where(zero_dir, END, 0).to(torch.int64)
    best_t = torch.full((n_rays,), T_FAR, dtype=torch.float32, device=dev)
    best_i = torch.zeros(n_rays, dtype=torch.int64, device=dev)
    best_nm = torch.zeros((n_rays, 4), dtype=torch.float32, device=dev)
    best_uv = torch.zeros((n_rays, 2), dtype=torch.float32, device=dev)
    found = torch.zeros(n_rays, dtype=torch.bool, device=dev)

    if check_every is None:
        check_every = CUDA_CHECK_EVERY if dev.type == "cuda" else 1
    step = 0
    while True:
        if step % check_every == 0 and not bool((cursor != END).any()):
            break
        step += 1
        active = cursor != END
        rows = bvh.nodes[torch.clamp_min(cursor, 0)]          # one gather

        # Slab test (inverted padding boxes are rejected explicitly).
        t0 = (rows[:, 0:3] - origins) * inv_d
        t1 = (rows[:, 3:6] - origins) * inv_d
        tnear = torch.minimum(t0, t1).amax(dim=1)
        tfar = torch.maximum(t0, t1).amin(dim=1)
        box_valid = (rows[:, 0:3] <= rows[:, 3:6]).all(dim=1)
        prune_t = limit if occl else torch.minimum(best_t, limit)
        box_hit = (box_valid & (tfar >= torch.clamp_min(tnear, tmin))
                   & (tnear < prune_t))

        child = rows[:, 6].to(torch.int64)
        nxt = rows[:, 7].to(torch.int64)
        tri_id = rows[:, 22].to(torch.int64)
        is_leaf = tri_id >= 0

        # Leaf: Moller-Trumbore against the triangle in the row.
        v0, e1, e2 = rows[:, 8:11], rows[:, 11:14], rows[:, 14:17]
        pvec = v3.cross(dirs, e2)
        det = v3.dot(e1, pvec)
        ok = det.abs() > DET_EPS
        inv_det = 1.0 / torch.where(ok, det, 1.0)
        tvec = origins - v0
        u = v3.dot(tvec, pvec) * inv_det
        qvec = v3.cross(tvec, e1)
        v = v3.dot(dirs, qvec) * inv_det
        t = v3.dot(e2, qvec) * inv_det
        tri_hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > tmin)
        t = torch.where(active & is_leaf & box_hit & tri_hit, t, T_FAR)

        descend = torch.where(~is_leaf & box_hit, child, nxt)
        if occl:
            found = found | ((t < limit) & (rows[:, 17] < 0.5))
            # Any-hit: a blocked ray stops walking.
            next_cursor = torch.where(found, END, descend)
        else:
            better = t < torch.minimum(best_t, limit)
            best_t = torch.where(better, t, best_t)
            best_i = torch.where(better, tri_id, best_i)
            best_nm = torch.where(better[:, None], rows[:, 18:22], best_nm)
            best_uv = torch.where(better[:, None],
                                  torch.stack([u, v], dim=1), best_uv)
            next_cursor = descend
        cursor = torch.where(active, next_cursor, END)

    if occl:
        return found
    return dict(best_t=best_t, best_i=best_i, best_nm=best_nm,
                best_uv=best_uv)


def with_bvh(scene: SceneArrays, builder: str = "auto",
             host: dict | None = None) -> SceneArrays:
    """The scene with its LBVH built and attached
    (``tpu_pt.intersect.lbvh.with_bvh``). ``builder`` is ``"auto"`` or
    ``"device"``: both build on the scene's device, since the JAX
    package's ``"native"`` host build (its C++ extension) is not ported
    and raises here (ROADMAP Queue 1 item 4). ``host``, the padded numpy
    scene arrays that let the native build skip device readbacks, is
    accepted and unused by the device build."""
    del host
    if builder == "native":
        raise NotImplementedError(
            "the native host LBVH build is not ported (ROADMAP Queue 1 "
            "item 4): the build runs on the scene's device "
            "(builder='auto' or 'device')")
    if builder not in ("auto", "device"):
        raise ValueError(f"unknown LBVH builder {builder!r} (auto, device "
                         "or native)")
    return dataclasses.replace(scene, bvh=build_lbvh(scene))


def _bvh_of(scene: SceneArrays, bvh: BVH | None) -> BVH:
    bvh = scene.bvh if bvh is None else bvh
    if bvh is None:
        raise ValueError("the scene has no BVH; build one with with_bvh()")
    return bvh


def intersect_closest(scene: SceneArrays, origins: torch.Tensor,
                      dirs: torch.Tensor, tmin: float = 0.01,
                      tmax: float = T_FAR, bvh: BVH | None = None) -> Hit:
    """Closest hit over a flat ray batch [N, 3] through the LBVH."""
    out = _traverse(_bvh_of(scene, bvh), origins, dirs, tmin, tmax, "closest")
    ok = out["best_t"] < T_FAR
    nm = out["best_nm"]
    return Hit(t=out["best_t"],
               tri=torch.where(ok, out["best_i"], 0).to(torch.int32), hit=ok,
               normal=nm[:, 0:3].contiguous(),
               mat=torch.where(ok, nm[:, 3], 0.0).to(torch.int32),
               u=out["best_uv"][:, 0].contiguous(),
               v=out["best_uv"][:, 1].contiguous())


def intersect_occluded(scene: SceneArrays, origins: torch.Tensor,
                       dirs: torch.Tensor, tmax: torch.Tensor,
                       tmin: float = 0.01, quirk_first_hit: bool = False,
                       bvh: BVH | None = None) -> torch.Tensor:
    """Any-hit occlusion with per-ray tmax through the LBVH; refractive
    surfaces pass light. Returns bool [N]."""
    bvh = _bvh_of(scene, bvh)
    if quirk_first_hit:
        h = intersect_closest(scene, origins, dirs, tmin=tmin, bvh=bvh)
        in_range = h.hit & (h.t < tmax)
        return in_range & (scene.mat_bsdf[h.mat.long()] != BSDF_REFRACTION)
    return _traverse(bvh, origins, dirs, tmin, T_FAR, "occluded",
                     tmax_per_ray=tmax)
