"""Host-side geometry refinement for the clustered intersection path
(counterpart of ``tpu_pt/scene/refine.py``, the same numpy operations, so
the same triangles).

The clustered kernels (``tpu_pt_torch.intersect.clustered``) cull work
with per-cluster boxes over kd-ordered triangles. A few huge triangles
(scene walls are two triangles each in the reference scenes, spanning the
whole world) poison that scheme: whichever 128-row cluster a wall triangle
lands in inherits a near-scene-sized box, so every ray sweeps it. The fix
is geometric: bisect any oversized triangle along its longest edge (the
same surface, material and geometric normal) until every triangle's box
extent is a bounded fraction of the scene extent.

Applied by :func:`tpu_pt_torch.scene.objloader.load_scene` only when asked
(``split_large=True``) and the triangle count exceeds the clustered path's
threshold (``dense.TRI_SLAB``): small scenes take the dense sweep, where
per-triangle boxes are irrelevant and splitting would only add rows.
"""

from __future__ import annotations

import numpy as np

# Largest allowed triangle-AABB extent, as a fraction of the scene's
# longest axis. 1/8 bounds a cluster containing a split wall piece to
# ~1/8 of the world per axis; finer fractions add rows for little
# additional culling (the cluster AABB is already dominated by the
# other 127 triangles' spread).
MAX_EXTENT_FRAC = 1.0 / 8.0


def split_large_tris(vertices: np.ndarray, indices: np.ndarray,
                     mat_ids: np.ndarray,
                     max_extent_frac: float = MAX_EXTENT_FRAC,
                     max_rounds: int = 32):
    """Longest-edge-bisect triangles until every AABB extent is small.

    Returns (vertices [3T, 3], indices [T, 3], mat_ids [T]) with
    triangles exploded to per-face vertices (downstream
    ``build_scene_arrays`` only reads gathered corners, so duplicated
    vertices cost nothing). Winding — and therefore the geometric
    normal — is preserved by every bisection case. Deterministic, pure
    numpy, runs once at scene load.
    """
    vertices = np.asarray(vertices, np.float32).reshape(-1, 3)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)
    mat_ids = np.asarray(mat_ids, np.int64).reshape(-1)

    v0 = vertices[indices[:, 0]]
    v1 = vertices[indices[:, 1]]
    v2 = vertices[indices[:, 2]]

    scene_lo = np.minimum(np.minimum(v0, v1), v2).min(axis=0)
    scene_hi = np.maximum(np.maximum(v0, v1), v2).max(axis=0)
    max_extent = float((scene_hi - scene_lo).max()) * max_extent_frac
    if max_extent <= 0.0:
        return vertices, indices, mat_ids

    for _ in range(max_rounds):
        lo = np.minimum(np.minimum(v0, v1), v2)
        hi = np.maximum(np.maximum(v0, v1), v2)
        big = (hi - lo).max(axis=1) > max_extent
        if not big.any():
            break
        keep = ~big
        b0, b1, b2 = v0[big], v1[big], v2[big]
        bm = mat_ids[big]

        e = np.stack([((b1 - b0) ** 2).sum(axis=1),
                      ((b2 - b1) ** 2).sum(axis=1),
                      ((b0 - b2) ** 2).sum(axis=1)], axis=1)
        longest = e.argmax(axis=1)[:, None]                    # [B, 1]

        m01 = 0.5 * (b0 + b1)
        m12 = 0.5 * (b1 + b2)
        m20 = 0.5 * (b2 + b0)

        def pick(a, b, c):
            return np.where(longest == 0, a,
                            np.where(longest == 1, b, c))

        # Split the longest edge at its midpoint into two triangles,
        # each keeping the original winding:
        #   edge v0v1: (v0, m, v2) + (m, v1, v2)
        #   edge v1v2: (v0, v1, m) + (v0, m, v2)
        #   edge v2v0: (v0, v1, m) + (m, v1, v2)
        c0 = (pick(b0, b0, b0), pick(m01, b1, b1), pick(b2, m12, m20))
        c1 = (pick(m01, b0, m20), pick(b1, m12, b1), pick(b2, b2, b2))

        v0 = np.concatenate([v0[keep], c0[0], c1[0]])
        v1 = np.concatenate([v1[keep], c0[1], c1[1]])
        v2 = np.concatenate([v2[keep], c0[2], c1[2]])
        mat_ids = np.concatenate([mat_ids[keep], bm, bm])

    t = v0.shape[0]
    out_verts = np.empty((3 * t, 3), np.float32)
    out_verts[0::3] = v0
    out_verts[1::3] = v1
    out_verts[2::3] = v2
    out_idx = np.arange(3 * t, dtype=np.int64).reshape(t, 3)
    return out_verts, out_idx, mat_ids
