"""Host-side 4x4 matrix and quaternion helpers for scene loading
(counterpart of the part of ``tpu_pt/mathlib.py`` that the glTF loader
uses; ``sutil/Matrix.h`` / ``sutil/Quaternion.h`` parity).

numpy float32, with the JAX package's exact operations, so both loaders
build bitwise-equal node transforms.
"""

from __future__ import annotations

import numpy as np


def mat4_identity() -> np.ndarray:
    return np.eye(4, dtype=np.float32)


def mat4_translate(v) -> np.ndarray:
    m = mat4_identity()
    m[:3, 3] = np.asarray(v, np.float32)
    return m


def mat4_scale(v) -> np.ndarray:
    m = mat4_identity()
    m[0, 0], m[1, 1], m[2, 2] = np.asarray(v, np.float32)
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [N, 3] points."""
    pts = np.asarray(pts, np.float32)
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose of the linear part."""
    lin = np.linalg.inv(m[:3, :3]).T
    out = np.asarray(normals, np.float32) @ lin.T
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norms, 1e-30)


def quat_normalize(q) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return q / max(float(np.linalg.norm(q)), 1e-30)


def quat_to_mat4(q) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix (glTF node
    rotations)."""
    w, x, y, z = quat_normalize(q)
    m = mat4_identity()
    m[:3, :3] = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)
    return m
