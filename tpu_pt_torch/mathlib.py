"""Host-side 4x4 matrices, quaternions and boxes (counterpart of
``tpu_pt/mathlib.py``; ``sutil/Matrix.h``, ``sutil/Quaternion.h`` and
``sutil/Aabb.h`` parity). They serve scene loading (glTF node transforms),
camera manipulation and BVH tooling.

numpy float32, with the JAX package's exact operations, so both packages
build bitwise-equal transforms.
"""

from __future__ import annotations

import math

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


def mat4_rotate(angle_rad: float, axis) -> np.ndarray:
    """Rotation about an arbitrary axis (Matrix.h ``rotate`` parity)."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    x, y, z = a
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    ic = 1.0 - c
    m = mat4_identity()
    m[:3, :3] = np.array([
        [c + x * x * ic, x * y * ic - z * s, x * z * ic + y * s],
        [y * x * ic + z * s, c + y * y * ic, y * z * ic - x * s],
        [z * x * ic - y * s, z * y * ic + x * s, c + z * z * ic],
    ], np.float32)
    return m


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 4x4 transform to [N, 3] points."""
    pts = np.asarray(pts, np.float32)
    return pts @ m[:3, :3].T + m[:3, 3]


def transform_vectors(m: np.ndarray, vecs: np.ndarray) -> np.ndarray:
    """Apply the linear part to [N, 3] vectors (no translation)."""
    return np.asarray(vecs, np.float32) @ m[:3, :3].T


def transform_normals(m: np.ndarray, normals: np.ndarray) -> np.ndarray:
    """Normals transform by the inverse-transpose of the linear part."""
    lin = np.linalg.inv(m[:3, :3]).T
    out = np.asarray(normals, np.float32) @ lin.T
    norms = np.linalg.norm(out, axis=-1, keepdims=True)
    return out / np.maximum(norms, 1e-30)


def quat_from_axis_angle(axis, angle_rad: float) -> np.ndarray:
    """Quaternion (w, x, y, z) of a rotation by ``angle_rad`` about
    ``axis``."""
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    h = angle_rad * 0.5
    return np.array([math.cos(h), *(math.sin(h) * a)], np.float32)


def quat_mul(q1, q2) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], np.float32)


def quat_conjugate(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([w, -x, -y, -z], np.float32)


def quat_normalize(q) -> np.ndarray:
    q = np.asarray(q, np.float32)
    return q / max(float(np.linalg.norm(q)), 1e-30)


def quat_rotate(q, v) -> np.ndarray:
    """Rotate vector v by unit quaternion q."""
    w, x, y, z = q
    u = np.array([x, y, z], np.float32)
    v = np.asarray(v, np.float32)
    return (2.0 * np.dot(u, v) * u
            + (w * w - np.dot(u, u)) * v
            + 2.0 * w * np.cross(u, v)).astype(np.float32)


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


class Aabb:
    """Axis-aligned bounding box (``sutil/Aabb.h`` surface)."""

    def __init__(self, lo=None, hi=None):
        if lo is None:
            self.invalidate()
        else:
            self.m_min = np.asarray(lo, np.float32).copy()
            self.m_max = np.asarray(hi if hi is not None else lo,
                                    np.float32).copy()

    def invalidate(self) -> None:
        self.m_min = np.full(3, np.inf, np.float32)
        self.m_max = np.full(3, -np.inf, np.float32)

    def valid(self) -> bool:
        return bool(np.all(self.m_min <= self.m_max))

    def include(self, other) -> None:
        if isinstance(other, Aabb):
            self.m_min = np.minimum(self.m_min, other.m_min)
            self.m_max = np.maximum(self.m_max, other.m_max)
        else:
            p = np.asarray(other, np.float32)
            self.m_min = np.minimum(self.m_min, p)
            self.m_max = np.maximum(self.m_max, p)

    def contains(self, p) -> bool:
        p = np.asarray(p, np.float32)
        return bool(np.all(p >= self.m_min) and np.all(p <= self.m_max))

    def center(self) -> np.ndarray:
        return 0.5 * (self.m_min + self.m_max)

    def extent(self) -> np.ndarray:
        return self.m_max - self.m_min

    def volume(self) -> float:
        e = self.extent()
        return float(e[0] * e[1] * e[2])

    def area(self) -> float:
        e = self.extent()
        return float(2.0 * (e[0] * e[1] + e[0] * e[2] + e[1] * e[2]))

    def longest_axis(self) -> int:
        return int(np.argmax(self.extent()))

    def max_extent(self) -> float:
        return float(self.extent()[self.longest_axis()])

    @staticmethod
    def of_points(pts: np.ndarray) -> "Aabb":
        b = Aabb()
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        b.m_min = pts.min(axis=0)
        b.m_max = pts.max(axis=0)
        return b
