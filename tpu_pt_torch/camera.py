"""Pinhole camera (counterpart of ``tpu_pt/camera.py``; the trackball is
not ported yet).

Host-side numpy, as in the JAX package: only the resulting (eye, U, V, W)
vectors reach the device (``render.CameraArrays``). The UVW frame is
``sutil::Camera::UVWFrame`` (``Camera.cpp:34-45``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


def _norm(v: np.ndarray) -> np.ndarray:
    n = float(np.linalg.norm(v))
    return v / n if n > 0 else v


@dataclasses.dataclass
class Camera:
    """Pinhole camera defined by eye/lookat/up/fovY/aspect.

    W = lookat - eye (NOT normalised: its length is the focal distance),
    V ⊥ U ⊥ W with |V| = |W|·tan(fovY/2) and |U| = |V|·aspect.
    """
    eye: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 1.0, 1.0], np.float32))
    lookat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 1.0, 0.0], np.float32))
    fov_y: float = 35.0  # degrees
    aspect: float = 1.0

    def __post_init__(self):
        self.eye = np.asarray(self.eye, np.float32)
        self.lookat = np.asarray(self.lookat, np.float32)
        self.up = np.asarray(self.up, np.float32)

    @property
    def direction(self) -> np.ndarray:
        return _norm(self.lookat - self.eye)

    def uvw_frame(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        w = (self.lookat - self.eye).astype(np.float32)
        wlen = float(np.linalg.norm(w))
        u = _norm(np.cross(w, self.up)).astype(np.float32)
        v = _norm(np.cross(u, w)).astype(np.float32)
        vlen = wlen * math.tan(0.5 * math.radians(self.fov_y))
        v = v * vlen
        u = u * (vlen * self.aspect)
        return u, v, w


def cornell_default_camera(aspect: float = 1.0) -> Camera:
    """The reference's hardcoded Cornell camera (``PathTracerMain.cpp:228-233``)."""
    return Camera(
        eye=np.array([278.0, 273.0, -900.0], np.float32),
        lookat=np.array([278.0, 273.0, 330.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32),
        fov_y=35.0,
        aspect=aspect,
    )
