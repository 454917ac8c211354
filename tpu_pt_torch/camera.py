"""Pinhole camera and trackball controller (counterpart of
``tpu_pt/camera.py``).

Host-side numpy, as in the JAX package: camera state is tiny and changes
per UI event; only the resulting (eye, U, V, W) vectors reach the device
(``render.CameraArrays``). The UVW frame is ``sutil::Camera::UVWFrame``
(``Camera.cpp:34-45``), the trackball ``sutil::Trackball``
(``Trackball.cpp:51-160``).
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

    def set_direction(self, d: np.ndarray) -> None:
        self.lookat = self.eye + float(
            np.linalg.norm(self.lookat - self.eye)) * np.asarray(d, np.float32)

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


class Trackball:
    """Lat/long orbit controller, 0.5 degrees per pixel, latitude clamped
    to +-89 degrees (``sutil::Trackball``, ``Trackball.cpp:58-160``): the
    camera orbits on a sphere around the lookat point (LOOKAT_FIXED) or
    turns in place (EYE_FIXED); a wheel zoom scales the eye-lookat
    distance."""

    EYE_FIXED = 0
    LOOKAT_FIXED = 1

    def __init__(self, camera: Camera):
        self.camera = camera
        self.view_mode = self.LOOKAT_FIXED
        self.gimbal_lock = False
        self.zoom_multiplier = 1.1
        self.move_speed = 1.0
        self._lat = 0.0  # radians
        self._lon = 0.0
        self._prev = None
        self._dist = float(np.linalg.norm(camera.lookat - camera.eye))
        self._u = np.array([1.0, 0.0, 0.0], np.float32)
        self._v = np.array([0.0, 1.0, 0.0], np.float32)
        self._w = np.array([0.0, 0.0, 1.0], np.float32)
        self.reinit_orientation_from_camera()

    def start_tracking(self, x: int, y: int) -> None:
        self._prev = (x, y)

    def update_tracking(self, x: int, y: int) -> None:
        if self._prev is None:
            self.start_tracking(x, y)
            return
        dx = x - self._prev[0]
        dy = y - self._prev[1]
        self._prev = (x, y)
        lat_deg = max(-89.0, min(89.0, math.degrees(self._lat) + 0.5 * dy))
        lon_deg = math.fmod(math.degrees(self._lon) - 0.5 * dx, 360.0)
        self._lat = math.radians(lat_deg)
        self._lon = math.radians(lon_deg)
        self.update_camera()
        if not self.gimbal_lock:
            self.reinit_orientation_from_camera()
            self.camera.up = self._w

    def update_camera(self) -> None:
        local = np.array([
            math.cos(self._lat) * math.sin(self._lon),
            math.cos(self._lat) * math.cos(self._lon),
            math.sin(self._lat),
        ], np.float32)
        dir_ws = local[0] * self._u + local[1] * self._v + local[2] * self._w
        if self.view_mode == self.EYE_FIXED:
            self.camera.lookat = self.camera.eye - dir_ws * self._dist
        else:
            self.camera.eye = self.camera.lookat + dir_ws * self._dist

    def set_reference_frame(self, u, v, w) -> None:
        self._u, self._v, self._w = (np.asarray(a, np.float32)
                                     for a in (u, v, w))
        dir_ws = -_norm(self.camera.lookat - self.camera.eye)
        local = np.array([np.dot(dir_ws, self._u), np.dot(dir_ws, self._v),
                          np.dot(dir_ws, self._w)])
        self._lon = math.atan2(local[0], local[1])
        self._lat = math.asin(max(-1.0, min(1.0, float(local[2]))))

    def zoom(self, direction: int) -> None:
        z = 1.0 / self.zoom_multiplier if direction > 0 else self.zoom_multiplier
        self._dist *= z
        self.camera.eye = self.camera.lookat + (
            self.camera.eye - self.camera.lookat) * z

    def reinit_orientation_from_camera(self) -> None:
        u, v, w = self.camera.uvw_frame()
        self._u = _norm(u)
        self._v = _norm(v)
        self._w = _norm(-w)
        self._v, self._w = self._w, self._v
        self._lat = 0.0
        self._lon = 0.0
        self._dist = float(np.linalg.norm(self.camera.lookat - self.camera.eye))

    def move_forward(self, speed: float | None = None) -> None:
        s = self.move_speed if speed is None else speed
        d = self.camera.direction
        self.camera.eye = self.camera.eye + d * s
        self.camera.lookat = self.camera.lookat + d * s
