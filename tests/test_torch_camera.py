"""Port parity for the host-side camera controller and math library:
``tpu_pt_torch.camera.Trackball`` / ``Camera.set_direction`` and the
seven ``tpu_pt_torch.mathlib`` names the trackball's users rotate with,
against ``tpu_pt``'s on the same seeded inputs. Both packages run the same
numpy operations, so every array is compared bit for bit.

Then the cases of ``tests/test_camera.py`` and
``tests/test_mathlib_profiling.py`` that touch these names, on the port.
"""

import math

import numpy as np
import pytest

import tpu_pt
from tpu_pt import mathlib as jml
from tpu_pt_torch import mathlib as ml
import tpu_pt_torch as tp
from tpu_pt_torch.camera import Camera, Trackball, cornell_default_camera


def _cameras(seed: int):
    rng = np.random.default_rng(seed)
    eye = rng.normal(size=3).astype(np.float32) * 50
    lookat = rng.normal(size=3).astype(np.float32)
    kw = dict(eye=eye, lookat=lookat, up=np.array([0.0, 1.0, 0.0], np.float32),
              fov_y=40.0, aspect=1.5)
    return tpu_pt.Camera(**kw), tp.Camera(**kw)


def _same_camera(a, b):
    for name in ("eye", "lookat", "up"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    for x, y in zip(a.uvw_frame(), b.uvw_frame()):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("mode", ["EYE_FIXED", "LOOKAT_FIXED"])
@pytest.mark.parametrize("gimbal_lock", [False, True])
def test_trackball_sequence_matches_reference(mode, gimbal_lock):
    """The same drags, zooms, moves and re-anchors through both trackballs
    leave equal eye / lookat / up and equal internal angles."""
    assert tp.Trackball is Trackball
    ref_cam, cam = _cameras(seed=7 + gimbal_lock)
    ref, ours = tpu_pt.Trackball(ref_cam), tp.Trackball(cam)
    rng = np.random.default_rng(11)
    for tb in (ref, ours):
        tb.view_mode = getattr(tb, mode)
        tb.gimbal_lock = gimbal_lock
    drags = rng.integers(-60, 60, size=(24, 2))
    for step, (dx, dy) in enumerate(drags):
        for tb in (ref, ours):
            if step % 8 == 0:
                tb.start_tracking(100, 100)
            x, y = tb._prev if tb._prev is not None else (0, 0)
            tb.update_tracking(int(x + dx), int(y + dy))
            if step % 5 == 0:
                tb.zoom(1 if step % 10 else -1)
            if step % 7 == 0:
                tb.move_forward(2.5 if step % 14 else None)
            if step == 12:
                tb.set_reference_frame([1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                                       [0.0, 1.0, 0.0])
                tb.update_camera()
        _same_camera(ref_cam, cam)
        assert (ref._lat, ref._lon, ref._dist) == (ours._lat, ours._lon,
                                                   ours._dist)
    for a, b in ((ref._u, ours._u), (ref._v, ours._v), (ref._w, ours._w)):
        np.testing.assert_array_equal(a, b)
    # The update before a start_tracking only starts one.
    fresh_ref, fresh = tpu_pt.Trackball(tpu_pt.Camera()), Trackball(Camera())
    fresh_ref.update_tracking(3, 4)
    fresh.update_tracking(3, 4)
    assert fresh_ref._prev == fresh._prev == (3, 4)
    _same_camera(fresh_ref.camera, fresh.camera)


def test_set_direction_matches_reference():
    ref, cam = _cameras(seed=3)
    d = np.array([0.2, -0.4, 0.8], np.float32)
    d /= np.linalg.norm(d)
    ref.set_direction(d)
    cam.set_direction(d)
    _same_camera(ref, cam)


def test_mathlib_functions_match_reference():
    rng = np.random.default_rng(5)
    for _ in range(8):
        axis = rng.normal(size=3)
        ang = float(rng.uniform(-math.pi, math.pi))
        v = rng.normal(size=(16, 3)).astype(np.float32)
        m = jml.mat4_rotate(ang, axis)
        np.testing.assert_array_equal(ml.mat4_rotate(ang, axis), m)
        np.testing.assert_array_equal(ml.transform_vectors(m, v),
                                      jml.transform_vectors(m, v))
        q = jml.quat_from_axis_angle(axis, ang)
        np.testing.assert_array_equal(ml.quat_from_axis_angle(axis, ang), q)
        q2 = jml.quat_from_axis_angle(rng.normal(size=3), 0.7)
        np.testing.assert_array_equal(ml.quat_mul(q, q2), jml.quat_mul(q, q2))
        np.testing.assert_array_equal(ml.quat_conjugate(q),
                                      jml.quat_conjugate(q))
        np.testing.assert_array_equal(ml.quat_rotate(q, v[0]),
                                      jml.quat_rotate(q, v[0]))
    pts = rng.normal(size=(32, 3)).astype(np.float32)
    a, b = ml.Aabb.of_points(pts), jml.Aabb.of_points(pts)
    a.include(ml.Aabb([-5, 0, 0], [0, 5, 5]))
    b.include(jml.Aabb([-5, 0, 0], [0, 5, 5]))
    a.include([9.0, -9.0, 1.0])
    b.include([9.0, -9.0, 1.0])
    np.testing.assert_array_equal(a.m_min, b.m_min)
    np.testing.assert_array_equal(a.m_max, b.m_max)
    for name in ("center", "extent", "volume", "area", "longest_axis",
                 "max_extent", "valid"):
        np.testing.assert_array_equal(getattr(a, name)(), getattr(b, name)())
    assert a.contains(pts[0]) == b.contains(pts[0]) is True
    assert not ml.Aabb().valid() and not jml.Aabb().valid()


# --------------------------------------------------------------------------
# The cases of tests/test_camera.py and tests/test_mathlib_profiling.py
# that touch these names, on the port.
# --------------------------------------------------------------------------

def test_set_direction_preserves_distance():
    cam = cornell_default_camera()
    d0 = np.linalg.norm(cam.lookat - cam.eye)
    cam.set_direction(np.array([0.0, 0.0, 1.0]))
    np.testing.assert_allclose(np.linalg.norm(cam.lookat - cam.eye), d0,
                               rtol=1e-6)


def test_trackball_zoom():
    cam = cornell_default_camera()
    tb = Trackball(cam)
    d0 = np.linalg.norm(cam.lookat - cam.eye)
    tb.zoom(+1)
    assert np.linalg.norm(cam.lookat - cam.eye) < d0
    tb.zoom(-1)
    np.testing.assert_allclose(np.linalg.norm(cam.lookat - cam.eye), d0,
                               rtol=1e-5)


def test_trackball_orbit_keeps_distance():
    cam = cornell_default_camera()
    tb = Trackball(cam)
    d0 = np.linalg.norm(cam.lookat - cam.eye)
    lookat0 = cam.lookat.copy()
    tb.start_tracking(100, 100)
    tb.update_tracking(150, 120)
    np.testing.assert_allclose(np.linalg.norm(cam.lookat - cam.eye), d0,
                               rtol=1e-4)
    np.testing.assert_allclose(cam.lookat, lookat0, atol=1e-4)
    assert np.linalg.norm(cam.eye - np.array([278.0, 273.0, -900.0])) > 1.0


def test_trackball_latitude_clamp():
    tb = Trackball(cornell_default_camera())
    tb.start_tracking(0, 0)
    tb.update_tracking(0, 100000)
    assert abs(math.degrees(tb._lat)) <= 89.0 + 1e-6


def test_trackball_move_forward():
    cam = cornell_default_camera()
    tb = Trackball(cam)
    eye0 = cam.eye.copy()
    tb.move_forward(10.0)
    assert np.linalg.norm(cam.eye - eye0) > 9.9


def test_mat4_rotate_composes():
    p = np.array([[1.0, 0.0, 0.0]])
    r = ml.mat4_rotate(math.pi / 2, [0, 0, 1])
    np.testing.assert_allclose(ml.transform_points(r, p), [[0, 1, 0]],
                               atol=1e-6)
    m = ml.mat4_translate([0, 0, 5]) @ r @ ml.mat4_scale([2, 3, 4])
    np.testing.assert_allclose(ml.transform_points(m, p), [[0, 2, 5]],
                               atol=1e-5)
    np.testing.assert_allclose(ml.transform_vectors(m, p), [[0, 2, 0]],
                               atol=1e-5)


def test_quaternion_rotation_matches_matrix():
    axis, ang = [0.3, -0.5, 0.8], 1.1
    q = ml.quat_from_axis_angle(axis, ang)
    m = ml.mat4_rotate(ang, axis)
    v = np.array([0.2, -0.7, 0.4], np.float32)
    np.testing.assert_allclose(ml.quat_rotate(q, v),
                               ml.transform_points(m, v[None])[0], atol=1e-5)
    np.testing.assert_allclose(ml.quat_to_mat4(q), m, atol=1e-5)
    np.testing.assert_allclose(
        ml.quat_rotate(ml.quat_conjugate(q), ml.quat_rotate(q, v)), v,
        atol=1e-5)


def test_quaternion_mul_compose():
    q1 = ml.quat_from_axis_angle([0, 0, 1], math.pi / 2)
    q2 = ml.quat_from_axis_angle([1, 0, 0], math.pi / 2)
    q = ml.quat_mul(q2, q1)  # rotate by q1 then q2
    v = np.array([1.0, 0.0, 0.0])
    expect = ml.quat_rotate(q2, ml.quat_rotate(q1, v))
    np.testing.assert_allclose(ml.quat_rotate(q, v), expect, atol=1e-5)


def test_aabb():
    b = ml.Aabb()
    assert not b.valid()
    b.include([0, 0, 0])
    b.include([2, 4, 6])
    assert b.valid()
    np.testing.assert_allclose(b.center(), [1, 2, 3])
    np.testing.assert_allclose(b.extent(), [2, 4, 6])
    assert b.longest_axis() == 2
    assert b.max_extent() == 6
    assert b.volume() == 48
    assert b.area() == 2 * (8 + 12 + 24)
    assert b.contains([1, 1, 1])
    assert not b.contains([3, 0, 0])
    b2 = ml.Aabb.of_points(np.array([[5, 5, 5], [6, 6, 6]]))
    b.include(b2)
    assert b.contains([5.5, 5.5, 5.5])
