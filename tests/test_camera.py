"""Camera semantics vs the reference CRTCamera (CRTCamera.cpp)."""

import numpy as np
import pytest

from directx_raytracer.models.camera import Camera
from directx_raytracer.utils import vecmath as vm


def test_default_orientation():
    cam = Camera()
    np.testing.assert_allclose(cam.rotation, np.eye(3), atol=1e-7)
    np.testing.assert_allclose(cam.forward, [0, 0, 1], atol=1e-7)
    np.testing.assert_allclose(cam.right, [1, 0, 0], atol=1e-7)
    np.testing.assert_allclose(cam.up, [0, 1, 0], atol=1e-7)


def test_pan_rotates_forward_around_y():
    cam = Camera()
    cam.pan(90.0)
    # rot_y(90): forward column becomes (-1, 0, 0) (CRTCamera.cpp:9-19)
    np.testing.assert_allclose(cam.forward, [-1, 0, 0], atol=1e-6)


def test_tilt_and_roll_compose_on_the_right():
    cam = Camera()
    cam.pan(30.0)
    cam.tilt(20.0)
    cam.roll(10.0)
    expected = vm.rot_y(30.0) @ vm.rot_x(20.0) @ vm.rot_z(10.0)
    np.testing.assert_allclose(cam.rotation, expected, atol=1e-6)


def test_move_and_zoom_follow_matrix_columns():
    cam = Camera(position=(1.0, 2.0, 3.0))
    cam.pan(90.0)
    r = cam.rotation
    cam.move_forward(2.0)
    np.testing.assert_allclose(cam.position, [1, 2, 3] + 2.0 * r[:, 2], atol=1e-6)
    cam.move_right(3.0)
    np.testing.assert_allclose(
        cam.position, [1, 2, 3] + 2.0 * r[:, 2] + 3.0 * r[:, 0], atol=1e-6
    )
    pos_before = cam.position.copy()
    cam.zoom(-1.5)
    np.testing.assert_allclose(cam.position, pos_before - 1.5 * r[:, 2], atol=1e-6)


def test_rotate_zero_is_identity():
    cam = Camera()
    cam.rotate(0.0, 0.0)
    np.testing.assert_allclose(cam.rotation, np.eye(3), atol=1e-6)


def test_rotate_yaw_90():
    cam = Camera()
    cam.rotate(90.0, 0.0)
    # forward = (cos0*sin90, sin0, cos0*cos90) = (1, 0, 0)  (CRTCamera.cpp:69-72)
    np.testing.assert_allclose(cam.forward, [1, 0, 0], atol=1e-6)
    # right = normalize(cross(worldUp, forward)) = (0, 0, -1)
    np.testing.assert_allclose(cam.right, [0, 0, -1], atol=1e-6)
    np.testing.assert_allclose(cam.up, [0, 1, 0], atol=1e-6)


def test_rotate_pitch_clamped_at_89_degrees():
    cam = Camera()
    cam.rotate(0.0, 200.0)
    assert cam.pitch == pytest.approx(89.0 * vm.DEG2RAD)
    cam.rotate(0.0, -500.0)
    assert cam.pitch == pytest.approx(-89.0 * vm.DEG2RAD)


def test_rotate_columns_orthonormal():
    cam = Camera()
    cam.rotate(37.0, -12.0)
    r = cam.rotation
    np.testing.assert_allclose(r.T @ r, np.eye(3), atol=1e-6)


def test_pan_around_target_orbits_position():
    cam = Camera(position=(0.0, 0.0, 10.0))
    cam.pan_around_target(90.0, target=(0.0, 0.0, 0.0))
    # toCamera=(0,0,10) row-multiplied by rot_y(90) -> (10, 0, 0)
    np.testing.assert_allclose(cam.position, [10, 0, 0], atol=1e-5)
    np.testing.assert_allclose(cam.rotation, vm.rot_y(90.0), atol=1e-6)


def test_wasd_semantics():
    """DXRTApp::updateCameraMovement (DXRTApp.cpp:92-107): W = moveForward(-s*dt),
    i.e., W moves along the view direction (-forward = -column 2)."""
    cam = Camera()
    cam.move_forward(-10.0 * 0.1)  # 'W' for 0.1 s at speed 10
    np.testing.assert_allclose(cam.position, [0, 0, -1.0], atol=1e-6)
