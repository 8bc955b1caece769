import numpy as np
import pytest

from open3d_slam_jax.slam.imu import ImuBuffer, ImuSignalLowPassFilter


def test_attitude_level():
    buf = ImuBuffer()
    for i in range(50):
        buf.push(i * 0.01, [0, 0, 9.81], [0, 0, 0])
    R, g = buf.estimate_attitude()
    np.testing.assert_allclose(R, np.eye(3), atol=1e-9)
    assert abs(g - 9.81) < 1e-6


def test_attitude_tilted_roll():
    # Body rolled by +30deg: gravity reads in body frame as R_x(-30) @ [0,0,g].
    ang = np.deg2rad(30)
    Rx = np.array([
        [1, 0, 0],
        [0, np.cos(ang), -np.sin(ang)],
        [0, np.sin(ang), np.cos(ang)],
    ])
    acc_body = Rx.T @ np.array([0, 0, 9.81])
    buf = ImuBuffer()
    for i in range(50):
        buf.push(i * 0.01, acc_body, [0, 0, 0])
    R, g = buf.estimate_attitude()
    # R_world_body must map the body up-direction back to world +z.
    up_world = R @ (acc_body / np.linalg.norm(acc_body))
    np.testing.assert_allclose(up_world, [0, 0, 1], atol=1e-9)


def test_gyro_bias():
    buf = ImuBuffer()
    rng = np.random.default_rng(0)
    for i in range(200):
        buf.push(i * 0.005, [0, 0, 9.81], [0.01, -0.02, 0.005] + rng.normal(0, 1e-3, 3))
    bias = buf.estimate_gyro_bias()
    np.testing.assert_allclose(bias, [0.01, -0.02, 0.005], atol=1e-3)


def test_angular_velocity_interpolation():
    buf = ImuBuffer()
    buf.push(0.0, [0, 0, 9.81], [0, 0, 0])
    buf.push(1.0, [0, 0, 9.81], [0, 0, 1.0])
    np.testing.assert_allclose(buf.angular_velocity(0.5), [0, 0, 0.5])
    np.testing.assert_allclose(buf.angular_velocity(-1), [0, 0, 0])
    np.testing.assert_allclose(buf.angular_velocity(5), [0, 0, 1.0])


def test_lowpass_smooths_noise():
    f = ImuSignalLowPassFilter(cutoff_hz=2.0, sample_rate_hz=100.0)
    rng = np.random.default_rng(1)
    out = [f.filter([1.0, 0, 0] + rng.normal(0, 0.5, 3)) for _ in range(500)]
    tail = np.stack(out[-100:])
    assert np.std(tail[:, 0]) < 0.2
    assert abs(np.mean(tail[:, 0]) - 1.0) < 0.1


def test_window_selection():
    buf = ImuBuffer()
    for i in range(100):
        acc = [0, 0, 9.81] if i < 50 else [5.0, 0, 9.81]
        buf.push(i * 0.01, acc, [0, 0, 0])
    R, g = buf.estimate_attitude(t_start=0.0, t_end=0.49)
    np.testing.assert_allclose(R, np.eye(3), atol=1e-9)


def test_insufficient_samples_raises():
    buf = ImuBuffer()
    with pytest.raises(ValueError):
        buf.estimate_attitude()
