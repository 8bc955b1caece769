"""Pipeline-level tests for the motion subsystems wired in round 2:

- constant-velocity scan undistortion inside ``process_scan``
  (≙ MotionCompensation.cpp:64-139 applied by the odometry worker),
- IMU attitude boot at startup (≙ ImuBuffer::estimateAttitudeFromImu),
- out-of-order measurement propagation (≙ Mapper.cpp:196-235).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam.pipeline import (
    MotionCompensationConfig,
    SlamConfig,
    SlamPipeline,
)
from tests.test_pipeline import make_world, small_config


def distorted_scan(world, pose_start, twist, m, seed, noise=0.005):
    """Simulate one sweep of a spinning lidar under constant body twist.

    Each point is measured in the sensor frame at its acquisition instant;
    the scan is stamped at the sweep end, so a point with phase p is seen
    from pose_start @ exp(p * twist). Returns (PointBatch with a ``times``
    channel, end-of-sweep pose)."""
    r = np.random.default_rng(seed)
    pose_end = pose_start @ np.asarray(
        se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64
    )
    local_end = (np.linalg.inv(pose_end) @ np.c_[world, np.ones(len(world))].T).T[:, :3]
    vis = np.where(np.linalg.norm(local_end, axis=1) < 20.0)[0]
    sel = r.choice(vis, size=min(m, len(vis)), replace=False)
    # Phase from azimuth in the end frame (consistent with the sensor model).
    az = np.arctan2(world[sel, 1] - pose_end[1, 3], world[sel, 0] - pose_end[0, 3])
    phases = (az + np.pi) / (2 * np.pi)
    pts = np.zeros((len(sel), 3), np.float32)
    for i, (idx, p) in enumerate(zip(sel, phases)):
        T_p = pose_start @ np.asarray(
            se3.exp_se3(jnp.asarray(p * np.asarray(twist), jnp.float32)), np.float64
        )
        pts[i] = (np.linalg.inv(T_p) @ np.r_[world[idx], 1.0])[:3]
    pts += r.normal(size=pts.shape).astype(np.float32) * noise
    # Fixed capacity: a varying count would compile a fresh XLA program per
    # frame (m <= 3000 < 4096 always holds).
    batch = pc.from_points(pts, capacity=4096,
                           extras={"times": phases.astype(np.float32)[:, None]})
    return batch, pose_end


@pytest.mark.slow
@pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="numerics A/B (20 pipeline replays, many fresh XLA programs); "
    "backend-independent — runs on the CPU tier",
)
def test_undistortion_reduces_pose_error(rng):
    """Spinning-lidar replay: with fast yaw+translation, enabling motion
    compensation must measurably reduce the final pose error.

    The robot starts at rest (frames 0-1), then moves at a constant
    aggressive twist — matching real deployments, where the first scan
    (which seeds the map before any motion estimate exists) is acquired
    undistorted. Starting at full speed would poison the map seed for
    *any* odometry-driven compensator, including the reference's."""
    world = make_world(rng)
    # Aggressive constant twist per 0.1 s frame: 0.25 rad yaw + 0.5 m forward.
    twist = np.array([0.0, 0.0, 0.25, 0.5, 0.0, 0.0])
    zero = np.zeros(6)

    def run(mc_enabled):
        cfg = small_config()
        cfg = dataclasses.replace(
            cfg,
            use_external_odometry=True,
            use_imu_attitude_init=False,
            motion_compensation=MotionCompensationConfig(
                enabled=mc_enabled, scan_duration=0.1, use_times_channel=True
            ),
        )
        pipe = SlamPipeline(cfg)
        pose = np.eye(4)
        errs = []
        for i in range(10):
            tw = zero if i < 2 else twist
            if i > 0:
                pose = pose @ np.asarray(
                    se3.exp_se3(jnp.asarray(tw, jnp.float32)), np.float64
                )
            start = pose @ np.asarray(
                se3.exp_se3(jnp.asarray(-tw, jnp.float32)), np.float64
            )
            scan, pose_end = distorted_scan(world, start, tw, 3000, seed=i)
            np.testing.assert_allclose(pose_end, pose, atol=1e-6)
            pipe.process_scan(scan, time=0.1 * i, external_odom_pose=pose)
            errs.append(np.linalg.norm(pipe.pose[:3, 3] - pose[:3, 3]))
        return errs[-1]

    err_off = run(False)
    err_on = run(True)
    # Undistorted registration must clearly beat distorted registration.
    assert err_on < 0.7 * err_off, (err_on, err_off)
    assert err_on < 0.15, err_on


def test_imu_attitude_boot(rng):
    """Buffered IMU samples set the initial roll/pitch before the first
    scan; yaw stays free (gravity gives no yaw)."""
    roll = 0.3  # rad
    R_wb = np.asarray(se3.matrix_from_rpy(jnp.asarray([roll, 0.0, 0.0])), np.float64)
    g_body = R_wb.T @ np.array([0.0, 0.0, 9.81])  # accelerometer reads +g "up"

    cfg = small_config()
    pipe = SlamPipeline(cfg)
    for k in range(20):
        pipe.add_imu(0.001 * k, g_body + rng.normal(size=3) * 0.02, rng.normal(size=3) * 0.001)

    scan = pc.from_points(
        rng.uniform(-5, 5, (512, 3)).astype(np.float32), capacity=512
    )
    pipe.process_scan(scan, time=0.1)
    # Gravity direction in the booted frame must match world -z.
    up_est = pipe.pose[:3, :3] @ (g_body / np.linalg.norm(g_body))
    assert np.dot(up_est, [0, 0, 1]) > 0.999, up_est


def test_imu_attitude_skipped_when_pose_set(rng):
    """An explicit set_initial_transform wins over IMU attitude boot."""
    cfg = small_config()
    pipe = SlamPipeline(cfg)
    T0 = np.eye(4)
    T0[:3, :3] = np.asarray(se3.matrix_from_rpy(jnp.asarray([0.0, 0.0, 1.0])), np.float64)
    for k in range(10):
        pipe.add_imu(0.001 * k, [1.0, 0.0, 9.7], [0, 0, 0])
    pipe.set_initial_transform(T0)
    scan = pc.from_points(rng.uniform(-5, 5, (512, 3)).astype(np.float32), capacity=512)
    pipe.process_scan(scan, time=0.1)
    np.testing.assert_allclose(pipe.pose[:3, :3], T0[:3, :3], atol=1e-6)


def test_out_of_order_scan_propagates(rng):
    """A stale-stamped scan must not be registered; the pose advances by the
    last odometry motion and the pipeline keeps accepting fresh scans."""
    world = make_world(rng)
    cfg = dataclasses.replace(small_config(), use_external_odometry=True,
                              use_imu_attitude_init=False)
    pipe = SlamPipeline(cfg)
    step = np.eye(4)
    step[0, 3] = 0.5
    pose = np.eye(4)
    from tests.test_pipeline import scan_at

    for i in range(3):
        if i > 0:
            pose = pose @ step
        scan = pc.from_points(scan_at(world, pose, 2000, seed=i), capacity=2048)
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=pose)
    pose_before = pipe.pose.copy()

    # Stale scan (t=0.15 < 0.2): must take the propagation path.
    stale = pc.from_points(scan_at(world, pose, 2000, seed=9), capacity=2048)
    stats = pipe.process_scan(stale, time=0.15, external_odom_pose=pose)
    assert stats.get("out_of_order") is True
    assert not stats["inserted"]
    # Propagated by the last odometry motion (one forward step).
    np.testing.assert_allclose(pipe.pose, pose_before @ step, atol=1e-5)

    # Fresh scan afterwards is processed normally.
    pose = pose @ step
    scan = pc.from_points(scan_at(world, pose, 2000, seed=4), capacity=2048)
    stats = pipe.process_scan(scan, time=0.3, external_odom_pose=pose)
    assert "out_of_order" not in stats
    err = np.linalg.norm(pipe.pose[:3, 3] - pose[:3, 3])
    assert err < 0.3, err
