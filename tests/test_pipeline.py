"""Deterministic replay integration tests (the reference's rosbag-replay
harness analogue, SURVEY 3.4)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam.mapper import MapperConfig
from open3d_slam_jax.slam.odometry import OdometryConfig
from open3d_slam_jax.slam.pipeline import SlamConfig, SlamPipeline
from open3d_slam_jax.slam.place_recognition import PlaceRecognitionConfig
from open3d_slam_jax.slam.submap_collection import SubmapCollectionConfig


def make_world(rng):
    """Square-corridor world (10m x 10m) with pillars for x/y constraint."""
    n = 24000
    pts = []
    # floor
    pts.append(np.c_[rng.uniform(-8, 18, (n // 2, 2)), np.zeros((n // 2, 1))])
    # outer walls of the square corridor region
    for (a, b, fixed, axis) in [
        (-8, 18, -8.0, 1), (-8, 18, 18.0, 1), (-8, 18, -8.0, 0), (-8, 18, 18.0, 0),
    ]:
        w = np.zeros((n // 8, 3))
        w[:, axis] = fixed
        w[:, 1 - axis] = rng.uniform(a, b, n // 8)
        w[:, 2] = rng.uniform(0, 3, n // 8)
        pts.append(w)
    # pillars scattered
    for cx, cy in [(0, 0), (10, 0), (10, 10), (0, 10), (5, 5)]:
        p = np.zeros((800, 3))
        p[:, 0] = cx + rng.uniform(-0.3, 0.3, 800)
        p[:, 1] = cy + rng.uniform(-0.3, 0.3, 800)
        p[:, 2] = rng.uniform(0, 3, 800)
        pts.append(p)
    return np.vstack(pts).astype(np.float32)


def scan_at(world, pose, m, seed):
    r = np.random.default_rng(seed)
    local = (np.linalg.inv(pose) @ np.c_[world, np.ones(len(world))].T).T[:, :3]
    d = np.linalg.norm(local, axis=1)
    vis = np.where(d < 20.0)[0]
    sel = r.choice(vis, size=min(m, len(vis)), replace=False)
    return (local[sel] + r.normal(size=(len(sel), 3)) * 0.01).astype(np.float32)


def small_config(loop_closures=False):
    icp_small = icp_mod.ICPConfig(
        knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 13,
        grid_bucket_cap=16, trimmed_ratio=0.9, minimizer="point_to_plane",
        max_iterations=20, min_diff_rot=1e-3, min_diff_trans=2e-3,
    )
    lc_icp = dataclasses.replace(icp_small, max_match_dist=1.0, grid_table_size=1 << 13)
    return SlamConfig(
        odometry=OdometryConfig(max_points=4096, voxel_size=0.3,
                                icp=dataclasses.replace(icp_small, max_match_dist=1.0)),
        mapper=MapperConfig(
            scan_capacity=4096, submap_capacity=16384, scan_voxel_size=0.25,
            reference_reinit_every=3, icp=icp_small,
        ),
        submaps=SubmapCollectionConfig(
            submap_capacity=16384, creation_radius=6.0, activation_radius=5.0,
            min_scans_before_switch=2,
        ),
        place_recognition=PlaceRecognitionConfig(
            num_yaw_hypotheses=8, min_overlap=0.3, max_residual=0.4,
            min_submaps_between_candidates=2, min_adjacency_distance=2,
            max_candidate_distance=15.0, icp=lc_icp,
        ),
        loop_closure_enabled=loop_closures,
    )


def square_trajectory(side=10.0, steps_per_side=10):
    """Walk a square and return to start."""
    poses = []
    T = np.eye(4)
    step = side / steps_per_side
    for leg in range(4):
        for _ in range(steps_per_side):
            poses.append(T.copy())
            T = T @ np.asarray(
                se3.exp_se3(jnp.asarray([0, 0, 0, step, 0, 0], jnp.float32)), np.float64
            )
        T = T @ np.asarray(
            se3.exp_se3(jnp.asarray([0, 0, np.pi / 2, 0, 0, 0], jnp.float32)), np.float64
        )
    poses.append(T.copy())
    return poses


@pytest.mark.slow
def test_replay_square_with_external_odometry(rng):
    """Full pipeline replay: external (biased) odometry + scan-to-map."""
    world = make_world(rng)
    cfg = small_config(loop_closures=False)
    cfg = dataclasses.replace(cfg, use_external_odometry=True)
    pipe = SlamPipeline(cfg)

    poses = square_trajectory(10.0, 8)
    bias = np.asarray(se3.exp_se3(jnp.asarray([0, 0, 0.001, 0.01, 0.005, 0], jnp.float32)), np.float64)
    odom = np.eye(4)
    errs = []
    for i, tp in enumerate(poses):
        if i > 0:
            odom = odom @ (np.linalg.inv(poses[i - 1]) @ tp @ bias)
        scan = pc.from_points(scan_at(world, tp, 5000, seed=i), capacity=8192)
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=odom)
        errs.append(np.linalg.norm(pipe.pose[:3, 3] - tp[:3, 3]))
    # Scan-to-map keeps error well below raw odometry drift.
    odom_drift = np.linalg.norm(odom[:3, 3] - poses[-1][:3, 3])
    assert errs[-1] < max(0.2, 0.5 * odom_drift), (errs[-1], odom_drift)
    assert len(pipe.submaps) >= 3
    assert pipe.assembled_map().shape[0] > 5000


@pytest.mark.slow
def test_replay_determinism(rng):
    world = make_world(rng)
    results = []
    for _ in range(2):
        pipe = SlamPipeline(small_config())
        poses = square_trajectory(6.0, 5)[:8]
        for i, tp in enumerate(poses):
            scan = pc.from_points(scan_at(world, tp, 3000, seed=i), capacity=4096)
            pipe.process_scan(scan, time=0.1 * i)
        results.append(pipe.pose)
    np.testing.assert_array_equal(results[0], results[1])


@pytest.mark.slow
def test_localization_on_prior_map(rng):
    """setInitialMap + setInitialTransform: localize without mapping drift."""
    world = make_world(rng)
    cfg = small_config()
    cfg = dataclasses.replace(cfg, use_external_odometry=True)
    pipe = SlamPipeline(cfg)
    pipe.set_initial_map(world[rng.choice(len(world), 20000, replace=False)], capacity=32768)
    T0 = np.eye(4)
    T0[:3, 3] = [2.0, 1.0, 0]
    pipe.set_initial_transform(T0)
    # Feed scans from poses near T0; identity odometry increments.
    pose = T0.copy()
    for i in range(4):
        if i > 0:
            pose = pose @ np.asarray(
                se3.exp_se3(jnp.asarray([0, 0, 0, 0.5, 0, 0], jnp.float32)), np.float64
            )
        scan = pc.from_points(scan_at(world, pose, 4000, seed=50 + i), capacity=8192)
        pipe.process_scan(
            scan, time=float(i),
            external_odom_pose=np.linalg.inv(T0) @ pose,  # odometry in its own frame
        )
    err = np.linalg.norm(pipe.pose[:3, 3] - pose[:3, 3])
    assert err < 0.2, err


@pytest.mark.slow
def test_loop_closure_fires_and_corrects(rng):
    """Drive the square with drifting odometry; on revisit, place
    recognition must accept a loop closure and the pose graph must pull the
    trajectory back (the reference's loopClosureWorker flow end-to-end)."""
    world = make_world(rng)
    cfg = small_config(loop_closures=True)
    cfg = dataclasses.replace(cfg, use_external_odometry=True)
    pipe = SlamPipeline(cfg)

    poses = square_trajectory(10.0, 8)
    bias = np.asarray(
        se3.exp_se3(jnp.asarray([0, 0, 0.004, 0.02, 0.01, 0], jnp.float32)), np.float64
    )
    odom = np.eye(4)
    for i, tp in enumerate(poses):
        if i > 0:
            odom = odom @ (np.linalg.inv(poses[i - 1]) @ tp @ bias)
        scan = pc.from_points(scan_at(world, tp, 5000, seed=i), capacity=8192)
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=odom)
    total_lc = sum(s.get("loop_closures", 0) for s in pipe.stats)
    assert len(pipe.submaps) >= 4
    assert total_lc >= 1, "no loop closure accepted on revisit"
    err = np.linalg.norm(pipe.pose[:3, 3] - poses[-1][:3, 3])
    assert err < 0.5, err


@pytest.mark.slow
def test_checkpoint_resume_bitexact(rng, tmp_path):
    """Save mid-run, restore into a fresh pipeline, continue: the resumed
    run must track the uninterrupted run exactly."""
    from open3d_slam_jax.slam import checkpoint

    world = make_world(rng)
    cfg = small_config()
    cfg = dataclasses.replace(cfg, use_external_odometry=True)
    poses = square_trajectory(6.0, 5)[:10]
    scans = [pc.from_points(scan_at(world, tp, 3000, seed=i), capacity=4096) for i, tp in enumerate(poses)]

    # Uninterrupted run.
    full = SlamPipeline(cfg)
    for i, (tp, sc) in enumerate(zip(poses, scans)):
        full.process_scan(sc, time=0.1 * i, external_odom_pose=tp)

    # Interrupted at scan 5 + checkpoint + resume.
    a = SlamPipeline(cfg)
    for i in range(5):
        a.process_scan(scans[i], time=0.1 * i, external_odom_pose=poses[i])
    ckpt = tmp_path / "state.npz"
    checkpoint.save_pipeline(a, str(ckpt))

    b = SlamPipeline(cfg)
    checkpoint.load_pipeline(b, str(ckpt))
    for i in range(5, 10):
        b.process_scan(scans[i], time=0.1 * i, external_odom_pose=poses[i])

    np.testing.assert_allclose(b.pose, full.pose, atol=1e-9)
    assert len(b.submaps) == len(full.submaps)

    # Map artifacts.
    out = tmp_path / "artifacts"
    checkpoint.save_map_artifacts(b, str(out))
    import json, os
    assert os.path.exists(out / "map.ply")
    g = json.load(open(out / "pose_graph.json"))
    assert len(g["nodes"]) == len(b.submaps)


@pytest.mark.slow
def test_relocalize_on_built_map(rng):
    """Kidnapped-robot: relocalize a scan on the built map with only a
    coarse hint (the SlamMapInitializer workflow).

    The world carries distinct box landmarks: in a self-similar corridor
    world, trimmed-residual scoring cannot disambiguate slides along walls
    (any ICP-based scorer aliases there, the reference's included)."""
    world = make_world(rng)
    boxes = []
    for (cx, cy, sx, sy, sz) in [(3, 2, 1.2, 0.6, 2.0), (12, 7, 0.8, 1.5, 1.4),
                                 (7, 12, 1.6, 0.9, 2.4)]:
        m = 700
        f1 = np.c_[np.full((m, 1), cx + sx), cy + rng.uniform(-sy, sy, (m, 1)), rng.uniform(0, sz, (m, 1))]
        f2 = np.c_[cx + rng.uniform(-sx, sx, (m, 1)), np.full((m, 1), cy + sy), rng.uniform(0, sz, (m, 1))]
        f3 = np.c_[cx + rng.uniform(-sx, sx, (m, 1)), cy + rng.uniform(-sy, sy, (m, 1)), np.full((m, 1), sz)]
        boxes += [f1, f2, f3]
    world = np.vstack([world] + boxes).astype(np.float32)
    cfg = dataclasses.replace(small_config(), use_external_odometry=True)
    pipe = SlamPipeline(cfg)
    poses = square_trajectory(10.0, 8)[:16]
    for i, tp in enumerate(poses):
        scan = pc.from_points(scan_at(world, tp, 5000, seed=i), capacity=8192)
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=tp)

    # Kidnap: true pose somewhere along the traversed path; hint 3m off.
    true_pose = poses[6].copy()
    scan = pc.from_points(scan_at(world, true_pose, 5000, seed=99), capacity=8192)
    hint = true_pose.copy()
    hint[0, 3] += 3.0
    hint[1, 3] -= 2.0
    T = pipe.relocalize(scan, hint_pose=hint, search_radius=8.0)
    assert T is not None, "relocalization failed"
    err = np.linalg.norm(T[:3, 3] - true_pose[:3, 3])
    assert err < 0.3, err
    np.testing.assert_allclose(pipe.pose, T)


@pytest.mark.slow
def test_dense_map_builds_alongside(rng):
    world = make_world(rng)
    cfg = dataclasses.replace(small_config(), use_external_odometry=True,
                              build_dense_map=True, dense_map_voxel=0.2,
                              dense_map_capacity=1 << 16)
    pipe = SlamPipeline(cfg)
    poses = square_trajectory(6.0, 5)[:6]
    for i, tp in enumerate(poses):
        pipe.process_scan(pc.from_points(scan_at(world, tp, 3000, seed=i), capacity=4096),
                          0.1 * i, external_odom_pose=tp)
    dm = pipe.dense_map_points()
    sparse = pipe.assembled_map()
    assert len(dm) > len(sparse) * 0.5
    # Dense map lives in the same frame as the sparse map.
    from scipy.spatial import cKDTree
    d, _ = cKDTree(sparse).query(dm[::20], k=1)
    assert np.median(d) < 0.5


@pytest.mark.slow
def test_online_runner_matches_offline(rng):
    """OnlineSlamRunner (threaded, ≙ the worker-thread front-end) must
    reproduce offline deterministic stepping when nothing is dropped,
    including IMU ingestion and external odometry pass-through."""
    import time as time_mod

    from open3d_slam_jax.slam.pipeline import OnlineSlamRunner

    world = make_world(rng)
    cfg = dataclasses.replace(small_config(), use_external_odometry=True,
                              use_imu_attitude_init=False)
    step = np.eye(4)
    step[0, 3] = 0.5
    scans, poses = [], []
    pose = np.eye(4)
    for i in range(4):
        if i > 0:
            pose = pose @ step
        scans.append(pc.from_points(scan_at(world, pose, 2000, seed=i), capacity=2048))
        poses.append(pose.copy())

    offline = SlamPipeline(cfg)
    for i, (s, p) in enumerate(zip(scans, poses)):
        offline.process_scan(s, time=0.1 * i, external_odom_pose=p)

    online_pipe = SlamPipeline(cfg)
    runner = OnlineSlamRunner(online_pipe, queue_size=8)
    runner.start()
    for k in range(5):
        runner.add_imu(0.001 * k, (0.0, 0.0, 9.81), (0.0, 0.0, 0.0))
    for i, (s, p) in enumerate(zip(scans, poses)):
        runner.add_range_scan(s, time=0.1 * i, odom_pose=p)
    deadline = time_mod.time() + 120.0
    while len(online_pipe.stats) < 4 and time_mod.time() < deadline:
        time_mod.sleep(0.05)
    runner.stop()

    assert len(online_pipe.stats) == 4 and runner.dropped == 0
    assert len(online_pipe.imu_buffer) == 5
    np.testing.assert_allclose(online_pipe.pose, offline.pose, atol=1e-6)
