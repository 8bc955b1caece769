"""Submap lifecycle gates + production-path space carving (round 2).

Covers the reference behaviors from ``SubmapCollection.cpp:94-148`` (force-new
on bank saturation, adjacency + consistency-gated re-activation) and
``Submap.cpp:56-86`` (periodic carving on scan insertion) as reached through
``SlamPipeline`` — not just the unit-level ``submap.carve``.
"""

import dataclasses

import numpy as np
import pytest

from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam.pipeline import SlamPipeline
from open3d_slam_jax.slam.submap_collection import (
    SubmapCollection,
    SubmapCollectionConfig,
)
from tests.test_pipeline import make_world, scan_at, small_config


def wall_scan(rng, n=3000, ghost=False):
    """Sensor at origin looking +x at a wall (x=10) + floor; optionally a
    dynamic 'ghost' object at x=5."""
    wall = np.c_[np.full(n // 2, 10.0), rng.uniform(-6, 6, n // 2), rng.uniform(0, 4, n // 2)]
    floor = np.c_[rng.uniform(1, 10, n // 2), rng.uniform(-6, 6, n // 2), np.zeros(n // 2)]
    pts = [wall, floor]
    if ghost:
        m = 600
        pts.append(
            np.c_[5.0 + rng.uniform(-0.2, 0.2, m),
                  rng.uniform(-0.8, 0.8, m),
                  rng.uniform(0.5, 2.0, m)]
        )
    return np.vstack(pts).astype(np.float32) + rng.normal(
        size=(sum(len(p) for p in pts), 3)
    ).astype(np.float32) * 0.005


def ghost_points_in_map(map_pts):
    sel = (
        (np.abs(map_pts[:, 0] - 5.0) < 0.5)
        & (np.abs(map_pts[:, 1]) < 1.0)
        & (map_pts[:, 2] > 0.3)
    )
    return int(sel.sum())


@pytest.mark.slow
def test_pipeline_carving_removes_ghost(rng):
    """A dynamic object seen in early scans must be carved out of the
    *pipeline's* submap bank once later scans see through it."""

    def run(carve_every_n):
        cfg = small_config()
        cfg = dataclasses.replace(
            cfg,
            use_external_odometry=True,
            use_imu_attitude_init=False,
            submaps=dataclasses.replace(
                cfg.submaps, carve_every_n=carve_every_n, carve_angle_tol=0.03,
                carve_range_margin=0.5,
            ),
            mapper=dataclasses.replace(cfg.mapper, min_movement_for_insertion=0.0),
        )
        pipe = SlamPipeline(cfg)
        T = np.eye(4)
        for i in range(10):
            ghost = i < 2  # object present only in the first two scans
            scan = pc.from_points(wall_scan(rng, ghost=ghost), capacity=4096)
            pipe.process_scan(scan, time=0.1 * i, external_odom_pose=T)
        return ghost_points_in_map(pipe.assembled_map())

    with_carve = run(carve_every_n=1)
    without_carve = run(carve_every_n=0)
    assert without_carve > 50, "test setup: ghost never entered the map"
    assert with_carve < 0.1 * without_carve, (with_carve, without_carve)


@pytest.mark.slow
def test_bank_saturation_forces_new_submap(rng):
    """When the active bank nears capacity the collection must roll a new
    submap rather than silently dropping geometry — even while the robot
    stays within the creation radius."""
    world = make_world(rng)
    cfg = small_config()
    cfg = dataclasses.replace(
        cfg,
        use_external_odometry=True,
        use_imu_attitude_init=False,
        submaps=dataclasses.replace(
            cfg.submaps,
            submap_capacity=4096,
            max_num_points=3000,
            creation_radius=1000.0,  # proximity alone would never switch
            activation_radius=1000.0,
            min_scans_before_switch=1,
        ),
        mapper=dataclasses.replace(cfg.mapper, min_movement_for_insertion=0.0),
    )
    pipe = SlamPipeline(cfg)
    pose = np.eye(4)
    step = np.eye(4)
    step[0, 3] = 1.0
    for i in range(10):
        if i > 0:
            pose = pose @ step
        scan = pc.from_points(scan_at(world, pose, 3000, seed=i), capacity=4096)
        pipe.process_scan(scan, time=0.1 * i, external_odom_pose=pose)
    assert len(pipe.submaps) >= 2, "bank saturated but no new submap was created"
    # No bank may exceed its saturation watermark by more than one scan merge.
    for e in pipe.submaps.submaps:
        occ = int(np.asarray(e.state.cloud.mask).sum())
        assert occ <= 4096


def test_switch_consistency_gate(rng):
    """Re-activating an adjacent submap requires the scan to actually
    overlap it (≙ isSwitchingSubmapsConsistant)."""
    cfg = SubmapCollectionConfig(
        submap_capacity=8192, submap_voxel_size=0.2, creation_radius=4.0,
        activation_radius=5.0, min_scans_before_switch=1,
        min_fitness_for_switch=0.1,  # sparse random clouds -> low absolute overlap
    )
    r = np.random.default_rng(3)

    def local_cloud():
        return pc.from_points(
            r.uniform(-3, 3, (2000, 3)).astype(np.float32), capacity=2048
        )

    def pose_at(x):
        T = np.eye(4)
        T[0, 3] = x
        return T

    coll = SubmapCollection(cfg)
    coll.insert_scan(local_cloud(), pose_at(0.0), pose_at(0.0))
    assert coll.active_idx == 0
    # Walk away -> new submap (adjacent to 0).
    coll.insert_scan(local_cloud(), pose_at(10.0), pose_at(10.0))
    assert coll.active_idx == 1
    assert coll.adjacency.is_adjacent(0, 1)

    # Return near submap 0 with a CONSISTENT scan -> switch back.
    coll._scans_in_active = 5
    idx, switched = coll.update_active_submap(pose_at(0.5), scan=local_cloud())
    assert idx == 0 and switched

    # Same geometry but a scan that does NOT overlap submap 1 -> no switch.
    coll._scans_in_active = 5
    junk = pc.from_points(
        (r.uniform(-3, 3, (2000, 3)) + np.array([0, 0, 500.0])).astype(np.float32),
        capacity=2048,
    )
    idx, switched = coll.update_active_submap(pose_at(10.5), scan=junk)
    assert not (idx == 1 and switched), "inconsistent scan must not re-activate"
