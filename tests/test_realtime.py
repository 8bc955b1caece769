"""RealtimePipeline — the online, deferred-readback SLAM orchestration.

Covers the round-4 real-time architecture (≙ the reference's concurrent
worker mode, ``SlamWrapper.cpp:554-1053``): one fused device step per scan,
poll-cadence stats, host submap lifecycle at poll boundaries, loop closure
on a worker thread, and trajectory parity with the deterministic offline
``SlamPipeline`` (the correctness harness, ≙ single-stepped rosbag replay).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam.mapper import MapperConfig
from open3d_slam_jax.slam.odometry import OdometryConfig
from open3d_slam_jax.slam.pipeline import (
    MotionCompensationConfig,
    SlamConfig,
    SlamPipeline,
)
from open3d_slam_jax.slam.realtime import (
    IDX_INSERTED,
    IDX_OCCUPANCY,
    IDX_POSE,
    RealtimePipeline,
    rt_init,
    rt_step,
)
from open3d_slam_jax.slam.submap_collection import SubmapCollectionConfig


def synth_scene(n, seed=0):
    rng = np.random.default_rng(seed)
    half = n // 2
    floor = np.c_[rng.uniform(-30, 30, (half, 2)), rng.normal(0, 0.02, (half, 1))]
    rest = n - half
    walls = []
    for i in range(6):
        m = rest // 6
        ang = 2 * np.pi * i / 6
        d = rng.uniform(8, 20)
        u = np.array([np.cos(ang), np.sin(ang)])
        t = rng.uniform(-8, 8, (m, 1))
        h = rng.uniform(0, 4, (m, 1))
        base = d * u[None, :] + t * np.array([[-u[1], u[0]]])
        walls.append(np.c_[base, h])
    return np.vstack([floor] + walls).astype(np.float32)


def sample(scene, pose, n, seed):
    rng = np.random.default_rng(seed)
    local = (np.linalg.inv(pose) @ np.c_[scene, np.ones(len(scene))].T).T[:, :3]
    r = np.linalg.norm(local, axis=1)
    vis = np.flatnonzero((r < 30) & (r > 1))
    sel = rng.choice(vis, size=n, replace=len(vis) < n)
    pts = local[sel] + rng.normal(size=(n, 3)) * 0.01
    return pc.from_points(pts.astype(np.float32), capacity=n)


def small_cfg(loop_closure=False, **submap_kw):
    icp_map = icp_mod.ICPConfig(
        knn=1, max_match_dist=1.0, matcher="grid",
        grid_table_size=1 << 12, grid_bucket_cap=48,
        trimmed_ratio=0.85, minimizer="point_to_plane",
        max_iterations=8, coarse_iterations=4, coarse_stride=4,
        candidate_refresh_every=6, fast_trimming=True,
    )
    odo = OdometryConfig(
        voxel_size=0.3, max_range=30.0, max_points=2048,
        icp=dataclasses.replace(OdometryConfig().icp, grid_table_size=1 << 11),
    )
    return SlamConfig(
        odometry=odo,
        mapper=MapperConfig(
            icp=icp_map, scan_voxel_size=0.2, scan_capacity=2048,
            submap_capacity=1 << 13, min_movement_for_insertion=0.05,
        ),
        submaps=SubmapCollectionConfig(submap_capacity=1 << 13, **submap_kw),
        motion_compensation=MotionCompensationConfig(enabled=False),
        use_imu_attitude_init=False,
        loop_closure_enabled=loop_closure,
    )


def drive(pipeline_cls, cfg, scans, **kw):
    p = pipeline_cls(cfg, **kw) if kw else pipeline_cls(cfg)
    if pipeline_cls is SlamPipeline:
        poses = []
        for i, s in enumerate(scans):
            p.process_scan(s, time=0.1 * i)
            poses.append(p.pose)
        return p, np.stack(poses)
    for i, s in enumerate(scans):
        p.process_scan(s, time=0.1 * i)
    p.finish()
    return p, p.trajectory()


def make_run(n_frames=16, n_pts=1024, twist=(0, 0, 0.08, 0.35, 0, 0)):
    scene = synth_scene(20000)
    T = np.eye(4)
    T[:3, 3] = [2.0, 0.0, 1.0]
    tw = np.asarray(twist, np.float64)
    poses, scans = [], []
    for i in range(n_frames):
        poses.append(T.copy())
        scans.append(sample(scene, T, n_pts, 100 + i))
        T = T @ np.asarray(se3.exp_se3(jnp.asarray(tw, jnp.float32)), np.float64)
    return scans, np.stack(poses)


def ate(est, gts):
    T_align = gts[0] @ np.linalg.inv(est[0])
    return np.asarray(
        [np.linalg.norm((np.linalg.inv(T_align @ e) @ g)[:3, 3])
         for e, g in zip(est, gts)]
    )


def test_rt_step_matches_mapper_semantics():
    """One fused rt_step produces a finite registered pose, inserts on
    movement, and reports occupancy in the packed stats vector."""
    cfg = small_cfg()
    scans, _ = make_run(n_frames=3)
    state = rt_init(scans[0], jnp.eye(4), cfg)
    assert int(jnp.sum(state.bank.cloud.mask)) > 0
    state2, stats = rt_step(
        state, scans[1], jnp.asarray(0.1, jnp.float32), jnp.eye(4), cfg
    )
    stats = np.asarray(stats)
    T = stats[IDX_POSE].reshape(4, 4)
    assert np.all(np.isfinite(T))
    assert stats[IDX_OCCUPANCY] > 0
    # Moved ~0.35 m >> 0.05 m gate: must insert.
    assert stats[IDX_INSERTED] > 0.5
    assert int(state2.scans_in_active) == 2


def test_realtime_matches_offline_trajectory():
    """The realtime path must track the deterministic offline harness: same
    scans, comparable ATE (both are registrations of the same chain; the
    realtime path differs only in poll-cadence lifecycle decisions)."""
    cfg = small_cfg()
    scans, gts = make_run(n_frames=14)
    _, offline_traj = drive(SlamPipeline, cfg, scans)
    _, rt_traj = drive(RealtimePipeline, cfg, scans, poll_every=4)
    assert rt_traj.shape == offline_traj.shape
    a_off = ate(offline_traj, gts)
    a_rt = ate(rt_traj, gts)
    # The 1024-pt test scans are deliberately sparse (CPU speed); both paths
    # land in the same decimeter class, and the realtime path must not be
    # meaningfully worse than the offline harness on identical input
    # (measured here: rt 0.13 vs offline 0.21 median).
    assert np.max(a_rt) < 0.8
    assert np.median(a_rt) < max(1.5 * np.median(a_off), 0.05)


def test_realtime_out_of_order_scan_skipped():
    cfg = small_cfg()
    scans, _ = make_run(n_frames=4)
    rt = RealtimePipeline(cfg, poll_every=2)
    rt.process_scan(scans[0], time=0.0)
    rt.process_scan(scans[1], time=0.1)
    rt.process_scan(scans[2], time=0.05)  # out of order
    rt.process_scan(scans[3], time=0.2)
    rt.finish()
    assert rt.frames[2].out_of_order
    assert not rt.frames[3].out_of_order
    assert rt.trajectory().shape == (4, 4, 4)


@pytest.mark.slow
def test_realtime_submap_switch_and_loop_closure():
    """A closed loop long enough to finish submaps: the lifecycle creates
    >=2 submaps at poll boundaries and the LC worker runs without
    destabilizing the trajectory."""
    cfg = small_cfg(loop_closure=True, creation_radius=5.0, activation_radius=6.0)
    scans, gts = make_run(n_frames=36, n_pts=2048, twist=(0, 0, 0.11, 0.5, 0, 0))
    rt, traj = drive(RealtimePipeline, cfg, scans, poll_every=4)
    assert len(rt.submaps.submaps) >= 2
    assert any(e.finished for e in rt.submaps.submaps)
    a = ate(traj, gts)
    assert np.median(a) < 0.15
    # Export paths stay alive after the run.
    assert rt.assembled_map().shape[0] > 0


def test_packed_h2d_mode_matches_pytree():
    """The packed-u16 upload path (one H2D object, ~1.5 mm quantization)
    must track the pytree path within quantization-level differences."""
    cfg = small_cfg()
    scans, gts = make_run(n_frames=10)
    _, tr_py = drive(RealtimePipeline, cfg, scans, poll_every=4)
    _, tr_pk = drive(RealtimePipeline, cfg, scans, poll_every=4, h2d_mode="packed")
    d = np.linalg.norm(tr_py[:, :3, 3] - tr_pk[:, :3, 3], axis=-1)
    # The ~1.5 mm quantization perturbs voxel assignments, so the sparse
    # 1024-pt chains diverge at their own sensitivity level (same class as
    # the realtime-vs-offline delta) — the accuracy-class check below is
    # the meaningful one.
    assert np.max(d) < 0.2, d
    a_pk = ate(tr_pk, gts)
    a_py = ate(tr_py, gts)
    assert np.median(a_pk) < max(1.5 * np.median(a_py), 0.05)


def test_pack_scan_u16_roundtrip():
    from open3d_slam_jax.slam.realtime import (
        _unpack_scan_u16, pack_scan_u16)

    rng = np.random.default_rng(3)
    xyz = rng.uniform(-50, 50, (256, 3)).astype(np.float32)
    mask = rng.uniform(size=256) > 0.1
    times = rng.uniform(size=256).astype(np.float32)
    packed, header = pack_scan_u16(xyz, mask, times)
    b = _unpack_scan_u16(jnp.asarray(packed), jnp.asarray(header), True)
    got_mask = np.asarray(b.mask)
    np.testing.assert_array_equal(got_mask, mask)
    err = np.abs(np.asarray(b.xyz)[mask] - xyz[mask])
    assert err.max() < 100.0 / 65535.0 * 1.01  # span/65535 quantization
    terr = np.abs(np.asarray(b.extras["times"])[mask, 0] - times[mask])
    assert terr.max() < 1.5 / 65534.0
    # no-times variant
    p2, h2 = pack_scan_u16(xyz, mask, None)
    b2 = _unpack_scan_u16(jnp.asarray(p2), jnp.asarray(h2), False)
    assert "times" not in b2.extras
    np.testing.assert_array_equal(np.asarray(b2.mask), mask)


def test_chunked_mode_matches_single_step():
    """chunk_size=4 (one scanned device program per 4 frames) must produce
    the same trajectory as single-step dispatch, including a padded final
    partial chunk."""
    cfg = small_cfg()
    scans, gts = make_run(n_frames=10)  # 10 = 2 full chunks + partial of 2
    _, tr_one = drive(RealtimePipeline, cfg, scans, poll_every=4)
    _, tr_chunk = drive(RealtimePipeline, cfg, scans, poll_every=4, chunk_size=4)
    assert tr_chunk.shape == tr_one.shape
    d = np.linalg.norm(tr_one[:, :3, 3] - tr_chunk[:, :3, 3], axis=-1)
    # Same arithmetic; differences only from lifecycle-poll timing (chunk
    # polls every 4 frames vs mixed cadence).
    assert np.max(d) < 0.05, d
    a = ate(tr_chunk, gts)
    assert np.median(a) < max(1.5 * np.median(ate(tr_one, gts)), 0.05)


def test_pose_graph_solve_applies_nonzero_increment():
    """Regression for the round-4 null result (EVAL_r04 protocol 4: 13
    solves, every increment under the 1e-6 identity gate): a loop
    constraint that contradicts the anchor chain MUST move the graph, be
    recorded in solve_log, transform the stored banks/anchors, and
    retroactively correct the recorded trajectory."""
    from open3d_slam_jax.slam import place_recognition as pr_mod
    from open3d_slam_jax.slam import submap as submap_mod
    from open3d_slam_jax.slam.realtime import FrameRecord
    from open3d_slam_jax.slam.submap_collection import SubmapEntry

    cfg = small_cfg(loop_closure=True)
    rt = RealtimePipeline(cfg, loop_closure_async=False)
    # Four submaps along +x; the chain drifted +0.8 m in x by submap 3.
    drift = np.eye(4)
    drift[0, 3] = 0.8
    anchors = []
    for i in range(4):
        T = np.eye(4)
        T[0, 3] = 4.0 * i
        if i == 3:
            T = drift @ T
        anchors.append(T)
        rt.submaps.submaps.append(SubmapEntry(
            state=submap_mod.create(64), anchor=T.copy(),
            parent=None if i == 0 else i - 1,
        ))
        if i > 0:
            rt.submaps.adjacency.add_edge(i - 1, i)
    rt.submaps.active_idx = 3
    # Recorded frames, one per submap, at the (drifted) anchors.
    for i, T in enumerate(anchors):
        rt.frames.append(FrameRecord(time=0.1 * i, pose=T.copy(), submap_idx=i))
    rt._last_polled_fidx = 3
    rt._last_polled_pose = anchors[3].copy()
    # Loop constraint: submap 3 truly sits at x=12 relative to submap 0.
    T_true_rel = np.eye(4)
    T_true_rel[0, 3] = 12.0
    rt._loop_constraints.append(pr_mod.LoopClosureConstraint(
        source_idx=3, target_idx=0, T_target_source=T_true_rel,
        overlap=0.9, residual=0.02, information=np.eye(6) * 50.0,
    ))
    rt._optimize_pose_graph()

    assert rt.pose_graph_solves == 1
    log = rt.solve_log[-1]
    assert log["max_inc_norm"] > 0.05, log  # the r4 failure: all < 1e-6
    assert log["moved_submaps"] >= 1, log
    assert log["chi2_post"] < log["chi2_pre"], log
    # Anchors moved toward consistency: submap 3 pulled back toward x=12.
    a3 = rt.submaps.submaps[3].anchor
    assert abs(a3[0, 3] - 12.0) < abs(12.8 - 12.0), a3
    # Retroactive trajectory correction applied to the recorded frame.
    f3 = rt.frames[3].pose
    assert abs(f3[0, 3] - 12.0) < 0.75, f3
    # The active-submap increment is queued for the dispatch boundary.
    with rt._inc_lock:
        assert rt._pending_increment is not None
