"""SLAM orchestration — the ``SlamWrapper`` analogue.

The reference (``SlamWrapper.cpp``) runs 4-7 worker threads over bounded
queues (odometry, mapping, loop closure, dense map, publishing). This
design keeps that *pipeline* shape but the heavy stages are single jitted
device calls, so the host side stays simple:

- **online mode**: ``add_range_scan``/``add_odometry_pose`` enqueue;
  ``spin_once``/worker threads drain queues through odometry -> mapper ->
  (periodic) loop closure -> pose graph;
- **offline deterministic replay** (≙ the rosbag single-stepping harness,
  ``SlamWrapper.cpp:465-552`` + ``RosbagRangeDataProcessorRos``): the driver
  calls :meth:`process_scan` once per (scan, time) pair — bitwise
  reproducible, the primary correctness harness;
- loop-closure application: optimized submap increments are applied to
  submap banks and the current pose re-anchored
  (≙ ``updateSubmapsAndTrajectory``, ``SlamWrapper.cpp:1055-1090``).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, List, Optional

import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import dense_map as dense_map_mod
from open3d_slam_jax.slam import motion_compensation as mc_mod
from open3d_slam_jax.slam import place_recognition as pr
from open3d_slam_jax.slam.imu import ImuBuffer
from open3d_slam_jax.slam import pose_graph as pg
from open3d_slam_jax.slam import submap as submap_mod
from open3d_slam_jax.slam.mapper import MapperConfig, build_map_reference, process_scan_for_matching, scan_to_map_step
from open3d_slam_jax.slam.odometry import LidarOdometry, OdometryConfig
from open3d_slam_jax.slam.submap_collection import (
    SubmapCollection,
    SubmapCollectionConfig,
)
from open3d_slam_jax.slam.transform_buffer import TransformInterpolationBuffer


@dataclasses.dataclass(frozen=True)
class MotionCompensationConfig:
    """≙ ``ConstantVelocityMotionCompensationParameters``: undistort every
    scan with the body velocity estimated from the pose buffer
    (``MotionCompensation.cpp:32-57``)."""

    enabled: bool = False
    scan_duration: float = 0.1  # s, one sweep (≙ scanDuration_)
    clockwise: bool = True  # spin direction (≙ isSpinningClockwise_)
    # Use the per-point ``times`` channel when the scan carries one;
    # azimuth-phase model otherwise (MotionCompensation.cpp:120-139).
    use_times_channel: bool = True


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    odometry: OdometryConfig = dataclasses.field(default_factory=OdometryConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    submaps: SubmapCollectionConfig = dataclasses.field(
        default_factory=SubmapCollectionConfig
    )
    place_recognition: pr.PlaceRecognitionConfig = dataclasses.field(
        default_factory=pr.PlaceRecognitionConfig
    )
    pose_graph: pg.PoseGraphConfig = dataclasses.field(default_factory=pg.PoseGraphConfig)
    use_external_odometry: bool = False  # ≙ useOdometryTopic
    loop_closure_enabled: bool = True
    motion_compensation: MotionCompensationConfig = dataclasses.field(
        default_factory=MotionCompensationConfig
    )
    # Boot the initial attitude (roll/pitch) from buffered IMU samples when
    # available (≙ ImuBuffer::estimateAttitudeFromImu, ImuBuffer.cpp:102).
    # Only applies while uninitialized and with an identity rotation (an
    # explicit set_initial_transform wins).
    use_imu_attitude_init: bool = True
    # ≙ is_build_dense_map: maintain the high-resolution aggregate map
    # alongside the sparse matching submaps (dense_map worker analogue).
    build_dense_map: bool = False
    dense_map_voxel: float = 0.05
    dense_map_capacity: int = 1 << 20
    node_capacity: int = 128
    edge_capacity: int = 512


class SlamPipeline:
    """Single-owner SLAM state machine; deterministic when stepped serially."""

    def __init__(self, cfg: Optional[SlamConfig] = None):
        self.cfg = cfg or SlamConfig()
        self.odometry = LidarOdometry(self.cfg.odometry)
        self.submaps = SubmapCollection(self.cfg.submaps)
        self.odom_buffer = TransformInterpolationBuffer()
        self.map_pose_buffer = TransformInterpolationBuffer()

        self._map_pose = np.eye(4)
        self._prev_odom_pose: Optional[np.ndarray] = None
        self._ref = None
        self._ref_submap_idx = -1
        self._ref_center = None
        self._scans_since_reinit = 0
        self._last_insert_pose: Optional[np.ndarray] = None
        self._initialized = False
        self.dense_map = (
            dense_map_mod.create(self.cfg.dense_map_capacity, self.cfg.dense_map_voxel)
            if self.cfg.build_dense_map
            else None
        )
        # Pose-graph bookkeeping: one node per submap (anchor poses).
        self._loop_constraints: List[pr.LoopClosureConstraint] = []
        self._scan_count = 0
        self.stats: List[dict] = []
        # IMU + motion state (attitude init, undistortion, out-of-order).
        self.imu_buffer = ImuBuffer()
        self._attitude_initialized = False
        self._last_scan_time: Optional[float] = None
        self._last_motion_twist = np.zeros(6)  # log of last odometry motion

    def add_imu(self, time: float, acc, gyro) -> None:
        """Buffer one IMU sample (≙ the imu callback -> ImuBuffer path)."""
        self.imu_buffer.push(time, acc, gyro)

    # ------------------------------------------------------------------
    # Offline deterministic stepping (the primary harness).
    # ------------------------------------------------------------------

    @property
    def pose(self) -> np.ndarray:
        return self._map_pose.copy()

    def process_scan(
        self,
        scan: pc.PointBatch,
        time: float,
        external_odom_pose: Optional[np.ndarray] = None,
    ) -> dict:
        """One full deterministic step: odometry -> mapper -> submaps ->
        (on submap finish) loop closure + pose graph."""
        cfg = self.cfg

        # --- IMU attitude boot (≙ estimateAttitudeFromImu at startup) ---
        if (
            cfg.use_imu_attitude_init
            and not self._initialized
            and not self._attitude_initialized
            and len(self.imu_buffer) >= 2
            and np.allclose(self._map_pose[:3, :3], np.eye(3))
        ):
            try:
                R_wb, _g = self.imu_buffer.estimate_attitude(t_end=time)
                self._map_pose = self._map_pose.copy()
                self._map_pose[:3, :3] = R_wb
                self._attitude_initialized = True
            except ValueError:
                pass

        # --- out-of-order measurement (≙ Mapper.cpp:196-235): propagate by
        # the odometry motion instead of registering. ---
        if self._last_scan_time is not None and time <= self._last_scan_time:
            motion = self._out_of_order_motion(external_odom_pose)
            self._map_pose = self._map_pose @ motion
            # Do NOT overwrite the registered pose at _last_scan_time: the
            # propagated pose reflects the newest odometry knowledge, not a
            # registration at that stamp. The buffer keeps registration
            # results only (≙ the reference's backup-transform path, which
            # publishes but does not insert).
            stats = dict(
                converged=False, inserted=False, degenerate=False,
                overlap=0.0, out_of_order=True,
            )
            self.stats.append(stats)
            return stats

        # --- constant-velocity undistortion (≙ MotionCompensation.cpp) ---
        mc = cfg.motion_compensation
        if mc.enabled and self._last_scan_time is not None:
            dt = max(time - self._last_scan_time, 1e-6)
            # With external odometry the sweep motion is known *before*
            # registration — use it directly; otherwise assume constant
            # velocity and reuse the previous frame's motion (the
            # reference's ConstantVelocity model).
            if (
                cfg.use_external_odometry
                and external_odom_pose is not None
                and self._prev_odom_pose is not None
            ):
                motion_now = np.linalg.inv(self._prev_odom_pose) @ np.asarray(
                    external_odom_pose, np.float64
                )
                base_twist = np.asarray(
                    se3.log_se3(jnp.asarray(motion_now, jnp.float32)), np.float64
                )
            else:
                base_twist = self._last_motion_twist
            twist = jnp.asarray(base_twist * (mc.scan_duration / dt), jnp.float32)
            if mc.use_times_channel and "times" in scan.extras:
                t_pts = np.asarray(scan.extras["times"][..., 0])
                m = np.asarray(scan.mask)
                if m.any():
                    scan = mc_mod.undistort_with_times(
                        scan, twist, float(t_pts[m].min()), float(t_pts[m].max())
                    )
            else:
                scan = mc_mod.undistort_with_azimuth(scan, twist, mc.clockwise)

        # --- odometry stage (≙ unifiedWorkerOdom) ---
        if cfg.use_external_odometry and external_odom_pose is not None:
            odom_pose = np.asarray(external_odom_pose, np.float64)
        else:
            odom_pose = self.odometry.add_scan(scan)
        self.odom_buffer.push(time, odom_pose)
        if self._prev_odom_pose is None:
            odom_motion = np.eye(4)
        else:
            odom_motion = np.linalg.inv(self._prev_odom_pose) @ odom_pose
        self._prev_odom_pose = odom_pose
        self._last_motion_twist = np.asarray(
            se3.log_se3(jnp.asarray(odom_motion, jnp.float32)), np.float64
        )
        self._last_scan_time = time

        # --- mapping stage (≙ unifiedWorkerMap / Mapper) ---
        stats = self._mapping_step(scan, odom_motion)
        self.map_pose_buffer.push(time, self._map_pose)

        # --- loop closure on freshly finished submaps ---
        if cfg.loop_closure_enabled:
            finished = self.submaps.pop_finished()
            if finished is not None:
                stats["loop_closures"] = self._attempt_loop_closures(finished)

        self._scan_count += 1
        self.stats.append(stats)
        return stats

    # ------------------------------------------------------------------

    def _out_of_order_motion(self, external_odom_pose) -> np.ndarray:
        """Odometry motion between the last mapped time and the newest
        odometry knowledge (≙ the backup-transform path, Mapper.cpp:219-227);
        falls back to the last computed motion when the buffer can't help."""
        latest = self.odom_buffer.latest_time
        if (
            latest is not None
            and self._last_scan_time is not None
            and self.odom_buffer.has(self._last_scan_time)
            and latest > self._last_scan_time
        ):
            T_prev = self.odom_buffer.lookup(self._last_scan_time)
            T_latest = self.odom_buffer.lookup(latest)
            return np.linalg.inv(T_prev) @ T_latest
        return np.asarray(
            se3.exp_se3(jnp.asarray(self._last_motion_twist, jnp.float32)),
            np.float64,
        )

    def _mapping_step(self, scan: pc.PointBatch, odom_motion: np.ndarray) -> dict:
        mcfg = self.cfg.mapper
        processed = process_scan_for_matching(scan, mcfg)

        if not self._initialized:
            self.submaps.insert_scan(
                processed, self._map_pose, self._map_pose, raw_scan=scan
            )
            self._rebuild_reference()
            self._last_insert_pose = self._map_pose.copy()
            self._initialized = True
            return dict(converged=True, inserted=True, degenerate=False, overlap=1.0)

        guess = self._map_pose @ odom_motion
        active_idx = self.submaps.active_idx
        if (
            self._scans_since_reinit >= mcfg.reference_reinit_every
            or active_idx != self._ref_submap_idx
        ):
            self._rebuild_reference(center=guess[:3, 3])

        res = scan_to_map_step(processed, self._ref, jnp.asarray(guess, jnp.float32), mcfg)
        finite = bool(jnp.all(jnp.isfinite(res.transform)))
        use_prior = (not finite) or (
            bool(res.degenerate) and float(res.overlap_ratio) < 0.05
        )
        new_pose = guess if use_prior else np.asarray(res.transform, np.float64)
        self._map_pose = new_pose
        self._scans_since_reinit += 1

        inserted = False
        moved = (
            self._last_insert_pose is None
            or np.linalg.norm(new_pose[:3, 3] - self._last_insert_pose[:3, 3])
            >= mcfg.min_movement_for_insertion
        )
        if moved and not use_prior:
            self.submaps.insert_scan(processed, new_pose, new_pose, raw_scan=scan)
            if self.dense_map is not None:
                self.dense_map = dense_map_mod.insert(
                    self.dense_map, scan, jnp.asarray(new_pose, jnp.float32)
                )
            self._last_insert_pose = new_pose.copy()
            inserted = True

        return dict(
            converged=bool(res.converged),
            inserted=inserted,
            degenerate=bool(res.degenerate),
            overlap=float(res.overlap_ratio),
            iterations=int(res.iterations),
        )

    def _rebuild_reference(self, center=None) -> None:
        if center is None:
            center = self._map_pose[:3, 3]
        active = self.submaps.active
        self._ref = build_map_reference(
            active.state.cloud, jnp.asarray(center, jnp.float32), self.cfg.mapper
        )
        self._ref_submap_idx = self.submaps.active_idx
        self._ref_center = np.asarray(center, np.float64).copy()
        self._scans_since_reinit = 0

    # ------------------------------------------------------------------
    # Loop closure + pose graph (≙ loopClosureWorker + OptimizationProblem).
    # ------------------------------------------------------------------

    def _attempt_loop_closures(self, finished_idx: int) -> int:
        constraints = pr.build_loop_closure_constraints(
            self.submaps, finished_idx, cfg=self.cfg.place_recognition
        )
        if not constraints:
            return 0
        self._loop_constraints.extend(constraints)
        self._optimize_pose_graph()
        return len(constraints)

    def _optimize_pose_graph(self) -> None:
        """Build nodes from submap anchors, odometry edges from consecutive
        anchors, loop edges from accepted constraints; solve; apply."""
        builder = pg.PoseGraphBuilder(self.cfg.node_capacity, self.cfg.edge_capacity)
        for e in self.submaps.submaps:
            builder.add_node(e.anchor)
        for i, e in enumerate(self.submaps.submaps):
            if e.parent is not None:
                T_rel = np.linalg.inv(self.submaps.submaps[e.parent].anchor) @ e.anchor
                builder.add_edge(e.parent, i, T_rel)
        for c in self._loop_constraints:
            builder.add_edge(
                c.target_idx,
                c.source_idx,
                c.T_target_source,
                info=c.information,
                is_loop=True,
            )
        graph = builder.build()
        out = pg.optimize(graph, self.cfg.pose_graph)
        new_poses = np.asarray(out.poses, np.float64)

        increments: Dict[int, np.ndarray] = {}
        for i, e in enumerate(self.submaps.submaps):
            inc = new_poses[i] @ np.linalg.inv(e.anchor)
            if not np.allclose(inc, np.eye(4), atol=1e-6):
                increments[i] = inc
        if increments:
            # Re-anchor the live pose with the active submap's increment
            # (≙ Mapper::loopClosureUpdate).
            active_inc = increments.get(self.submaps.active_idx, np.eye(4))
            self.submaps.apply_pose_updates(increments)
            self._map_pose = active_inc @ self._map_pose
            self._ref_submap_idx = -1  # force reference rebuild

    # ------------------------------------------------------------------
    # Map export / localization mode.
    # ------------------------------------------------------------------

    def assembled_map(self) -> np.ndarray:
        return self.submaps.map_points()

    def dense_map_points(self) -> np.ndarray:
        """High-resolution aggregate map (requires build_dense_map)."""
        if self.dense_map is None:
            return np.zeros((0, 3), np.float32)
        out = dense_map_mod.export(self.dense_map)
        return np.asarray(out.xyz)[np.asarray(out.mask)]

    def save_map(self, path: str) -> None:
        from open3d_slam_jax.io import save_ply

        save_ply(path, self.assembled_map())

    def set_initial_map(self, points: np.ndarray, capacity: Optional[int] = None) -> None:
        """Localization-on-prior-map mode (≙ ``SlamWrapper::setInitialMap``):
        seed the collection with one big frozen submap."""
        capacity = capacity or self.cfg.submaps.submap_capacity
        batch = pc.from_points(points, capacity=capacity)
        self.submaps.insert_scan(batch, np.eye(4), np.eye(4))
        self._rebuild_reference(center=np.zeros(3))
        self._initialized = True
        self._last_insert_pose = self._map_pose.copy()

    def set_initial_transform(self, T: np.ndarray) -> None:
        """≙ ``SlamWrapper::setInitialTransform`` (map initializer output)."""
        self._map_pose = np.asarray(T, np.float64).copy()

    def relocalize(
        self,
        scan: pc.PointBatch,
        hint_pose: Optional[np.ndarray] = None,
        search_radius: float = 10.0,
    ) -> Optional[np.ndarray]:
        """Global (re)localization of a scan against the current map —
        the programmatic ``SlamMapInitializer``: FPFH-RANSAC coarse
        alignment when features carry, otherwise a batched yaw/translation
        hypothesis sweep around ``hint_pose`` (identity if None), refined
        and gated like a loop closure. Sets the live pose on success."""
        mcfg = self.cfg.mapper
        prcfg = self.cfg.place_recognition
        processed = process_scan_for_matching(scan, mcfg)
        map_pts = self.assembled_map()
        if len(map_pts) == 0:
            return None
        target = pc.from_points(
            map_pts, capacity=max(1 << int(np.ceil(np.log2(max(len(map_pts), 2)))), 1024)
        )
        hint = np.eye(4) if hint_pose is None else np.asarray(hint_pose, np.float64)
        # Stricter gates than loop closure: a wrong global pose is much more
        # damaging than a skipped relocalization attempt.
        prcfg = dataclasses.replace(
            prcfg,
            num_xy_offsets=5,
            xy_offset=search_radius / 2.0,
            min_overlap=max(prcfg.min_overlap, 0.45),
            max_residual=min(prcfg.max_residual, 0.2),
        )
        got = pr.verify_candidate(processed, target, hint, prcfg)
        if got is None:
            return None
        T, overlap, residual = got
        # Final polish at the mapper's tight matching radius. Verify BEFORE
        # committing any state: a failed polish must leave the pipeline
        # exactly as it was (the coarse hypothesis is not trusted on its own).
        active = self.submaps.active
        polish_ref = build_map_reference(
            active.state.cloud, jnp.asarray(T[:3, 3], jnp.float32), mcfg
        )
        res = scan_to_map_step(processed, polish_ref, jnp.asarray(T, jnp.float32), mcfg)
        if not (
            bool(jnp.all(jnp.isfinite(res.transform)))
            and float(res.overlap_ratio) > 0.2
        ):
            return None
        self._map_pose = np.asarray(res.transform, np.float64)
        self._ref = polish_ref
        self._ref_submap_idx = self.submaps.active_idx
        self._ref_center = np.asarray(T[:3, 3], np.float64).copy()
        self._scans_since_reinit = 0
        self._initialized = True
        return self._map_pose.copy()


class OnlineSlamRunner:
    """Threaded online front-end over SlamPipeline (≙ the worker threads +
    CircularBuffers). One worker drains the scan queue; callers never block.
    The pipeline itself stays single-owner — only the worker touches it."""

    def __init__(self, pipeline: SlamPipeline, queue_size: int = 20,
                 viz_server=None, viz_every: int = 5):
        import collections

        self.pipeline = pipeline
        self._q: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._imu_q: "collections.deque" = collections.deque(maxlen=4096)
        self._stop = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self.dropped = 0
        # Optional live publisher (viz_server.VizServer): the worker pushes
        # a throttled snapshot after every ``viz_every``-th scan, the
        # analogue of the reference's visualization worker threads.
        self._viz = viz_server
        self._viz_every = max(1, int(viz_every))
        self._scan_count = 0
        self._traj: list = []

    def start(self) -> None:
        self._worker.start()

    def add_range_scan(
        self,
        scan: pc.PointBatch,
        time: float,
        odom_pose: "Optional[np.ndarray]" = None,
    ) -> None:
        """Non-blocking enqueue; drops oldest under backpressure
        (≙ CircularBuffer semantics). ``odom_pose``: the external odometry
        pose to pair with this scan (≙ the odometry-topic path)."""
        try:
            self._q.put_nowait((scan, time, odom_pose))
        except queue.Full:
            try:
                self._q.get_nowait()
                self.dropped += 1
            except queue.Empty:
                pass
            self._q.put_nowait((scan, time, odom_pose))

    def add_imu(self, time: float, acc, gyro) -> None:
        """Enqueue one IMU sample (≙ the imu callback); drained by the
        worker before each scan so the pipeline stays single-owner."""
        self._imu_q.append((time, acc, gyro))

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                scan, t, odom = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            # Drain buffered IMU samples first (attitude boot needs them
            # before the first scan registers).
            while self._imu_q:
                it, acc, gyro = self._imu_q.popleft()
                self.pipeline.add_imu(it, acc, gyro)
            stats = self.pipeline.process_scan(scan, t, external_odom_pose=odom)
            self._scan_count += 1
            if self._viz is not None:
                self._traj.append(np.asarray(self.pipeline.pose[:3, 3]))
                if self._scan_count % self._viz_every == 1 or self._viz_every == 1:
                    self._viz.publish(
                        map_points=self.pipeline.assembled_map(),
                        trajectory=np.asarray(self._traj),
                        stats=stats,
                    )

    def stop(self) -> None:
        self._stop.set()
        self._worker.join(timeout=5.0)
