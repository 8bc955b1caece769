"""Real-time SLAM orchestration — the concurrent ``SlamWrapper`` analogue.

The offline :class:`~open3d_slam_jax.slam.pipeline.SlamPipeline` is
the deterministic correctness harness (≙ the reference's single-stepped
rosbag replay). THIS module is the analogue of the reference's *online*
mode — the 4-7 worker threads over bounded queues that sustain sensor rate
(``SlamWrapper.cpp:554-1053``) — re-designed so that the host never waits
on the device on the mapping critical path:

- **One fused jitted step per scan** (:func:`rt_step`): motion compensation,
  odometry registration, scan-to-map X-ICP, the conditional reference
  rebuild, and the gated submap insert (+ optional carving and dense-map
  aggregation) all execute in a single device program over device-resident
  state. Every per-scan decision the offline pipeline makes on host
  (fitness gate, return-prior, min-movement insertion gating,
  reinit cadence) runs on device via ``where``/``lax.cond``.
- **Zero blocking readbacks on the mapping critical path**: dispatch is
  asynchronous; each step returns a packed per-frame stats vector whose
  device handle is queued and fetched in batches every ``poll_every``
  frames (one round-trip amortized over N scans). The offline pipeline's
  ~16 blocking round-trips per scan become ~1/poll_every.
- **Loop closure off the critical path** (≙ ``loopClosureWorker``,
  ``SlamWrapper.cpp:1011-1053``): finished submaps are queued to a worker
  thread that runs place recognition + pose-graph optimization; the
  resulting pose increment is applied to the live device state at the next
  dispatch boundary (≙ ``updateSubmapsAndTrajectory`` consuming
  ``isOptimizedGraphAvailable_`` on the mapping thread,
  ``SlamWrapper.cpp:949-961``).

Submap lifecycle decisions (creation / activation / force-new) are host
logic evaluated at poll boundaries from the polled stats — they take effect
up to ``poll_every`` frames after their trigger condition, the bounded
staleness this design trades for sensor-rate throughput (the reference's
worker queues introduce the same kind of latency between the mapping and
loop-closure views of the collection).
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import dense_map as dense_map_mod
from open3d_slam_jax.slam import motion_compensation as mc_mod
from open3d_slam_jax.slam import place_recognition as pr
from open3d_slam_jax.slam import pose_graph as pg
from open3d_slam_jax.slam import submap as submap_mod
from open3d_slam_jax.slam.imu import ImuBuffer
from open3d_slam_jax.slam.mapper import (
    build_map_reference,
    process_scan_for_matching,
)
from open3d_slam_jax.slam import odometry as odo_mod
from open3d_slam_jax.slam.pipeline import SlamConfig
from open3d_slam_jax.slam.submap_collection import (
    SubmapCollection,
    SubmapEntry,
)

# Packed per-frame stats vector layout (float32). One vector per rt_step;
# the host fetches them in stacked batches — the deferred-readback channel.
IDX_POSE = slice(0, 16)  # row-major 4x4 map->sensor pose
IDX_CONVERGED = 16
IDX_INSERTED = 17
IDX_DEGENERATE = 18
IDX_OVERLAP = 19
IDX_ITERATIONS = 20
IDX_OCCUPANCY = 21  # valid points in the active bank AFTER this step
IDX_ODOM_OK = 22  # odometry fitness gate passed
IDX_USE_PRIOR = 23  # registration rejected -> odometry prior kept
IDX_RESIDUAL = 24
IDX_ROW_SAT = 25  # matcher candidate-row saturation (recall monitor)
IDX_REBUILT = 26  # reference rebuild ran this step
IDX_CARVED = 27
STATS_LEN = 28


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RtState:
    """Device-resident per-scan SLAM state (one pytree, fixed shapes)."""

    odom_prev: pc.PointBatch  # previous preprocessed scan (odometry ref)
    last_motion: jax.Array  # [4,4] last scan-to-scan odometry motion
    map_pose: jax.Array  # [4,4] map -> range sensor (latest registered)
    ref: icp_mod.ICPReference  # active scan-to-map registration reference
    scans_since_reinit: jax.Array  # int32
    last_insert_pos: jax.Array  # [3]
    bank: submap_mod.SubmapState  # ACTIVE submap bank
    scans_in_active: jax.Array  # int32 (carve cadence counter)
    dense: Optional[dense_map_mod.DenseMapState]  # None when disabled


def _empty_odom_prev(cfg: SlamConfig) -> pc.PointBatch:
    cap = cfg.odometry.max_points if not cfg.use_external_odometry else 8
    b = pc.from_points(np.zeros((0, 3), np.float32), capacity=cap)
    # Odometry preprocess adds normals; keep the pytree structure identical.
    return b.with_extras(normals=jnp.zeros((cap, 3), jnp.float32))


@functools.partial(jax.jit, static_argnames=("cfg",))
def rt_init(scan: pc.PointBatch, map_pose: jax.Array, cfg: SlamConfig):
    """First-scan initialization: insert into a fresh bank, build the
    registration reference, seed the odometry state. Returns RtState."""
    mcfg = cfg.mapper
    proc = process_scan_for_matching(scan, mcfg)
    bank = submap_mod.create(cfg.submaps.submap_capacity)
    bank = submap_mod.insert_scan(
        bank, proc, map_pose,
        cfg.submaps.submap_voxel_size, cfg.submaps.submap_crop_radius,
    )
    ref = build_map_reference(bank.cloud, map_pose[:3, 3], mcfg)
    if cfg.use_external_odometry:
        odom_prev = _empty_odom_prev(cfg)
    else:
        odom_prev = odo_mod.preprocess(scan, jax.random.key(0), cfg.odometry)
    dense = None
    if cfg.build_dense_map:
        dense = dense_map_mod.create(cfg.dense_map_capacity, cfg.dense_map_voxel)
        dense = dense_map_mod.insert(dense, scan, map_pose)
    return RtState(
        odom_prev=odom_prev,
        last_motion=jnp.eye(4, dtype=jnp.float32),
        map_pose=jnp.asarray(map_pose, jnp.float32),
        ref=ref,
        scans_since_reinit=jnp.asarray(0, jnp.int32),
        last_insert_pos=jnp.asarray(map_pose, jnp.float32)[:3, 3],
        bank=bank,
        scans_in_active=jnp.asarray(1, jnp.int32),
        dense=dense,
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def rt_step(
    state: RtState,
    scan: pc.PointBatch,
    dt: jax.Array,
    ext_motion: jax.Array,
    cfg: SlamConfig,
):
    """One fully-fused SLAM step. Returns ``(new_state, stats[STATS_LEN])``.

    Device-side control flow replaces the host decisions of
    ``SlamPipeline.process_scan`` one-for-one:

    - odometry fitness gate (≙ ``Odometry.cpp:56-71``) — ``where``;
    - reference re-init cadence (≙ ``Mapper.cpp:329-347``) — ``lax.cond``
      so the expensive rebuild executes only when due;
    - return-prior on degenerate/non-finite registration
      (≙ ``ICP.cpp:1334-1341`` + ``Mapper.cpp:400-402``) — ``where``;
    - min-movement insertion gate (≙ ``Mapper.cpp:463-469``) and the
      carve cadence (≙ ``Submap.cpp:56-86``) — ``lax.cond``.
    """
    ocfg, mcfg, mc = cfg.odometry, cfg.mapper, cfg.motion_compensation

    # --- constant-velocity undistortion (≙ MotionCompensation.cpp) ---
    if mc.enabled:
        twist = se3.log_se3(state.last_motion) * (
            mc.scan_duration / jnp.maximum(dt, 1e-6)
        )
        if mc.use_times_channel and "times" in scan.extras:
            t = scan.extras["times"][..., 0]
            t_min = jnp.min(jnp.where(scan.mask, t, jnp.inf))
            t_max = jnp.max(jnp.where(scan.mask, t, -jnp.inf))
            scan = mc_mod.undistort_with_times(scan, twist, t_min, t_max)
        else:
            scan = mc_mod.undistort_with_azimuth(scan, twist, mc.clockwise)

    # --- odometry stage (≙ unifiedWorkerOdom) ---
    if cfg.use_external_odometry:
        motion = ext_motion
        odom_prev = state.odom_prev
        odom_ok = jnp.asarray(True)
    else:
        odom_proc = odo_mod.preprocess(scan, jax.random.key(0), ocfg)
        odo_res = icp_mod.register_pair(
            odom_proc, state.odom_prev, state.last_motion, ocfg.icp
        )
        odom_ok = (odo_res.overlap_ratio >= ocfg.min_fitness) & jnp.all(
            jnp.isfinite(odo_res.transform)
        )
        motion = jnp.where(odom_ok, odo_res.transform, state.last_motion)
        odom_prev = odom_proc

    # --- mapping stage (≙ unifiedWorkerMap / Mapper) ---
    proc = process_scan_for_matching(scan, mcfg)
    guess = state.map_pose @ motion
    rebuild = state.scans_since_reinit >= mcfg.reference_reinit_every
    ref = lax.cond(
        rebuild,
        lambda: build_map_reference(state.bank.cloud, guess[:3, 3], mcfg),
        lambda: state.ref,
    )
    scans_since_reinit = jnp.where(rebuild, 1, state.scans_since_reinit + 1)

    res = icp_mod.icp_single(proc, ref, guess, mcfg.icp)
    finite = jnp.all(jnp.isfinite(res.transform))
    use_prior = (~finite) | (res.degenerate & (res.overlap_ratio < 0.05))
    new_pose = jnp.where(use_prior, guess, res.transform)

    # --- insertion gating + carve + insert (≙ SubmapCollection::insertScan) ---
    moved = (
        jnp.linalg.norm(new_pose[:3, 3] - state.last_insert_pos)
        >= mcfg.min_movement_for_insertion
    )
    insert = moved & ~use_prior
    bank = state.bank
    carved = jnp.asarray(False)
    if cfg.submaps.carve_every_n > 0:
        n = cfg.submaps.carve_every_n
        carved = (
            insert
            & (state.scans_in_active > 0)
            & (state.scans_in_active % n == 0)
        )
        bank = lax.cond(
            carved,
            lambda b: submap_mod.carve(
                b, scan, new_pose,
                angle_tol=cfg.submaps.carve_angle_tol,
                range_margin=cfg.submaps.carve_range_margin,
            ),
            lambda b: b,
            bank,
        )
    bank = lax.cond(
        insert,
        lambda b: submap_mod.insert_scan(
            b, proc, new_pose,
            cfg.submaps.submap_voxel_size, cfg.submaps.submap_crop_radius,
        ),
        lambda b: b,
        bank,
    )
    dense = state.dense
    if cfg.build_dense_map:
        dense = lax.cond(
            insert,
            lambda d: dense_map_mod.insert(d, scan, new_pose),
            lambda d: d,
            dense,
        )
    last_insert_pos = jnp.where(insert, new_pose[:3, 3], state.last_insert_pos)
    scans_in_active = state.scans_in_active + insert.astype(jnp.int32)
    occupancy = jnp.sum(bank.cloud.mask).astype(jnp.float32)

    stats = jnp.concatenate([
        new_pose.reshape(-1),
        jnp.stack([
            res.converged.astype(jnp.float32),
            insert.astype(jnp.float32),
            res.degenerate.astype(jnp.float32),
            res.overlap_ratio.astype(jnp.float32),
            res.iterations.astype(jnp.float32),
            occupancy,
            odom_ok.astype(jnp.float32),
            use_prior.astype(jnp.float32),
            res.residual.astype(jnp.float32),
            res.match_row_saturation.astype(jnp.float32),
            rebuild.astype(jnp.float32),
            carved.astype(jnp.float32),
        ]),
    ])
    new_state = RtState(
        odom_prev=odom_prev,
        last_motion=motion,
        map_pose=new_pose,
        ref=ref,
        scans_since_reinit=scans_since_reinit,
        last_insert_pos=last_insert_pos,
        bank=bank,
        scans_in_active=scans_in_active,
        dense=dense,
    )
    return new_state, stats


@functools.partial(jax.jit, static_argnames=("cfg",))
def rt_step_chunk(
    state: RtState,
    scans: pc.PointBatch,  # stacked [K, N, ...]
    dts: jax.Array,  # [K]
    ext_motions: jax.Array,  # [K, 4, 4]
    cfg: SlamConfig,
):
    """K sequential :func:`rt_step`\\ s in ONE device program (lax.scan).

    Each dispatch returns the step's output state (the ~36 MB RtState,
    dominated by the cell-list table); scanning K frames per dispatch
    returns it once per chunk, so any per-dispatch cost amortizes /K
    (built for a host with a high per-dispatch cost; unmeasured on a local
    GPU, ROADMAP design 5) while the per-frame stats come back
    as a single [K, STATS_LEN] buffer (also replacing the K-handle stack
    at poll time). Latency trade: the pose lags up to K frames — the
    throughput mode of the online pipeline (≙ deep worker queues in the
    reference); paced mode keeps K=1.
    """

    def body(st, inp):
        scan, dt, ext = inp
        return rt_step(st, scan, dt, ext, cfg)

    return lax.scan(body, state, (scans, dts, ext_motions))


# ---------------------------------------------------------------------------
# Packed-u16 scan upload, for hosts whose host->device link limits the
# realtime loop (unmeasured on a local GPU, ROADMAP design 5): a scan
# pytree is 3+ separate transfers of ~20 B/point. The packed path ships ONE [N, 4]
# uint16 array (x, y, z quantized over the scan AABB, ~1.5 mm at 100 m
# span; sweep phase in [0, 1] quantized to 16 bits; 0xFFFF phase =
# invalid point) plus an 8-float header — 8 B/point, one object.
# ---------------------------------------------------------------------------


def pack_scan_u16(scan_xyz: np.ndarray, mask: np.ndarray,
                  times: Optional[np.ndarray]) -> tuple:
    """Host-side packing -> (packed [N,4] u16, header [8] f32)."""
    xyz = np.asarray(scan_xyz, np.float32)
    m = np.asarray(mask, bool)
    n = xyz.shape[0]
    if m.any():
        lo = xyz[m].min(axis=0)
        hi = xyz[m].max(axis=0)
    else:
        lo = np.zeros(3, np.float32)
        hi = np.ones(3, np.float32)
    span = np.maximum(hi - lo, 1e-6)
    q = np.zeros((n, 4), np.uint16)
    qf = np.clip((xyz - lo) / span * 65535.0 + 0.5, 0, 65535)
    q[:, :3] = qf.astype(np.uint16)
    if times is not None:
        t = np.clip(np.asarray(times, np.float32).reshape(n), 0.0, 1.0)
        q[:, 3] = np.minimum((t * 65534.0 + 0.5).astype(np.uint32), 65534).astype(np.uint16)
    q[~m, 3] = 0xFFFF
    header = np.zeros(8, np.float32)
    header[:3] = lo
    header[3:6] = span
    header[6] = 1.0 if times is not None else 0.0
    return q, header


def _unpack_scan_u16(packed: jax.Array, header: jax.Array,
                     has_times: bool) -> pc.PointBatch:
    q = packed.astype(jnp.float32)
    lo = header[:3]
    span = header[3:6]
    xyz = q[:, :3] / 65535.0 * span[None, :] + lo[None, :]
    mask = packed[:, 3] != jnp.uint16(0xFFFF)
    xyz = jnp.where(mask[:, None], xyz, pc.PAD_COORD)
    extras = {}
    if has_times:
        extras["times"] = (q[:, 3:4] / 65534.0)
    return pc.PointBatch(xyz=xyz, mask=mask, extras=extras)


@functools.partial(jax.jit, static_argnames=("cfg", "has_times"))
def rt_step_packed(
    state: RtState,
    packed: jax.Array,
    header: jax.Array,
    dt: jax.Array,
    ext_motion: jax.Array,
    cfg: SlamConfig,
    has_times: bool = True,
):
    """:func:`rt_step` over a packed-u16 scan (one H2D object)."""
    scan = _unpack_scan_u16(packed, header, has_times)
    return rt_step(state, scan, dt, ext_motion, cfg)


@functools.partial(jax.jit, static_argnames=("capacity",))
def _seed_bank(
    old: submap_mod.SubmapState,
    center: jax.Array,
    voxel_size,
    crop_radius,
    capacity: int,
) -> submap_mod.SubmapState:
    """Seed a fresh submap bank with the old bank's patch around ``center``
    — the overlap transition region a new reference submap starts from
    (≙ the scan-insertion overlap buffer, ``SubmapCollection.cpp:189-245``):
    registration stays continuous across the switch instead of facing an
    empty map."""
    from open3d_slam_jax.ops.voxel import voxel_downsample

    d2 = jnp.sum((old.cloud.xyz - center) ** 2, axis=-1)
    patch = old.cloud.with_mask(d2 <= jnp.asarray(crop_radius) ** 2)
    patch = dataclasses.replace(patch, extras={})
    # Seed at most half the bank: a near-full seed would trip the
    # force-new saturation gate immediately and cascade submap creation.
    seed = voxel_downsample(
        patch, voxel_size, capacity=capacity // 2, priority_center=center
    )
    cloud = pc.PointBatch(
        xyz=jnp.concatenate(
            [seed.xyz, jnp.full((capacity - capacity // 2, 3), pc.PAD_COORD)],
            axis=0,
        ),
        mask=jnp.concatenate(
            [seed.mask, jnp.zeros((capacity - capacity // 2,), bool)], axis=0
        ),
        extras={},
    )
    return submap_mod.SubmapState(
        cloud=cloud, pose=jnp.eye(4, dtype=jnp.float32),
        num_scans=jnp.asarray(0, jnp.int32),
    )


@dataclasses.dataclass
class FrameRecord:
    """Host-side per-frame record, filled in as stats are polled."""

    time: float
    pose: Optional[np.ndarray] = None  # [4,4] registered pose (after poll)
    inserted: bool = False
    converged: bool = False
    degenerate: bool = False
    out_of_order: bool = False
    # Active submap at dispatch: pose-graph increments are applied to past
    # frames per-submap (the trajectory half of updateSubmapsAndTrajectory,
    # SlamWrapper.cpp:1055-1090 — the reference re-anchors the past path,
    # not only the live pose).
    submap_idx: int = 0


class RealtimePipeline:
    """Host front-end over :func:`rt_step` — the online SlamWrapper.

    Usage::

        rt = RealtimePipeline(cfg, poll_every=8)
        for scan, t in stream:
            rt.process_scan(scan, t)     # non-blocking dispatch
        rt.finish()                      # drain stats + join loop closure
        traj = rt.trajectory()           # [F, 4, 4] per-frame poses

    ``poll_every=1`` gives the paced low-latency mode (one blocking stats
    fetch per scan, still a single device program per scan); larger values
    amortize the host<->device round-trip for maximum throughput.
    """

    def __init__(
        self,
        cfg: Optional[SlamConfig] = None,
        poll_every: int = 8,
        loop_closure_async: bool = True,
        h2d_mode: str = "pytree",
        chunk_size: int = 1,
        async_rebuild: bool = True,
    ):
        if h2d_mode not in ("pytree", "packed"):
            raise ValueError(f"h2d_mode must be 'pytree' or 'packed', got {h2d_mode!r}")
        if chunk_size > 1 and h2d_mode == "packed":
            raise ValueError("chunk_size > 1 currently requires h2d_mode='pytree'")
        self.cfg = cfg or SlamConfig()
        # Async reference rebuild (≙ the reference's periodic re-init running
        # off the mapping hot path, Mapper.cpp:329-360): the rebuild becomes
        # its OWN device program launched by the host at the cadence; the
        # per-frame step program then never takes the rebuild branch, so no
        # single frame carries the full rebuild latency — in paced (10 Hz)
        # operation the rebuild executes in the idle gap between arrivals.
        self.async_rebuild = bool(async_rebuild)
        # The step config is the jit static key for every device program.
        # HOST-ONLY fields (loop closure, place recognition, pose graph,
        # IMU boot) are normalized to defaults so configs differing only in
        # host behavior SHARE compiled programs — e.g. an lc_on/lc_off A/B
        # in one process compiles the multi-minute step stack once.
        _defaults = SlamConfig()
        self._step_cfg = dataclasses.replace(
            self.cfg,
            loop_closure_enabled=_defaults.loop_closure_enabled,
            place_recognition=_defaults.place_recognition,
            pose_graph=_defaults.pose_graph,
            node_capacity=_defaults.node_capacity,
            edge_capacity=_defaults.edge_capacity,
            use_imu_attitude_init=_defaults.use_imu_attitude_init,
        )
        if self.async_rebuild:
            self._step_cfg = dataclasses.replace(
                self._step_cfg,
                mapper=dataclasses.replace(
                    self.cfg.mapper, reference_reinit_every=1 << 30
                ),
            )
        self._frames_since_rebuild = 1
        self.h2d_mode = h2d_mode
        self.chunk_size = max(1, int(chunk_size))
        self._chunk_buf: List[tuple] = []  # (scan, dt, ext, frame_idx)
        self._pending_chunks: List[tuple] = []  # (stats [K, S] handle, frame idxs)
        self.poll_every = max(1, int(poll_every))
        self.submaps = SubmapCollection(self.cfg.submaps)
        self._state: Optional[RtState] = None
        self._pending: List[jax.Array] = []  # unfetched stats handles
        self._pending_meta: List[int] = []  # frame index per pending handle
        self.frames: List[FrameRecord] = []
        self._last_time: Optional[float] = None
        # Most recent dispatched scan (device handles; free to retain) —
        # consumed by the re-activation consistency gate.
        self._last_scan: Optional[pc.PointBatch] = None
        self._prev_ext_pose: Optional[np.ndarray] = None
        self._initial_pose = np.eye(4)
        self._last_polled_pose = np.eye(4)
        self._last_polled_fidx = -1
        self.imu_buffer = ImuBuffer()
        self._attitude_initialized = False
        # Submap lifecycle mirrors (host side of the collection).
        self._registry_lock = threading.Lock()
        # Guards FrameRecord.pose + the pending-stats lists against the
        # loop-closure worker's retroactive trajectory correction.
        self._frames_lock = threading.Lock()
        # fidx -> correction for frames dispatched pre-solve but polled
        # post-solve (their device stats predate the increment).
        self._poll_corr: Dict[int, np.ndarray] = {}
        # Frames whose stats are being fetched outside the lock right now
        # (pending for _poll_corr purposes; see poll()).
        self._in_fetch: set = set()
        self._scans_in_active_at_switch = 0
        self._last_switch_frame = -(10**9)
        self._frames_done = 0
        # Loop closure worker (≙ loopClosureWorker thread).
        self.loop_closure_async = loop_closure_async and self.cfg.loop_closure_enabled
        self._lc_queue: "queue.Queue" = queue.Queue()
        self._lc_thread: Optional[threading.Thread] = None
        self._lc_stop = threading.Event()
        self._loop_constraints: List[pr.LoopClosureConstraint] = []
        self._pending_increment: Optional[np.ndarray] = None  # active-bank inc
        self._inc_lock = threading.Lock()
        self._lc_busy = False
        self.loop_closure_count = 0
        self.pose_graph_solves = 0
        self.solve_log: List[dict] = []  # per-solve chi2/increment diagnostics
        if self.loop_closure_async:
            self._lc_thread = threading.Thread(target=self._lc_worker, daemon=True)
            self._lc_thread.start()

    # ------------------------------------------------------------------
    # Ingestion.
    # ------------------------------------------------------------------

    def warmup(self, example_scan: pc.PointBatch) -> None:
        """Compile every mapping-critical-path program (init, step, packed
        step, submap seeding, the stats-poll stack) on throwaway state
        BEFORE streaming starts, so no XLA compile lands inside the
        real-time loop (a cold compile cache compiles everything). Loop
        closure programs compile lazily on the worker thread — off the
        critical path by design."""
        cfg = self._step_cfg
        state = rt_init(example_scan, jnp.eye(4, dtype=jnp.float32), cfg)
        eye = jnp.eye(4, dtype=jnp.float32)
        dt = jnp.asarray(0.1, jnp.float32)
        state2, stats = rt_step(state, example_scan, dt, eye, cfg)
        if self.h2d_mode == "packed":
            times = None
            if "times" in example_scan.extras:
                times = np.asarray(example_scan.extras["times"])[..., 0]
            packed, header = pack_scan_u16(
                np.asarray(example_scan.xyz), np.asarray(example_scan.mask), times
            )
            _, stats = rt_step_packed(
                state2, jnp.asarray(packed), jnp.asarray(header), dt, eye, cfg,
                has_times=times is not None,
            )
        if self.chunk_size > 1:
            scans = pc.stack([example_scan] * self.chunk_size)
            dts = jnp.full((self.chunk_size,), 0.1, jnp.float32)
            exts = jnp.tile(eye, (self.chunk_size, 1, 1))
            _, stats_c = rt_step_chunk(state2, scans, dts, exts, cfg)
            np.asarray(stats_c)
        _seed_bank(
            state2.bank,
            jnp.zeros(3, jnp.float32),
            cfg.submaps.submap_voxel_size,
            cfg.mapper.map_patch_radius,
            capacity=cfg.submaps.submap_capacity,
        )
        np.asarray(jnp.stack([stats] * self.poll_every))  # poll program + sync
        if self.async_rebuild:
            jax.block_until_ready(build_map_reference(
                state2.bank.cloud, state2.map_pose[:3, 3], self.cfg.mapper
            ))
        # Re-activation consistency gate program (scan-vs-bank overlap).
        from open3d_slam_jax.slam.constraint_builders import (
            overlap_fraction,
        )

        overlap_fraction(
            example_scan, state2.bank.cloud,
            radius=max(self.cfg.submaps.submap_voxel_size, 1e-3),
        )
        if self.cfg.loop_closure_enabled:
            self._warmup_loop_closure()

    def _warmup_loop_closure(self) -> None:
        """Compile the loop-closure worker's programs (verify-candidate
        FPFH/RANSAC/ICP stack, bank compaction/transform, pose-graph
        solvers) on throwaway data BEFORE streaming. Without this, the
        worker's first finished submap can spend minutes compiling and
        every solve lands after the stream — corrections that can never
        reach the live map.
        The compile cache is keyed on shapes + config, both of which match
        the production calls exactly."""
        cfg = self.cfg
        rng = np.random.default_rng(0)
        n = 16384  # build_loop_closure_constraints' scan_capacity
        # Structured scene: ground + two walls (FPFH/RANSAC need geometry).
        m = n // 4
        pts = np.concatenate([
            np.c_[rng.uniform(-8, 8, (2 * m, 2)), rng.normal(0, 0.02, (2 * m, 1))],
            np.c_[rng.uniform(-8, 8, (m, 1)), np.full((m, 1), 8.0),
                  rng.uniform(0, 3, (m, 1))],
            np.c_[np.full((n - 3 * m, 1), -8.0), rng.uniform(-8, 8, (n - 3 * m, 1)),
                  rng.uniform(0, 3, (n - 3 * m, 1))],
        ]).astype(np.float32)
        a = pc.from_points(pts, capacity=n)
        b = pc.from_points(pts + np.float32([0.05, -0.03, 0.01]), capacity=n)
        # Compile each worker program DIRECTLY rather than hoping the full
        # verify_candidate path reaches them (a failed synthetic FPFH/RANSAC
        # would silently skip the grid+1-seed hypothesis shape and leave a
        # multi-minute compile inside the stream). register_hypotheses is
        # keyed on the seed-array shape: grid (FPFH-miss) and grid+1
        # (FPFH-hit) are distinct programs.
        prc = cfg.place_recognition
        from open3d_slam_jax.ops import normals as _normals_mod

        an = _normals_mod.estimate_normals(a, knn=8, max_dist=2.0 * prc.icp.max_match_dist)
        bn = _normals_mod.estimate_normals(b, knn=8, max_dist=2.0 * prc.icp.max_match_dist)
        grid = np.asarray(pr._seed_grid(np.eye(4), prc))
        shapes = [grid]
        if prc.use_fpfh_ransac:
            shapes.append(np.concatenate([np.eye(4, dtype=np.float32)[None], grid]))
            # FPFH + mutual-match + device-RANSAC programs.
            fpfh_ok = False
            try:
                fpfh_ok = pr.fpfh_coarse_align(an, bn, prc) is not None
            except Exception:
                pass
            if not fpfh_ok:
                # The feature pipeline compiled up to wherever it bailed;
                # compile the RANSAC program explicitly so nothing is left.
                try:
                    from open3d_slam_jax.models import ransac as _ransac_mod

                    ok = np.zeros(n, bool)
                    ok[: max(prc.ransac_min_inliers * 4, 64)] = True
                    _ransac_mod.ransac_align(
                        an.xyz, bn.xyz, jnp.asarray(ok), jax.random.key(0),
                        _ransac_mod.RansacConfig(
                            num_hypotheses=prc.ransac_hypotheses,
                            inlier_dist=prc.ransac_inlier_dist,
                            min_inliers=prc.ransac_min_inliers,
                        ),
                    )
                except Exception:
                    import warnings

                    warnings.warn(
                        "loop-closure warmup: RANSAC program failed to "
                        "compile; first real FPFH hit will compile in-stream"
                    )
        for seeds in shapes:
            try:
                icp_mod.register_hypotheses(an, bn, jnp.asarray(seeds), prc.icp)
            except Exception:
                import warnings

                warnings.warn(
                    f"loop-closure warmup: hypothesis shape {seeds.shape} "
                    "failed to compile; it will compile in-stream"
                )
        # Bank-shaped programs the worker uses (compact + rigid transform).
        bank = submap_mod.create(cfg.submaps.submap_capacity)
        pc.compact(bank.cloud, n)
        submap_mod.transform_submap(bank, jnp.eye(4, dtype=jnp.float32))
        # Pose-graph solvers: one graph under and one over the auto-PCG
        # threshold so both the dense and PCG programs are compiled.
        counts = [4]
        auto = getattr(cfg.pose_graph, "auto_pcg_nodes", None)
        if cfg.pose_graph.solver == "auto" and auto is not None and (
            auto + 2 <= cfg.node_capacity
        ):
            counts.append(auto + 2)
        for k in counts:
            builder = pg.PoseGraphBuilder(cfg.node_capacity, cfg.edge_capacity)
            T = np.eye(4)
            for i in range(k):
                T = T.copy()
                T[0, 3] = float(i)
                builder.add_node(T)
            for i in range(k - 1):
                Trel = np.eye(4)
                Trel[0, 3] = 1.0
                builder.add_edge(i, i + 1, Trel)
            loop = np.eye(4)
            loop[0, 3] = float(k - 1) - 0.05
            builder.add_edge(0, k - 1, loop, is_loop=True)
            try:
                pg.optimize(builder.build(), cfg.pose_graph)
            except Exception:
                pass

    def add_imu(self, time: float, acc, gyro) -> None:
        self.imu_buffer.push(time, acc, gyro)

    def set_initial_transform(self, T: np.ndarray) -> None:
        self._initial_pose = np.asarray(T, np.float64).copy()

    @property
    def pose(self) -> np.ndarray:
        """Latest POLLED pose (may lag the device by < poll_every frames)."""
        return self._last_polled_pose.copy()

    def process_scan(
        self,
        scan: pc.PointBatch,
        time: float,
        external_odom_pose: Optional[np.ndarray] = None,
    ) -> None:
        """Dispatch one scan. Never blocks on device results except at the
        poll cadence (and on first-scan initialization)."""
        cfg = self.cfg
        rec = FrameRecord(time=time)

        # Out-of-order scans are not registered (≙ the backup-transform
        # path, Mapper.cpp:196-235 — the reference publishes a propagated
        # pose but does not insert; here the frame is marked and skipped).
        if self._last_time is not None and time <= self._last_time:
            # Under _frames_lock: the LC worker's retroactive pass snapshots
            # self.frames and corrects polled poses in place — an unlocked
            # append here could capture a pre-correction pose yet be missing
            # from the worker's snapshot (permanently uncorrected frame).
            with self._frames_lock:
                rec.out_of_order = True
                rec.pose = self._last_polled_pose.copy()
                rec.submap_idx = self.submaps.active_idx
                self.frames.append(rec)
            return

        self._last_scan = scan
        if self._state is None:
            # IMU attitude boot (≙ estimateAttitudeFromImu at startup).
            if (
                cfg.use_imu_attitude_init
                and not self._attitude_initialized
                and len(self.imu_buffer) >= 2
                and np.allclose(self._initial_pose[:3, :3], np.eye(3))
            ):
                try:
                    R_wb, _ = self.imu_buffer.estimate_attitude(t_end=time)
                    self._initial_pose = self._initial_pose.copy()
                    self._initial_pose[:3, :3] = R_wb
                    self._attitude_initialized = True
                except ValueError:
                    pass
            self._state = rt_init(
                scan, jnp.asarray(self._initial_pose, jnp.float32), self._step_cfg
            )
            self._frames_since_rebuild = 1
            with self._registry_lock:
                self.submaps.submaps.append(
                    SubmapEntry(
                        state=self._state.bank,
                        anchor=self._initial_pose.copy(),
                        parent=None,
                    )
                )
                self.submaps.active_idx = 0
            rec.pose = self._initial_pose.copy()
            rec.inserted = rec.converged = True
            self._last_polled_pose = self._initial_pose.copy()
            self.frames.append(rec)
            self._last_time = time
            if external_odom_pose is not None:
                self._prev_ext_pose = np.asarray(external_odom_pose, np.float64)
            self._frames_done += 1
            return

        dt = time - (self._last_time if self._last_time is not None else time)
        if cfg.use_external_odometry and external_odom_pose is not None:
            ext = np.asarray(external_odom_pose, np.float64)
            prev = self._prev_ext_pose if self._prev_ext_pose is not None else ext
            ext_motion = np.linalg.inv(prev) @ ext
            self._prev_ext_pose = ext
        else:
            ext_motion = np.eye(4)

        if self.chunk_size > 1:
            with self._frames_lock:
                self._chunk_buf.append((scan, dt, ext_motion, len(self.frames)))
                rec.submap_idx = self.submaps.active_idx
                self.frames.append(rec)
            self._last_time = time
            self._frames_done += 1
            if len(self._chunk_buf) >= self.chunk_size:
                self._dispatch_chunk()
            return
        # One atomic dispatch section (vs the loop-closure worker): consume
        # the pending increment, dispatch, enqueue the stats handle. The
        # worker's retroactive pass takes the same lock, so every frame is
        # either (a) dispatched post-increment, (b) pending -> corrected at
        # poll via _poll_corr, or (c) polled -> corrected in place.
        with self._frames_lock:
            self._apply_pending_increment_locked()
            if self.h2d_mode == "packed":
                times = None
                if "times" in scan.extras:
                    times = np.asarray(scan.extras["times"])[..., 0]
                packed, header = pack_scan_u16(
                    np.asarray(scan.xyz), np.asarray(scan.mask), times
                )
                self._state, stats = rt_step_packed(
                    self._state,
                    jnp.asarray(packed),
                    jnp.asarray(header),
                    jnp.asarray(dt, jnp.float32),
                    jnp.asarray(ext_motion, jnp.float32),
                    self._step_cfg,
                    has_times=times is not None,
                )
            else:
                self._state, stats = rt_step(
                    self._state,
                    scan,
                    jnp.asarray(dt, jnp.float32),
                    jnp.asarray(ext_motion, jnp.float32),
                    self._step_cfg,
                )
            self._pending.append(stats)
            self._pending_meta.append(len(self.frames))
            rec.submap_idx = self.submaps.active_idx
            self.frames.append(rec)
            self._frames_since_rebuild += 1
            if (
                self.async_rebuild
                and self._frames_since_rebuild
                >= self.cfg.mapper.reference_reinit_every
            ):
                self._launch_rebuild()
        self._last_time = time
        self._frames_done += 1
        if len(self._pending) >= self.poll_every:
            self.poll()

    def _launch_rebuild(self) -> None:
        """Refresh the registration reference. Async mode: launch
        :func:`build_map_reference` as its OWN device program and swap the
        (not-yet-materialized) handles into the step state — device-queue
        ordering makes the next step consume the finished rebuild, while no
        frame's STATS depend on it, so a paced stream absorbs the rebuild
        in its idle gap (≙ the reference's periodic re-init running while
        mapping continues, ``Mapper.cpp:329-360``). Sync mode: arm the
        in-step rebuild branch."""
        if not self.async_rebuild:
            self._state = dataclasses.replace(
                self._state, scans_since_reinit=jnp.asarray(10**6, jnp.int32)
            )
            return
        ref = build_map_reference(
            self._state.bank.cloud, self._state.map_pose[:3, 3], self.cfg.mapper
        )
        self._state = dataclasses.replace(
            self._state, ref=ref, scans_since_reinit=jnp.asarray(0, jnp.int32)
        )
        self._frames_since_rebuild = 0

    def _apply_pending_increment_locked(self) -> None:
        """Consume a pending loop-closure increment at the dispatch boundary
        (≙ checkIfOptimizedGraphAvailable on the mapping thread,
        ``SlamWrapper.cpp:949-961``). Caller holds ``_frames_lock``."""
        with self._inc_lock:
            inc = self._pending_increment
            self._pending_increment = None
        if inc is not None:
            T = jnp.asarray(inc, jnp.float32)
            self._state = dataclasses.replace(
                self._state,
                map_pose=T @ self._state.map_pose,
                bank=submap_mod.transform_submap(self._state.bank, T),
            )
            # The map moved: the reference must be rebuilt before the next
            # registration.
            self._launch_rebuild()

    def _dispatch_chunk(self) -> None:
        """Stack the buffered frames and run them as ONE scanned device
        program; the chunk's [K, STATS_LEN] stats buffer becomes a single
        pending fetch. Short buffers are padded by repeating the last scan
        with dt ~ 0 (registers in place, below the movement gate — no
        inserts), so one compiled chunk shape serves every dispatch."""
        with self._frames_lock:
            if not self._chunk_buf:
                return
            self._apply_pending_increment_locked()
            K = self.chunk_size
            buf = list(self._chunk_buf)
            self._chunk_buf = []
            n_real = len(buf)
            while len(buf) < K:
                scan, _, _, _ = buf[-1]
                buf.append((scan, 1e-4, np.eye(4), -1))
            scans = pc.stack([b[0] for b in buf])
            dts = jnp.asarray(np.asarray([b[1] for b in buf], np.float32))
            exts = jnp.asarray(
                np.stack([np.asarray(b[2], np.float32) for b in buf])
            )
            self._state, stats = rt_step_chunk(
                self._state, scans, dts, exts, self._step_cfg
            )
            self._pending_chunks.append((stats, [b[3] for b in buf[:n_real]]))
            self._frames_since_rebuild += n_real
            if (
                self.async_rebuild
                and self._frames_since_rebuild
                >= self.cfg.mapper.reference_reinit_every
            ):
                self._launch_rebuild()
        self.poll()

    # ------------------------------------------------------------------
    # Deferred stats consumption + submap lifecycle.
    # ------------------------------------------------------------------

    def poll(self) -> None:
        """Fetch all pending stats (one stacked transfer for single-step
        mode; the chunk buffers directly in chunk mode) and run the host
        bookkeeping they gate (trajectory, submap switching, loop-closure
        triggers). The blocking device fetch runs OUTSIDE the frames lock
        (a loop-closure solve finishing mid-poll must not wait out a full
        host<->device transfer to hand off its correction); frames whose
        stats are in flight stay visible to the retroactive pass via
        ``_in_fetch`` so their corrections land in ``_poll_corr``."""
        with self._frames_lock:
            handles, metas = self._pending, self._pending_meta
            self._pending, self._pending_meta = [], []
            chunks = self._pending_chunks
            self._pending_chunks = []
            if not handles and not chunks:
                return
            self._in_fetch.update(metas)
            for _, idxs in chunks:
                self._in_fetch.update(idxs)
        rows_meta: List[tuple] = []
        if handles:
            stacked = np.asarray(jnp.stack(handles))  # one blocking fetch
            rows_meta.extend(zip(stacked, metas))
        for handle, idxs in chunks:
            arr = np.asarray(handle)  # one fetch per chunk buffer
            rows_meta.extend((arr[k], fidx) for k, fidx in enumerate(idxs))
        with self._frames_lock:
            for row, fidx in rows_meta:
                self._in_fetch.discard(fidx)
                rec = self.frames[fidx]
                pose = row[IDX_POSE].reshape(4, 4).astype(np.float64)
                # Frame dispatched before a pose-graph solve, polled after:
                # its stats predate the increment — apply it now.
                corr = self._poll_corr.pop(fidx, None)
                if corr is not None:
                    pose = corr @ pose
                rec.pose = pose
                rec.inserted = bool(row[IDX_INSERTED] > 0.5)
                rec.converged = bool(row[IDX_CONVERGED] > 0.5)
                rec.degenerate = bool(row[IDX_DEGENERATE] > 0.5)
            last_fidx = rows_meta[-1][1]
            self._last_polled_fidx = last_fidx
            self._last_polled_pose = self.frames[last_fidx].pose.copy()
            occupancy = float(rows_meta[-1][0][IDX_OCCUPANCY])
        self._maybe_switch_submap(self._last_polled_pose, occupancy)

    def _maybe_switch_submap(self, pose: np.ndarray, occupancy: float) -> None:
        """Host submap lifecycle from polled stats (≙ updateActiveSubmap,
        SubmapCollection.cpp:94-148, evaluated at poll cadence)."""
        cfg = self.cfg.submaps
        with self._registry_lock:
            cur = self.submaps.active_idx
            entry = self.submaps.submaps[cur]
            # Keep the registry's view of the active bank fresh (loop
            # closure + map export read it).
            entry.state = self._state.bank
            pos = pose[:3, 3]
            d_cur = np.linalg.norm(entry.anchor[:3, 3] - pos)
            max_pts = (
                cfg.max_num_points
                if cfg.max_num_points is not None
                else int(0.9 * cfg.submap_capacity)
            )
            force_new = occupancy >= max_pts
            young = (
                self._frames_done - self._last_switch_frame
                < cfg.min_scans_before_switch
            )
            if (not force_new) and (young or d_cur <= cfg.creation_radius):
                return
            # Try re-activating a nearby finished submap (adjacency +
            # proximity + the overlap CONSISTENCY gate, ≙
            # isSwitchingSubmapsConsistant, SubmapCollection.cpp:390-402:
            # without it a drifted return re-activates the old submap and
            # corrupts it with misplaced inserts instead of creating the
            # new submap a loop closure needs). The gate is one blocking
            # device call — rare, poll-cadence only.
            best, best_d = -1, np.inf
            if not force_new:
                for i, e in enumerate(self.submaps.submaps):
                    if i == cur:
                        continue
                    d = np.linalg.norm(e.anchor[:3, 3] - pos)
                    if d < best_d:
                        best, best_d = i, d
            if (
                best >= 0
                and best_d <= cfg.activation_radius
                and self.submaps.adjacency.is_adjacent(cur, best)
                and self.submaps._switch_consistent(self._last_scan, pose, best)
            ):
                self._finish_active(cur)
                self.submaps.active_idx = best
                self._state = dataclasses.replace(
                    self._state,
                    bank=self.submaps.submaps[best].state,
                    scans_in_active=jnp.asarray(0, jnp.int32),
                )
                self._launch_rebuild()
                self._last_switch_frame = self._frames_done
                return
            if force_new or d_cur > cfg.creation_radius:
                # Seed the fresh bank with the old bank's local patch (the
                # overlap transition region) BEFORE finishing the old one.
                seeded = _seed_bank(
                    self._state.bank,
                    jnp.asarray(pos, jnp.float32),
                    cfg.submap_voxel_size,
                    self.cfg.mapper.map_patch_radius,
                    capacity=cfg.submap_capacity,
                )
                self._finish_active(cur)
                new_idx = self._create_submap(pose, parent=cur)
                self.submaps.submaps[new_idx].state = seeded
                self.submaps.active_idx = new_idx
                self._state = dataclasses.replace(
                    self._state,
                    bank=seeded,
                    scans_in_active=jnp.asarray(0, jnp.int32),
                )
                self._launch_rebuild()
                self._last_switch_frame = self._frames_done

    def _create_submap(self, pose: np.ndarray, parent: Optional[int]) -> int:
        entry = SubmapEntry(
            state=submap_mod.create(self.cfg.submaps.submap_capacity),
            anchor=np.asarray(pose, np.float64).copy(),
            parent=parent,
        )
        self.submaps.submaps.append(entry)
        idx = len(self.submaps.submaps) - 1
        if parent is not None:
            self.submaps.adjacency.add_edge(parent, idx)
        return idx

    def _finish_active(self, idx: int) -> None:
        e = self.submaps.submaps[idx]
        e.state = self._state.bank
        if not e.finished:
            e.finished = True
            if self.loop_closure_async:
                self._lc_queue.put(idx)
            elif self.cfg.loop_closure_enabled:
                self._run_loop_closure(idx)

    # ------------------------------------------------------------------
    # Loop closure + pose graph (worker thread, ≙ loopClosureWorker).
    # ------------------------------------------------------------------

    def _lc_worker(self) -> None:
        while not self._lc_stop.is_set():
            try:
                idx = self._lc_queue.get(timeout=0.1)
            except queue.Empty:
                continue
            self._lc_busy = True
            try:
                self._run_loop_closure(idx)
            except Exception:  # never take down mapping from the LC thread
                import traceback

                traceback.print_exc()
            finally:
                self._lc_busy = False

    def _run_loop_closure(self, finished_idx: int) -> None:
        constraints = pr.build_loop_closure_constraints(
            self.submaps, finished_idx, cfg=self.cfg.place_recognition
        )
        if not constraints:
            return
        self._loop_constraints.extend(constraints)
        self.loop_closure_count += len(constraints)
        # Accepted closures become adjacency edges (≙ the reference updating
        # the adjacency matrix after applying closures,
        # SlamWrapper.cpp:1078-1089): a corrected revisit region can then
        # RE-ACTIVATE the original submap instead of duplicating it.
        with self._registry_lock:
            for c in constraints:
                self.submaps.adjacency.add_edge(c.source_idx, c.target_idx)
        self._optimize_pose_graph()

    def _optimize_pose_graph(self) -> None:
        """Build/solve the pose graph from the registry; apply increments to
        stored banks directly and hand the active-submap increment to the
        mapping thread (≙ updateSubmapsAndTrajectory split across the
        loop-closure and mapping workers)."""
        with self._registry_lock:
            entries = list(self.submaps.submaps)
            active_idx = self.submaps.active_idx
        # Measured per-submap observability -> anisotropic odometry-edge
        # information (the reference weighs odometry constraints by
        # registration-derived information matrices,
        # constraint_builders.cpp:33-118 + GetInformationMatrixFrom-
        # PointClouds). A segment whose registrations X-ICP flagged
        # degenerate gets WEAK translation information along its travel
        # direction, so the solve concentrates loop-closure corrections in
        # the blind segments instead of uniformly bending well-observed
        # ones (uniform identity info measurably DRAGGED correctly-mapped
        # rooms: corridor-protocol lc_on ATE 5.4 vs lc_off 2.6 before
        # this).
        with self._frames_lock:
            frames_snap = [
                (r.submap_idx, r.degenerate)
                for r in self.frames
                if r.pose is not None
            ]
        deg_frac: Dict[int, list] = {}
        for sidx, deg in frames_snap:
            deg_frac.setdefault(sidx, []).append(1.0 if deg else 0.0)
        W_STRONG, W_BLIND = 100.0, 2.0
        builder = pg.PoseGraphBuilder(self.cfg.node_capacity, self.cfg.edge_capacity)
        for e in entries:
            builder.add_node(e.anchor)
        for i, e in enumerate(entries):
            if e.parent is not None:
                T_rel = np.linalg.inv(entries[e.parent].anchor) @ e.anchor
                flags = deg_frac.get(e.parent, [])
                # X-ICP's binary insufficient-information flag fires only on
                # the starkest frames (production thresholds); a segment
                # where >=25% of registrations were flagged is treated as
                # fully blind along its travel direction.
                frac = min(1.0, 4.0 * float(np.mean(flags))) if flags else 0.0
                info = np.eye(6) * W_STRONG
                d = T_rel[:3, 3]
                nd = float(np.linalg.norm(d))
                if nd > 1e-6 and frac > 0.0:
                    dn = d / nd
                    w_para = W_STRONG * (1.0 - frac) + W_BLIND * frac
                    # Residual layout: [omega(3), v(3)] in the edge-local
                    # frame; soften translation along the travel direction.
                    info[3:, 3:] = W_STRONG * np.eye(3) + (
                        w_para - W_STRONG
                    ) * np.outer(dn, dn)
                builder.add_edge(e.parent, i, T_rel, info=info)
        for c in self._loop_constraints:
            builder.add_edge(
                c.target_idx, c.source_idx, c.T_target_source,
                info=c.information, is_loop=True,
            )
        graph = builder.build()
        import os as _os

        dump_dir = _os.environ.get("O3S_DUMP_POSE_GRAPHS")
        if dump_dir:
            # Offline-repro hook: save the exact solve inputs (anchors,
            # parent chain, loop constraints) for solver debugging.
            np.savez(
                _os.path.join(dump_dir, f"pg_{self.pose_graph_solves:03d}.npz"),
                anchors=np.stack([e.anchor for e in entries]),
                parents=np.asarray([
                    -1 if e.parent is None else e.parent for e in entries
                ]),
                lc_src=np.asarray([c.source_idx for c in self._loop_constraints]),
                lc_tgt=np.asarray([c.target_idx for c in self._loop_constraints]),
                lc_T=np.stack([c.T_target_source for c in self._loop_constraints]),
                lc_info=np.stack([c.information for c in self._loop_constraints]),
            )
        chi2_pre = float(pg.chi2(graph))
        out = pg.optimize(graph, self.cfg.pose_graph)
        chi2_post = float(pg.chi2(out))
        self.pose_graph_solves += 1
        new_poses = np.asarray(out.poses, np.float64)

        increments: Dict[int, np.ndarray] = {}
        inc_norms = []
        for i, e in enumerate(entries):
            inc = new_poses[i] @ np.linalg.inv(e.anchor)
            inc_norms.append(float(np.linalg.norm(inc - np.eye(4))))
            if not np.allclose(inc, np.eye(4), atol=1e-6):
                increments[i] = inc
        # Per-solve diagnostics (≙ the reference's printed optimization
        # summary): chi2 before/after and the largest submap increment —
        # the observable that proves a solve actually moved the graph.
        self.solve_log.append({
            "nodes": len(entries),
            "loop_edges": len(self._loop_constraints),
            "chi2_pre": chi2_pre,
            "chi2_post": chi2_post,
            "max_inc_norm": max(inc_norms) if inc_norms else 0.0,
            "moved_submaps": len(increments),
        })
        if not increments:
            return
        with self._registry_lock:
            # Re-read the active index: the mapping thread may have switched
            # submaps during the (long) solve above, and the increment handed
            # to the live device bank must be the CURRENT active submap's —
            # else device state and the retroactive frame corrections diverge
            # by resolve(new)^-1 @ resolve(old).
            active_idx = self.submaps.active_idx
            # Transform every NON-active stored bank here on the worker;
            # parent-chain propagation for unoptimized submaps.
            resolved: Dict[int, np.ndarray] = {}

            def resolve(i: int) -> np.ndarray:
                if i in resolved:
                    return resolved[i]
                if i in increments:
                    resolved[i] = increments[i]
                elif self.submaps.submaps[i].parent is not None:
                    resolved[i] = resolve(self.submaps.submaps[i].parent)
                else:
                    resolved[i] = np.eye(4)
                return resolved[i]

            for i, e in enumerate(self.submaps.submaps):
                T = resolve(i)
                if i == active_idx or np.allclose(T, np.eye(4), atol=1e-9):
                    continue
                e.state = submap_mod.transform_submap(
                    e.state, jnp.asarray(T, jnp.float32)
                )
                e.anchor = T @ e.anchor
            active_inc = resolve(active_idx)
            self.submaps.submaps[active_idx].anchor = (
                active_inc @ self.submaps.submaps[active_idx].anchor
            )
            all_res = {
                i: resolve(i) for i in range(len(self.submaps.submaps))
            }
        # Retroactive trajectory correction — the trajectory half of
        # updateSubmapsAndTrajectory (SlamWrapper.cpp:1055-1090): the
        # reference re-anchors the PAST path, not only the live pose. Each
        # recorded frame is moved by its submap's increment; frames still
        # in flight get the correction queued for poll time; frames
        # dispatched after this block see it baked into device state via
        # the pending increment (the dispatch section holds the same lock).
        with self._frames_lock:
            pending_fidx = set(self._pending_meta) | set(self._in_fetch)
            for _, idxs in self._pending_chunks:
                pending_fidx.update(idxs)
            eye = np.eye(4)
            for fidx, rec in enumerate(list(self.frames)):
                T = all_res.get(rec.submap_idx)
                if T is None or np.allclose(T, eye, atol=1e-9):
                    continue
                if rec.pose is not None:
                    rec.pose = T @ rec.pose
                elif fidx in pending_fidx:
                    base = self._poll_corr.get(fidx)
                    self._poll_corr[fidx] = T if base is None else T @ base
            if 0 <= self._last_polled_fidx < len(self.frames):
                p = self.frames[self._last_polled_fidx].pose
                if p is not None:
                    self._last_polled_pose = p.copy()
            if not np.allclose(active_inc, eye, atol=1e-9):
                with self._inc_lock:
                    base = (
                        self._pending_increment
                        if self._pending_increment is not None
                        else np.eye(4)
                    )
                    self._pending_increment = active_inc @ base

    # ------------------------------------------------------------------
    # Shutdown + export.
    # ------------------------------------------------------------------

    def finish(self, wait_loop_closures: bool = True) -> None:
        """Drain pending stats, finish the active submap bookkeeping, and
        (optionally) wait for queued loop closures."""
        if self._chunk_buf:
            self._dispatch_chunk()  # flush the partial chunk (padded)
        self.poll()
        with self._registry_lock:
            if self.submaps.submaps:
                self.submaps.submaps[self.submaps.active_idx].state = self._state.bank
        if wait_loop_closures and self.loop_closure_async:
            import time as _time

            # Graceful join: let the worker drain the queue AND finish the
            # in-flight item (first-call compiles can take minutes), then
            # stop it.
            deadline = _time.time() + 900.0
            while (not self._lc_queue.empty() or self._lc_busy) and (
                _time.time() < deadline
            ):
                _time.sleep(0.05)
            self._lc_stop.set()
            if self._lc_thread is not None:
                self._lc_thread.join(timeout=60.0)
        # Apply any loop-closure increment still pending so the exported
        # map reflects the final optimized graph. The TRAJECTORY was
        # already corrected by the solve's retroactive pass (frames +
        # _last_polled_pose) — only the device-resident bank needs it.
        with self._inc_lock:
            inc = self._pending_increment
            self._pending_increment = None
        if inc is not None and self._state is not None:
            T = jnp.asarray(inc, jnp.float32)
            self._state = dataclasses.replace(
                self._state,
                map_pose=T @ self._state.map_pose,
                bank=submap_mod.transform_submap(self._state.bank, T),
                scans_since_reinit=jnp.asarray(10**6, jnp.int32),
            )
            with self._registry_lock:
                self.submaps.submaps[self.submaps.active_idx].state = self._state.bank

    def trajectory(self) -> np.ndarray:
        """[F, 4, 4] per-frame registered poses (out-of-order frames carry
        the last known pose). Call :meth:`finish`/:meth:`poll` first."""
        out = []
        last = self._initial_pose
        for rec in self.frames:
            if rec.pose is not None:
                last = rec.pose
            out.append(last)
        return np.stack(out) if out else np.zeros((0, 4, 4))

    def assembled_map(self) -> np.ndarray:
        with self._registry_lock:
            if self.submaps.submaps:
                self.submaps.submaps[self.submaps.active_idx].state = self._state.bank
            return self.submaps.map_points()

    def dense_map_points(self) -> np.ndarray:
        if self._state is None or self._state.dense is None:
            return np.zeros((0, 3), np.float32)
        out = dense_map_mod.export(self._state.dense)
        return np.asarray(out.xyz)[np.asarray(out.mask)]
