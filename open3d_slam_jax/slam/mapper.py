"""Scan-to-map refinement — the real-time core loop.

Analogue of the reference ``Mapper`` (``Mapper.cpp:168-484``): per scan,

1. initial guess = previous map pose composed with the odometry motion since
   then (``Mapper.cpp:248-260``);
2. crop the active submap patch around the robot
   (``ScanToMapRegistration.cpp:90-96``);
3. periodically rebuild the registration reference (normals + grid hash,
   ≙ the KD-tree re-init at ``Mapper.cpp:329-347``);
4. run X-ICP scan-to-map registration (``Mapper.cpp:367-374``);
5. gate map insertion on minimum movement (``Mapper.cpp:463-469``).

Device work (reference build, registration, insertion) is jitted with fixed
shapes; the host keeps poses/cadence. When the registration declares the
problem degenerate-and-unsolvable the prior is kept
(≙ ``whetherToReturnPrior_``, ``ICP.cpp:1334-1341``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models.localizability import DegeneracyConfig
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.ops import grid_hash
from open3d_slam_jax.ops.voxel import voxel_downsample
from open3d_slam_jax.slam import submap as submap_mod


@dataclasses.dataclass(frozen=True)
class MapperConfig:
    """≙ ``MapperParameters`` (``Parameters.hpp:66-110``) — same knobs."""

    scan_voxel_size: float = 0.3  # scan processing voxel (narrow crop)
    scan_crop_radius: float = 30.0  # narrow crop for matching
    scan_capacity: int = 16384
    map_patch_radius: float = 40.0  # submap patch around robot
    reference_reinit_every: int = 10  # scans (≙ referenceCloudSettingPeriod 1 s @ 10 Hz)
    # Registration-reference capacity: the cropped patch is COMPACTED to
    # this many points (nearest-to-robot win under pressure) before normals
    # + matcher-structure build, so the rebuild cost scales with the
    # reference size rather than the full bank capacity. None = keep the
    # bank capacity (the round-3 behavior).
    ref_capacity: Optional[int] = 65536
    normals_knn: int = 8
    normals_radius: float = 1.0
    # "moments": radius-capped covariance normals in one streaming pass
    #   (the rebuild-rate production path, ~25x the knn path's speed);
    # "knn": exact-KNN covariance (≙ SurfaceNormal.cpp semantics).
    normals_method: str = "moments"
    min_movement_for_insertion: float = 0.1  # m (≙ minMovementBetweenMappingSteps)
    submap_voxel_size: float = 0.15
    submap_capacity: int = 131072
    submap_crop_radius: float = 50.0
    carving_enabled: bool = False
    icp: icp_mod.ICPConfig = dataclasses.field(
        default_factory=lambda: icp_mod.ICPConfig(
            knn=1,
            max_match_dist=0.5,
            matcher="grid",
            grid_table_size=1 << 16,
            grid_bucket_cap=48,
            trimmed_ratio=0.9,
            minimizer="point_to_plane",
            max_iterations=10,
            min_diff_rot=1e-3,
            min_diff_trans=8e-3,
            coarse_iterations=20,
            coarse_stride=4,
            candidate_refresh_every=10,
            candidate_slack=0.25,
            fast_trimming=True,
            fused_kernel=True,
            # The reference production config runs X-ICP degeneracy
            # awareness (param/icp.yaml degeneracyAwareness:
            # OptimizedEqualityConstraints with enoughInformationThreshold
            # 250 / insufficientInformationThreshold 180; ICP.cpp:2185-2446)
            # — so does the production default here: binary detection on the
            # first round, frozen thereafter; in-round iterations run the
            # fused pair-GN kernel + frozen-direction KKT.
            degeneracy=DegeneracyConfig(
                method="optimized",
                enough_information_threshold=250.0,
                insufficient_information_threshold=180.0,
            ),
        )
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def process_scan_for_matching(scan: pc.PointBatch, cfg: MapperConfig) -> pc.PointBatch:
    """Narrow crop + voxelize (≙ processForScanMatchingAndMerging,
    ``ScanToMapRegistration.cpp:57-69``). GICP additionally needs scan-side
    normals (its plane-to-plane covariances), so estimate them here."""
    d2 = jnp.sum(scan.xyz * scan.xyz, axis=-1)
    s = scan.with_mask(d2 <= cfg.scan_crop_radius**2)
    # priority_center = the sensor origin: under CAPACITY pressure (a 64k
    # scan at a fine voxel exceeds scan_capacity) retention sheds the
    # FARTHEST range bands instead of a packed-key half-space — the r4
    # half-space-retention bug class resurfaced here on the scan path and
    # biased 64k registrations into a systematic ~11% trajectory-radius
    # error (per-lap ATE bulge, tools/probe_r5_64k.py).
    s = voxel_downsample(
        s, cfg.scan_voxel_size, capacity=cfg.scan_capacity,
        priority_center=jnp.zeros(3, s.xyz.dtype),
    )
    if cfg.icp.minimizer == "gicp" and s.normals is None:
        ngrid = grid_hash.build_grid(
            s.padded_xyz(), s.mask, 2.0 * cfg.normals_radius,
            cfg.icp.grid_table_size, 32,
        )
        s = normals_mod.estimate_normals_grid(
            s, ngrid, knn=cfg.normals_knn, max_dist=cfg.normals_radius,
            orient_towards=(0.0, 0.0, 0.0),
        )
    return s


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_nearest(
    cloud: pc.PointBatch, center: jax.Array, capacity: int
) -> pc.PointBatch:
    """Compact the valid points nearest ``center`` into a ``[capacity]``
    batch (geometry only). One sort of the bank; under pressure the
    nearest points win."""
    n = cloud.capacity
    d2 = jnp.sum((cloud.xyz - center) ** 2, axis=-1)
    key = jnp.where(cloud.mask, d2, jnp.inf)
    _, order = jax.lax.sort_key_val(
        key, jnp.arange(n, dtype=jnp.int32), is_stable=True
    )
    take = order[:capacity]
    mask = cloud.mask[take]
    xyz = jnp.where(mask[:, None], cloud.xyz[take], pc.PAD_COORD)
    return pc.PointBatch(xyz=xyz, mask=mask, extras={})


@functools.partial(jax.jit, static_argnames=("capacity",))
def compact_uniform(
    cloud: pc.PointBatch, capacity: int
) -> pc.PointBatch:
    """Compact valid points into ``[capacity]`` with UNIFORM-random
    retention under pressure (deterministic index-hash priority).

    The registration-reference retention rule: a nearest-to-robot rule
    collapses the patch to a ball once the bank outgrows the capacity,
    starving X-ICP of the far structure that constrains rotation — the
    64k pipeline diverged exactly that way (ATE 15-31 m with degenerate
    flags, tools/probe_r4_64k.py) while uniform thinning keeps the crop's
    full spatial extent at reduced density (matching stays exact within
    the search radius; sensor clouds are densest near the robot anyway).
    """
    from open3d_slam_jax.ops.grid_hash import _fmix32

    n = cloud.capacity
    pri = _fmix32(jnp.arange(n, dtype=jnp.uint32)).astype(jnp.float32)
    key = jnp.where(cloud.mask, pri, jnp.inf)
    _, order = jax.lax.sort_key_val(
        key, jnp.arange(n, dtype=jnp.int32), is_stable=True
    )
    take = order[:capacity]
    mask = cloud.mask[take]
    xyz = jnp.where(mask[:, None], cloud.xyz[take], pc.PAD_COORD)
    return pc.PointBatch(xyz=xyz, mask=mask, extras={})


@functools.partial(jax.jit, static_argnames=("cfg",))
def build_map_reference(
    map_cloud: pc.PointBatch, center: jax.Array, cfg: MapperConfig
) -> icp_mod.ICPReference:
    """Crop the patch around the robot, compute normals, build the matcher
    structure — the reference re-init step (KD-tree rebuild analogue,
    ``Mapper.cpp:329-347``). Rebuild-rate cost path: patch compaction to
    ``ref_capacity`` + streaming moment normals + single-sort cell-list
    build."""
    patch = submap_mod.crop_around(map_cloud, center, cfg.map_patch_radius)
    if cfg.ref_capacity is not None and cfg.ref_capacity < patch.capacity:
        patch = compact_uniform(patch, cfg.ref_capacity)
    ngrid = grid_hash.build_grid(
        patch.padded_xyz(), patch.mask, 2.0 * cfg.normals_radius,
        cfg.icp.grid_table_size, 32,
    )
    if cfg.normals_method == "moments":
        patch = normals_mod.estimate_normals_moments(
            patch, ngrid, max_dist=cfg.normals_radius, orient_towards=center
        )
    else:
        patch = normals_mod.estimate_normals_grid(
            patch, ngrid, knn=cfg.normals_knn, max_dist=cfg.normals_radius,
            orient_towards=center,
        )
    return icp_mod.build_reference(patch, cfg.icp)


@functools.partial(jax.jit, static_argnames=("cfg",))
def scan_to_map_step(
    scan_processed: pc.PointBatch,
    ref: icp_mod.ICPReference,
    init_T: jax.Array,
    cfg: MapperConfig,
) -> icp_mod.ICPResult:
    return icp_mod.icp_single(scan_processed, ref, init_T, cfg.icp)


class Mapper:
    """Host orchestration of the scan-to-map loop (≙ ``Mapper`` object).

    Single-submap version; see SubmapCollection for the multi-submap
    lifecycle.
    """

    def __init__(self, cfg: Optional[MapperConfig] = None):
        self.cfg = cfg or MapperConfig()
        self.submap = submap_mod.create(self.cfg.submap_capacity)
        self._ref: Optional[icp_mod.ICPReference] = None
        self._scans_since_reinit = 0
        self._map_pose = np.eye(4)  # map -> range sensor (latest)
        self._last_insert_pose: Optional[np.ndarray] = None
        self._initialized = False

    @property
    def pose(self) -> np.ndarray:
        return self._map_pose.copy()

    def add_scan(self, scan: pc.PointBatch, odom_motion: np.ndarray) -> dict:
        """Process one scan. ``odom_motion``: relative odometry motion since
        the previous scan (identity if unknown). Returns a stats dict."""
        cfg = self.cfg
        processed = process_scan_for_matching(scan, cfg)

        if not self._initialized:
            T0 = jnp.asarray(self._map_pose, jnp.float32)
            self.submap = submap_mod.insert_scan(
                self.submap, processed, T0, cfg.submap_voxel_size, cfg.submap_crop_radius
            )
            self._rebuild_reference()
            self._last_insert_pose = self._map_pose.copy()
            self._initialized = True
            return dict(converged=True, inserted=True, degenerate=False)

        # Odometry-propagated initial guess (Mapper.cpp:248-260).
        guess = self._map_pose @ odom_motion
        if self._scans_since_reinit >= cfg.reference_reinit_every:
            self._rebuild_reference(center=guess[:3, 3])

        res = scan_to_map_step(
            processed, self._ref, jnp.asarray(guess, jnp.float32), cfg
        )
        finite = bool(jnp.all(jnp.isfinite(res.transform)))
        use_prior = (not finite) or (
            bool(res.degenerate) and float(res.overlap_ratio) < 0.05
        )
        new_pose = guess if use_prior else np.asarray(res.transform, np.float64)
        self._map_pose = new_pose
        self._scans_since_reinit += 1

        # Insertion gating on minimum movement (Mapper.cpp:463-469).
        inserted = False
        moved = (
            self._last_insert_pose is None
            or np.linalg.norm(new_pose[:3, 3] - self._last_insert_pose[:3, 3])
            >= cfg.min_movement_for_insertion
        )
        if moved and not use_prior:
            T = jnp.asarray(new_pose, jnp.float32)
            if cfg.carving_enabled:
                self.submap = submap_mod.carve(self.submap, processed, T)
            self.submap = submap_mod.insert_scan(
                self.submap, processed, T, cfg.submap_voxel_size, cfg.submap_crop_radius
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
        self._ref = build_map_reference(
            self.submap.cloud, jnp.asarray(center, jnp.float32), self.cfg
        )
        self._scans_since_reinit = 0

    def map_points(self) -> np.ndarray:
        cloud = self.submap.cloud
        m = np.asarray(cloud.mask)
        return np.asarray(cloud.xyz)[m]
