"""Submaps as fixed-capacity device point banks.

Analogue of the reference ``Submap`` (``Submap.cpp``): one local map anchored
at a pose, grown by inserting registered scans, bounded by voxel aggregation
and cropping, optionally space-carved. All mutation is functional: a jitted
``insert_scan`` produces the next bank from (bank, scan, pose) with static
shapes — the device replacement for the mutex-guarded concat/voxelize of the
reference (``Submap.cpp:39-157``).

Space carving (``helpers.cpp:238-318``): a map point is erased if the new
scan sees *through* it — i.e. some ray of the scan passes close to the point
and terminates well behind it. Implemented as an angular grid-hash KNN over
unit ray directions + a range comparison: fully vectorized, no voxel raycast
loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import grid_hash
from open3d_slam_jax.ops.pointcloud import PAD_COORD, PointBatch
from open3d_slam_jax.ops.voxel import voxel_downsample


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SubmapState:
    """Device state of one submap (map-frame points)."""

    cloud: PointBatch  # point bank, capacity fixed
    pose: jax.Array  # [4, 4] submap anchor pose in map frame
    num_scans: jax.Array  # int32


def create(capacity: int, pose: Optional[jax.Array] = None, dtype=jnp.float32) -> SubmapState:
    cloud = PointBatch(
        xyz=jnp.full((capacity, 3), PAD_COORD, dtype),
        mask=jnp.zeros((capacity,), bool),
        extras={},
    )
    if pose is None:
        pose = jnp.eye(4, dtype=dtype)
    return SubmapState(cloud=cloud, pose=pose, num_scans=jnp.asarray(0, jnp.int32))


@functools.partial(jax.jit, static_argnames=("scan_voxel_capacity",))
def insert_scan(
    state: SubmapState,
    scan: PointBatch,
    T_map_scan: jax.Array,
    voxel_size,
    crop_radius,
    scan_voxel_capacity: Optional[int] = None,
) -> SubmapState:
    """Insert a registered scan (≙ ``Submap::insertScan``):

    1. transform scan to map frame;
    2. crop to ``crop_radius`` around the scan origin (the submap's local
       working volume, ≙ the mapBuilderCropBox);
    3. concat with the bank and voxel-aggregate back to bank capacity —
       the fixed-shape equivalent of ``voxelizeWithinCroppingVolume``.

    Under ``capacity`` pressure, voxels are retained near-to-far from the
    scan origin (``voxel_downsample(priority_center=...)``): the bank
    sheds its farthest geometry first, keeping the frontier the robot is
    driving into mapped (the bounded-local-map behavior of the
    reference's crop-volume voxelizer).
    """
    cap = state.cloud.capacity
    posed = scan.transformed(T_map_scan)
    origin = T_map_scan[:3, 3]
    d2 = jnp.sum((posed.xyz - origin) ** 2, axis=-1)
    posed = posed.with_mask(d2 <= jnp.asarray(crop_radius) ** 2)

    # Drop extra channels the bank doesn't carry (bank stores geometry only;
    # normals are recomputed per reference re-init, like the reference's
    # periodic initReference path).
    posed = dataclasses.replace(posed, extras={})
    bank = dataclasses.replace(state.cloud, extras={})

    merged = PointBatch(
        xyz=jnp.concatenate([bank.xyz, posed.xyz], axis=0),
        mask=jnp.concatenate([bank.mask, posed.mask], axis=0),
        extras={},
    )
    new_cloud = voxel_downsample(
        merged, voxel_size, capacity=cap, priority_center=origin
    )
    return dataclasses.replace(
        state, cloud=new_cloud, num_scans=state.num_scans + 1
    )


@functools.partial(jax.jit, static_argnames=("table_size", "bucket_cap"))
def carve(
    state: SubmapState,
    scan: PointBatch,
    T_map_scan: jax.Array,
    angle_tol: float = 0.01,
    range_margin: float = 0.3,
    max_range: float = 60.0,
    table_size: int = 1 << 14,
    bucket_cap: int = 16,
) -> SubmapState:
    """Space carving (≙ ``getIdxsOfCarvedPoints``): erase bank points the new
    scan proves to be free space.

    For each bank point p (sensor at o): find the scan ray with the closest
    direction (KNN over unit direction vectors, radius = angle_tol in chord
    units); if that ray's measured range exceeds ``|p - o| + range_margin``,
    the sensor saw through p => clear its mask bit.
    """
    o = T_map_scan[:3, 3]
    scan_map = se3.apply_transform(T_map_scan, scan.xyz)
    ray = scan_map - o
    rng = jnp.linalg.norm(ray, axis=-1)
    dirs = ray / jnp.maximum(rng[:, None], 1e-9)
    dirs = jnp.where(scan.mask[:, None], dirs, PAD_COORD)

    grid = grid_hash.build_grid(dirs, scan.mask, 2.0 * angle_tol, table_size, bucket_cap)

    v = state.cloud.xyz - o
    vr = jnp.linalg.norm(v, axis=-1)
    vdirs = v / jnp.maximum(vr[:, None], 1e-9)
    vdirs = jnp.where(state.cloud.mask[:, None], vdirs, PAD_COORD)

    res = grid_hash.grid_knn(grid, dirs, vdirs, state.cloud.mask, k=1, max_dist=angle_tol)
    matched = res.ids[:, 0] >= 0
    ray_range = rng[jnp.maximum(res.ids[:, 0], 0)]
    seen_through = matched & (ray_range > vr + range_margin) & (vr < max_range)
    new_cloud = state.cloud.with_mask(~seen_through)
    return dataclasses.replace(state, cloud=new_cloud)


@functools.partial(jax.jit, static_argnames=())
def transform_submap(state: SubmapState, T: jax.Array) -> SubmapState:
    """Rigidly move a submap after pose-graph optimization
    (≙ ``Submap::transform``, ``Submap.cpp:115-128``)."""
    return dataclasses.replace(
        state,
        cloud=state.cloud.transformed(T),
        pose=T @ state.pose,
    )


def crop_around(cloud: PointBatch, center: jax.Array, radius) -> PointBatch:
    """Radius crop used to cut the matching patch around the robot
    (≙ ``ScanToMapRegistration::cropSubmap``, ``ScanToMapRegistration.cpp:90-96``)."""
    d2 = jnp.sum((cloud.xyz - center) ** 2, axis=-1)
    return cloud.with_mask(d2 <= jnp.asarray(radius) ** 2)
