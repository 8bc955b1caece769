"""Exact voxel-grid aggregation on device.

Replaces the reference's ``VoxelGridDataPointsFilter``
(``DataPointsFilters/VoxelGrid.cpp``) and the incremental
``voxelizeWithinCroppingVolume`` (``open3d_slam/src/helpers.cpp:117-192``)
with a fixed-shape sort + segment-mean:

1. quantize points to integer cells;
2. group equal cells by a *lexicographic double stable sort* of two packed
   int32 keys (exact — no hash collisions, unlike a single hashed key);
3. segment ids = prefix sum of cell-change flags;
4. per-voxel mean position / normal / any channel via ``segment_sum``;
5. scatter the first ``capacity`` voxels into a fresh padded PointBatch.

Voxel order in the output is lexicographic in (z-ish) packed keys —
deterministic, mask-padded, jit/vmap-safe.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops.pointcloud import PAD_COORD, PointBatch

# Cell coordinates are offset into [0, 2^20) per axis and packed into two
# int32 keys: key_hi = x * 2^10 + y_hi, key_lo = y_lo * 2^20 + z. 2^20 cells
# per axis at 0.05 m voxels spans +-26 km — far beyond any LiDAR map.
_AXIS_BITS = 20
_AXIS_OFFSET = 1 << (_AXIS_BITS - 1)


def _pack_keys(cell: jax.Array):
    """``[N, 3]`` int32 cells -> two int32 lexicographic keys."""
    c = jnp.clip(cell + _AXIS_OFFSET, 0, (1 << _AXIS_BITS) - 1)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    y_hi, y_lo = y >> 10, y & 0x3FF
    key_hi = x * (1 << 10) + y_hi  # < 2^30
    key_lo = y_lo * (1 << _AXIS_BITS) + z  # < 2^30
    return key_hi, key_lo


@functools.partial(jax.jit, static_argnames=("capacity",))
def voxel_downsample(
    batch: PointBatch,
    voxel_size,
    capacity: Optional[int] = None,
    priority_center=None,
) -> PointBatch:
    """Average all valid points (and their extra channels) per voxel.

    Matches the reference VoxelGrid filter's ``averageExistingValues`` mode:
    output point = centroid of the voxel's points, channels averaged
    (normals re-normalized). Output capacity defaults to the input capacity.

    ``priority_center`` (optional ``[3]``): retention priority under
    CAPACITY pressure. Without it, the surviving voxels are the first
    ``capacity`` in packed-key (spatial half-space!) order — fine when the
    output fits, but an active submap bank at capacity would silently drop
    a spatial EXTREME, unmapping whatever frontier the robot drives into
    (the 64k-pipeline divergence, tools/probe_r4_64k.py). With a center,
    voxels are ranked near-to-far in ~4.8 m distance bands so pressure
    sheds the FARTHEST geometry first — the bounded-local-map behavior of
    the reference's ``voxelizeWithinCroppingVolume``.
    """
    n = batch.capacity
    if capacity is None:
        capacity = n
    voxel_size = jnp.asarray(voxel_size, batch.xyz.dtype)

    cell = jnp.floor(batch.xyz / voxel_size).astype(jnp.int32)
    key_hi, key_lo = _pack_keys(cell)
    big = jnp.int32(0x7FFFFFFF)
    key_hi = jnp.where(batch.mask, key_hi, big)
    key_lo = jnp.where(batch.mask, key_lo, big)

    # Lexicographic sort: stable sort by minor key, then stable by major key
    # (then optionally by the distance band, as the new major key — the band
    # is a function of the CELL, so equal cells stay adjacent).
    order0 = jnp.argsort(key_lo, stable=True)
    order = order0[jnp.argsort(key_hi[order0], stable=True)]
    if priority_center is not None:
        center = jnp.asarray(priority_center, batch.xyz.dtype)
        cc = (cell.astype(batch.xyz.dtype) + 0.5) * voxel_size
        dist = jnp.linalg.norm(cc - center, axis=-1)
        band = jnp.clip(
            (dist / (32.0 * voxel_size)).astype(jnp.int32), 0, 63
        )
        band = jnp.where(batch.mask, band, jnp.int32(64))
        order = order[jnp.argsort(band[order], stable=True)]
    s_hi, s_lo = key_hi[order], key_lo[order]
    s_xyz = batch.xyz[order]
    s_mask = batch.mask[order]

    new_seg = jnp.concatenate(
        [
            jnp.ones((1,), bool),
            (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1]),
        ]
    )
    seg_id = jnp.cumsum(new_seg.astype(jnp.int32)) - 1  # [N], < N
    seg_id = jnp.where(s_mask, seg_id, capacity)  # invalid -> dropped segment

    ones = s_mask.astype(batch.xyz.dtype)
    counts = jax.ops.segment_sum(ones, seg_id, num_segments=capacity + 1)[:capacity]
    sums = jax.ops.segment_sum(
        s_xyz * ones[:, None], seg_id, num_segments=capacity + 1
    )[:capacity]
    out_mask = counts > 0
    denom = jnp.maximum(counts, 1.0)[:, None]
    out_xyz = jnp.where(out_mask[:, None], sums / denom, PAD_COORD)

    extras = {}
    for name, vals in batch.extras.items():
        s_vals = vals[order]
        vsum = jax.ops.segment_sum(
            s_vals * ones[:, None], seg_id, num_segments=capacity + 1
        )[:capacity]
        avg = vsum / denom
        if name == "normals":
            norm = jnp.linalg.norm(avg, axis=-1, keepdims=True)
            avg = avg / jnp.maximum(norm, 1e-12)
        extras[name] = jnp.where(out_mask[:, None], avg, 0.0)

    return PointBatch(xyz=out_xyz, mask=out_mask, extras=extras)


@functools.partial(jax.jit, static_argnames=())
def voxel_first_point(batch: PointBatch, voxel_size) -> PointBatch:
    """Keep (mask in) only the first valid point of each voxel — the cheap
    "use first point" policy of the reference VoxelGrid filter. Preserves the
    input layout (no re-ordering), so extras stay untouched."""
    voxel_size = jnp.asarray(voxel_size, batch.xyz.dtype)
    cell = jnp.floor(batch.xyz / voxel_size).astype(jnp.int32)
    key_hi, key_lo = _pack_keys(cell)
    big = jnp.int32(0x7FFFFFFF)
    key_hi = jnp.where(batch.mask, key_hi, big)
    key_lo = jnp.where(batch.mask, key_lo, big)

    order0 = jnp.argsort(key_lo, stable=True)
    order = order0[jnp.argsort(key_hi[order0], stable=True)]
    s_hi, s_lo = key_hi[order], key_lo[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])]
    )
    keep_sorted = first & batch.mask[order]
    keep = jnp.zeros_like(batch.mask).at[order].set(keep_sorted)
    return batch.with_mask(keep)
