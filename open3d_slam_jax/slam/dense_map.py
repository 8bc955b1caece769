"""Dense map — running per-voxel aggregation.

Analogue of the reference ``VoxelizedPointCloud`` (``Voxel.hpp:38-75``,
``VoxelHashMap.hpp``): the dense map stores, per occupied voxel, the running
aggregate (mean position / normal / color + count) of every point ever
inserted, independent of the sparse matching submap. The reference maintains
it in a ``denseMapWorker`` thread; here insertion is one jitted
scatter-by-key step into fixed-capacity voxel banks.

Unlike :func:`ops.voxel.voxel_downsample` (which re-aggregates a batch from
scratch), this structure is *incremental*: counts accumulate across scans so
means stay unbiased, and voxel identity is stable (open addressing on the
packed cell key with linear probing resolved at insert time).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops.pointcloud import PointBatch
from open3d_slam_jax.ops.voxel import _pack_keys


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DenseMapState:
    """Fixed-capacity voxel aggregate bank, keyed by packed cell keys."""

    key_hi: jax.Array  # [C] int32, occupied slots; MAXINT = free
    key_lo: jax.Array  # [C]
    sum_xyz: jax.Array  # [C, 3]
    sum_normal: jax.Array  # [C, 3]
    sum_color: jax.Array  # [C, 3]
    count: jax.Array  # [C] float32
    voxel_size: jax.Array  # scalar

    @property
    def capacity(self) -> int:
        return self.count.shape[0]

    def occupied(self) -> jax.Array:
        return self.count > 0


_FREE = jnp.int32(0x7FFFFFFF)


def create(capacity: int, voxel_size, dtype=jnp.float32) -> DenseMapState:
    return DenseMapState(
        key_hi=jnp.full((capacity,), _FREE, jnp.int32),
        key_lo=jnp.full((capacity,), _FREE, jnp.int32),
        sum_xyz=jnp.zeros((capacity, 3), dtype),
        sum_normal=jnp.zeros((capacity, 3), dtype),
        sum_color=jnp.zeros((capacity, 3), dtype),
        count=jnp.zeros((capacity,), dtype),
        voxel_size=jnp.asarray(voxel_size, dtype),
    )


@functools.partial(jax.jit, static_argnames=())
def insert(state: DenseMapState, scan: PointBatch, T_map_scan: jax.Array) -> DenseMapState:
    """Insert a posed scan: aggregate into existing voxels, claim free slots
    for new ones.

    Slot resolution is sort-based (no serial probing): existing keys and the
    scan's new unique keys are matched by a merge over the sorted key space;
    new keys claim free slots in order. Voxels beyond capacity are dropped
    (mask-counted, like every fixed bank in this stack).
    """
    cap = state.capacity
    posed = scan.transformed(T_map_scan)
    xyz = posed.xyz
    cell = jnp.floor(xyz / state.voxel_size).astype(jnp.int32)
    k_hi, k_lo = _pack_keys(cell)
    k_hi = jnp.where(scan.mask, k_hi, _FREE)
    k_lo = jnp.where(scan.mask, k_lo, _FREE)

    # Per-scan voxel aggregation first (one entry per distinct new cell).
    n = xyz.shape[0]
    order0 = jnp.argsort(k_lo, stable=True)
    order = order0[jnp.argsort(k_hi[order0], stable=True)]
    s_hi, s_lo = k_hi[order], k_lo[order]
    new_seg = jnp.concatenate(
        [jnp.ones((1,), bool), (s_hi[1:] != s_hi[:-1]) | (s_lo[1:] != s_lo[:-1])]
    )
    seg = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    s_mask = scan.mask[order]
    seg = jnp.where(s_mask, seg, n)
    ones = s_mask.astype(xyz.dtype)

    def seg_sum(v):
        return jax.ops.segment_sum(v, seg, num_segments=n + 1)[:n]

    agg_cnt = seg_sum(ones)
    agg_xyz = seg_sum(xyz[order] * ones[:, None])
    nrm = posed.extras.get("normals")
    agg_nrm = seg_sum(nrm[order] * ones[:, None]) if nrm is not None else jnp.zeros_like(agg_xyz)
    col = posed.extras.get("colors")
    agg_col = seg_sum(col[order] * ones[:, None]) if col is not None else jnp.zeros_like(agg_xyz)
    # Representative key per segment (first row of each run). INTEGER
    # segment sums: packed keys exceed 2^24, so routing them through f32
    # corrupts low bits (distinct cells silently merge).
    def seg_sum_i(v):
        return jax.ops.segment_sum(v, seg, num_segments=n + 1)[:n]

    agg_hi = seg_sum_i(jnp.where(new_seg, s_hi, 0))
    agg_lo = seg_sum_i(jnp.where(new_seg, s_lo, 0))
    agg_valid = agg_cnt > 0

    # Slot resolution by OPEN ADDRESSING (hash + linear probing), fully
    # vectorized: P rounds of gather-check / scatter-claim over the n scan
    # voxels. The former union-sort matching re-sorted the ENTIRE bank
    # every insert — two stable argsorts of cap+n rows ≈ 100+ ms per frame
    # at the 1M-voxel default, which single-handedly throttled the e2e
    # pipeline; probing touches O(n * P) elements instead and leaves the
    # bank unsorted (export never needs key order). Unresolved voxels
    # after P probes are dropped, like every fixed bank in this stack.
    from open3d_slam_jax.ops.grid_hash import _fmix32

    P = 16
    row_ids = jnp.arange(n, dtype=jnp.int32)
    h0 = _fmix32(
        jax.lax.bitcast_convert_type(agg_hi, jnp.uint32) * jnp.uint32(2654435761)
        + jax.lax.bitcast_convert_type(agg_lo, jnp.uint32) * jnp.uint32(805459861)
    )
    slot_p = (h0 % jnp.uint32(cap)).astype(jnp.int32)
    key_hi = state.key_hi
    key_lo = state.key_lo
    alive = agg_valid
    slot = jnp.zeros((n,), jnp.int32)
    resolved = jnp.zeros((n,), bool)
    for _ in range(P):
        cur_hi = key_hi[slot_p]
        cur_lo = key_lo[slot_p]
        hit = alive & (cur_hi == agg_hi) & (cur_lo == agg_lo)
        empty = alive & (cur_hi == _FREE) & ~hit
        # Competing claims on the same free slot: lowest row id wins.
        claim = jnp.full((cap + 1,), n, jnp.int32)
        claim = claim.at[jnp.where(empty, slot_p, cap)].min(row_ids, mode="drop")
        won = empty & (claim[slot_p] == row_ids)
        key_hi = key_hi.at[jnp.where(won, slot_p, cap)].set(agg_hi, mode="drop")
        key_lo = key_lo.at[jnp.where(won, slot_p, cap)].set(agg_lo, mode="drop")
        ok_now = hit | won
        slot = jnp.where(ok_now, slot_p, slot)
        resolved = resolved | ok_now
        alive = alive & ~ok_now
        slot_p = jnp.where(slot_p + 1 >= cap, 0, slot_p + 1)

    ok = resolved
    slot = jnp.where(ok, slot, cap)  # dropped

    wsel = ok.astype(xyz.dtype)
    sum_xyz = state.sum_xyz.at[slot].add(agg_xyz * wsel[:, None], mode="drop")
    sum_normal = state.sum_normal.at[slot].add(agg_nrm * wsel[:, None], mode="drop")
    sum_color = state.sum_color.at[slot].add(agg_col * wsel[:, None], mode="drop")
    count = state.count.at[slot].add(agg_cnt * wsel, mode="drop")

    return dataclasses.replace(
        state,
        key_hi=key_hi,
        key_lo=key_lo,
        sum_xyz=sum_xyz[:cap],
        sum_normal=sum_normal[:cap],
        sum_color=sum_color[:cap],
        count=count[:cap],
    )


def export(state: DenseMapState) -> PointBatch:
    """Materialize the aggregate means as a PointBatch."""
    denom = jnp.maximum(state.count, 1.0)[:, None]
    xyz = state.sum_xyz / denom
    mask = state.occupied()
    extras = {}
    nsum = state.sum_normal
    nn = jnp.linalg.norm(nsum, axis=-1, keepdims=True)
    extras["normals"] = jnp.where(nn > 1e-9, nsum / jnp.maximum(nn, 1e-9), 0.0)
    extras["colors"] = state.sum_color / denom
    return PointBatch(
        xyz=jnp.where(mask[:, None], xyz, 1.0e9), mask=mask, extras=extras
    )
