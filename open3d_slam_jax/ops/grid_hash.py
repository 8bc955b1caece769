"""Device spatial grid hash — the fixed-shape replacement for both the libnabo
KD-tree (``MatchersImpl.cpp``, KNN correspondence search) and the CPU
``VoxelHashMap`` (``open3d_slam/include/open3d_slam/VoxelHashMap.hpp``).

Design
------
No pointer chasing and no per-point gathers. The "tree build" is one argsort
plus one scatter that packs each point's *payload* — position, index, and
optionally its normal — directly into a dense bucket table:

    table[T, C, 8] = [x, y, z, bitcast(index), nx, ny, nz, 0]

A KNN query hashes the 2x2x2 block of cells nearest each query point
(cell size = 2 * search radius covers the radius exactly) and fetches the
8 candidate buckets as **contiguous 256-byte row gathers** — the layout is
chosen so the hot loop never does a scattered per-point load; distances are
then pure elementwise math against in-register candidates. Hash collisions only add
false candidates (rejected by true distance); bucket overflow (> C points)
drops the excess, which tests bound statistically.

Build: O(M log M) bitonic sort + O(M) scatter. Query: 8 row gathers + fused
arithmetic per query. Everything static-shape and jit/vmap-safe.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops.knn import INVALID_ID, INF, KnnResult, _merge_topk

# Teschner-style spatial hash primes (large odd primes, standard choice).
_P1 = jnp.uint32(2654435761)
_P2 = jnp.uint32(805459861)
_P3 = jnp.uint32(3674653429)

_PAD = 1.0e9  # coordinate pushed far away for empty slots

# Payload channel layout.
_CH = 8
_IDX_CH = 3
_NRM = slice(4, 7)


def _fmix32(h: jax.Array) -> jax.Array:
    """murmur3 finalizer: full avalanche so nearby cells decorrelate."""
    h = h ^ (h >> 16)
    h = h * jnp.uint32(0x85EBCA6B)
    h = h ^ (h >> 13)
    h = h * jnp.uint32(0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def _cell_hash(cell: jax.Array, table_size: int) -> jax.Array:
    """Hash ``[..., 3]`` int32 cell coords into ``[0, table_size)``."""
    c = cell.astype(jnp.uint32)
    h = _fmix32(c[..., 0] * _P1 + c[..., 1] * _P2 + c[..., 2] * _P3)
    return (h % jnp.uint32(table_size)).astype(jnp.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridHash:
    """Built spatial hash: payload table ``[T, C, 8]`` + cell size."""

    table: jax.Array
    cell_size: jax.Array
    has_normals: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def bucket_cap(self) -> int:
        return self.table.shape[1]

    @property
    def table_size(self) -> int:
        return self.table.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MatchResult:
    """KNN result with inlined payloads (no follow-up gathers needed).

    ``dists [N, k]`` squared (inf invalid), ``ids [N, k]`` (-1 invalid),
    ``xyz [N, k, 3]`` matched positions, ``normals [N, k, 3]`` matched
    normals (zeros when the grid was built without them).
    """

    dists: jax.Array
    ids: jax.Array
    xyz: jax.Array
    normals: jax.Array

    def valid(self) -> jax.Array:
        return self.ids >= 0

    def knn_result(self) -> KnnResult:
        return KnnResult(dists=self.dists, ids=self.ids)


@functools.partial(jax.jit, static_argnames=("table_size", "bucket_cap"))
def build_grid(
    xyz: jax.Array,
    mask: jax.Array,
    cell_size,
    table_size: int = 1 << 16,
    bucket_cap: int = 16,
    normals: Optional[jax.Array] = None,
) -> GridHash:
    """Hash ``xyz [M, 3]`` (mask-valid points only) into a GridHash.

    Pass ``normals [M, 3]`` to inline them in the payload so matching
    returns them for free (the scan-to-map hot path).
    """
    m = xyz.shape[0]
    cell_size = jnp.asarray(cell_size, xyz.dtype)
    cell = jnp.floor(xyz / cell_size).astype(jnp.int32)
    hkey = _cell_hash(cell, table_size)
    # Invalid points hash to the out-of-range sentinel bucket.
    hkey = jnp.where(mask, hkey, table_size)

    order = jnp.argsort(hkey)
    sorted_keys = hkey[order]
    # Rank of each sorted point within its equal-key run.
    # Rank within each equal-key run via cummax of run-start positions
    # (one scan instead of a searchsorted per element).
    first_flag = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    idxs = jnp.arange(sorted_keys.shape[0], dtype=jnp.int32)
    first_pos = jax.lax.cummax(jnp.where(first_flag, idxs, 0))
    rank = idxs - first_pos

    in_table = (sorted_keys < table_size) & (rank < bucket_cap)
    slot_idx = jnp.where(
        in_table, sorted_keys * bucket_cap + rank, table_size * bucket_cap
    )

    payload = jnp.zeros((m, _CH), xyz.dtype)
    payload = payload.at[:, :3].set(xyz[order])
    payload = payload.at[:, _IDX_CH].set(
        jax.lax.bitcast_convert_type(order.astype(jnp.int32), jnp.float32)
    )
    if normals is not None:
        payload = payload.at[:, _NRM].set(normals[order])

    empty = jnp.zeros((_CH,), xyz.dtype)
    empty = empty.at[:3].set(_PAD)
    empty = empty.at[_IDX_CH].set(
        jax.lax.bitcast_convert_type(jnp.int32(INVALID_ID), jnp.float32)
    )
    table = jnp.broadcast_to(empty, (table_size * bucket_cap + 1, _CH))
    table = table.at[slot_idx].set(payload, mode="drop")
    return GridHash(
        table=table[:-1].reshape(table_size, bucket_cap * _CH).reshape(table_size, bucket_cap, _CH),
        cell_size=cell_size,
        has_normals=normals is not None,
    )


@functools.partial(jax.jit, static_argnames=("k",))
def grid_match(
    grid: GridHash,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    k: int = 1,
    max_dist=None,
) -> MatchResult:
    """KNN within radius ``max_dist`` (<= cell_size / 2; None = cell/2),
    payloads inlined. The production matcher hot path."""
    n = query_xyz.shape[0]
    dtype = query_xyz.dtype
    cap = grid.bucket_cap
    table_size = grid.table_size
    s = grid.cell_size
    radius = s * 0.5 if max_dist is None else jnp.asarray(max_dist, dtype)
    max_d2 = radius * radius

    u = query_xyz / s
    base_cell = jnp.floor(u).astype(jnp.int32)
    frac = u - jnp.floor(u)
    step = jnp.where(frac < 0.5, -1, 1).astype(jnp.int32)  # [N, 3]

    # The 8 neighbor-cell hashes; a bucket shared by two blocks (hash
    # collision) is visited once or its candidates would duplicate in top-k.
    hashes = []
    for bits in range(8):
        offs = jnp.array([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1], jnp.int32)
        cell = base_cell + step * offs[None, :]
        hashes.append(_cell_hash(cell, table_size))

    flat = grid.table.reshape(table_size, cap * _CH)

    best_d = jnp.full((n, k), INF, dtype)
    best_i = jnp.full((n, k), INVALID_ID, jnp.int32)
    best_x = jnp.zeros((n, k, 3), dtype)
    best_nrm = jnp.zeros((n, k, 3), dtype)

    # Process block-by-block: keeps live intermediates at [N, C] so XLA can
    # pipeline gather + elementwise math without re-streaming a [N, 8C] buffer.
    for bits in range(8):
        h = hashes[bits]
        seen = jnp.zeros((n,), bool)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        # ONE contiguous row gather per block: [N, C * 8] -> candidates.
        rows = flat[h].reshape(n, cap, _CH)
        cand_xyz = rows[..., :3]
        cand_ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)
        # Elementwise distance: broadcast subtract, no batched matmul.
        diff = cand_xyz - query_xyz[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        d2 = jnp.where((cand_ids >= 0) & ~seen[:, None], d2, INF)
        if k == 1:
            blk_best = jnp.min(d2, axis=-1, keepdims=True)  # [N, 1]
            # One-hot pick of the (first) argmin row — no gathers.
            is_min = d2 <= blk_best
            first = jnp.cumsum(is_min.astype(jnp.int32), axis=-1) == 1
            pick = (is_min & first).astype(dtype)
            sel_row = jnp.sum(rows * pick[:, :, None], axis=1)
            sel_id = jnp.sum(
                jnp.where(is_min & first, cand_ids, 0), axis=-1, keepdims=True
            )
            take = blk_best < best_d  # [N, 1]
            best_d = jnp.where(take, blk_best, best_d)
            best_i = jnp.where(take, sel_id, best_i)
            best_x = jnp.where(take[..., None], sel_row[:, None, :3], best_x)
            best_nrm = jnp.where(take[..., None], sel_row[:, None, _NRM], best_nrm)
        else:
            kk = min(k, cap)
            neg_d, sel = jax.lax.top_k(-d2, kk)
            sel_ids = jnp.take_along_axis(cand_ids, sel, axis=-1)
            sel_rows = jnp.take_along_axis(rows, sel[..., None], axis=1)
            d_cat = jnp.concatenate([best_d, -neg_d], axis=-1)
            i_cat = jnp.concatenate([best_i, sel_ids], axis=-1)
            x_cat = jnp.concatenate([best_x, sel_rows[..., :3]], axis=1)
            n_cat = jnp.concatenate([best_nrm, sel_rows[..., _NRM]], axis=1)
            neg_top, order = jax.lax.top_k(-d_cat, k)
            best_d = -neg_top
            best_i = jnp.take_along_axis(i_cat, order, axis=-1)
            best_x = jnp.take_along_axis(x_cat, order[..., None], axis=1)
            best_nrm = jnp.take_along_axis(n_cat, order[..., None], axis=1)

    invalid = (best_d > max_d2) | ~jnp.isfinite(best_d) | ~query_mask[:, None]
    return MatchResult(
        dists=jnp.where(invalid, INF, best_d),
        ids=jnp.where(invalid, INVALID_ID, best_i),
        xyz=jnp.where(invalid[..., None], 0.0, best_x),
        normals=jnp.where(invalid[..., None], 0.0, best_nrm),
    )


@functools.partial(jax.jit, static_argnames=())
def grid_moments(
    grid: GridHash,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    max_dist,
):
    """Within-radius neighborhood MOMENTS per query: one streaming pass.

    Returns ``(count [N], mean [N, 3], cov [N, 3, 3])`` over all table
    points within ``max_dist`` of each query (the query itself included if
    it is in the table); ``mean`` is QUERY-CENTERED (add the query position
    to get the map-frame neighborhood centroid). No top-k, no ``take_along_axis`` — each of the 8
    candidate blocks is a contiguous row gather followed by masked elementwise
    accumulation of (1, x, x xᵀ), so the pass runs at gather/stream rate.
    This is the production normals path for the map-reference rebuild: a
    radius-capped covariance replaces the reference's exact-KNN covariance
    (``DataPointsFilters/SurfaceNormal.cpp`` knn -> cov) with MORE samples
    per point at a fraction of the cost — the top-k selection the KNN
    variant needs was measured at 365 ms for 131k points (k=8) while this
    pass is bounded by the same gather traffic as a k=1 match.
    """
    n = query_xyz.shape[0]
    dtype = query_xyz.dtype
    cap = grid.bucket_cap
    table_size = grid.table_size
    radius = jnp.asarray(max_dist, dtype)
    max_d2 = radius * radius

    u = query_xyz / grid.cell_size
    base_cell = jnp.floor(u).astype(jnp.int32)
    frac = u - jnp.floor(u)
    step = jnp.where(frac < 0.5, -1, 1).astype(jnp.int32)

    hashes = []
    for bits in range(8):
        offs = jnp.array([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1], jnp.int32)
        hashes.append(_cell_hash(base_cell + step * offs[None, :], table_size))

    flat = grid.table.reshape(table_size, cap * _CH)
    cnt = jnp.zeros((n,), dtype)
    s1 = jnp.zeros((n, 3), dtype)
    s2 = jnp.zeros((n, 6), dtype)  # xx, yy, zz, xy, xz, yz packed

    for bits in range(8):
        h = hashes[bits]
        seen = jnp.zeros((n,), bool)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        rows = flat[h].reshape(n, cap, _CH)
        cand = rows[..., :3]
        ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)
        # Moments are accumulated in QUERY-CENTERED coordinates (|diff| <=
        # radius): covariance is translation-invariant, and raw map-frame
        # coordinates (~1e2 m) would lose ~3 digits of the ~1e-2 variances
        # to f32 cancellation in E[x^2] - mu^2.
        diff = cand - query_xyz[:, None, :]
        d2 = jnp.sum(diff * diff, axis=-1)
        w = ((ids >= 0) & ~seen[:, None] & (d2 <= max_d2)).astype(dtype)
        cnt = cnt + jnp.sum(w, axis=-1)
        s1 = s1 + jnp.einsum("nc,nci->ni", w, diff)
        x, y, z = diff[..., 0], diff[..., 1], diff[..., 2]
        s2 = s2 + jnp.stack(
            [
                jnp.sum(w * x * x, axis=-1),
                jnp.sum(w * y * y, axis=-1),
                jnp.sum(w * z * z, axis=-1),
                jnp.sum(w * x * y, axis=-1),
                jnp.sum(w * x * z, axis=-1),
                jnp.sum(w * y * z, axis=-1),
            ],
            axis=-1,
        )

    c = jnp.maximum(cnt, 1.0)
    mean = s1 / c[:, None]  # query-centered neighborhood mean
    mx, my, mz = mean[..., 0], mean[..., 1], mean[..., 2]
    cxx = s2[..., 0] / c - mx * mx
    cyy = s2[..., 1] / c - my * my
    czz = s2[..., 2] / c - mz * mz
    cxy = s2[..., 3] / c - mx * my
    cxz = s2[..., 4] / c - mx * mz
    cyz = s2[..., 5] / c - my * mz
    cov = jnp.stack(
        [
            jnp.stack([cxx, cxy, cxz], axis=-1),
            jnp.stack([cxy, cyy, cyz], axis=-1),
            jnp.stack([cxz, cyz, czz], axis=-1),
        ],
        axis=-2,
    )
    valid = query_mask & (cnt >= 1.0)
    return jnp.where(valid, cnt, 0.0), mean, cov


@functools.partial(jax.jit, static_argnames=())
def gather_candidates(grid: GridHash, query_xyz: jax.Array, query_mask: jax.Array):
    """Fetch the 2x2x2 candidate payloads once: ``rows [N, 8C, 8]``,
    ``valid [N, 8C]`` (duplicate buckets + empty slots already invalidated).

    The refresh step of candidate caching: matching against these rows is
    EXACT for any query displacement up to the grid's slack margin
    (cell_size / 2 - search radius), so an ICP inner loop can re-rank the
    cached candidates for several iterations without touching the table.
    """
    n = query_xyz.shape[0]
    cap = grid.bucket_cap
    table_size = grid.table_size
    u = query_xyz / grid.cell_size
    base_cell = jnp.floor(u).astype(jnp.int32)
    frac = u - jnp.floor(u)
    step = jnp.where(frac < 0.5, -1, 1).astype(jnp.int32)

    hashes = []
    for bits in range(8):
        offs = jnp.array([(bits >> 2) & 1, (bits >> 1) & 1, bits & 1], jnp.int32)
        hashes.append(_cell_hash(base_cell + step * offs[None, :], table_size))

    flat = grid.table.reshape(table_size, cap * _CH)
    rows_out = []
    valid_out = []
    for bits in range(8):
        h = hashes[bits]
        seen = jnp.zeros((n,), bool)
        for prev in range(bits):
            seen = seen | (h == hashes[prev])
        rows = flat[h].reshape(n, cap, _CH)
        ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)
        valid = (ids >= 0) & ~seen[:, None] & query_mask[:, None]
        rows_out.append(rows)
        valid_out.append(valid)
    return jnp.concatenate(rows_out, axis=1), jnp.concatenate(valid_out, axis=1)


@functools.partial(jax.jit, static_argnames=("k",))
def match_from_candidates(
    rows: jax.Array,  # [N, M, 8] cached payloads
    valid: jax.Array,  # [N, M]
    query_xyz: jax.Array,
    query_mask: jax.Array,
    max_dist,
    k: int = 1,
) -> MatchResult:
    """Re-rank cached candidates for the current query positions.

    One streaming pass over the cache — no gathers. Semantically identical
    to :func:`grid_match` while the queries stay within the slack margin.
    """
    n, m, _ = rows.shape
    dtype = query_xyz.dtype
    # Scalar or per-query [N] radii (KDTreeVarDistMatcher semantics).
    radius = jnp.asarray(max_dist, dtype)
    max_d2 = (radius * radius).reshape(-1, 1) if radius.ndim == 1 else radius * radius

    diff = rows[..., :3] - query_xyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid, d2, INF)
    cand_ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)

    if k == 1:
        best_d = jnp.min(d2, axis=-1, keepdims=True)
        is_min = d2 <= best_d
        first = jnp.cumsum(is_min.astype(jnp.int32), axis=-1) == 1
        pick = (is_min & first).astype(dtype)
        sel_row = jnp.sum(rows * pick[:, :, None], axis=1)
        best_i = jnp.sum(jnp.where(is_min & first, cand_ids, 0), axis=-1, keepdims=True)
        best_x = sel_row[:, None, :3]
        best_nrm = sel_row[:, None, _NRM]
    else:
        # Iterative argmin + one-hot reduction: k passes of [N, M]
        # min/select re-stream ``rows`` instead of gathering winner rows
        # with take_along_axis (chosen on the first target; unmeasured on
        # the H100).
        iota = jax.lax.broadcasted_iota(jnp.int32, d2.shape, 1)
        d = d2
        ds, is_, xs, ns = [], [], [], []
        for _ in range(k):
            am = jnp.argmin(d, axis=-1)
            pick = iota == am[:, None]
            pf = pick.astype(dtype)
            ds.append(jnp.min(d, axis=-1))
            is_.append(jnp.sum(jnp.where(pick, cand_ids, 0), axis=-1))
            sel_row = jnp.sum(rows * pf[:, :, None], axis=1)
            xs.append(sel_row[:, :3])
            ns.append(sel_row[:, _NRM])
            d = jnp.where(pick, INF, d)
        best_d = jnp.stack(ds, axis=-1)
        best_i = jnp.stack(is_, axis=-1)
        best_x = jnp.stack(xs, axis=1)
        best_nrm = jnp.stack(ns, axis=1)

    invalid = (best_d > max_d2) | ~jnp.isfinite(best_d) | ~query_mask[:, None]
    return MatchResult(
        dists=jnp.where(invalid, INF, best_d),
        ids=jnp.where(invalid, INVALID_ID, best_i),
        xyz=jnp.where(invalid[..., None], 0.0, best_x),
        normals=jnp.where(invalid[..., None], 0.0, best_nrm),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def match_candidates_masked(
    rows: jax.Array,  # [N, M, 8] cached payloads
    valid: jax.Array,  # [N, M]
    query_xyz: jax.Array,
    query_mask: jax.Array,
    max_dist,
    k: int = 1,
) -> MatchResult:
    """Candidate-major re-rank: top-k as a MASK, no row gathers.

    Returns a MatchResult whose pair axis is the full candidate capacity M
    (not k): non-top-k / out-of-radius slots carry INF dist / INVALID id /
    zero payloads. The SET of surviving pairs is identical to
    :func:`match_from_candidates` (k nearest within the radius), but the
    layout keeps every consumer a fused streaming pass over ``rows``:
    masking instead of gathering the selected rows removes the
    ``take_along_axis`` entirely (chosen on the first target; unmeasured on
    the H100).
    Weighted LS downstream is unchanged: masked pairs get weight zero.
    """
    dtype = query_xyz.dtype
    radius = jnp.asarray(max_dist, dtype)
    max_d2 = (radius * radius).reshape(-1, 1) if radius.ndim == 1 else radius * radius

    diff = rows[..., :3] - query_xyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid, d2, INF)
    cand_ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)

    if k < rows.shape[1]:
        # k-th smallest distance per query = selection threshold. Ties at
        # the threshold admit a few extra equal-distance pairs (harmless
        # for weighted LS).
        neg_topk, _ = jax.lax.top_k(-d2, k)
        kth = -neg_topk[:, k - 1]
        sel = d2 <= kth[:, None]
    else:
        sel = jnp.ones_like(valid)

    invalid = ~sel | (d2 > max_d2) | ~query_mask[:, None]
    return MatchResult(
        dists=jnp.where(invalid, INF, d2),
        ids=jnp.where(invalid, INVALID_ID, cand_ids),
        xyz=jnp.where(invalid[..., None], 0.0, rows[..., :3]),
        normals=jnp.where(invalid[..., None], 0.0, rows[..., _NRM]),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def grid_knn(
    grid: GridHash,
    ref_xyz: jax.Array,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    k: int = 1,
    max_dist=None,
) -> KnnResult:
    """Compatibility wrapper returning only (dists, ids). ``ref_xyz`` is
    unused (payloads are inlined in the table) and kept for API parity."""
    res = grid_match(grid, query_xyz, query_mask, k=k, max_dist=max_dist)
    return res.knn_result()
