"""Precomputed cell candidate lists — the production matcher structure.

The 2x2x2 bucket grid (``grid_hash``) over-fetches badly when the map is
much denser than the search radius (bucket cell = 2 * radius holds tens of
points; capping drops true neighbours). The cell list moves that work to
build time, Verlet-list style:

- build: cells of side = search radius; for every occupied cell, collect ALL
  reference points within ``radius`` of any possible query in that cell
  (i.e. points in the 27-neighbourhood, distance-gated to the cell with
  margin) into a fixed-capacity payload list ``[T, C, 8]``
  (x, y, z, id, nx, ny, nz, 0);
- query: ONE contiguous row gather of the query's own cell list + pure elementwise
  distance ranking. Exact within radius (up to list overflow, which the
  build gates by *distance* so near candidates win deterministically).

Build cost is a 27x-expanded sort + scatter, amortized over the reference
re-init period exactly like the reference's KD-tree rebuild
(``Mapper.cpp:329-347``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops.grid_hash import (
    _cell_hash, _fmix32, MatchResult, _CH, _IDX_CH, _NRM,
)
from open3d_slam_jax.ops.knn import INVALID_ID, INF

_PAD = 1.0e9


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CellList:
    """``table [T, C, 8]`` payload lists; ``cell_size`` = search radius.

    ``dropped``: build-time overflow counter — the number of eligible
    (cell, point) pairs that did not fit in ``list_cap`` (distance-gated,
    so near-the-cell-center candidates always win; ≙ the recall monitoring
    the reference gets from KDTreeMatcher's visit counters). 0 means the
    lists are exact within the build radius.
    """

    table: jax.Array
    cell_size: jax.Array
    dropped: jax.Array = dataclasses.field(
        default_factory=lambda: jnp.zeros((), jnp.int32)
    )

    @property
    def list_cap(self) -> int:
        return self.table.shape[1]

    @property
    def table_size(self) -> int:
        return self.table.shape[0]


@functools.partial(jax.jit, static_argnames=("table_size", "list_cap"))
def build_cell_list(
    xyz: jax.Array,
    mask: jax.Array,
    radius,
    table_size: int = 1 << 16,
    list_cap: int = 64,
    normals: Optional[jax.Array] = None,
) -> CellList:
    """Build candidate lists for nearest-neighbour queries within ``radius``.

    A point p is listed in cell c iff ``dist(p, box(c)) <= radius`` — the
    exact condition for p to be a possible within-radius match of some query
    in c. Under capacity pressure, closest-to-cell-center points win.
    """
    if table_size > (1 << 17):
        raise ValueError(
            "cell-list table_size is limited to 2^17 (the build's composite "
            f"sort key uses 18 hash bits + 13 priority bits), got {table_size}"
        )
    m = xyz.shape[0]
    dtype = xyz.dtype
    radius = jnp.asarray(radius, dtype)
    cell = jnp.floor(xyz / radius).astype(jnp.int32)

    # 27 neighbour offsets: candidate (cell, point) pairs.
    offsets = jnp.asarray(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        jnp.int32,
    )  # [27, 3]
    tgt_cells = cell[:, None, :] + offsets[None, :, :]  # [M, 27, 3]

    # Distance from the point to the target cell's axis-aligned box
    # (eligibility) and to its center (retention priority — no ties, so
    # under capacity pressure each cell keeps a ball around its center).
    lo = tgt_cells.astype(dtype) * radius
    hi = lo + radius
    dx = jnp.maximum(jnp.maximum(lo - xyz[:, None, :], xyz[:, None, :] - hi), 0.0)
    box_d2 = jnp.sum(dx * dx, axis=-1)  # [M, 27]
    eligible = (box_d2 <= radius * radius) & mask[:, None]
    center = lo + 0.5 * radius
    ctr_d2 = jnp.sum((xyz[:, None, :] - center) ** 2, axis=-1)

    h = _cell_hash(tgt_cells, table_size)  # [M, 27]
    flat_h = jnp.where(eligible, h, table_size).reshape(-1)
    flat_d = ctr_d2.reshape(-1)

    # ONE fused stable sort over a composite 31-bit key: hash in the high
    # bits, 13-bit quantized center-distance priority in the low bits.
    # Replaces the former two stable argsorts + permutation gather over the
    # 27x-expanded pair array — the sort is the whole build (a design from
    # the first target, unmeasured on the H100). Quantization only
    # coarsens the retention priority under capacity pressure (ties within
    # ~r^2/4096 break by pair index); eligibility and recall are unchanged.
    qd = jnp.clip(
        flat_d * (8191.0 / (4.0 * radius * radius)), 0.0, 8191.0
    ).astype(jnp.int32)
    key = flat_h * 8192 + qd
    sorted_key, order = jax.lax.sort_key_val(
        key, jnp.arange(key.shape[0], dtype=jnp.int32), is_stable=True
    )
    s_h = sorted_key >> 13
    s_pt = order // 27  # flat pair index -> source point (layout [M, 27])

    # Rank within each equal-key run via cummax of run-start positions
    # (one scan instead of a searchsorted per element).
    first_flag = jnp.concatenate(
        [jnp.ones((1,), bool), s_h[1:] != s_h[:-1]]
    )
    idxs = jnp.arange(s_h.shape[0], dtype=jnp.int32)
    first_pos = jax.lax.cummax(jnp.where(first_flag, idxs, 0))
    rank = idxs - first_pos
    in_table = (s_h < table_size) & (rank < list_cap)
    slot = jnp.where(in_table, s_h * list_cap + rank, table_size * list_cap)

    payload = jnp.zeros((s_pt.shape[0], _CH), dtype)
    payload = payload.at[:, :3].set(xyz[s_pt])
    payload = payload.at[:, _IDX_CH].set(
        jax.lax.bitcast_convert_type(s_pt, jnp.float32)
    )
    if normals is not None:
        payload = payload.at[:, _NRM].set(normals[s_pt])

    empty = jnp.zeros((_CH,), dtype)
    empty = empty.at[:3].set(_PAD)
    empty = empty.at[_IDX_CH].set(
        jax.lax.bitcast_convert_type(jnp.int32(INVALID_ID), jnp.float32)
    )
    table = jnp.broadcast_to(empty, (table_size * list_cap + 1, _CH))
    table = table.at[slot].set(payload, mode="drop")
    dropped = jnp.sum(((s_h < table_size) & (rank >= list_cap)).astype(jnp.int32))
    return CellList(
        table=table[:-1].reshape(table_size, list_cap, _CH),
        cell_size=radius,
        dropped=dropped,
    )


@functools.partial(jax.jit, static_argnames=())
def gather_cell_candidates(cl: CellList, query_xyz: jax.Array, query_mask: jax.Array):
    """One row gather per query: ``rows [N, C, 8]``, ``valid [N, C]``."""
    table_size = cl.table_size
    cap = cl.list_cap
    cellq = jnp.floor(query_xyz / cl.cell_size).astype(jnp.int32)
    h = _cell_hash(cellq, table_size)
    flat = cl.table.reshape(table_size, cap * _CH)
    rows = flat[h].reshape(-1, cap, _CH)
    ids = jax.lax.bitcast_convert_type(rows[..., _IDX_CH], jnp.int32)
    valid = (ids >= 0) & query_mask[:, None]
    return rows, valid


@functools.partial(jax.jit, static_argnames=("k",))
def cell_match(
    cl: CellList,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    k: int = 1,
    max_dist=None,
) -> MatchResult:
    """Exact within-radius KNN via the precomputed lists (one gather).

    ``max_dist`` may be a scalar or a per-query ``[N]`` array (the
    KDTreeVarDistMatcher semantics — per-point search radii from a
    descriptor); per-point radii must not exceed the build radius.
    """
    from open3d_slam_jax.ops.grid_hash import match_from_candidates

    radius = cl.cell_size if max_dist is None else jnp.asarray(max_dist, query_xyz.dtype)
    rows, valid = gather_cell_candidates(cl, query_xyz, query_mask)
    return match_from_candidates(rows, valid, query_xyz, query_mask, radius, k)


# ---------------------------------------------------------------------------
# Packed 16-byte payloads: positions quantized to the cell frame (u16 per
# axis over the eligibility span), normals octahedral-encoded (2 x u16), a
# 16-bit cell checksum guarding against hash-collision mis-decoding, and the
# point index. Halves gather and cache traffic vs the 32-byte payload at
# ~23 um position / ~1e-4 rad normal resolution (radius 0.5 m).
#
# Word layout (4 x f32 bitcast):
#   w0 = xq | yq << 16          w1 = zq | oct_u << 16
#   w2 = point index (int32)    w3 = oct_v | cellcheck << 16
# ---------------------------------------------------------------------------

_CHP = 4  # packed channel count


def _cell_check(cell: jax.Array) -> jax.Array:
    """16-bit cell checksum, fully avalanched and seeded differently from
    the table hash (a weak mixer here caused STRUCTURED joint collisions:
    cells colliding in the table also collided in the checksum)."""
    c = cell.astype(jnp.uint32)
    h = _fmix32(
        c[..., 0] * jnp.uint32(0x27D4EB2F)
        + c[..., 1] * jnp.uint32(0x165667B1)
        + c[..., 2] * jnp.uint32(0x9E3779B1)
        + jnp.uint32(0xDEADBEEF)
    )
    return h & jnp.uint32(0xFFFF)


def _oct_encode(n: jax.Array):
    """Unit normals [..., 3] -> octahedral (u, v) u16."""
    l1 = jnp.sum(jnp.abs(n), axis=-1, keepdims=True)
    p = n / jnp.maximum(l1, 1e-12)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    fold_x = (1.0 - jnp.abs(py)) * jnp.sign(jnp.where(px == 0, 1.0, px))
    fold_y = (1.0 - jnp.abs(px)) * jnp.sign(jnp.where(py == 0, 1.0, py))
    u = jnp.where(pz < 0, fold_x, px)
    v = jnp.where(pz < 0, fold_y, py)
    to16 = lambda x: jnp.clip(((x + 1.0) * 0.5 * 65535.0 + 0.5), 0, 65535).astype(jnp.uint32)
    return to16(u), to16(v)


def _oct_decode(u16: jax.Array, v16: jax.Array, dtype=jnp.float32):
    u = u16.astype(dtype) / 65535.0 * 2.0 - 1.0
    v = v16.astype(dtype) / 65535.0 * 2.0 - 1.0
    z = 1.0 - jnp.abs(u) - jnp.abs(v)
    fold_u = (1.0 - jnp.abs(v)) * jnp.sign(jnp.where(u == 0, 1.0, u))
    fold_v = (1.0 - jnp.abs(u)) * jnp.sign(jnp.where(v == 0, 1.0, v))
    x = jnp.where(z < 0, fold_u, u)
    y = jnp.where(z < 0, fold_v, v)
    n = jnp.stack([x, y, z], axis=-1)
    nn = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(nn, 1e-12)


@functools.partial(jax.jit, static_argnames=("table_size", "list_cap"))
def build_cell_list_packed(
    xyz: jax.Array,
    mask: jax.Array,
    radius,
    table_size: int = 1 << 16,
    list_cap: int = 48,
    normals: Optional[jax.Array] = None,
) -> CellList:
    """Packed-payload variant of :func:`build_cell_list` (16 B/slot)."""
    if table_size > (1 << 17):
        raise ValueError(
            "cell-list table_size is limited to 2^17 (the build's composite "
            f"sort key uses 18 hash bits + 13 priority bits), got {table_size}"
        )
    m = xyz.shape[0]
    dtype = xyz.dtype
    radius = jnp.asarray(radius, dtype)
    cell = jnp.floor(xyz / radius).astype(jnp.int32)

    offsets = jnp.asarray(
        [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)],
        jnp.int32,
    )
    tgt_cells = cell[:, None, :] + offsets[None, :, :]  # [M, 27, 3]
    lo = tgt_cells.astype(dtype) * radius
    hi = lo + radius
    dx = jnp.maximum(jnp.maximum(lo - xyz[:, None, :], xyz[:, None, :] - hi), 0.0)
    box_d2 = jnp.sum(dx * dx, axis=-1)
    eligible = (box_d2 <= radius * radius) & mask[:, None]
    center = lo + 0.5 * radius
    ctr_d2 = jnp.sum((xyz[:, None, :] - center) ** 2, axis=-1)

    h = _cell_hash(tgt_cells, table_size)
    flat_h = jnp.where(eligible, h, table_size).reshape(-1)
    flat_d = ctr_d2.reshape(-1)
    flat_pt = jnp.repeat(jnp.arange(m, dtype=jnp.int32), 27)
    # Quantization frame per pair: org = cell lo - radius, span = 3 radius.
    org = (lo - radius).reshape(-1, 3)
    span = 3.0 * radius
    q = jnp.clip(
        (xyz[flat_pt] - org) / span * 65535.0 + 0.5, 0.0, 65535.0
    ).astype(jnp.uint32)
    check = _cell_check(tgt_cells.reshape(-1, 3))
    if normals is not None:
        ou, ov = _oct_encode(normals[flat_pt])
    else:
        ou = jnp.zeros_like(check)
        ov = jnp.zeros_like(check)

    w0 = q[:, 0] | (q[:, 1] << 16)
    w1 = q[:, 2] | (ou << 16)
    w2 = flat_pt.astype(jnp.uint32)
    w3 = ov | (check << 16)
    # The table stays INTEGER-typed: bitcasting packed words to f32 for
    # storage is unsafe — NaN-pattern payloads can be canonicalized by
    # copies/scatters, silently corrupting bits.
    payload = jax.lax.bitcast_convert_type(
        jnp.stack([w0, w1, w2, w3], axis=-1), jnp.int32
    )

    # Same composite-key single sort as build_cell_list (see there).
    qd = jnp.clip(
        flat_d * (8191.0 / (4.0 * radius * radius)), 0.0, 8191.0
    ).astype(jnp.int32)
    key = flat_h * 8192 + qd
    sorted_key, order = jax.lax.sort_key_val(
        key, jnp.arange(key.shape[0], dtype=jnp.int32), is_stable=True
    )
    s_h = sorted_key >> 13
    first_flag = jnp.concatenate([jnp.ones((1,), bool), s_h[1:] != s_h[:-1]])
    idxs = jnp.arange(s_h.shape[0], dtype=jnp.int32)
    rank = idxs - jax.lax.cummax(jnp.where(first_flag, idxs, 0))
    in_table = (s_h < table_size) & (rank < list_cap)
    slot = jnp.where(in_table, s_h * list_cap + rank, table_size * list_cap)

    empty = jnp.asarray([0, 0, INVALID_ID, 0], jnp.int32)
    table = jnp.broadcast_to(empty, (table_size * list_cap + 1, _CHP))
    table = table.at[slot].set(payload[order], mode="drop")
    dropped = jnp.sum(((s_h < table_size) & (rank >= list_cap)).astype(jnp.int32))
    return CellList(
        table=table[:-1].reshape(table_size, list_cap, _CHP),
        cell_size=radius,
        dropped=dropped,
    )


def _is_packed(cl: CellList) -> bool:
    return cl.table.shape[-1] == _CHP


@functools.partial(jax.jit, static_argnames=())
def gather_packed_candidates(cl: CellList, query_xyz: jax.Array, query_mask: jax.Array):
    """One row gather per query + the query's decode frame.

    Returns (rows [N, C, 4], valid [N, C], org [N, 3]) — org is the
    quantization origin of the query's OWN cell; rows whose checksum does
    not match (bucket hash collision from another cell) are invalidated.
    """
    table_size = cl.table_size
    cap = cl.list_cap
    cellq = jnp.floor(query_xyz / cl.cell_size).astype(jnp.int32)
    h = _cell_hash(cellq, table_size)
    flat = cl.table.reshape(table_size, cap * _CHP)
    rows = flat[h].reshape(-1, cap, _CHP)  # int32
    w = jax.lax.bitcast_convert_type(rows, jnp.uint32)
    ids = rows[..., 2]
    check = (w[..., 3] >> 16) & jnp.uint32(0xFFFF)
    ok_check = check == _cell_check(cellq)[:, None]
    valid = (ids >= 0) & ok_check & query_mask[:, None]
    org = cellq.astype(query_xyz.dtype) * cl.cell_size - cl.cell_size
    return rows, valid, org


@functools.partial(jax.jit, static_argnames=("k",))
def match_from_packed(
    rows: jax.Array,  # [N, C, 4]
    valid: jax.Array,  # [N, C]
    org: jax.Array,  # [N, 3] decode origin per query
    cell_size,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    max_dist,
    k: int = 1,
) -> MatchResult:
    """Re-rank packed cached candidates (the 16-byte hot path)."""
    n, cap, _ = rows.shape
    dtype = query_xyz.dtype
    radius = jnp.asarray(max_dist, dtype)
    max_d2 = radius * radius
    span = 3.0 * jnp.asarray(cell_size, dtype)

    w = jax.lax.bitcast_convert_type(rows, jnp.uint32)
    xq = (w[..., 0] & jnp.uint32(0xFFFF)).astype(dtype)
    yq = (w[..., 0] >> 16).astype(dtype)
    zq = (w[..., 1] & jnp.uint32(0xFFFF)).astype(dtype)
    scale = span / 65535.0
    cand = jnp.stack([xq, yq, zq], axis=-1) * scale + org[:, None, :]
    cand_ids = rows[..., 2]

    diff = cand - query_xyz[:, None, :]
    d2 = jnp.sum(diff * diff, axis=-1)
    d2 = jnp.where(valid & query_mask[:, None], d2, INF)

    if k == 1:
        best_d = jnp.min(d2, axis=-1, keepdims=True)
        is_min = d2 <= best_d
        first = jnp.cumsum(is_min.astype(jnp.int32), axis=-1) == 1
        pickb = is_min & first
        pick = pickb.astype(dtype)
        sel_row = jnp.sum(jnp.where(pickb[:, :, None], rows, 0), axis=1)
        best_i = jnp.sum(jnp.where(pickb, cand_ids, 0), axis=-1, keepdims=True)
        best_x = jnp.sum(cand * pick[:, :, None], axis=1)[:, None, :]
        sw = jax.lax.bitcast_convert_type(sel_row, jnp.uint32)
        ou = (sw[..., 1] >> 16) & jnp.uint32(0xFFFF)
        ov = sw[..., 3] & jnp.uint32(0xFFFF)
        best_nrm = _oct_decode(ou, ov, dtype)[:, None, :]
    else:
        neg_d, sel = jax.lax.top_k(-d2, k)
        best_d = -neg_d
        best_i = jnp.take_along_axis(cand_ids, sel, axis=-1)
        best_x = jnp.take_along_axis(cand, sel[..., None], axis=1)
        sel_rows = jnp.take_along_axis(rows, sel[..., None], axis=1)
        sw = jax.lax.bitcast_convert_type(sel_rows, jnp.uint32)
        ou = (sw[..., 1] >> 16) & jnp.uint32(0xFFFF)
        ov = sw[..., 3] & jnp.uint32(0xFFFF)
        best_nrm = _oct_decode(ou, ov, dtype)

    invalid = (best_d > max_d2) | ~jnp.isfinite(best_d) | ~query_mask[:, None]
    return MatchResult(
        dists=jnp.where(invalid, INF, best_d),
        ids=jnp.where(invalid, INVALID_ID, best_i),
        xyz=jnp.where(invalid[..., None], 0.0, best_x),
        normals=jnp.where(invalid[..., None], 0.0, best_nrm),
    )


@functools.partial(jax.jit, static_argnames=("k",))
def cell_match_packed(
    cl: CellList,
    query_xyz: jax.Array,
    query_mask: jax.Array,
    k: int = 1,
    max_dist=None,
) -> MatchResult:
    radius = cl.cell_size if max_dist is None else jnp.asarray(max_dist, query_xyz.dtype)
    rows, valid, org = gather_packed_candidates(cl, query_xyz, query_mask)
    return match_from_packed(
        rows, valid, org, cl.cell_size, query_xyz, query_mask, radius, k
    )
