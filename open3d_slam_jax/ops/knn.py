"""K-nearest-neighbour search on device.

Replaces libpointmatcher's ``KDTreeMatcher`` (libnabo KD-tree,
``MatchersImpl.h:62-135``) with two fixed-shape engines:

- :func:`knn_bruteforce` — exact streaming search: the query/reference
  cross-distance matrix is produced tile-by-tile as a matmul
  (``d^2 = |q|^2 - 2 q.r + |r|^2``) with a running top-k merge, so memory
  stays O(N_q * tile). Ground truth for
  tests and small problems.
- :mod:`open3d_slam_jax.ops.grid_hash` — the production O(N) grid
  bucket search (see that module).

Semantics match the reference ``Matches`` contract (``PointMatcher.h:416-436``):
returned ``dists`` are *squared* distances, slots beyond ``max_dist`` or with
no candidate hold ``INVALID_ID`` (-1) and ``+inf`` distance. k results per
query are sorted ascending.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

INVALID_ID = -1
INF = jnp.inf


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KnnResult:
    """``dists``: squared distances ``[..., N, k]`` (inf = no match);
    ``ids``: reference indices ``[..., N, k]`` (-1 = no match)."""

    dists: jax.Array
    ids: jax.Array

    @property
    def k(self) -> int:
        return self.dists.shape[-1]

    def valid(self) -> jax.Array:
        return self.ids >= 0


def _merge_topk(d_a, i_a, d_b, i_b, k):
    """Merge two sorted-or-not candidate sets into the k smallest."""
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    neg_d, sel = jax.lax.top_k(-d, k)
    return -neg_d, jnp.take_along_axis(i, sel, axis=-1)


@functools.partial(jax.jit, static_argnames=("k", "q_tile", "r_tile"))
def knn_bruteforce(
    query_xyz: jax.Array,
    query_mask: jax.Array,
    ref_xyz: jax.Array,
    ref_mask: jax.Array,
    k: int = 1,
    max_dist: float = jnp.inf,
    q_tile: int = 2048,
    r_tile: int = 4096,
) -> KnnResult:
    """Exact KNN of ``query_xyz [N,3]`` against ``ref_xyz [M,3]``.

    ``max_dist`` is a *euclidean* radius gate (the reference matcher's
    ``maxDist``, ``MatchersImpl.cpp``); matches beyond it are invalidated.
    Masked-out queries get all-invalid rows; masked-out reference points are
    never returned.
    """
    n = query_xyz.shape[0]
    m = ref_xyz.shape[0]
    dtype = query_xyz.dtype

    n_pad = (-n) % q_tile
    q = jnp.pad(query_xyz, ((0, n_pad), (0, 0)))
    m_pad = (-m) % r_tile
    r = jnp.pad(ref_xyz, ((0, m_pad), (0, 0)))
    rmask = jnp.pad(ref_mask, (0, m_pad))
    num_r_tiles = r.shape[0] // r_tile

    r_tiles = r.reshape(num_r_tiles, r_tile, 3)
    rmask_tiles = rmask.reshape(num_r_tiles, r_tile)
    r_sq_tiles = jnp.sum(r_tiles * r_tiles, axis=-1)

    max_d2 = jnp.asarray(max_dist, dtype) ** 2

    def process_query_tile(q_blk):
        q_sq = jnp.sum(q_blk * q_blk, axis=-1, keepdims=True)  # [qt, 1]

        def scan_ref(carry, tile):
            best_d, best_i = carry
            r_blk, rm_blk, r_sq, tile_idx = tile
            # [qt, rt] squared distances via one matmul.
            cross = jnp.dot(q_blk, r_blk.T, preferred_element_type=jnp.float32)
            d2 = q_sq - 2.0 * cross + r_sq[None, :]
            d2 = jnp.maximum(d2, 0.0)
            d2 = jnp.where(rm_blk[None, :], d2, INF)
            if k == 1:
                tile_best = jnp.min(d2, axis=-1, keepdims=True)
                tile_arg = jnp.argmin(d2, axis=-1, keepdims=True) + tile_idx * r_tile
                take_new = tile_best < best_d
                best_d = jnp.where(take_new, tile_best, best_d)
                best_i = jnp.where(take_new, tile_arg, best_i)
            else:
                neg_d, arg = jax.lax.top_k(-d2, k)
                best_d, best_i = _merge_topk(
                    best_d, best_i, -neg_d, arg + tile_idx * r_tile, k
                )
            return (best_d, best_i), None

        init = (
            jnp.full((q_blk.shape[0], k), INF, dtype),
            jnp.full((q_blk.shape[0], k), 0, jnp.int32),
        )
        (best_d, best_i), _ = jax.lax.scan(
            scan_ref,
            init,
            (r_tiles, rmask_tiles, r_sq_tiles, jnp.arange(num_r_tiles)),
        )
        return best_d, best_i

    q_blocks = q.reshape(-1, q_tile, 3)
    dists, ids = jax.lax.map(process_query_tile, q_blocks)
    dists = dists.reshape(-1, k)[:n]
    ids = ids.reshape(-1, k)[:n]

    invalid = (dists > max_d2) | ~jnp.isfinite(dists) | ~query_mask[:, None]
    dists = jnp.where(invalid, INF, dists)
    ids = jnp.where(invalid, INVALID_ID, ids)
    return KnnResult(dists=dists, ids=ids)


def gather_matched(ref_values: jax.Array, ids: jax.Array) -> jax.Array:
    """Gather per-match reference attributes; invalid ids read slot 0
    (callers must mask by ``ids >= 0``)."""
    safe = jnp.maximum(ids, 0)
    return ref_values[safe]
