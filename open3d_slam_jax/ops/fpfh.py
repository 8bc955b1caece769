"""FPFH (Fast Point Feature Histograms) on device.

The reference's place recognition runs Open3D's CPU FPFH + RANSAC
(``PlaceRecognition.cpp:81-85``, ``Submap::computeFeatures``
``Submap.cpp:255-275``). This is the batched device equivalent:

- SPFH: for each point, the (alpha, phi, theta) Darboux-frame angles against
  its KNN neighbours, histogrammed into 11 bins per angle via one-hot sums
  (Rusu et al. 2009) — no scatters, pure elementwise math;
- FPFH: SPFH(p) + mean over neighbours of SPFH(n_k) / ||p - n_k||,
  L1-normalized per subhistogram, 33-dim.

Neighbour positions and normals come inlined from the grid-hash payload, so
feature computation is gather-free after the match.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops import grid_hash
from open3d_slam_jax.ops.pointcloud import PointBatch

BINS = 11
DIM = 3 * BINS


def _pair_features(p, n_p, q, n_q):
    """Darboux angles for point pairs: ``p, q [.., 3]`` with normals.

    Returns (alpha, phi, theta) each in their natural ranges:
    alpha, phi in [-1, 1] (cosines), theta in [-pi, pi].
    """
    d = q - p
    dist = jnp.linalg.norm(d, axis=-1, keepdims=True)
    du = d / jnp.maximum(dist, 1e-12)
    u = n_p
    v = jnp.cross(du, u)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    w = jnp.cross(u, v)
    alpha = jnp.sum(v * n_q, axis=-1)
    phi = jnp.sum(u * du, axis=-1)
    theta = jnp.arctan2(jnp.sum(w * n_q, axis=-1), jnp.sum(u * n_q, axis=-1))
    return alpha, phi, theta


def _hist(vals, lo, hi, valid):
    """One-hot histogram over BINS bins: ``vals [N, k]`` -> ``[N, BINS]``."""
    idx = jnp.clip(((vals - lo) / (hi - lo) * BINS).astype(jnp.int32), 0, BINS - 1)
    onehot = jax.nn.one_hot(idx, BINS, dtype=vals.dtype)
    return jnp.sum(onehot * valid[..., None].astype(vals.dtype), axis=-2)


@functools.partial(jax.jit, static_argnames=("knn",))
def compute_fpfh(
    batch: PointBatch,
    grid: grid_hash.GridHash,
    knn: int = 16,
    radius=None,
) -> jax.Array:
    """FPFH descriptors ``[N, 33]`` for all valid points.

    ``grid`` must be built over ``batch`` itself WITH normals inlined.
    """
    if batch.normals is None:
        raise ValueError("compute_fpfh requires normals")
    xyz = batch.padded_xyz()
    res = grid_hash.grid_match(grid, xyz, batch.mask, k=knn, max_dist=radius)
    valid = res.valid()  # [N, k]
    # Exclude self-matches (distance 0).
    valid = valid & (res.dists > 1e-12)

    p = xyz[:, None, :]
    n_p = batch.normals[:, None, :]
    q = res.xyz
    n_q = res.normals
    alpha, phi, theta = _pair_features(p, n_p, q, n_q)

    spfh = jnp.concatenate(
        [
            _hist(alpha, -1.0, 1.0, valid),
            _hist(phi, -1.0, 1.0, valid),
            _hist(theta, -jnp.pi, jnp.pi, valid),
        ],
        axis=-1,
    )  # [N, 33]
    counts = jnp.maximum(jnp.sum(valid, axis=-1, keepdims=True), 1)
    spfh = spfh / counts.astype(spfh.dtype)

    # FPFH aggregation: neighbours' SPFH weighted by inverse distance.
    ids = jnp.maximum(res.ids, 0)
    nb_spfh = spfh[ids]  # [N, k, 33]
    wgt = jnp.where(valid, 1.0 / jnp.sqrt(jnp.maximum(res.dists, 1e-9)), 0.0)
    wsum = jnp.maximum(jnp.sum(wgt, axis=-1, keepdims=True), 1e-9)
    agg = jnp.einsum("nk,nkd->nd", wgt / wsum, nb_spfh)
    fpfh = spfh + agg

    # L1-normalize each 11-bin subhistogram (Open3D convention: percentage).
    out = []
    for i in range(3):
        sub = fpfh[:, i * BINS : (i + 1) * BINS]
        out.append(sub / jnp.maximum(jnp.sum(sub, axis=-1, keepdims=True), 1e-9) * 100.0)
    fpfh = jnp.concatenate(out, axis=-1)
    return jnp.where(batch.mask[:, None], fpfh, 0.0)


@functools.partial(jax.jit, static_argnames=("k",))
def match_features(
    feat_a: jax.Array,
    mask_a: jax.Array,
    feat_b: jax.Array,
    mask_b: jax.Array,
    k: int = 1,
):
    """Nearest neighbours in feature space via one distance matmul.

    ``[Na, D] x [Nb, D]`` -> ids ``[Na, k]`` into b (and squared dists).
    Meant for sampled keypoint sets (hundreds-thousands).
    """
    a2 = jnp.sum(feat_a * feat_a, axis=-1, keepdims=True)
    b2 = jnp.sum(feat_b * feat_b, axis=-1)
    cross = jnp.dot(feat_a, feat_b.T, preferred_element_type=jnp.float32)
    d2 = a2 - 2.0 * cross + b2[None, :]
    d2 = jnp.where(mask_b[None, :], d2, jnp.inf)
    neg, ids = jax.lax.top_k(-d2, k)
    d = -neg
    bad = ~mask_a[:, None] | ~jnp.isfinite(d)
    return jnp.where(bad, jnp.inf, d), jnp.where(bad, -1, ids)


@functools.partial(jax.jit, static_argnames=("ratio",))
def mutual_matches(
    feat_a: jax.Array,
    mask_a: jax.Array,
    feat_b: jax.Array,
    mask_b: jax.Array,
    ratio: float | None = None,
):
    """Mutual-nearest-neighbour correspondences (Open3D's
    ``mutual_filter=True`` RANSAC option): a->b and b->a must agree.

    ``ratio``: optional Lowe distinctiveness test — keep a match only when
    its feature distance beats the second-best by the given ratio
    (``d1 < ratio * d2``). Essential in planar-dominated scenes: identical
    ground/wall features mutual-match at random and would swamp RANSAC's
    minimal samples with outliers. Returns (ids ``[Na]`` into b, mask)."""
    da, ab2 = match_features(feat_a, mask_a, feat_b, mask_b, k=2 if ratio else 1)
    _, ba = match_features(feat_b, mask_b, feat_a, mask_a, k=1)
    ab = ab2[:, 0]
    back = ba[jnp.maximum(ab, 0), 0]
    ok = (ab >= 0) & (back == jnp.arange(feat_a.shape[0])) & mask_a
    if ratio is not None:
        # Squared feature distances: d1 < ratio^2 * d2.
        ok = ok & (da[:, 0] < (ratio * ratio) * da[:, 1])
    return jnp.where(ok, ab, -1), ok
