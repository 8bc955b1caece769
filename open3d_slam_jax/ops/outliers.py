"""Per-correspondence outlier weights.

Fixed-shape counterparts of libpointmatcher's ``OutlierFilters``
(``OutlierFiltersImpl.h:59-223``, impl ``OutlierFiltersImpl.cpp``). Each
function maps squared match distances ``[..., N, k]`` (+ a validity mask) to
multiplicative weights; filters compose by elementwise product exactly like
the reference chain (``ICP.cpp`` applies them in sequence).

All quantiles follow the reference's nth-element semantics via
:func:`masked_quantile`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops.pointcloud import masked_quantile


def _flat_quantile(dists, valid, q):
    """Quantile over all valid entries of ``[N, k]`` (reference pools all
    knn matches together, ``Matches::getDistsQuantile``)."""
    flat = dists.reshape(-1)
    vflat = valid.reshape(-1)
    return masked_quantile(flat, vflat, q)


def trimmed_dist(dists: jax.Array, valid: jax.Array, ratio: float) -> jax.Array:
    """TrimmedDistOutlierFilter: binary weight ``dist <= quantile(ratio)``."""
    limit = _flat_quantile(dists, valid, ratio)
    return ((dists <= limit) & valid).astype(dists.dtype)


def var_trimmed_dist(
    dists: jax.Array,
    valid: jax.Array,
    min_ratio: float = 0.05,
    max_ratio: float = 0.99,
    lam: float = 0.95,
) -> jax.Array:
    """VarTrimmedDistOutlierFilter: pick the inlier ratio minimizing
    Chetverikov's FRMSD ``mean(d^2[:r]) / ratio^(2 lambda)``
    (``optimizeInlierRatio``, ``OutlierFiltersImpl.cpp:180-215``), then trim
    at the optimal ratio's distance."""
    flat = dists.reshape(-1)
    vflat = valid.reshape(-1)
    n = flat.shape[0]
    big = jnp.asarray(jnp.finfo(dists.dtype).max, dists.dtype)
    # Sort valid squared dists ascending; invalid pushed to the end as 0
    # contribution to the cumsum (masked) but excluded from the range.
    svals = jnp.sort(jnp.where(vflat, flat, big))
    count = jnp.maximum(jnp.sum(vflat.astype(jnp.int32)), 1)
    csum = jnp.cumsum(jnp.where(jnp.arange(n) < count, svals, 0.0))
    ids = jnp.arange(1, n + 1, dtype=dists.dtype)
    ratio = ids / count.astype(dists.dtype)
    frms = csum / ids / jnp.maximum(ratio, 1e-9) ** (2.0 * lam)
    in_range = (ratio >= min_ratio) & (ratio <= max_ratio) & (jnp.arange(n) < count)
    best = jnp.argmin(jnp.where(in_range, frms, big))
    limit = svals[best]
    return ((dists <= limit) & valid).astype(dists.dtype)


def median_dist(dists: jax.Array, valid: jax.Array, factor: float) -> jax.Array:
    """MedianDistOutlierFilter: keep dists <= factor * median."""
    med = _flat_quantile(dists, valid, 0.5)
    return ((dists <= factor * med) & valid).astype(dists.dtype)


def max_dist_weight(dists: jax.Array, valid: jax.Array, max_dist: float) -> jax.Array:
    """MaxDistOutlierFilter (squared-distance gate at max_dist metres)."""
    return ((dists <= max_dist**2) & valid).astype(dists.dtype)


def min_dist_weight(dists: jax.Array, valid: jax.Array, min_dist: float) -> jax.Array:
    """MinDistOutlierFilter."""
    return ((dists >= min_dist**2) & valid).astype(dists.dtype)


def generic_descriptor_weight(
    desc_matched: jax.Array,
    valid: jax.Array,
    use_soft_threshold: bool,
    use_larger_than: bool,
    threshold: float,
) -> jax.Array:
    """GenericDescriptorOutlierFilter (``OutlierFiltersImpl.cpp:295-377``):
    weight pairs by a 1-D reference descriptor gathered at the matched id.

    Binary mode gates on ``desc > threshold`` (or ``<`` when
    ``use_larger_than`` is false); soft mode uses the descriptor value
    itself, normalized by the max over valid pairs (the reference divides
    by ``w.maxCoeff()``). Invalid matches weigh zero either way.
    """
    d = jnp.where(valid, desc_matched, 0.0)
    if use_soft_threshold:
        return d / jnp.maximum(jnp.max(d), 1e-12)
    if use_larger_than:
        keep = desc_matched > threshold
    else:
        keep = desc_matched < threshold
    return (keep & valid).astype(desc_matched.dtype)


def surface_normal_gate(
    reading_normals: jax.Array,
    matched_ref_normals: jax.Array,
    valid: jax.Array,
    max_angle: float,
) -> jax.Array:
    """SurfaceNormalOutlierFilter: binary gate on the angle between the
    reading point's normal and the matched reference normal."""
    cos = jnp.sum(reading_normals * matched_ref_normals, axis=-1)
    keep = jnp.abs(cos) >= jnp.cos(max_angle)
    return (keep & valid).astype(reading_normals.dtype)


# Robust M-estimator weights (RobustOutlierFilter,
# ``OutlierFiltersImpl.cpp:384-453``). ``e2`` = squared residual distance,
# ``k2`` = squared tuning scale. Each returns w(e) for IRLS.


def robust_weight(name: str, e2: jax.Array, k2) -> jax.Array:
    k2 = jnp.asarray(k2, e2.dtype)
    r = e2 / k2
    if name == "cauchy":
        return 1.0 / (1.0 + r)
    if name == "welsch":
        return jnp.exp(-r)
    if name == "sc":  # switchable constraint
        return jnp.where(e2 <= k2, jnp.ones_like(r), (4.0 * k2 * k2) / (k2 + e2) ** 2 * (1.0 / k2))
    if name == "gm":  # Geman-McClure
        return k2 / (k2 + e2) ** 2 * jnp.maximum(k2, 1.0)
    if name == "tukey":
        return jnp.where(e2 <= k2, (1.0 - r) ** 2, jnp.zeros_like(r))
    if name == "huber":
        e = jnp.sqrt(jnp.maximum(e2, 1e-30))
        k = jnp.sqrt(k2)
        return jnp.where(e2 <= k2, jnp.ones_like(r), k / e)
    if name == "l1":
        e = jnp.sqrt(jnp.maximum(e2, 1e-30))
        return 1.0 / jnp.maximum(e, 1e-9)
    if name == "student":
        d = 3.0
        return (d + 1.0) / (d + r)
    raise ValueError(f"unknown robust weight: {name}")


def mad_scale(dists: jax.Array, valid: jax.Array) -> jax.Array:
    """Median absolute deviation of euclidean distances — the reference's
    ``approximation`` scale estimator for robust filters."""
    e = jnp.sqrt(jnp.maximum(dists, 0.0))
    med = _flat_quantile(e, valid, 0.5)
    mad = _flat_quantile(jnp.abs(e - med), valid, 0.5)
    return 1.4826 * mad


def trimmed_dist_limit(
    dists: jax.Array, valid: jax.Array, ratio: float, max_d2, bins: int = 256
) -> jax.Array:
    """Histogram-located TrimmedDist keep-threshold (scalar).

    Resolution max_d2/bins; used by :func:`trimmed_dist_histogram` and by
    the pair-cached ICP rounds, which freeze the threshold once per round
    (same staleness contract as the cached pair selection)."""
    max_d2 = jnp.asarray(max_d2, dists.dtype)
    d = dists.reshape(-1)
    v = valid.reshape(-1)
    idx = jnp.clip((d / max_d2 * bins).astype(jnp.int32), 0, bins - 1)
    onehot_counts = jnp.zeros((bins + 1,), jnp.int32).at[
        jnp.where(v, idx, bins)
    ].add(1, mode="drop")
    counts = onehot_counts[:bins]
    csum = jnp.cumsum(counts)
    total = jnp.maximum(csum[-1], 1)
    target = (total.astype(dists.dtype) * ratio).astype(jnp.int32)
    # First bin whose cumulative count reaches the target.
    reached = csum >= target
    first = jnp.argmax(reached)
    return (first.astype(dists.dtype) + 1.0) / bins * max_d2


def trimmed_dist_histogram(
    dists: jax.Array, valid: jax.Array, ratio: float, max_d2, bins: int = 256
) -> jax.Array:
    """Sort-free TrimmedDist: the keep-threshold is located with a fixed
    histogram over [0, max_d2] instead of an O(N log N) sort — O(N) elementwise work,
    threshold resolution max_d2/bins (points within one bin of the exact
    quantile may flip). The production fast path for the jitted ICP loop;
    the exact nth-element variant stays the default.
    """
    limit = trimmed_dist_limit(dists, valid, ratio, max_d2, bins)
    return ((dists <= limit) & valid).astype(dists.dtype)
