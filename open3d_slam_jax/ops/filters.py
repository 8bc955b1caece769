"""Masked point-cloud filters.

Fixed-shape counterparts of the reference's two filter families:

- libpointmatcher ``DataPointsFilters`` (31 modules registered in
  ``pointmatcher/Registry.cpp:67-96``) — implemented here as mask
  transformations over a fixed-capacity :class:`PointBatch`;
- open3d_slam ``croppers.hpp`` (MaxRadius/MinRadius/Cylinder/BoundingBox
  cropping volumes, invertible and posable).

Every filter returns a new PointBatch with the same capacity; points are
"removed" by clearing mask bits (compact separately if a smaller static
shape is wanted). Sampling filters take an explicit PRNG key — reproducible
under jit and across hosts.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from open3d_slam_jax.ops.pointcloud import PointBatch, masked_quantile


# ---------------------------------------------------------------------------
# Distance / volume crops (DataPointsFilters MaxDist/MinDist/BoundingBox +
# open3d_slam croppers).
# ---------------------------------------------------------------------------


def max_dist(batch: PointBatch, dist, center=None) -> PointBatch:
    """Keep points with ||p - center|| <= dist (MaxDistDataPointsFilter /
    MaxRadiusCroppingVolume)."""
    xyz = batch.xyz if center is None else batch.xyz - jnp.asarray(center, batch.xyz.dtype)
    d2 = jnp.sum(xyz * xyz, axis=-1)
    return batch.with_mask(d2 <= jnp.asarray(dist, d2.dtype) ** 2)


def min_dist(batch: PointBatch, dist, center=None) -> PointBatch:
    """Keep points with ||p - center|| >= dist (MinDistDataPointsFilter /
    MinRadiusCroppingVolume)."""
    xyz = batch.xyz if center is None else batch.xyz - jnp.asarray(center, batch.xyz.dtype)
    d2 = jnp.sum(xyz * xyz, axis=-1)
    return batch.with_mask(d2 >= jnp.asarray(dist, d2.dtype) ** 2)


def min_max_radius(batch: PointBatch, rmin, rmax, center=None) -> PointBatch:
    """MinMaxRadiusCroppingVolume (croppers.hpp)."""
    return min_dist(max_dist(batch, rmax, center), rmin, center)


def axis_dist(batch: PointBatch, axis: int, dist, keep_inside: bool = True) -> PointBatch:
    """MaxDist on a single axis (dim=0/1/2 modes of MaxDistDataPointsFilter)."""
    v = jnp.abs(batch.xyz[..., axis])
    keep = v <= dist if keep_inside else v >= dist
    return batch.with_mask(keep)


def bounding_box(batch: PointBatch, lo, hi, remove_inside: bool = False) -> PointBatch:
    """BoundingBoxDataPointsFilter: axis-aligned box keep/remove."""
    lo = jnp.asarray(lo, batch.xyz.dtype)
    hi = jnp.asarray(hi, batch.xyz.dtype)
    inside = jnp.all((batch.xyz >= lo) & (batch.xyz <= hi), axis=-1)
    return batch.with_mask(~inside if remove_inside else inside)


def cylinder(batch: PointBatch, radius, half_height, center=None, remove_inside: bool = False) -> PointBatch:
    """CylinderCroppingVolume (croppers.hpp): vertical cylinder about center."""
    xyz = batch.xyz if center is None else batch.xyz - jnp.asarray(center, batch.xyz.dtype)
    in_r = (xyz[..., 0] ** 2 + xyz[..., 1] ** 2) <= jnp.asarray(radius) ** 2
    in_h = jnp.abs(xyz[..., 2]) <= half_height
    inside = in_r & in_h
    return batch.with_mask(~inside if remove_inside else inside)


def remove_nan(batch: PointBatch) -> PointBatch:
    """RemoveNaNDataPointsFilter: drop non-finite points."""
    finite = jnp.all(jnp.isfinite(batch.xyz), axis=-1)
    return batch.with_mask(finite)


def distance_limit(batch: PointBatch, axis: int = -1, dist: float = jnp.inf, keep_inside: bool = True) -> PointBatch:
    """DistanceLimitDataPointsFilter: radial (axis=-1) or per-axis limit."""
    if axis < 0:
        v = jnp.linalg.norm(batch.xyz, axis=-1)
    else:
        v = jnp.abs(batch.xyz[..., axis])
    keep = v < dist if keep_inside else v > dist
    return batch.with_mask(keep)


def max_quantile_on_axis(batch: PointBatch, axis: int, ratio: float) -> PointBatch:
    """MaxQuantileOnAxisDataPointsFilter: keep points below the ``ratio``
    quantile of the given coordinate."""
    v = batch.xyz[..., axis]
    limit = masked_quantile(v, batch.mask, ratio)
    return batch.with_mask(v <= limit)


# ---------------------------------------------------------------------------
# Sampling filters.
# ---------------------------------------------------------------------------


def random_sampling(batch: PointBatch, key: jax.Array, prob: float) -> PointBatch:
    """RandomSamplingDataPointsFilter: keep each valid point with prob."""
    u = jax.random.uniform(key, batch.mask.shape)
    return batch.with_mask(u < prob)


def max_point_count(batch: PointBatch, key: jax.Array, max_count: int) -> PointBatch:
    """MaxPointCountDataPointsFilter: if count > max_count, keep a uniform
    random subset of exactly max_count valid points."""
    n = batch.capacity
    u = jax.random.uniform(key, (n,))
    # Rank valid points by random score; keep the max_count smallest ranks.
    score = jnp.where(batch.mask, u, 2.0)
    order = jnp.argsort(score)
    rank = jnp.zeros((n,), jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    keep = batch.mask & (rank < max_count)
    over = batch.count() > max_count
    return batch.with_mask(jnp.where(over, keep, batch.mask))


def fix_step_sampling(batch: PointBatch, step: int) -> PointBatch:
    """FixStepSamplingDataPointsFilter: keep every step-th point (by index)."""
    idx = jnp.arange(batch.capacity)
    return batch.with_mask((idx % step) == 0)


# ---------------------------------------------------------------------------
# Geometry-aware filters.
# ---------------------------------------------------------------------------


def shadow_filter(batch: PointBatch, eps: float = 0.1) -> PointBatch:
    """ShadowDataPointsFilter: remove points whose normal is almost
    perpendicular to the observation ray (veil points at depth edges).
    Requires ``normals``; sensor assumed at the origin (as in the reference,
    which uses the observation direction descriptor)."""
    normals = batch.extras["normals"]
    ray = batch.xyz / jnp.maximum(jnp.linalg.norm(batch.xyz, axis=-1, keepdims=True), 1e-12)
    cos = jnp.abs(jnp.sum(normals * ray, axis=-1))
    return batch.with_mask(cos > eps)


def incidence_angle(batch: PointBatch) -> PointBatch:
    """IncidenceAngleDataPointsFilter: store the incidence angle (angle
    between the viewing ray and the surface normal) as an extra channel."""
    normals = batch.extras["normals"]
    ray = -batch.xyz
    ray = ray / jnp.maximum(jnp.linalg.norm(ray, axis=-1, keepdims=True), 1e-12)
    cos = jnp.clip(jnp.abs(jnp.sum(normals * ray, axis=-1)), 0.0, 1.0)
    return batch.with_extras(incidenceAngles=jnp.arccos(cos)[:, None])


def observation_direction(batch: PointBatch, sensor=(0.0, 0.0, 0.0)) -> PointBatch:
    """ObservationDirectionDataPointsFilter: unit vector point -> sensor."""
    v = jnp.asarray(sensor, batch.xyz.dtype)[None, :] - batch.xyz
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-12)
    return batch.with_extras(observationDirections=v)


def orient_normals(
    batch: PointBatch, towards=(0.0, 0.0, 0.0), toward_center: bool = True
) -> PointBatch:
    """OrientNormalsDataPointsFilter (``OrientNormals.cpp:60-95``): flip
    normals consistently w.r.t. the observation direction.

    Uses the ``observationDirections`` channel when present (the reference
    requires it); otherwise the direction ``towards - xyz`` (sensor at
    ``towards``). ``toward_center`` ≙ the ``towardCenter`` param: True
    orients normals toward the observation point, False away from it.
    """
    normals = batch.extras["normals"]
    if "observationDirections" in batch.extras:
        to_vp = batch.extras["observationDirections"]
    else:
        to_vp = jnp.asarray(towards, batch.xyz.dtype)[None, :] - batch.xyz
    scalar = jnp.sum(normals * to_vp, axis=-1, keepdims=True)
    flip = (scalar < 0) if toward_center else (scalar > 0)
    return batch.with_extras(normals=jnp.where(flip, -normals, normals))


def simple_sensor_noise(batch: PointBatch, gain: float = 1.0) -> PointBatch:
    """SimpleSensorNoiseDataPointsFilter (LMS-style model): noise grows
    linearly with range; stored as ``simpleSensorNoise`` channel."""
    d = jnp.linalg.norm(batch.xyz, axis=-1, keepdims=True)
    noise = gain * (0.0122 + 0.0007 * d)
    return batch.with_extras(simpleSensorNoise=noise)


def cut_at_descriptor_threshold(
    batch: PointBatch, name: str, threshold, use_larger_than: bool = True
) -> PointBatch:
    """CutAtDescriptorThresholdDataPointsFilter: gate on an extra channel."""
    v = batch.extras[name][..., 0]
    keep = v <= threshold if use_larger_than else v >= threshold
    return batch.with_mask(keep)


# ---------------------------------------------------------------------------
# Density / sampling filters needing neighbourhood or normal information.
# ---------------------------------------------------------------------------


def max_density(batch: PointBatch, key: jax.Array, max_dens: float, knn: int = 8) -> PointBatch:
    """MaxDensityDataPointsFilter: estimate local density from the KNN ball
    and randomly thin regions above ``max_dens`` points/m^3 so the expected
    density matches the cap (same stochastic policy as the reference)."""
    from open3d_slam_jax.ops import knn as knn_mod

    xyz = batch.padded_xyz()
    res = knn_mod.knn_bruteforce(xyz, batch.mask, xyz, batch.mask, k=knn)
    r2 = res.dists[:, -1]  # squared radius of the knn ball
    r3 = jnp.maximum(r2, 1e-12) ** 1.5
    density = knn / (4.0 / 3.0 * jnp.pi * r3)
    keep_prob = jnp.clip(max_dens / jnp.maximum(density, 1e-9), 0.0, 1.0)
    u = jax.random.uniform(key, batch.mask.shape)
    return batch.with_mask(u < keep_prob)


def normal_space_sampling(
    batch: PointBatch, key: jax.Array, target_count: int,
    n_theta: int = 8, n_phi: int = 16,
) -> PointBatch:
    """NormalSpaceDataPointsFilter: uniform sampling over the normal-sphere
    (Rusinkiewicz's normal-space sampling): bin normals into an az/el grid
    and keep an equal random quota per occupied bin."""
    normals = batch.extras["normals"]
    theta = jnp.arccos(jnp.clip(normals[:, 2], -1.0, 1.0))  # [0, pi]
    phi = jnp.arctan2(normals[:, 1], normals[:, 0])  # [-pi, pi]
    ti = jnp.clip((theta / jnp.pi * n_theta).astype(jnp.int32), 0, n_theta - 1)
    pi_ = jnp.clip(((phi + jnp.pi) / (2 * jnp.pi) * n_phi).astype(jnp.int32), 0, n_phi - 1)
    bin_id = jnp.where(batch.mask, ti * n_phi + pi_, n_theta * n_phi)
    n_bins = n_theta * n_phi

    # Rank points within each bin by a random score (sort by (bin, score)).
    score = jax.random.uniform(key, batch.mask.shape)
    order0 = jnp.argsort(score)
    order = order0[jnp.argsort(bin_id[order0], stable=True)]
    s_bin = bin_id[order]
    first_flag = jnp.concatenate([jnp.ones((1,), bool), s_bin[1:] != s_bin[:-1]])
    idxs = jnp.arange(batch.capacity, dtype=jnp.int32)
    rank = idxs - jax.lax.cummax(jnp.where(first_flag, idxs, 0))
    quota = max(1, target_count // n_bins)
    keep_sorted = (rank < quota) & (s_bin < n_bins)
    keep = jnp.zeros_like(batch.mask).at[order].set(keep_sorted)
    return batch.with_mask(keep)


def covariance_sampling(batch: PointBatch, target_count: int) -> PointBatch:
    """CovarianceSamplingDataPointsFilter (Gelfand et al. geometrically
    stable sampling): keep the points contributing most to the weakest
    directions of the torque-normalized 6x6 constraint covariance."""
    normals = batch.extras["normals"]
    # Torque normalization: scale positions by 1/L so rotation and
    # translation contributions are commensurate.
    from open3d_slam_jax.ops.pointcloud import masked_mean

    c = masked_mean(batch.xyz, batch.mask[..., None], axis=-2)
    rel = batch.xyz - c
    L = jnp.sqrt(masked_mean(jnp.sum(rel * rel, -1), batch.mask))
    rel = rel / jnp.maximum(L, 1e-9)
    J = jnp.concatenate([jnp.cross(rel, normals), normals], axis=-1)  # [N, 6]
    J = jnp.where(batch.mask[:, None], J, 0.0)
    C = J.T @ J
    w, V = jnp.linalg.eigh(C)
    # Weight each point by its alignment with the 3 weakest eigenvectors,
    # inversely scaled by their eigenvalues.
    a = jnp.abs(J @ V[:, :3])  # [N, 3]
    inv = 1.0 / jnp.sqrt(jnp.maximum(w[:3], 1e-9))
    scores = jnp.sum(a * inv[None, :], axis=-1)
    scores = jnp.where(batch.mask, scores, -jnp.inf)
    order = jnp.argsort(-scores)
    rank = jnp.zeros((batch.capacity,), jnp.int32).at[order].set(
        jnp.arange(batch.capacity, dtype=jnp.int32)
    )
    return batch.with_mask(batch.mask & (rank < target_count))


def remove_sensor_bias(
    batch: PointBatch,
    sensor_type: int = 0,
    angle_threshold_deg: float = 88.0,
) -> PointBatch:
    """RemoveSensorBiasDataPointsFilter (``RemoveSensorBias.h:67-73``): push
    points back along the viewing ray to compensate the incidence-angle
    range bias of LiDARs (Laconte et al. 2019 model, reduced to its dominant
    incidence term ``dr = k0 * (1/cos(angle) - 1) + k1 * r``).

    ``sensor_type`` ≙ the reference param (0 = SICK LMS-1xx, 1 = Velodyne
    HDL-32E — different pulse widths => different bias constants);
    ``angle_threshold_deg``: no correction above this incidence angle, and
    those points are removed (the reference drops them as unreliable).
    Needs ``incidenceAngles`` (see :func:`incidence_angle`); sensor at the
    origin."""
    k0, k1 = ((0.03, 0.0005), (0.012, 0.0002))[int(sensor_type)]
    ang = batch.extras["incidenceAngles"][..., 0]
    thresh = jnp.deg2rad(jnp.asarray(angle_threshold_deg, batch.xyz.dtype))
    r = jnp.linalg.norm(batch.xyz, axis=-1)
    dr = k0 * (1.0 / jnp.maximum(jnp.cos(ang), 0.2) - 1.0) + k1 * r
    dr = jnp.where(ang <= thresh, dr, 0.0)
    scale = jnp.maximum(r - dr, 0.0) / jnp.maximum(r, 1e-9)
    xyz = batch.xyz * scale[:, None]
    import dataclasses as _dc

    out = _dc.replace(batch, xyz=jnp.where(batch.mask[:, None], xyz, batch.xyz))
    return out.with_mask(ang <= thresh)


def hidden_point_removal(
    points: "np.ndarray", viewpoint, param: float = 3.0, radius=None
) -> "np.ndarray":
    """HiddenPointRemovalDataPointsFilter (Katz et al. spherical flip +
    convex hull). Host-side (scipy hull), like the reference's CPU path
    (Open3D ``HiddenPointRemoval``, ``HiddenPointRemoval.h:32-40``).
    ``radius``: the spherical-projection radius (the reference's ``radius``
    param, default 100); when None, ``max_norm * 10^param`` (Katz's rule).
    Returns a boolean keep-mask over ``points [n, 3]`` numpy."""
    import numpy as np
    from scipy.spatial import ConvexHull

    vp = np.asarray(viewpoint, np.float64)
    p = np.asarray(points, np.float64) - vp
    norm = np.linalg.norm(p, axis=1, keepdims=True)
    if radius is not None:
        # Spherical flip needs R > max range; widen a degenerate radius.
        R = max(float(radius), float(norm.max()) * 1.1)
    else:
        R = norm.max() * (10.0 ** param)
    flipped = p + 2 * (R - norm) * (p / np.maximum(norm, 1e-12))
    pts = np.vstack([flipped, np.zeros((1, 3))])
    hull = ConvexHull(pts)
    keep = np.zeros(len(p), dtype=bool)
    vis = hull.vertices[hull.vertices < len(p)]
    keep[vis] = True
    return keep
