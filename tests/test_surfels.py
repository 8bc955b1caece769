"""Elipsoids / Gestalt surfel descriptors and the force2D minimizer."""

import pytest
import numpy as np
import jax.numpy as jnp

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import surfels
from open3d_slam_jax.ops.pointcloud import PointBatch, from_points


def _plane_cloud(rng, n=2000, extent=4.0, z=0.0, noise=0.0):
    xy = rng.uniform(-extent, extent, size=(n, 2))
    zz = np.full((n, 1), z) + rng.normal(scale=noise, size=(n, 1))
    return np.concatenate([xy, zz], axis=1).astype(np.float32)


def test_elipsoids_planar_surfels(rng):
    pts = _plane_cloud(rng, n=4000, noise=0.002)
    batch = from_points(jnp.asarray(pts), capacity=4096)
    out = surfels.elipsoids(batch, box_size=1.0)
    m = np.asarray(out.mask)
    assert m.sum() >= 40  # 8x8 grid of boxes occupied
    nrm = np.asarray(out.extras["normals"])[m]
    # Planar boxes: normal ~ +-z, planarity high, sphericality ~ 0.
    assert np.all(np.abs(nrm[:, 2]) > 0.99)
    shapes = np.asarray(out.extras["shapes"])[m]
    assert np.all(shapes[:, 0] > 0.5)  # planarity
    assert np.all(shapes[:, 2] < 0.05)  # sphericality
    w = np.asarray(out.extras["weights"])[m]
    assert w.sum() == np.asarray(batch.mask).sum()


def test_elipsoids_min_planarity_drops_spheres(rng):
    ball = rng.normal(size=(3000, 3)).astype(np.float32) * 0.5
    batch = from_points(jnp.asarray(ball), capacity=4096)
    out = surfels.elipsoids(batch, box_size=4.0, min_planarity=0.5)
    assert np.asarray(out.mask).sum() == 0


def test_gestalt_descriptor_heights(rng):
    # Flat ground with a raised quadrant: bins over that quadrant should
    # report higher mean height.
    pts = _plane_cloud(rng, n=6000, extent=5.0)
    raised = (pts[:, 0] > 0.5) & (pts[:, 1] > 0.5)
    pts[raised, 2] = 1.0
    batch = from_points(jnp.asarray(pts), capacity=8192)
    kp = jnp.asarray([[0.0, 0.0, 0.0]], dtype=jnp.float32)
    out = surfels.gestalt(batch, kp, jnp.ones((1,), bool), radius=4.0)
    means = np.asarray(out["means"]).reshape(4, 8)
    # Sector 0 of angles starts at atan2+pi=0 -> angle -pi; the raised
    # quadrant (x>0,y>0) maps to angles [pi, 3pi/2) after the +pi shift,
    # i.e. sectors 4-5.  Outer rings there should be high.
    assert means[3, 4] > 0.5 or means[3, 5] > 0.5
    # Opposite sectors stay flat.
    assert abs(means[3, 0]) < 0.1
    assert np.all(np.isfinite(np.asarray(out["variances"])))


@pytest.mark.slow
def test_force2d_registration_recovers_yaw_xy(rng):
    # A 2.5-D world: walls + floor. True motion is planar.
    pts = []
    g = _plane_cloud(rng, n=3000, extent=5.0)
    pts.append(g)
    for wx in (-5.0, 5.0):
        yz = rng.uniform(0, 2, size=(800, 2))
        y = rng.uniform(-5, 5, size=(800, 1))
        pts.append(np.concatenate([np.full((800, 1), wx), y, yz[:, :1]], 1))
    pts = np.concatenate(pts).astype(np.float32)

    theta = 0.06
    c, s = np.cos(theta), np.sin(theta)
    T_true = np.eye(4, dtype=np.float32)
    T_true[:2, :2] = [[c, -s], [s, c]]
    T_true[0, 3], T_true[1, 3] = 0.15, -0.1

    moved = pts @ T_true[:3, :3].T + T_true[:3, 3]
    cfg = icp_mod.ICPConfig(
        knn=8, max_match_dist=0.7, max_iterations=30, force_2d=True,
        matcher="brute",
    )
    from open3d_slam_jax.ops import normals as normals_mod

    reading = from_points(jnp.asarray(pts), capacity=8192)
    ref_batch = normals_mod.estimate_normals(
        from_points(jnp.asarray(moved), capacity=8192), knn=10
    )
    reference = icp_mod.build_reference(ref_batch, cfg)
    res = icp_mod.icp_single(reading, reference, jnp.eye(4), cfg)
    T = np.asarray(res.transform)
    assert np.abs(T[:3, 3] - T_true[:3, 3]).max() < 0.02
    assert np.abs(T[:3, :3] - T_true[:3, :3]).max() < 0.01
    # z row/column untouched by the 2-D increments.
    assert abs(T[2, 3]) < 5e-3
