import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import ransac
from open3d_slam_jax.ops import fpfh, grid_hash
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.ops import filters


def structured_scene(rng, n=3000):
    """Scene with varied local geometry so FPFH is discriminative."""
    m = n // 3
    floor = np.c_[rng.uniform(-4, 4, (m, 2)), np.zeros((m, 1))]
    # ramp (slanted plane)
    u = rng.uniform(-2, 2, (m, 2))
    ramp = np.c_[u[:, :1] + 3, u[:, 1:], 0.5 * u[:, :1] + 1.5]
    # cylinder
    ang = rng.uniform(0, 2 * np.pi, m)
    cyl = np.c_[np.cos(ang) * 0.8 - 3, np.sin(ang) * 0.8, rng.uniform(0, 2, m)]
    pts = np.vstack([floor, ramp, cyl]).astype(np.float32)
    return pts + rng.normal(size=pts.shape).astype(np.float32) * 0.005


def with_features(pts, rng_cap=4096):
    b = pc.from_points(pts, capacity=rng_cap)
    b = normals_mod.estimate_normals(b, knn=10, orient_towards=(0.0, 0.0, 10.0))
    grid = grid_hash.build_grid(
        b.padded_xyz(), b.mask, 1.0, 1 << 12, 32, normals=b.normals
    )
    feats = fpfh.compute_fpfh(b, grid, knn=16)
    return b, feats


def test_fpfh_shape_and_norm(rng):
    pts = structured_scene(rng)
    b, feats = with_features(pts)
    f = np.asarray(feats)
    assert f.shape[1] == 33
    valid = np.asarray(b.mask)
    # Each 11-bin subhistogram sums to ~100 for points with neighbours
    # (isolated points legitimately have all-zero features).
    nonzero = valid & (f.sum(axis=1) > 0)
    assert nonzero.mean() > 0.6
    for i in range(3):
        s = f[nonzero][:, i * 11 : (i + 1) * 11].sum(axis=1)
        np.testing.assert_allclose(s, 100.0, atol=1.0)
    assert np.all(f[~valid] == 0)


def test_fpfh_distinguishes_geometry(rng):
    # Flat-floor points should have similar features to each other and
    # different from cylinder points.
    pts = structured_scene(rng)
    b, feats = with_features(pts)
    f = np.asarray(feats)
    m = len(pts) // 3
    floor_f = f[:m][np.asarray(b.mask)[:m]]
    cyl_f = f[2 * m : 3 * m][np.asarray(b.mask)[2 * m : 3 * m]]
    intra = np.linalg.norm(floor_f[:200] - floor_f[200:400], axis=1).mean()
    inter = np.linalg.norm(floor_f[:200] - cyl_f[:200], axis=1).mean()
    assert inter > 1.5 * intra, (intra, inter)


def test_feature_match_identity(rng):
    pts = structured_scene(rng)
    b, feats = with_features(pts)
    d, ids = fpfh.match_features(feats, b.mask, feats, b.mask, k=1)
    ids = np.asarray(ids)[:, 0]
    f = np.asarray(feats)
    valid = np.asarray(b.mask) & (f.sum(axis=1) > 0)
    # A point's own feature is at distance 0, so the nearest neighbour's
    # distance must be 0 for every featured point (ties may pick another
    # identical-feature point).
    dd = np.asarray(d)[:, 0]
    # Squared feature norms are ~1e4, so f32 cancellation noise in
    # a^2 - 2ab + b^2 is ~5e-3; 0.05 is "zero" at this scale.
    assert np.mean(dd[valid] < 0.05) > 0.99


def test_ransac_recovers_transform(rng):
    pts = structured_scene(rng)
    T_true = np.asarray(
        se3.exp_se3(jnp.asarray([0.1, -0.05, 0.8, 2.0, -1.0, 0.3], jnp.float32))
    )
    moved = pts @ T_true[:3, :3].T + T_true[:3, 3]
    # Correspondences: exact with 30% gross outliers.
    C = 500
    sel = rng.choice(len(pts), C, replace=False)
    src = pts[sel].astype(np.float32)
    tgt = moved[sel].astype(np.float32)
    n_out = int(C * 0.3)
    tgt[:n_out] = rng.uniform(-5, 5, (n_out, 3)).astype(np.float32)
    res = ransac.ransac_align(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(C, bool), jax.random.key(0),
        ransac.RansacConfig(num_hypotheses=512, inlier_dist=0.1),
    )
    assert bool(res.ok)
    T = np.asarray(res.transform)
    np.testing.assert_allclose(T, T_true, atol=0.02)
    assert float(res.fitness) > 0.5


def test_ransac_rejects_garbage(rng):
    C = 300
    src = rng.uniform(-5, 5, (C, 3)).astype(np.float32)
    tgt = rng.uniform(-5, 5, (C, 3)).astype(np.float32)
    res = ransac.ransac_align(
        jnp.asarray(src), jnp.asarray(tgt), jnp.ones(C, bool), jax.random.key(1),
        ransac.RansacConfig(num_hypotheses=256, inlier_dist=0.05, min_inliers=15),
    )
    assert not bool(res.ok)


def landmark_scene(rng, n_boxes=7):
    """Asymmetric arrangement of boxes on a floor: corner/edge points give
    FPFH distinctive signatures (planar-only scenes are degenerate for any
    local descriptor — matching relies on landmarks, as in real buildings)."""
    pts = [np.c_[rng.uniform(-8, 8, (1500, 2)), np.zeros((1500, 1))]]
    centers = rng.uniform(-6, 6, (n_boxes, 2))
    sizes = rng.uniform(0.5, 1.8, (n_boxes, 3))
    for (cx, cy), (sx, sy, sz) in zip(centers, sizes):
        m = 260
        # 3 visible faces per box.
        f1 = np.c_[np.full((m, 1), cx + sx), cy + rng.uniform(-sy, sy, (m, 1)), rng.uniform(0, sz, (m, 1))]
        f2 = np.c_[cx + rng.uniform(-sx, sx, (m, 1)), np.full((m, 1), cy + sy), rng.uniform(0, sz, (m, 1))]
        f3 = np.c_[cx + rng.uniform(-sx, sx, (m, 1)), cy + rng.uniform(-sy, sy, (m, 1)), np.full((m, 1), sz)]
        pts += [f1, f2, f3]
    out = np.vstack(pts).astype(np.float32)
    return out + rng.normal(size=out.shape).astype(np.float32) * 0.005


@pytest.mark.slow
def test_fpfh_ransac_end_to_end(rng):
    """Coarse alignment from features alone (no initial guess) on a
    landmark-rich scene with mutual-nearest correspondence filtering."""
    pts_a = landmark_scene(rng)
    T_true = np.asarray(
        se3.exp_se3(jnp.asarray([0, 0, 1.2, 3.0, 2.0, 0.0], jnp.float32))
    )
    pts_b = (pts_a @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)
    # Independent subsampling of each side (different visible points).
    keep_a = rng.uniform(size=len(pts_a)) < 0.7
    keep_b = rng.uniform(size=len(pts_b)) < 0.7
    a, fa = with_features(pts_a[keep_a], rng_cap=8192)
    bb, fb = with_features(pts_b[keep_b], rng_cap=8192)

    ids, ok = fpfh.mutual_matches(fa, a.mask, fb, bb.mask)
    ids_np, ok_np = np.asarray(ids), np.asarray(ok)
    assert ok_np.sum() > 50, ok_np.sum()
    src = np.asarray(a.xyz)
    tgt = np.asarray(bb.xyz)[np.maximum(ids_np, 0)]
    res = ransac.ransac_align(
        jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(ok_np), jax.random.key(3),
        ransac.RansacConfig(num_hypotheses=2048, inlier_dist=0.3, min_inliers=20),
    )
    assert bool(res.ok)
    T = np.asarray(res.transform)
    # Coarse: within ~0.5m / ~0.2rad is enough to seed ICP.
    delta = np.linalg.inv(T) @ T_true
    assert np.linalg.norm(delta[:3, 3]) < 0.5, delta[:3, 3]
    ang = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    assert ang < 0.2, ang
