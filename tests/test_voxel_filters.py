import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import filters, voxel
from open3d_slam_jax.ops import pointcloud as pc


def voxel_oracle(points, size):
    """Numpy oracle: mean of points per occupied voxel."""
    cells = np.floor(points / size).astype(np.int64)
    out = {}
    for p, c in zip(points, map(tuple, cells)):
        out.setdefault(c, []).append(p)
    return {c: np.mean(v, axis=0) for c, v in out.items()}


def test_voxel_downsample_matches_oracle(rng):
    pts = rng.uniform(-3, 3, size=(500, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=512)
    out = voxel.voxel_downsample(b, 0.75)
    oracle = voxel_oracle(pts, 0.75)
    got_xyz = np.asarray(out.xyz)[np.asarray(out.mask)]
    assert len(got_xyz) == len(oracle)
    ref = np.array(sorted(map(tuple, oracle.values())))
    got = np.array(sorted(map(tuple, got_xyz)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_voxel_downsample_negative_coords(rng):
    pts = (rng.uniform(-10, -5, size=(200, 3))).astype(np.float32)
    b = pc.from_points(pts)
    out = voxel.voxel_downsample(b, 0.5)
    oracle = voxel_oracle(pts, 0.5)
    assert int(jnp.sum(out.mask)) == len(oracle)


def test_voxel_downsample_averages_extras(rng):
    pts = np.array([[0.1, 0.1, 0.1], [0.2, 0.2, 0.2], [5.0, 5.0, 5.0]], np.float32)
    vals = np.array([[1.0], [3.0], [10.0]], np.float32)
    b = pc.from_points(pts, extras={"intensity": vals})
    out = voxel.voxel_downsample(b, 1.0)
    got = sorted(np.asarray(out.extras["intensity"])[np.asarray(out.mask)][:, 0])
    np.testing.assert_allclose(got, [2.0, 10.0], atol=1e-6)


def test_voxel_downsample_ignores_invalid(rng):
    pts = rng.uniform(0, 1, size=(50, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=100)  # 50 padded slots
    out = voxel.voxel_downsample(b, 10.0)
    # All valid points in one voxel -> one output point; padding untouched.
    assert int(jnp.sum(out.mask)) == 1
    np.testing.assert_allclose(
        np.asarray(out.xyz)[np.asarray(out.mask)][0], pts.mean(axis=0), atol=1e-5
    )


def test_voxel_first_point(rng):
    pts = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    b = pc.from_points(pts)
    out = voxel.voxel_first_point(b, 0.5)
    oracle = voxel_oracle(pts, 0.5)
    assert int(jnp.sum(out.mask)) == len(oracle)
    # Kept points are a subset of the originals (no averaging).
    kept = np.asarray(out.xyz)[np.asarray(out.mask)]
    orig = set(map(tuple, pts))
    assert all(tuple(p) in orig for p in kept)


def test_crops(rng):
    pts = rng.uniform(-2, 2, size=(400, 3)).astype(np.float32)
    b = pc.from_points(pts)
    d = np.linalg.norm(pts, axis=1)

    out = filters.max_dist(b, 1.0)
    np.testing.assert_array_equal(np.asarray(out.mask), d <= 1.0)

    out = filters.min_dist(b, 1.0)
    np.testing.assert_array_equal(np.asarray(out.mask), d >= 1.0)

    out = filters.min_max_radius(b, 0.5, 1.5)
    np.testing.assert_array_equal(np.asarray(out.mask), (d >= 0.5) & (d <= 1.5))

    out = filters.bounding_box(b, [-1, -1, -1], [1, 1, 1])
    np.testing.assert_array_equal(np.asarray(out.mask), np.all(np.abs(pts) <= 1, axis=1))

    out = filters.bounding_box(b, [-1, -1, -1], [1, 1, 1], remove_inside=True)
    np.testing.assert_array_equal(np.asarray(out.mask), ~np.all(np.abs(pts) <= 1, axis=1))

    out = filters.cylinder(b, radius=1.0, half_height=0.5)
    ref = (pts[:, 0] ** 2 + pts[:, 1] ** 2 <= 1.0) & (np.abs(pts[:, 2]) <= 0.5)
    np.testing.assert_array_equal(np.asarray(out.mask), ref)


def test_crop_with_center(rng):
    pts = rng.uniform(-2, 2, size=(100, 3)).astype(np.float32)
    b = pc.from_points(pts)
    c = np.array([1.0, 0.0, 0.0], np.float32)
    out = filters.max_dist(b, 0.8, center=c)
    ref = np.linalg.norm(pts - c, axis=1) <= 0.8
    np.testing.assert_array_equal(np.asarray(out.mask), ref)


def test_remove_nan():
    pts = np.array([[0, 0, 0], [np.nan, 1, 1], [1, np.inf, 1], [2, 2, 2]], np.float32)
    b = pc.PointBatch(xyz=jnp.asarray(pts), mask=jnp.ones(4, bool))
    out = filters.remove_nan(b)
    np.testing.assert_array_equal(np.asarray(out.mask), [True, False, False, True])


def test_random_sampling(rng):
    b = pc.from_points(rng.normal(size=(10000, 3)).astype(np.float32))
    out = filters.random_sampling(b, jax.random.key(0), 0.3)
    frac = int(out.count()) / 10000
    assert 0.27 < frac < 0.33


def test_max_point_count(rng):
    b = pc.from_points(rng.normal(size=(1000, 3)).astype(np.float32))
    out = filters.max_point_count(b, jax.random.key(1), 200)
    assert int(out.count()) == 200
    # No-op when under the limit.
    out2 = filters.max_point_count(b, jax.random.key(1), 5000)
    assert int(out2.count()) == 1000


def test_max_quantile_on_axis(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    b = pc.from_points(pts)
    out = filters.max_quantile_on_axis(b, 2, 0.5)
    kept = int(out.count())
    assert abs(kept - 250) <= 5


def test_fix_step_sampling(rng):
    b = pc.from_points(rng.normal(size=(100, 3)).astype(np.float32))
    out = filters.fix_step_sampling(b, 4)
    assert int(out.count()) == 25


def test_orient_normals(rng):
    pts = np.array([[1.0, 0, 0], [0, 2.0, 0]], np.float32)
    normals = np.array([[1.0, 0, 0], [0, 1.0, 0]], np.float32)
    b = pc.from_points(pts, extras={"normals": normals})
    out = filters.orient_normals(b, towards=(0.0, 0.0, 0.0))
    # Normals should now point towards the origin (negative direction).
    np.testing.assert_allclose(np.asarray(out.extras["normals"]), -normals, atol=1e-6)


def test_observation_direction(rng):
    pts = np.array([[2.0, 0, 0]], np.float32)
    b = pc.from_points(pts)
    out = filters.observation_direction(b)
    np.testing.assert_allclose(np.asarray(out.extras["observationDirections"]), [[-1, 0, 0]], atol=1e-6)


def test_max_density(rng):
    # Dense cluster + sparse region: the cluster must be thinned.
    import jax
    dense = rng.uniform(0, 0.5, (1500, 3)).astype(np.float32)
    sparse = rng.uniform(5, 15, (300, 3)).astype(np.float32)
    b = pc.from_points(np.vstack([dense, sparse]))
    out = filters.max_density(b, jax.random.key(0), max_dens=500.0)
    kept = np.asarray(out.mask)
    assert kept[:1500].mean() < 0.7
    assert kept[1500:].mean() > 0.9


def test_normal_space_sampling(rng):
    import jax
    n = 2000
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    # Bias: 80% pointing +z.
    normals[: int(n * 0.8)] = [0, 0, 1.0]
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    b = pc.from_points(rng.normal(size=(n, 3)).astype(np.float32), extras={"normals": normals})
    out = filters.normal_space_sampling(b, jax.random.key(0), target_count=256)
    kept = np.asarray(out.mask)
    frac_up = kept[: int(n * 0.8)].sum() / max(kept.sum(), 1)
    # The +z bin is capped at its quota => far below 80%.
    assert frac_up < 0.3, frac_up


def test_covariance_sampling(rng):
    pts = rng.uniform(-2, 2, (800, 3)).astype(np.float32)
    normals = rng.normal(size=(800, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    b = pc.from_points(pts, extras={"normals": normals})
    out = filters.covariance_sampling(b, target_count=200)
    assert int(out.count()) == 200


def test_remove_sensor_bias(rng):
    pts = np.array([[10.0, 0, 0.0]], np.float32)
    b = pc.from_points(pts, extras={"normals": np.array([[-1.0, 0, 0]], np.float32)})
    b = filters.incidence_angle(b)
    out = filters.remove_sensor_bias(b, sensor_type=0)
    r = float(np.linalg.norm(np.asarray(out.xyz)[0]))
    assert r < 10.0 and r > 9.9
    # High-incidence points are dropped, not corrected (reference behavior).
    grazing = pc.from_points(
        np.array([[10.0, 0, 0.0]], np.float32),
        extras={"normals": np.array([[0.0, 1.0, 0]], np.float32)},
    )
    grazing = filters.incidence_angle(grazing)
    dropped = filters.remove_sensor_bias(grazing, angle_threshold_deg=88.0)
    assert int(dropped.count()) == 0


def test_hidden_point_removal(rng):
    # Two concentric spheres: from the center-ish viewpoint outside, the far
    # hemisphere of the inner sphere is hidden.
    import numpy as np
    ang = rng.uniform(0, 2 * np.pi, 500)
    el = rng.uniform(-np.pi / 2, np.pi / 2, 500)
    def sphere(r):
        return np.c_[r * np.cos(el) * np.cos(ang), r * np.cos(el) * np.sin(ang), r * np.sin(el)]
    pts = sphere(1.0).astype(np.float32)
    keep = filters.hidden_point_removal(pts, viewpoint=[5.0, 0, 0], param=2.0)
    vis_frac_front = keep[pts[:, 0] > 0.3].mean()
    vis_frac_back = keep[pts[:, 0] < -0.3].mean()
    assert vis_frac_front > 0.6
    assert vis_frac_back < 0.2
