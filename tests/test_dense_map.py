import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import dense_map


def test_insert_and_export(rng):
    state = dense_map.create(1024, voxel_size=0.5)
    pts = rng.uniform(0, 4, (500, 3)).astype(np.float32)
    scan = pc.from_points(pts, capacity=512)
    state = dense_map.insert(state, scan, jnp.eye(4))
    out = dense_map.export(state)
    n_vox = int(jnp.sum(out.mask))
    # Oracle voxel count.
    cells = set(map(tuple, np.floor(pts / 0.5).astype(int)))
    assert n_vox == len(cells), (n_vox, len(cells))


def test_incremental_mean_unbiased(rng):
    """Two insertions into the same voxel: mean over ALL points, unlike a
    re-voxelization of means."""
    state = dense_map.create(64, voxel_size=10.0)
    a = np.zeros((4, 3), np.float32)  # 4 points at origin
    b = np.ones((8, 3), np.float32) * 2  # 8 points at (2,2,2), same voxel
    state = dense_map.insert(state, pc.from_points(a, capacity=8), jnp.eye(4))
    state = dense_map.insert(state, pc.from_points(b, capacity=8), jnp.eye(4))
    out = dense_map.export(state)
    got = np.asarray(out.xyz)[np.asarray(out.mask)]
    assert len(got) == 1
    np.testing.assert_allclose(got[0], np.full(3, 16.0 / 12.0), atol=1e-5)


def test_no_duplicate_voxels_across_insertions(rng):
    state = dense_map.create(2048, voxel_size=0.5)
    pts = rng.uniform(0, 5, (400, 3)).astype(np.float32)
    for _ in range(3):
        state = dense_map.insert(state, pc.from_points(pts, capacity=512), jnp.eye(4))
    out = dense_map.export(state)
    cells = set(map(tuple, np.floor(pts / 0.5).astype(int)))
    assert int(jnp.sum(out.mask)) == len(cells)
    # Counts triple, means unchanged.
    total = float(jnp.sum(state.count))
    assert total == 3 * 400


def test_posed_insertion(rng):
    state = dense_map.create(256, voxel_size=0.5)
    pts = rng.uniform(0, 1, (50, 3)).astype(np.float32)
    T = jnp.eye(4).at[:3, 3].set(jnp.asarray([10.0, 0, 0]))
    state = dense_map.insert(state, pc.from_points(pts, capacity=64), T)
    out = dense_map.export(state)
    got = np.asarray(out.xyz)[np.asarray(out.mask)]
    assert np.all(got[:, 0] > 9.0)


def test_capacity_overflow_graceful(rng):
    state = dense_map.create(16, voxel_size=0.1)
    pts = rng.uniform(0, 10, (300, 3)).astype(np.float32)  # ~300 voxels >> 16
    state = dense_map.insert(state, pc.from_points(pts, capacity=512), jnp.eye(4))
    out = dense_map.export(state)
    assert int(jnp.sum(out.mask)) <= 16
    assert bool(jnp.all(jnp.isfinite(out.xyz[out.mask])))


def test_colors_and_normals_aggregate(rng):
    state = dense_map.create(64, voxel_size=5.0)
    pts = np.zeros((10, 3), np.float32)
    normals = np.tile([[0, 0, 1.0]], (10, 1)).astype(np.float32)
    colors = np.tile([[1.0, 0.5, 0.25]], (10, 1)).astype(np.float32)
    scan = pc.from_points(pts, capacity=16, extras={"normals": normals, "colors": colors})
    state = dense_map.insert(state, scan, jnp.eye(4))
    out = dense_map.export(state)
    m = np.asarray(out.mask)
    np.testing.assert_allclose(np.asarray(out.extras["normals"])[m][0], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.extras["colors"])[m][0], [1.0, 0.5, 0.25], atol=1e-5)
