import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.geometry import se3


def test_from_points_pad(rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=16)
    assert b.capacity == 16
    assert int(b.count()) == 10
    np.testing.assert_allclose(np.asarray(b.xyz[:10]), pts)
    assert np.all(np.asarray(b.mask[10:]) == False)  # noqa: E712


def test_from_points_truncate(rng):
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=5)
    assert b.capacity == 5
    assert int(b.count()) == 5


def test_extras_padding(rng):
    pts = rng.normal(size=(4, 3)).astype(np.float32)
    normals = rng.normal(size=(4, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=8, extras={"normals": normals})
    assert b.normals.shape == (8, 3)
    np.testing.assert_allclose(np.asarray(b.normals[:4]), normals)


def test_masked_centroid(rng):
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=32)
    c = np.asarray(pc.masked_centroid(b))
    np.testing.assert_allclose(c, pts.mean(axis=0), atol=1e-5)


def test_transformed_rotates_normals(rng):
    pts = rng.normal(size=(6, 3)).astype(np.float32)
    normals = np.tile(np.array([[0, 0, 1.0]], dtype=np.float32), (6, 1))
    b = pc.from_points(pts, extras={"normals": normals})
    T = se3.exp_se3(jnp.asarray([0.0, np.pi / 2, 0.0, 1.0, 2.0, 3.0], dtype=jnp.float32))
    tb = b.transformed(T)
    # Rotation by pi/2 about y maps z -> x.
    np.testing.assert_allclose(np.asarray(tb.normals), np.tile([[1, 0, 0]], (6, 1)), atol=1e-5)
    Tnp = np.asarray(T)
    np.testing.assert_allclose(np.asarray(tb.xyz), pts @ Tnp[:3, :3].T + Tnp[:3, 3], atol=1e-4)


def test_compact(rng):
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=16)
    keep = np.zeros(16, dtype=bool)
    keep[[1, 5, 7, 11]] = True
    b = b.with_mask(jnp.asarray(keep))
    c = pc.compact(b, capacity=8)
    assert int(c.count()) == 4
    np.testing.assert_allclose(np.asarray(c.xyz[:4]), pts[[1, 5, 7, 11]])
    assert np.all(~np.asarray(c.mask[4:]))


def test_masked_quantile_matches_reference_semantics(rng):
    # Reference: nth_element at floor(count * q) over valid values.
    vals = rng.normal(size=(100,)).astype(np.float32)
    mask = rng.uniform(size=(100,)) > 0.3
    q = 0.7
    valid = np.sort(vals[mask])
    expected = valid[min(int(len(valid) * q), len(valid) - 1)]
    got = float(pc.masked_quantile(jnp.asarray(vals), jnp.asarray(mask), q))
    assert got == np.float32(expected)


def test_masked_quantile_q1_is_max(rng):
    vals = rng.normal(size=(50,)).astype(np.float32)
    mask = np.ones(50, dtype=bool)
    got = float(pc.masked_quantile(jnp.asarray(vals), jnp.asarray(mask), 1.0))
    assert got == np.float32(vals.max())


def test_pointbatch_is_pytree(rng):
    b = pc.from_points(rng.normal(size=(4, 3)).astype(np.float32))
    b2 = jax.tree.map(lambda x: x, b)
    assert isinstance(b2, pc.PointBatch)


def test_batch_stack_and_vmap(rng):
    bs = [pc.from_points(rng.normal(size=(8, 3)).astype(np.float32), capacity=8) for _ in range(3)]
    stacked = pc.stack(bs)
    assert stacked.xyz.shape == (3, 8, 3)
    counts = jax.vmap(lambda b: b.count())(stacked)
    assert counts.shape == (3,)


def test_organized_index_grid_roundtrip():
    """index_grid parity (≙ DataPoints::indexGrid, PointMatcher.h:222-405):
    from_organized builds the grid, masking leaves dangling cells invalid,
    compact remaps indices."""
    h, w = 4, 6
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.arange(w)[None, :]
    img[..., 1] = np.arange(h)[:, None]
    img[1, 2] = np.nan  # one dead pixel
    b = pc.from_organized(img)
    assert b.is_organized
    assert b.capacity == h * w
    g = np.asarray(b.index_grid)
    assert g.shape == (h, w)
    assert g[1, 2] == -1
    assert int(b.count()) == h * w - 1
    # organized_view recovers the image (dead pixel invalid).
    xyz_img, valid = pc.organized_view(b)
    assert not bool(valid[1, 2])
    assert bool(valid[0, 0])
    np.testing.assert_allclose(np.asarray(xyz_img)[0, 1], img[0, 1], atol=0)

    # Mask-removing a point leaves its grid cell invalid through the view.
    keep = np.ones(h * w, bool)
    keep[g[2, 3]] = False
    b2 = b.with_mask(jnp.asarray(keep))
    _, valid2 = pc.organized_view(b2)
    assert not bool(valid2[2, 3])

    # compact remaps: every surviving cell still points at the same xyz.
    c = pc.compact(b2, h * w)
    gc = np.asarray(c.index_grid)
    cx = np.asarray(c.xyz)
    for row in range(h):
        for col in range(w):
            if (row, col) in ((1, 2), (2, 3)):
                assert gc[row, col] == -1 or not bool(
                    np.asarray(c.mask)[gc[row, col]]
                )
                continue
            assert gc[row, col] >= 0
            np.testing.assert_allclose(cx[gc[row, col]], img[row, col], atol=0)


def test_organized_surface_normal_uses_grid():
    """The registry's OrganizedCloudSurfaceNormal consumes the batch's own
    index grid (no rows/cols needed) and produces plane normals."""
    from open3d_slam_jax.config import registry

    h, w = 16, 16
    img = np.zeros((h, w, 3), np.float32)
    img[..., 0] = np.arange(w)[None, :] * 0.1
    img[..., 1] = np.arange(h)[:, None] * 0.1
    b = pc.from_organized(img)
    chain = registry.make_filter_chain(
        [{"OrganizedCloudSurfaceNormalDataPointsFilter": {}}]
    )
    out = chain(b, jax.random.key(0))
    n = np.asarray(out.normals)
    m = np.asarray(out.mask)
    interior = np.asarray(b.index_grid)[2:-2, 2:-2].reshape(-1)
    nz = np.abs(n[interior, 2])
    assert np.all(m[interior])
    assert np.all(nz > 0.99)  # flat plane -> +-z normals
