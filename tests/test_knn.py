import jax.numpy as jnp
import numpy as np
from scipy.spatial import cKDTree

from open3d_slam_jax.ops import grid_hash, knn
from open3d_slam_jax.ops import pointcloud as pc


def make_clouds(rng, n=500, m=800):
    q = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
    r = rng.uniform(-5, 5, size=(m, 3)).astype(np.float32)
    return q, r


def test_bruteforce_k1_matches_kdtree(rng):
    q, r = make_clouds(rng)
    res = knn.knn_bruteforce(
        jnp.asarray(q), jnp.ones(len(q), bool), jnp.asarray(r), jnp.ones(len(r), bool), k=1
    )
    tree = cKDTree(r)
    d_ref, i_ref = tree.query(q, k=1)
    np.testing.assert_array_equal(np.asarray(res.ids)[:, 0], i_ref)
    np.testing.assert_allclose(np.asarray(res.dists)[:, 0], d_ref**2, rtol=1e-4, atol=1e-5)


def test_bruteforce_k3(rng):
    q, r = make_clouds(rng, 200, 300)
    res = knn.knn_bruteforce(
        jnp.asarray(q), jnp.ones(len(q), bool), jnp.asarray(r), jnp.ones(len(r), bool), k=3
    )
    tree = cKDTree(r)
    d_ref, i_ref = tree.query(q, k=3)
    np.testing.assert_array_equal(np.asarray(res.ids), i_ref)
    # ascending
    d = np.asarray(res.dists)
    assert np.all(np.diff(d, axis=1) >= 0)


def test_bruteforce_max_dist(rng):
    q, r = make_clouds(rng)
    res = knn.knn_bruteforce(
        jnp.asarray(q), jnp.ones(len(q), bool), jnp.asarray(r), jnp.ones(len(r), bool),
        k=1, max_dist=0.3,
    )
    tree = cKDTree(r)
    d_ref, _ = tree.query(q, k=1)
    valid = np.asarray(res.valid())[:, 0]
    np.testing.assert_array_equal(valid, d_ref <= 0.3)
    assert np.all(np.asarray(res.ids)[~valid] == knn.INVALID_ID)
    assert np.all(np.isinf(np.asarray(res.dists)[~valid]))


def test_bruteforce_ref_mask(rng):
    q, r = make_clouds(rng, 100, 200)
    rmask = np.zeros(200, dtype=bool)
    rmask[:50] = True
    res = knn.knn_bruteforce(
        jnp.asarray(q), jnp.ones(100, bool), jnp.asarray(r), jnp.asarray(rmask), k=1
    )
    tree = cKDTree(r[:50])
    _, i_ref = tree.query(q, k=1)
    np.testing.assert_array_equal(np.asarray(res.ids)[:, 0], i_ref)


def test_bruteforce_query_mask(rng):
    q, r = make_clouds(rng, 64, 64)
    qmask = np.zeros(64, dtype=bool)
    qmask[:10] = True
    res = knn.knn_bruteforce(jnp.asarray(q), jnp.asarray(qmask), jnp.asarray(r), jnp.ones(64, bool), k=1)
    assert np.all(np.asarray(res.ids)[10:] == knn.INVALID_ID)
    assert np.all(np.asarray(res.ids)[:10] >= 0)


def test_bruteforce_nonaligned_sizes(rng):
    # Sizes far from tile multiples exercise the padding path.
    q, r = make_clouds(rng, 37, 53)
    res = knn.knn_bruteforce(jnp.asarray(q), jnp.ones(37, bool), jnp.asarray(r), jnp.ones(53, bool), k=2)
    tree = cKDTree(r)
    _, i_ref = tree.query(q, k=2)
    np.testing.assert_array_equal(np.asarray(res.ids), i_ref)


def test_grid_knn_matches_bruteforce_within_radius(rng):
    q = rng.uniform(-4, 4, size=(600, 3)).astype(np.float32)
    r = rng.uniform(-4, 4, size=(2000, 3)).astype(np.float32)
    radius = 0.5
    grid = grid_hash.build_grid(
        jnp.asarray(r), jnp.ones(len(r), bool), cell_size=2 * radius,
        table_size=1 << 12, bucket_cap=32,
    )
    res = grid_hash.grid_knn(grid, jnp.asarray(r), jnp.asarray(q), jnp.ones(len(q), bool), k=1, max_dist=radius)
    tree = cKDTree(r)
    d_ref, i_ref = tree.query(q, k=1, distance_upper_bound=radius)
    got_valid = np.asarray(res.valid())[:, 0]
    ref_valid = np.isfinite(d_ref)
    # Bucket cap 32 at this density: expect exact agreement.
    np.testing.assert_array_equal(got_valid, ref_valid)
    np.testing.assert_array_equal(np.asarray(res.ids)[got_valid, 0], i_ref[got_valid])


def test_grid_knn_k3(rng):
    q = rng.uniform(-3, 3, size=(300, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, size=(1500, 3)).astype(np.float32)
    radius = 0.6
    grid = grid_hash.build_grid(jnp.asarray(r), jnp.ones(len(r), bool), 2 * radius, 1 << 12, 64)
    res = grid_hash.grid_knn(grid, jnp.asarray(r), jnp.asarray(q), jnp.ones(len(q), bool), k=3, max_dist=radius)
    tree = cKDTree(r)
    d_ref, i_ref = tree.query(q, k=3, distance_upper_bound=radius)
    ref_valid = np.isfinite(d_ref)
    # f32 distance rounding can flip inclusion exactly at the radius
    # boundary; compare only clearly-inside / clearly-outside matches.
    clear = ~ref_valid | (np.abs(np.where(ref_valid, d_ref, 0.0) - radius) > 1e-4)
    np.testing.assert_array_equal(np.asarray(res.valid())[clear], ref_valid[clear])
    ids = np.asarray(res.ids)
    sure = ref_valid & clear
    np.testing.assert_array_equal(ids[sure], i_ref[sure])


def test_grid_build_masked_points_excluded(rng):
    r = rng.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    mask = np.zeros(100, bool)
    mask[:10] = True
    grid = grid_hash.build_grid(jnp.asarray(r), jnp.asarray(mask), 1.0, 1 << 8, 16)
    ids = np.asarray(grid.table[..., 3]).view(np.int32).ravel()
    assert set(ids[ids >= 0]) <= set(range(10))


def test_grid_match_payload_consistency(rng):
    r = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    nrm = rng.normal(size=(500, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(-2, 2, size=(200, 3)).astype(np.float32)
    grid = grid_hash.build_grid(
        jnp.asarray(r), jnp.ones(500, bool), 1.0, 1 << 10, 32, normals=jnp.asarray(nrm)
    )
    res = grid_hash.grid_match(grid, jnp.asarray(q), jnp.ones(200, bool), k=1, max_dist=0.5)
    valid = np.asarray(res.valid())[:, 0]
    ids = np.asarray(res.ids)[valid, 0]
    # Inlined payloads must equal the source arrays at the matched ids.
    np.testing.assert_allclose(np.asarray(res.xyz)[valid, 0], r[ids], atol=1e-6)
    np.testing.assert_allclose(np.asarray(res.normals)[valid, 0], nrm[ids], atol=1e-6)


def test_grid_overflow_graceful(rng):
    # 500 points in one cell with bucket_cap 8: query must still return a
    # valid (if approximate) neighbor, never garbage ids.
    r = (rng.uniform(0, 0.01, size=(500, 3))).astype(np.float32)
    grid = grid_hash.build_grid(jnp.asarray(r), jnp.ones(500, bool), 1.0, 1 << 8, 8)
    q = np.array([[0.005, 0.005, 0.005]], dtype=np.float32)
    res = grid_hash.grid_knn(grid, jnp.asarray(r), jnp.asarray(q), jnp.ones(1, bool), k=1, max_dist=0.5)
    assert int(res.ids[0, 0]) in range(500)


def test_packed_cell_list_matches_exact(rng):
    from open3d_slam_jax.ops import cell_list

    r = rng.uniform(-4, 4, size=(3000, 3)).astype(np.float32)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(-4, 4, size=(800, 3)).astype(np.float32)
    radius = 0.5
    exact = cell_list.build_cell_list(jnp.asarray(r), jnp.ones(3000, bool), radius,
                                      1 << 13, 48, normals=jnp.asarray(nrm))
    packed = cell_list.build_cell_list_packed(jnp.asarray(r), jnp.ones(3000, bool), radius,
                                              1 << 13, 48, normals=jnp.asarray(nrm))
    re = cell_list.cell_match(exact, jnp.asarray(q), jnp.ones(800, bool), k=1, max_dist=radius)
    rp = cell_list.cell_match_packed(packed, jnp.asarray(q), jnp.ones(800, bool), k=1, max_dist=radius)
    ve, vp = np.asarray(re.valid())[:, 0], np.asarray(rp.valid())[:, 0]
    # Valid sets agree except at quantization-boundary ties.
    assert np.mean(ve == vp) > 0.995
    both = ve & vp
    same_id = np.asarray(re.ids)[both, 0] == np.asarray(rp.ids)[both, 0]
    assert same_id.mean() > 0.99
    # Positions decode to ~25um, normals to ~1e-4.
    dx = np.abs(np.asarray(re.xyz)[both, 0] - np.asarray(rp.xyz)[both, 0])
    assert dx[same_id].max() < 1e-3
    dn = np.abs(
        np.asarray(re.normals)[both, 0][same_id]
        - np.asarray(rp.normals)[both, 0][same_id]
    )
    assert dn.max() < 1e-3


def test_cell_match_per_point_radius(rng):
    """KDTreeVarDistMatcher semantics: per-query search radii."""
    from open3d_slam_jax.ops import cell_list

    r = rng.uniform(-3, 3, size=(2000, 3)).astype(np.float32)
    q = rng.uniform(-3, 3, size=(400, 3)).astype(np.float32)
    cl = cell_list.build_cell_list(jnp.asarray(r), jnp.ones(2000, bool), 0.5, 1 << 12, 48)
    radii = rng.uniform(0.05, 0.5, size=400).astype(np.float32)
    res = cell_list.cell_match(cl, jnp.asarray(q), jnp.ones(400, bool), k=1,
                               max_dist=jnp.asarray(radii))
    from scipy.spatial import cKDTree
    tree = cKDTree(r)
    d_ref, i_ref = tree.query(q, k=1)
    valid = np.asarray(res.valid())[:, 0]
    expect = d_ref <= radii
    # boundary-rounding tolerance
    clear = np.abs(d_ref - radii) > 1e-4
    np.testing.assert_array_equal(valid[clear], expect[clear])
    np.testing.assert_array_equal(np.asarray(res.ids)[valid & clear, 0], i_ref[valid & clear])


def test_masked_candidate_match_same_pairs_as_compact(rng):
    """match_candidates_masked selects exactly the same (query, ref) pair set
    as the compact top-k selection, just in candidate-major layout."""
    from open3d_slam_jax.ops import cell_list, grid_hash

    r = rng.uniform(-4, 4, size=(3000, 3)).astype(np.float32)
    nrm = rng.normal(size=(3000, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    q = rng.uniform(-4, 4, size=(500, 3)).astype(np.float32)
    radius = 0.5
    cl = cell_list.build_cell_list(jnp.asarray(r), jnp.ones(3000, bool), radius,
                                   1 << 13, 48, normals=jnp.asarray(nrm))
    rows, valid = cell_list.gather_cell_candidates(cl, jnp.asarray(q), jnp.ones(500, bool))
    compact = grid_hash.match_from_candidates(rows, valid, jnp.asarray(q),
                                              jnp.ones(500, bool), radius, k=4)
    masked = grid_hash.match_candidates_masked(rows, valid, jnp.asarray(q),
                                               jnp.ones(500, bool), radius, k=4)
    for n in range(500):
        a = set(np.asarray(compact.ids)[n][np.asarray(compact.valid())[n]].tolist())
        b = set(np.asarray(masked.ids)[n][np.asarray(masked.valid())[n]].tolist())
        assert a == b, (n, a, b)
