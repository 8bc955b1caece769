import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import grid_hash, normals
from open3d_slam_jax.ops import pointcloud as pc


def test_eigh3x3_matches_numpy(rng):
    A = rng.normal(size=(200, 3, 3)).astype(np.float32)
    A = A + np.swapaxes(A, 1, 2)
    evals, evecs = normals.eigh3x3(jnp.asarray(A))
    ref_vals = np.linalg.eigvalsh(A)
    np.testing.assert_allclose(np.asarray(evals), ref_vals, atol=2e-4 * np.abs(ref_vals).max())
    # Eigenvector property: A v = lambda v.
    for i in range(3):
        v = np.asarray(evecs)[..., :, i]
        lam = np.asarray(evals)[..., i]
        resid = np.einsum("bij,bj->bi", A, v) - lam[:, None] * v
        assert np.max(np.abs(resid)) < 5e-3


def test_eigh3x3_degenerate_isotropic():
    A = np.tile(np.eye(3, dtype=np.float32) * 2.0, (4, 1, 1))
    evals, evecs = normals.eigh3x3(jnp.asarray(A))
    np.testing.assert_allclose(np.asarray(evals), 2.0, atol=1e-5)
    # Vectors remain orthonormal.
    VtV = np.einsum("bij,bik->bjk", np.asarray(evecs), np.asarray(evecs))
    np.testing.assert_allclose(VtV, np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-4)


def make_plane(rng, n=400, normal=(0.0, 0.0, 1.0), noise=0.0):
    normal = np.asarray(normal, np.float32)
    normal = normal / np.linalg.norm(normal)
    # Basis orthogonal to the normal.
    a = np.array([1.0, 0, 0], np.float32)
    if abs(normal @ a) > 0.9:
        a = np.array([0, 1.0, 0], np.float32)
    u = np.cross(normal, a); u /= np.linalg.norm(u)
    v = np.cross(normal, u)
    coords = rng.uniform(-1, 1, size=(n, 2)).astype(np.float32)
    pts = coords[:, :1] * u + coords[:, 1:] * v
    pts += rng.normal(size=(n, 1)).astype(np.float32) * noise * normal
    return pts.astype(np.float32), normal


def test_plane_normals(rng):
    pts, n_true = make_plane(rng, normal=(1.0, 2.0, 3.0), noise=1e-3)
    b = pc.from_points(pts)
    out = normals.estimate_normals(b, knn=12)
    got = np.asarray(out.normals)
    dots = np.abs(got @ n_true)
    assert np.mean(dots > 0.99) > 0.95


def test_normals_oriented(rng):
    pts, n_true = make_plane(rng, normal=(0, 0, 1.0))
    pts = pts + np.array([0, 0, -5.0], np.float32)  # plane below sensor
    b = pc.from_points(pts)
    out = normals.estimate_normals(b, knn=10, orient_towards=(0.0, 0.0, 0.0))
    got = np.asarray(out.normals)
    # All normals should point up (towards sensor at origin).
    assert np.all(got[:, 2] > 0.9)


def test_normals_grid_matches_bruteforce(rng):
    pts = rng.uniform(-2, 2, size=(800, 3)).astype(np.float32)
    b = pc.from_points(pts)
    bf = normals.estimate_normals(b, knn=8, max_dist=0.8)
    grid = grid_hash.build_grid(b.padded_xyz(), b.mask, 1.6, 1 << 12, 64)
    gr = normals.estimate_normals_grid(b, grid, knn=8, max_dist=0.8)
    # Normals agree up to sign for nearly all points.
    dots = np.abs(np.sum(np.asarray(bf.normals) * np.asarray(gr.normals), axis=-1))
    valid = np.linalg.norm(np.asarray(bf.normals), axis=-1) > 0.5
    assert np.mean(dots[valid] > 0.999) > 0.98


def test_normals_return_eigen(rng):
    pts, _ = make_plane(rng, noise=1e-3)
    b = pc.from_points(pts)
    out = normals.estimate_normals(b, knn=10, return_eigen=True)
    ev = np.asarray(out.extras["eigValues"])
    assert ev.shape == (400, 3)
    assert np.all(np.diff(ev, axis=1) >= -1e-5)  # ascending
    surf = np.asarray(out.extras["surfaceness"])
    assert surf.mean() > 0.5  # planar cloud -> high surfaceness
    assert np.mean(surf > 0.3) > 0.8


def test_normals_masked_points_zero(rng):
    pts = rng.uniform(-1, 1, size=(50, 3)).astype(np.float32)
    b = pc.from_points(pts, capacity=100)
    out = normals.estimate_normals(b, knn=6)
    got = np.asarray(out.normals)
    assert np.all(got[50:] == 0)
    assert np.all(np.abs(np.linalg.norm(got[:50], axis=-1) - 1.0) < 1e-3)


def test_organized_normals_plane(rng):
    # Range image of a tilted plane z = 0.2x + 0.1y + 2.
    H, W = 32, 64
    u, v = np.meshgrid(np.linspace(-2, 2, W), np.linspace(-1, 1, H))
    xyz = np.stack([u, v, 0.2 * u + 0.1 * v + 2.0], axis=-1).astype(np.float32)
    valid = np.ones((H, W), bool)
    n = np.asarray(normals.estimate_normals_organized(jnp.asarray(xyz), jnp.asarray(valid)))
    expected = np.array([-0.2, -0.1, 1.0]); expected /= np.linalg.norm(expected)
    inner = n[2:-2, 2:-2].reshape(-1, 3)
    dots = np.abs(inner @ expected)
    assert np.mean(dots > 0.999) > 0.99


def test_organized_normals_invalid_holes(rng):
    H, W = 16, 16
    xyz = rng.normal(size=(H, W, 3)).astype(np.float32)
    valid = np.ones((H, W), bool)
    valid[5, 5] = False
    n = np.asarray(normals.estimate_normals_organized(jnp.asarray(xyz), jnp.asarray(valid)))
    # Neighbourhood of the hole has zero normals.
    assert np.all(n[5, 4] == 0) and np.all(n[4, 5] == 0) and np.all(n[5, 5] == 0)
