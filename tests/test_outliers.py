import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import outliers


def test_trimmed_dist_keeps_ratio(rng):
    d = rng.uniform(0, 1, size=(1000, 1)).astype(np.float32) ** 2
    valid = np.ones((1000, 1), bool)
    w = np.asarray(outliers.trimmed_dist(jnp.asarray(d), jnp.asarray(valid), 0.75))
    frac = w.sum() / 1000
    assert 0.74 <= frac <= 0.76
    # Kept matches are exactly the smallest distances.
    kept = d[w > 0]
    dropped = d[w == 0]
    assert kept.max() <= dropped.min()


def test_trimmed_dist_ignores_invalid(rng):
    d = rng.uniform(0, 1, size=(100, 1)).astype(np.float32)
    valid = np.zeros((100, 1), bool)
    valid[:50] = True
    w = np.asarray(outliers.trimmed_dist(jnp.asarray(d), jnp.asarray(valid), 0.8))
    assert np.all(w[~valid] == 0)
    assert abs(w.sum() - 40) <= 1


def test_median_dist(rng):
    d = rng.uniform(0, 1, size=(500, 1)).astype(np.float32)
    valid = np.ones((500, 1), bool)
    w = np.asarray(outliers.median_dist(jnp.asarray(d), jnp.asarray(valid), 1.0))
    assert abs(w.sum() - 250) <= 5


def test_max_min_dist_weights():
    d = jnp.asarray([[0.01], [0.25], [1.2], [4.0]], jnp.float32)  # squared
    valid = jnp.ones((4, 1), bool)
    w_max = np.asarray(outliers.max_dist_weight(d, valid, 1.0))
    np.testing.assert_array_equal(w_max[:, 0], [1, 1, 0, 0])
    w_min = np.asarray(outliers.min_dist_weight(d, valid, 0.5))
    np.testing.assert_array_equal(w_min[:, 0], [0, 1, 1, 1])
    # invalid pairs always weigh zero
    invalid = jnp.zeros((4, 1), bool)
    assert np.asarray(outliers.max_dist_weight(d, invalid, 10.0)).sum() == 0


def test_generic_descriptor_weight_binary_and_soft():
    desc = jnp.asarray([0.2, 0.05, 0.8, 0.5], jnp.float32)
    valid = jnp.asarray([True, True, True, False])
    # binary, keep larger-than 0.1
    w = np.asarray(
        outliers.generic_descriptor_weight(desc, valid, False, True, 0.1)
    )
    np.testing.assert_array_equal(w, [1, 0, 1, 0])
    # binary, keep smaller-than 0.1
    w = np.asarray(
        outliers.generic_descriptor_weight(desc, valid, False, False, 0.1)
    )
    np.testing.assert_array_equal(w, [0, 1, 0, 0])
    # soft: descriptor / max over valid (OutlierFiltersImpl.cpp:357-376)
    w = np.asarray(
        outliers.generic_descriptor_weight(desc, valid, True, True, 0.1)
    )
    np.testing.assert_allclose(w, [0.25, 0.0625, 1.0, 0.0], rtol=1e-6)


def test_surface_normal_gate():
    rn = jnp.asarray([[0, 0, 1.0], [0, 0, 1.0], [1.0, 0, 0]])
    mn = jnp.asarray([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])
    valid = jnp.ones(3, bool)
    w = np.asarray(outliers.surface_normal_gate(rn, mn, valid, np.pi / 4))
    # aligned, orthogonal, anti-parallel (|cos| used -> kept)
    np.testing.assert_array_equal(w, [1.0, 0.0, 1.0])


def test_robust_weights_monotone(rng):
    e2 = jnp.asarray(np.linspace(0, 10, 50, dtype=np.float32))
    for name in ["cauchy", "welsch", "gm", "tukey", "huber", "student", "l1"]:
        w = np.asarray(outliers.robust_weight(name, e2, 1.0))
        assert np.all(np.isfinite(w)), name
        assert np.all(np.diff(w) <= 1e-6), name  # non-increasing
        assert w[0] > w[-1] or name == "tukey", name


def test_var_trimmed_picks_inlier_fraction(rng):
    # 70% inliers at near-constant distance, 30% gross outliers: the FRMSD
    # criterion (flat mean => FRMS ~ r^-2lam decreasing) cuts near 0.7.
    inl = (0.01 + rng.uniform(0, 0.001, size=700)).astype(np.float32)
    out = rng.uniform(1.0, 2.0, size=300).astype(np.float32)
    d = np.concatenate([inl, out])[:, None] ** 2
    valid = np.ones((1000, 1), bool)
    w = np.asarray(outliers.var_trimmed_dist(jnp.asarray(d), jnp.asarray(valid), 0.2, 0.99))
    frac = w.sum() / 1000
    assert 0.6 <= frac <= 0.8, frac
    assert np.all(w[:700, 0] >= w[700:, 0].max() - 1e-6)


def test_mad_scale(rng):
    e = np.abs(rng.normal(size=5000).astype(np.float32))
    d = (e**2)[:, None]
    valid = np.ones((5000, 1), bool)
    s = float(outliers.mad_scale(jnp.asarray(d), jnp.asarray(valid)))
    # For half-normal |N(0,1)|: median ~ 0.674, MAD ~ 0.394 -> scale ~ 0.585.
    assert 0.5 < s < 0.7


def test_trimmed_histogram_close_to_exact(rng):
    d = (rng.uniform(0, 0.5, size=(5000, 1)).astype(np.float32)) ** 2
    valid = rng.uniform(size=(5000, 1)) > 0.2
    exact = np.asarray(outliers.trimmed_dist(jnp.asarray(d), jnp.asarray(valid), 0.8))
    hist = np.asarray(outliers.trimmed_dist_histogram(jnp.asarray(d), jnp.asarray(valid), 0.8, 0.25))
    # Agreement except near the bin-resolution boundary.
    agree = (exact == hist).mean()
    assert agree > 0.98, agree
    kept_e, kept_h = exact.sum(), hist.sum()
    assert abs(kept_e - kept_h) / kept_e < 0.03
