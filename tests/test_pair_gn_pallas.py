"""Fused pair-GN Pallas kernel (Triton route) vs the XLA broadcast normal
equations. On the CPU the kernel runs in the Pallas interpreter
(``conftest`` sets ``interpret=True``)."""

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.kernels.pair_gn_pallas import pair_gn_fused
from open3d_slam_jax.models import minimizers
from open3d_slam_jax.geometry import se3


def _setup(rng, n=700, k=8):
    reading = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    q = reading[:, None, :] + rng.normal(scale=0.1, size=(n, k, 3)).astype(np.float32)
    nrm = rng.normal(size=(n, k, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    valid = rng.uniform(size=(n, k)) > 0.2
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray(se3.exp_so3(jnp.asarray([0.02, -0.01, 0.05])))
    T[:3, 3] = (0.1, -0.05, 0.02)
    return reading, q, nrm, valid, T


def test_fused_kernel_matches_xla(rng):
    reading, q, nrm, valid, T = _setup(rng)
    max_d2 = 0.5**2
    tau = 0.03
    A, b, sw, swr2, nok = pair_gn_fused(
        jnp.asarray(reading), jnp.asarray(q), jnp.asarray(nrm),
        jnp.asarray(valid), jnp.asarray(T), tau, max_d2,
        block=256,
    )
    # XLA reference path
    src = np.asarray(se3.apply_transform(jnp.asarray(T), jnp.asarray(reading)))
    d2 = np.sum((src[:, None, :] - q) ** 2, -1)
    w = (valid & (d2 <= max_d2) & (d2 <= tau)).astype(np.float32)
    A_ref, b_ref = minimizers.point_to_plane_normal_equations_bc(
        jnp.asarray(src), jnp.asarray(q), jnp.asarray(nrm), jnp.asarray(w)
    )
    np.testing.assert_allclose(np.asarray(A), np.asarray(A_ref), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(np.asarray(b), np.asarray(b_ref), rtol=2e-5, atol=2e-4)
    assert abs(float(sw) - w.sum()) < 1e-3
    r = np.sum((src[:, None, :] - q) * nrm, -1)
    np.testing.assert_allclose(float(swr2), float((w * r * r).sum()), rtol=1e-4)
    assert abs(float(nok) - float((valid & (d2 <= max_d2)).sum())) < 1e-3


def test_fused_kernel_no_trim(rng):
    reading, q, nrm, valid, T = _setup(rng, n=300)
    A, b, sw, _, _ = pair_gn_fused(
        jnp.asarray(reading), jnp.asarray(q), jnp.asarray(nrm),
        jnp.asarray(valid), jnp.asarray(T), np.inf, np.inf,
        block=128,
    )
    assert abs(float(sw) - valid.sum()) < 1e-3
    assert np.isfinite(np.asarray(A)).all() and np.isfinite(np.asarray(b)).all()


@pytest.mark.slow
def test_fused_icp_matches_xla_path(rng):
    """icp_single with cfg.fused_kernel ~= the XLA cached path."""
    import dataclasses

    from open3d_slam_jax.models import icp as icp_mod
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops.pointcloud import from_points

    ref_pts = rng.uniform(-6, 6, size=(6000, 3)).astype(np.float32)
    ref_pts[:, 2] = 0.2 * np.sin(ref_pts[:, 0]) + 0.2 * np.cos(ref_pts[:, 1] * 1.3)
    read = ref_pts[::2] + rng.normal(scale=0.005, size=(3000, 3)).astype(np.float32)

    cfg = icp_mod.ICPConfig(
        knn=8, max_match_dist=0.6, matcher="grid", grid_table_size=1 << 13,
        trimmed_ratio=0.9, fast_trimming=True, max_iterations=15,
        candidate_refresh_every=5, candidate_slack=0.15,
        moment_cached=False,  # force the kernel-vs-XLA comparison
    )
    ref_b = normals_mod.estimate_normals(from_points(jnp.asarray(ref_pts), capacity=8192), knn=10)
    reference = icp_mod.build_reference(ref_b, cfg)
    reading = from_points(jnp.asarray(read), capacity=4096)
    T0 = jnp.eye(4).at[0, 3].set(0.08).at[1, 3].set(-0.05)

    res_xla = icp_mod.icp_single(reading, reference, T0, cfg)
    cfg_f = dataclasses.replace(cfg, fused_kernel=True)
    res_fused = icp_mod.icp_single(reading, reference, T0, cfg_f)

    np.testing.assert_allclose(
        np.asarray(res_fused.transform), np.asarray(res_xla.transform), atol=5e-4
    )
    assert abs(float(res_fused.overlap_ratio) - float(res_xla.overlap_ratio)) < 0.05


@pytest.mark.slow
def test_fused_icp_vmapped(rng):
    import dataclasses

    import jax

    from open3d_slam_jax.models import icp as icp_mod
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops.pointcloud import from_points

    ref_pts = rng.uniform(-4, 4, size=(3000, 3)).astype(np.float32)
    # Bumpy surface: observable in all six DoF (a single plane is not).
    ref_pts[:, 2] = 0.3 * np.sin(ref_pts[:, 0] * 1.7) + 0.3 * np.cos(ref_pts[:, 1] * 1.1)
    read = ref_pts[::2] + rng.normal(scale=0.004, size=(1500, 3)).astype(np.float32)
    cfg = icp_mod.ICPConfig(
        knn=4, max_match_dist=0.6, matcher="grid", grid_table_size=1 << 12,
        trimmed_ratio=0.9, fast_trimming=True, max_iterations=10,
        candidate_refresh_every=5, fused_kernel=True,
        moment_cached=False,  # exercise the kernel, not the moment path
    )
    ref_b = normals_mod.estimate_normals(from_points(jnp.asarray(ref_pts), capacity=4096), knn=10)
    reference = icp_mod.build_reference(ref_b, cfg)
    reading = from_points(jnp.asarray(read), capacity=2048)
    T0s = jnp.stack([
        jnp.eye(4).at[0, 3].set(0.05),
        jnp.eye(4).at[1, 3].set(-0.04),
    ])
    res = jax.vmap(lambda t: icp_mod.icp_single(reading, reference, t, cfg))(T0s)
    T = np.asarray(res.transform)
    assert T.shape == (2, 4, 4)
    np.testing.assert_allclose(T[:, :3, 3], 0.0, atol=0.01)


@pytest.mark.slow
def test_fused_xicp_matches_xla_path(rng):
    """X-ICP chain with round-frozen analysis: the fused kernel + KKT solve
    must reproduce the unfused XLA path exactly."""
    import dataclasses

    import jax

    from open3d_slam_jax.models import icp as icp_mod
    from open3d_slam_jax.models.localizability import DegeneracyConfig
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops.pointcloud import from_points

    pts = np.c_[rng.uniform(-6, 6, (2000, 2)),
                0.3 * np.sin(rng.uniform(-6, 6, (2000, 1)))].astype(np.float32)
    ref_b = normals_mod.estimate_normals(
        from_points(jnp.asarray(pts), capacity=2048), knn=8, max_dist=1.0,
        orient_towards=(0.0, 0.0, 10.0),
    )
    T_true = np.asarray(se3.exp_se3(jnp.asarray(
        [0.01, -0.02, 0.03, 0.06, -0.04, 0.02], jnp.float32)))
    moved = pts @ np.linalg.inv(T_true)[:3, :3].T + np.linalg.inv(T_true)[:3, 3]
    reading = from_points(jnp.asarray(moved.astype(np.float32)), capacity=2048)
    base = icp_mod.ICPConfig(
        knn=1, max_match_dist=1.0, matcher="grid", grid_table_size=1 << 12,
        grid_bucket_cap=48, trimmed_ratio=0.85, max_iterations=12,
        coarse_iterations=0, candidate_refresh_every=6, candidate_slack=0.3,
        fast_trimming=True, moment_cached=False,
        degeneracy=DegeneracyConfig(method="equality_constraints"),
    )
    r_u = icp_mod.register_pair(reading, ref_b, jnp.eye(4), base)
    r_f = icp_mod.register_pair(
        reading, ref_b, jnp.eye(4), dataclasses.replace(base, fused_kernel=True)
    )
    np.testing.assert_allclose(
        np.asarray(r_f.transform), np.asarray(r_u.transform), atol=5e-5
    )
    np.testing.assert_array_equal(
        np.asarray(r_f.localizability_trans), np.asarray(r_u.localizability_trans)
    )


def test_folded_kernel_matches_padded(rng):
    """knn=1 pairs (the production chain's layout) give the same sums at
    every block size, i.e. whatever the padding to the block."""
    from open3d_slam_jax.kernels.pair_gn_pallas import pair_gn_fused

    reading, q, nrm, valid, T = _setup(rng, n=900, k=1)
    outs = [
        pair_gn_fused(
            jnp.asarray(reading), jnp.asarray(q), jnp.asarray(nrm),
            jnp.asarray(valid), jnp.asarray(T), 0.03, 0.5**2,
            block=block,
        )
        for block in (128, 512, 1024)
    ]
    A_p, b_p, sw_p, swr2_p, nok_p = outs[0]
    for A_f, b_f, sw_f, swr2_f, nok_f in outs[1:]:
        np.testing.assert_allclose(np.asarray(A_f), np.asarray(A_p), rtol=2e-5, atol=2e-4)
        np.testing.assert_allclose(np.asarray(b_f), np.asarray(b_p), rtol=2e-5, atol=2e-4)
        assert float(sw_f) == pytest.approx(float(sw_p), rel=1e-6)
        assert float(swr2_f) == pytest.approx(float(swr2_p), rel=1e-4)
        assert float(nok_f) == pytest.approx(float(nok_p), rel=1e-6)


def test_pair_gn_step_rejects_unpadded_pairs():
    from open3d_slam_jax.kernels.pair_gn_pallas import pair_gn_step

    soa = tuple(jnp.zeros((300,), jnp.float32) for _ in range(10))
    with pytest.raises(ValueError, match="multiple of block"):
        pair_gn_step(soa, jnp.eye(4), 0.1, 0.1, block=256, interpret=True)
