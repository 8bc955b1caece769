import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models import minimizers
from open3d_slam_jax.models.localizability import DegeneracyConfig
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc


def make_surface_cloud(rng, n=2000):
    """Box-ish scene with 3 orthogonal planes: fully constrains 6 DoF."""
    m = n // 3
    floor = np.c_[rng.uniform(-3, 3, (m, 2)), np.zeros((m, 1))]
    wallx = np.c_[np.zeros((m, 1)), rng.uniform(-3, 3, (m, 2))]
    wally = np.c_[rng.uniform(-3, 3, (m, 1)), np.full((m, 1), 3.0), rng.uniform(0, 3, (m, 1))]
    pts = np.vstack([floor, wallx, wally]).astype(np.float32)
    return pts + rng.normal(size=pts.shape).astype(np.float32) * 0.002


def with_normals(pts, capacity=None):
    b = pc.from_points(pts, capacity=capacity)
    return normals_mod.estimate_normals(b, knn=10, orient_towards=(0.0, 0.0, 10.0))


def small_transform(rot=0.05, trans=0.15):
    return se3.exp_se3(
        jnp.asarray([rot, -rot * 0.6, rot * 0.3, trans, -trans * 0.5, trans * 0.8], jnp.float32)
    )


BASE_CFG = icp_mod.ICPConfig(
    knn=1,
    max_match_dist=0.5,
    matcher="brute",
    trimmed_ratio=0.9,
    minimizer="point_to_plane",
    max_iterations=30,
    min_diff_rot=1e-4,
    min_diff_trans=1e-4,
)


def pose_error(T_est, T_true):
    delta = np.asarray(se3.transform_inverse(jnp.asarray(T_est)) @ T_true)
    rot_err = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    trans_err = np.linalg.norm(delta[:3, 3])
    return rot_err, trans_err


@pytest.mark.slow
def test_point_to_plane_recovers_transform(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    # reading = T_true^-1 * ref  => aligning reading to ref should give T_true.
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 1e-3, trans_err
    assert rot_err < 1e-4, rot_err
    # Accelerator float noise can keep the smoothed deltas marginally above the
    # (very tight) 1e-4 thresholds; accuracy is the real gate.
    assert bool(res.converged) or trans_err < 5e-4
    assert float(res.overlap_ratio) > 0.85


@pytest.mark.slow
def test_grid_matcher_matches_brute(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    cfg_grid = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "matcher": "grid",
                                    "grid_table_size": 1 << 14, "grid_bucket_cap": 32})
    res_b = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)
    res_g = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg_grid)
    np.testing.assert_allclose(
        np.asarray(res_g.transform), np.asarray(res_b.transform), atol=2e-3
    )


@pytest.mark.slow
def test_hash_matcher_matches_brute(rng):
    """The cheap-build per-cell bucket matcher (scan-to-scan odometry's
    default) must agree with brute force, both re-matched every iteration
    and in candidate-cached mode."""
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    res_b = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)
    for extra in ({}, {"candidate_refresh_every": 5, "fast_trimming": True}):
        cfg_h = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "matcher": "hash",
                                     "grid_table_size": 1 << 13,
                                     "grid_bucket_cap": 48, **extra})
        res_h = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg_h)
        np.testing.assert_allclose(
            np.asarray(res_h.transform), np.asarray(res_b.transform), atol=2e-3
        )


def test_point_to_point_recovers_transform(rng):
    ref_pts = make_surface_cloud(rng)
    ref = pc.from_points(ref_pts)
    T_true = small_transform(rot=0.03, trans=0.05)
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "minimizer": "point_to_point",
                               "trimmed_ratio": 0.95})
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 5e-3
    assert rot_err < 5e-3


def test_kabsch_exact_single_shot(rng):
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    T_true = np.asarray(small_transform(0.3, 1.0))
    moved = pts @ T_true[:3, :3].T + T_true[:3, 3]
    T = minimizers.point_to_point_transform(
        jnp.asarray(pts), jnp.asarray(moved), jnp.ones(100)
    )
    np.testing.assert_allclose(np.asarray(T), T_true, atol=1e-5)


def test_icp_with_initial_guess(rng):
    # Large offset fails from identity but succeeds from a good guess.
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = se3.exp_se3(jnp.asarray([0.4, 0.2, -0.3, 2.0, 1.5, 0.4], jnp.float32))
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    T_guess = T_true @ np.asarray(se3.exp_se3(jnp.asarray([0.02, 0, 0, 0.05, 0, 0], jnp.float32)))
    res = icp_mod.register_pair(reading, ref, jnp.asarray(T_guess), BASE_CFG)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 2e-3
    assert rot_err < 2e-3


def test_identical_clouds_identity(rng):
    ref_pts = make_surface_cloud(rng, 900)
    ref = with_normals(ref_pts)
    reading = pc.from_points(ref_pts)
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)
    rot_err, trans_err = pose_error(res.transform, jnp.eye(4))
    assert trans_err < 1e-4
    assert rot_err < 1e-4
    assert not bool(jnp.any(jnp.isnan(res.transform)))


def test_trimmed_rejects_outlier_region(rng):
    # Reading has 20% of points displaced; trimmed 0.75 should ignore them.
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform(0.02, 0.05)
    reading_pts = np.array(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    n_out = len(reading_pts) // 5
    reading_pts[:n_out] += rng.normal(size=(n_out, 3)).astype(np.float32) * 0.2 + 0.3
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "trimmed_ratio": 0.75})
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 5e-3
    assert rot_err < 5e-3


def corridor_cloud(rng, n=3000):
    """Two parallel walls + floor: unconstrained along x (corridor axis)."""
    m = n // 3
    floor = np.c_[rng.uniform(-5, 5, (m, 1)), rng.uniform(-1, 1, (m, 1)), np.zeros((m, 1))]
    w1 = np.c_[rng.uniform(-5, 5, (m, 1)), np.full((m, 1), 1.0), rng.uniform(0, 2, (m, 1))]
    w2 = np.c_[rng.uniform(-5, 5, (m, 1)), np.full((m, 1), -1.0), rng.uniform(0, 2, (m, 1))]
    return np.vstack([floor, w1, w2]).astype(np.float32)


def test_solution_remapping_locks_corridor_axis(rng):
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    # True offset along the corridor: unobservable; ICP should NOT move x.
    T_true = se3.exp_se3(jnp.asarray([0, 0, 0, 0.5, 0, 0], jnp.float32))
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    cfg = icp_mod.ICPConfig(**{
        **BASE_CFG.__dict__,
        "degeneracy": DegeneracyConfig(method="solution_remapping",
                                       solution_remapping_threshold=150.0),
    })
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    T = np.asarray(res.transform)
    # x must stay (near) zero: the degenerate direction is projected out.
    assert abs(T[0, 3]) < 0.05, T[0, 3]
    # eigenvalue spread reported
    assert float(res.condition_number) > 10


def test_equality_constraints_lock_corridor_axis(rng):
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = se3.exp_se3(jnp.asarray([0, 0, 0, 0.5, 0, 0], jnp.float32))
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    cfg = icp_mod.ICPConfig(**{
        **BASE_CFG.__dict__,
        "degeneracy": DegeneracyConfig(method="equality_constraints"),
    })
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    T = np.asarray(res.transform)
    assert abs(T[0, 3]) < 0.05, T[0, 3]
    assert bool(res.degenerate)
    # The x translation direction must be flagged non-localizable.
    assert float(jnp.min(res.localizability_trans)) < 0.5


def test_equality_constraints_well_constrained_matches_vanilla(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    cfg = icp_mod.ICPConfig(**{
        **BASE_CFG.__dict__,
        "degeneracy": DegeneracyConfig(method="equality_constraints"),
    })
    res_c = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
    res_v = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)
    assert not bool(res_c.degenerate)
    np.testing.assert_allclose(
        np.asarray(res_c.transform), np.asarray(res_v.transform), atol=1e-4
    )


@pytest.mark.slow
def test_register_hypotheses(rng):
    ref_pts = make_surface_cloud(rng, 900)
    ref = with_normals(ref_pts, capacity=1024)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts, capacity=1024)
    # 4 hypotheses: one good, three bad.
    inits = np.stack([
        np.eye(4, dtype=np.float32),
        np.asarray(se3.exp_se3(jnp.asarray([0, 0, 1.5, 4, 0, 0], jnp.float32))),
        np.asarray(se3.exp_se3(jnp.asarray([0, 0, -2.0, -4, 2, 0], jnp.float32))),
        np.asarray(se3.exp_se3(jnp.asarray([1.5, 0, 0, 0, -5, 1], jnp.float32))),
    ])
    res = icp_mod.register_hypotheses(reading, ref, jnp.asarray(inits), BASE_CFG)
    assert res.transform.shape == (4, 4, 4)
    residuals = np.asarray(res.residual)
    best = int(np.argmin(np.where(np.asarray(res.overlap_ratio) > 0.5, residuals, np.inf)))
    assert best == 0
    rot_err, trans_err = pose_error(np.asarray(res.transform)[0], T_true)
    assert trans_err < 2e-3


@pytest.mark.slow
def test_register_batch(rng):
    B = 3
    readings, refs, inits, trues = [], [], [], []
    for i in range(B):
        ref_pts = make_surface_cloud(rng, 900)
        twist = np.array([0.02 * (i + 1), 0, 0, 0.1 * (i + 1), 0, 0], np.float32)
        T_true = se3.exp_se3(jnp.asarray(twist))
        reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
        refs.append(with_normals(ref_pts, capacity=1024))
        readings.append(pc.from_points(reading_pts, capacity=1024))
        inits.append(np.eye(4, dtype=np.float32))
        trues.append(T_true)
    res = icp_mod.register_batch(pc.stack(readings), pc.stack(refs), jnp.asarray(np.stack(inits)), BASE_CFG)
    for i in range(B):
        rot_err, trans_err = pose_error(np.asarray(res.transform)[i], trues[i])
        assert trans_err < 3e-3, (i, trans_err)


def test_4dof_mode(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = se3.exp_se3(jnp.asarray([0, 0, 0.04, 0.1, -0.05, 0.08], jnp.float32))
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "force_4dof": True})
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 3e-3
    assert rot_err < 1e-3
    # Rotation must be pure yaw.
    T = np.asarray(res.transform)
    assert abs(T[2, 0]) < 1e-5 and abs(T[2, 1]) < 1e-5


def test_gicp_recovers_transform(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = normals_mod.estimate_normals(pc.from_points(reading_pts), knn=10)
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "minimizer": "gicp"})
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 1e-3, trans_err
    assert rot_err < 2e-4, rot_err


def test_gicp_moments_match_direct_system(rng):
    """The moment-tensor reconstruction of the GICP normal equations must
    equal the direct per-pair reduction exactly (same frozen M/weights)."""
    P = 400
    p0 = jnp.asarray(rng.normal(0, 4, (P, 3)).astype(np.float32))
    q = jnp.asarray(rng.normal(0, 4, (P, 3)).astype(np.float32))

    def unit(x):
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    sn = jnp.asarray(unit(rng.normal(size=(P, 3))).astype(np.float32))
    rn = jnp.asarray(unit(rng.normal(size=(P, 3))).astype(np.float32))
    w = jnp.asarray(
        ((rng.uniform(0, 1, P) > 0.25) * rng.uniform(0.5, 2, P)).astype(np.float32)
    )
    T = se3.exp_se3(jnp.asarray([0.05, -0.1, 0.2, 0.3, -0.2, 0.1], jnp.float32))
    p = p0 @ T[:3, :3].T + T[:3, 3]
    sn_rot = sn @ T[:3, :3].T
    A_d, b_d = minimizers.gicp_normal_equations(p, sn_rot, q, rn, w)
    mom = minimizers.gicp_moments(p0, sn_rot, q, rn, w)
    A_m, b_m, resid = minimizers.gicp_system_from_moments(T, mom)
    np.testing.assert_allclose(np.asarray(A_m), np.asarray(A_d), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(b_m), np.asarray(b_d), rtol=1e-4, atol=1e-2)
    rd = np.sqrt(float(jnp.sum(w * jnp.sum((p - q) ** 2, -1)) / jnp.sum(w)))
    assert abs(float(resid) - rd) < 1e-3 * rd


def test_pt2plane_moments_match_direct_system(rng):
    """Moment-tensor reconstruction of the point-to-plane normal equations
    must equal the direct per-pair reduction."""
    P = 600
    p0 = jnp.asarray(rng.normal(0, 4, (P, 3)).astype(np.float32))
    q = jnp.asarray(rng.normal(0, 4, (P, 3)).astype(np.float32))
    n = rng.normal(size=(P, 3))
    n = jnp.asarray((n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32))
    w = jnp.asarray(
        ((rng.uniform(0, 1, P) > 0.25) * rng.uniform(0.5, 2, P)).astype(np.float32)
    )
    T = se3.exp_se3(jnp.asarray([0.05, -0.1, 0.2, 0.3, -0.2, 0.1], jnp.float32))
    p = p0 @ T[:3, :3].T + T[:3, 3]
    A_d, b_d = minimizers.point_to_plane_normal_equations(p, q, n, w)
    mom = minimizers.point_to_plane_moments(p0, q, n, w)
    A_m, b_m, resid = minimizers.point_to_plane_system_from_moments(T, mom)
    np.testing.assert_allclose(np.asarray(A_m), np.asarray(A_d), rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(np.asarray(b_m), np.asarray(b_d), rtol=1e-4, atol=1e-2)
    r = jnp.sum((p - q) * n, -1)
    rd = float(jnp.sqrt(jnp.sum(w * r * r) / jnp.sum(w)))
    assert abs(float(resid) - rd) < 1e-3 * max(rd, 1e-6)


@pytest.mark.slow
def test_pt2plane_moment_cached_matches_direct(rng):
    """Moment-cached point-to-plane rounds (plain and X-ICP frozen-analysis)
    must land on the same transform as the direct path."""
    ref_pts = make_surface_cloud(rng, n=4500)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )
    reading = pc.from_points(reading_pts)
    base = dict(
        BASE_CFG.__dict__,
        matcher="grid",
        grid_table_size=1 << 13,
        grid_bucket_cap=48,
        candidate_refresh_every=5,
        candidate_slack=0.25,
        fast_trimming=True,
    )
    variants = [
        dict(degeneracy=DegeneracyConfig(method="none")),
        dict(degeneracy=DegeneracyConfig(method="equality_constraints")),
        dict(degeneracy=DegeneracyConfig(method="solution_remapping")),
        dict(knn=2),
    ]
    for extra in variants:
        errs = {}
        for mc in (False, True):
            cfg = icp_mod.ICPConfig(**{**base, "moment_cached": mc, **extra})
            res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
            errs[mc] = pose_error(res.transform, T_true)
        assert errs[True][1] < 1e-3, (extra, errs)
        assert errs[True][0] < 3e-4, (extra, errs)
        assert errs[False][1] < 1e-3, (extra, errs)


def _production_icp(name):
    from open3d_slam_jax.slam.mapper import MapperConfig
    from open3d_slam_jax.slam.odometry import OdometryConfig

    cfg = {"mapper_xicp": MapperConfig().icp, "odometry_hash": OdometryConfig().icp}[name]
    # Small cloud: a table sized for it keeps the test fast.
    return dataclasses.replace(
        cfg, grid_table_size=1 << 12, max_match_dist=0.5, fused_kernel=False
    )


@pytest.mark.parametrize("chain", ["mapper_xicp", "odometry_hash"])
def test_production_chain_moment_cached_matches_direct(rng, chain):
    """The mapper's X-ICP chain and the odometry hash chain land on the same
    transform with moment-cached rounds (their default linearisation) as
    with the direct per-pair path."""
    ref_pts = make_surface_cloud(rng, n=3000)
    ref = with_normals(ref_pts, capacity=4096)
    T_true = small_transform(0.02, 0.08)
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )
    reading = pc.from_points(reading_pts, capacity=4096)
    cfg = _production_icp(chain)
    assert cfg.moment_cached
    T = {}
    for mc in (True, False):
        res = icp_mod.register_pair(
            reading, ref, jnp.eye(4), dataclasses.replace(cfg, moment_cached=mc)
        )
        T[mc] = np.asarray(res.transform)
        rot_err, trans_err = pose_error(T[mc], T_true)
        assert trans_err < 5e-3 and rot_err < 2e-3, (mc, rot_err, trans_err)
    np.testing.assert_allclose(T[True], T[False], atol=5e-3)


@pytest.mark.slow
def test_gicp_moment_cached_matches_direct(rng):
    """Moment-cached GICP rounds (O(1) in-round iterations) must land on
    the same transform as the direct per-pair path."""
    ref_pts = make_surface_cloud(rng, n=4500)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )
    reading = normals_mod.estimate_normals(pc.from_points(reading_pts), knn=10)
    base = dict(
        BASE_CFG.__dict__,
        minimizer="gicp",
        matcher="grid",
        grid_table_size=1 << 13,
        grid_bucket_cap=48,
        candidate_refresh_every=5,
        candidate_slack=0.25,
        fast_trimming=True,
    )
    errs = {}
    for mc in (False, True):
        cfg = icp_mod.ICPConfig(**{**base, "moment_cached": mc})
        res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
        errs[mc] = pose_error(res.transform, T_true)
    # Both converge; the moment path must be at least as accurate (its
    # stale-round guard re-verifies convergence on fresh weights).
    assert errs[True][1] < 2e-3, errs
    assert errs[True][0] < 5e-4, errs
    assert errs[False][1] < 2e-3, errs


@pytest.mark.slow
def test_gicp_beats_point_to_point_on_sliding_planes(rng):
    # Two offset parallel planes sliding: plane-to-plane cost should still
    # lock z while tolerating in-plane sampling differences.
    n = 1500
    a = np.c_[rng.uniform(-3, 3, (n, 2)), np.zeros((n, 1))].astype(np.float32)
    b = np.c_[rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 1.0)].astype(np.float32)
    ref_pts = np.vstack([a, b])
    ref = with_normals(ref_pts)
    T_true = se3.exp_se3(jnp.asarray([0, 0, 0, 0, 0, 0.3], jnp.float32))
    # Independent sampling of the same surfaces for the reading.
    a2 = np.c_[rng.uniform(-3, 3, (n, 2)), np.zeros((n, 1))].astype(np.float32)
    b2 = np.c_[rng.uniform(-3, 3, (n, 2)), np.full((n, 1), 1.0)].astype(np.float32)
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(np.vstack([a2, b2])))
    )
    reading = normals_mod.estimate_normals(pc.from_points(reading_pts), knn=10)
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "minimizer": "gicp"})
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
    T = np.asarray(res.transform)
    assert abs(T[2, 3] - 0.3) < 0.02, T[2, 3]


def test_candidate_cached_matches_exact(rng):
    """Cache-mode ICP must land on (nearly) the same transform as the
    re-match-every-iteration mode."""
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    base = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "matcher": "grid",
                               "grid_table_size": 1 << 14, "grid_bucket_cap": 32})
    cached = icp_mod.ICPConfig(**{**base.__dict__, "candidate_refresh_every": 5,
                                  "candidate_slack": 0.25})
    res_e = icp_mod.register_pair(reading, ref, jnp.eye(4), base)
    res_c = icp_mod.register_pair(reading, ref, jnp.eye(4), cached)
    # Early rounds can exceed the slack (cold start), so allow small
    # deviation; accuracy vs ground truth must stay in the same class.
    np.testing.assert_allclose(
        np.asarray(res_c.transform), np.asarray(res_e.transform), atol=3e-3
    )
    rot_err, trans_err = pose_error(res_c.transform, T_true)
    assert trans_err < 2e-3, trans_err


def test_candidate_cached_with_good_prior_is_exact(rng):
    """With a near-truth prior (the production fine-phase regime), cached
    mode matches the exact matcher tightly."""
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    prior = np.asarray(T_true) @ np.asarray(
        se3.exp_se3(jnp.asarray([0.003, 0, -0.002, 0.02, 0.01, 0], jnp.float32))
    )
    base = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "matcher": "grid",
                               "grid_table_size": 1 << 14, "grid_bucket_cap": 32})
    cached = icp_mod.ICPConfig(**{**base.__dict__, "candidate_refresh_every": 5,
                                  "candidate_slack": 0.25})
    res_e = icp_mod.register_pair(reading, ref, jnp.asarray(prior, jnp.float32), base)
    res_c = icp_mod.register_pair(reading, ref, jnp.asarray(prior, jnp.float32), cached)
    np.testing.assert_allclose(
        np.asarray(res_c.transform), np.asarray(res_e.transform), atol=2e-4
    )


def test_inspector_trace_and_dump(rng, tmp_path):
    from open3d_slam_jax.models import inspector

    ref_pts = make_surface_cloud(rng, 900)
    ref_b = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    ref = icp_mod.build_reference(ref_b, BASE_CFG)
    trace = inspector.trace_icp(reading, ref, jnp.eye(4), BASE_CFG, iterations=12)
    assert trace.transforms.shape == (12, 4, 4)
    res = np.asarray(trace.residuals)
    assert res[-1] < res[0]  # optimization actually descends
    # Deltas shrink towards convergence.
    assert np.asarray(trace.delta_trans)[-1] < np.asarray(trace.delta_trans)[0]
    path = inspector.dump_trace(trace, reading, ref, str(tmp_path / "dump"), every=4)
    import json, os
    stats = json.load(open(path))
    assert stats["iterations"] == 12
    assert os.path.exists(tmp_path / "dump" / "reading_iter_000.ply")
    assert os.path.exists(tmp_path / "dump" / "reference.ply")

    pi = inspector.PerformanceInspector()
    pi.add_trace(trace)
    s = pi.summary()
    assert s["IterationsCount"]["last"] == 12


@pytest.mark.slow
def test_bound_checker_aborts_runaway(rng):
    """A mostly-unconstrained problem that would slide far gets frozen at
    the prior when the bound checker fires (≙ BoundTransformationChecker:
    abort => ICP returns the initial guess)."""
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = se3.exp_se3(jnp.asarray([0, 0, 0, 1.5, 0, 0], jnp.float32))
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "max_match_dist": 2.0,
                               "max_translation_norm": 0.2})
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    T = np.asarray(res.transform)
    assert bool(res.aborted)
    np.testing.assert_allclose(T, np.eye(4), atol=1e-5)  # prior returned
    # Without the bound it is free to move.
    cfg2 = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "max_match_dist": 2.0})
    res2 = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg2)
    assert not bool(res2.aborted)


def test_covariance_shape_and_scale(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), BASE_CFG)
    C = np.asarray(res.covariance)
    assert C.shape == (6, 6)
    assert np.all(np.isfinite(C))
    # Symmetric PSD-ish, and small for a well-constrained low-noise problem.
    np.testing.assert_allclose(C, C.T, atol=1e-8)
    assert np.all(np.diag(C) >= 0)
    assert np.all(np.diag(C) < 1e-3)


@pytest.mark.slow
def test_icp_sequence_api(rng):
    ref_pts = make_surface_cloud(rng, 900)
    ref = with_normals(ref_pts)
    seq = icp_mod.ICPSequence(BASE_CFG)
    assert not seq.has_map()
    import pytest as _pt
    with _pt.raises(RuntimeError):
        seq(pc.from_points(ref_pts))
    seq.set_map(ref)
    assert seq.has_map()
    T_true = small_transform(0.02, 0.05)
    for i in range(3):  # stream of readings against the same map
        reading_pts = np.asarray(
            se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
        ) + rng.normal(size=(len(ref_pts), 3)).astype(np.float32) * 0.002
        res = seq(pc.from_points(reading_pts))
        rot_err, trans_err = pose_error(res.transform, T_true)
        assert trans_err < 5e-3
    seq.clear_map()
    assert not seq.has_map()


@pytest.mark.slow
def test_packed_payload_icp_matches_exact(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform()
    reading_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(reading_pts)
    base = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "matcher": "grid",
                               "grid_table_size": 1 << 14, "grid_bucket_cap": 48})
    packed = icp_mod.ICPConfig(**{**base.__dict__, "packed_payload": True})
    r0 = icp_mod.register_pair(reading, ref, jnp.eye(4), base)
    r1 = icp_mod.register_pair(reading, ref, jnp.eye(4), packed)
    np.testing.assert_allclose(np.asarray(r1.transform), np.asarray(r0.transform), atol=5e-4)
    # Cached + packed together.
    cp = icp_mod.ICPConfig(**{**packed.__dict__, "candidate_refresh_every": 5})
    r2 = icp_mod.register_pair(reading, ref, jnp.eye(4), cp)
    rot_err, trans_err = pose_error(r2.transform, T_true)
    assert trans_err < 2e-3, trans_err


def test_var_trimmed_in_loop(rng):
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform(0.02, 0.05)
    reading_pts = np.array(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    n_out = len(reading_pts) // 4
    reading_pts[:n_out] += 0.5  # gross outlier block
    cfg = icp_mod.ICPConfig(**{**BASE_CFG.__dict__, "trimmed_ratio": None,
                               "var_trimmed": (0.3, 0.95)})
    res = icp_mod.register_pair(pc.from_points(reading_pts), ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 1e-2, trans_err


def test_unrolled_spd_solver_matches_numpy(rng):
    for n in (4, 6):
        M = rng.normal(size=(n, n)).astype(np.float32)
        A = M @ M.T + np.eye(n, dtype=np.float32) * 0.1
        b = rng.normal(size=n).astype(np.float32)
        x = np.asarray(minimizers.solve_spd_unrolled(jnp.asarray(A), jnp.asarray(b), damping=0.0))
        np.testing.assert_allclose(A @ x, b, atol=2e-4 * np.abs(b).max() + 1e-4)


@pytest.mark.slow
def test_anderson_acceleration_reduces_iterations(rng):
    """AA(1) (AA-ICP, arxiv 1709.05479) cuts vanilla-ICP iterations on a
    slow-converging problem and lands on the same pose."""
    import dataclasses

    from open3d_slam_jax.ops import normals as normals_mod

    ref_pts = rng.uniform(-6, 6, size=(5000, 3)).astype(np.float32)
    ref_pts[:, 2] = 0.4 * np.sin(ref_pts[:, 0]) + 0.4 * np.cos(ref_pts[:, 1] * 0.7)
    read = ref_pts[::2] + rng.normal(scale=0.01, size=(2500, 3)).astype(np.float32)

    # Vanilla chain: point-to-point (slow linear convergence), no coarse
    # phase, tight differential thresholds.
    cfg = icp_mod.ICPConfig(
        knn=1, max_match_dist=1.5, matcher="grid", grid_table_size=1 << 13,
        minimizer="point_to_point", max_iterations=60,
        min_diff_rot=5e-5, min_diff_trans=5e-5,
    )
    ref_b = normals_mod.estimate_normals(
        pc.from_points(jnp.asarray(ref_pts), capacity=8192), knn=10)
    reference = icp_mod.build_reference(ref_b, cfg)
    reading = pc.from_points(jnp.asarray(read), capacity=4096)
    T0 = jnp.eye(4).at[0, 3].set(0.4).at[1, 3].set(-0.3)

    plain = icp_mod.icp_single(reading, reference, T0, cfg)
    aa = icp_mod.icp_single(
        reading, reference, T0, dataclasses.replace(cfg, anderson=True))
    assert bool(plain.converged) and bool(aa.converged)
    assert int(aa.iterations) <= int(plain.iterations)
    np.testing.assert_allclose(
        np.asarray(aa.transform)[:3, 3], np.asarray(plain.transform)[:3, 3],
        atol=5e-3,
    )


def test_generic_descriptor_gate_rejects_low_confidence_region(rng):
    """GenericDescriptorOutlierFilter end-to-end: a displaced ghost copy of
    the floor carries descriptor 0; gating on it recovers the transform the
    ungated chain is dragged away from (OutlierFiltersImpl.cpp:295-377)."""
    good = make_surface_cloud(rng, n=1500)
    # A rigidly co-moving low-confidence shelf 0.2 m above the floor: its
    # readings can only match conf-0 reference points, so the gate must
    # zero exactly those pairs (visible in the overlap observable).
    ghost = good[good[:, 2] < 0.1] + np.asarray([0.0, 0.0, 0.2], np.float32)
    ref_pts = np.vstack([good, ghost])
    conf = np.concatenate(
        [np.ones(len(good), np.float32), np.zeros(len(ghost), np.float32)]
    )[:, None]
    ref = normals_mod.estimate_normals(
        pc.from_points(ref_pts, extras={"confidence": conf}),
        knn=10, orient_towards=(0.0, 0.0, 10.0),
    )
    T_true = small_transform(rot=0.02, trans=0.08)
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )
    reading = pc.from_points(reading_pts)
    base = icp_mod.ICPConfig(
        knn=1, max_match_dist=0.5, matcher="brute", trimmed_ratio=None,
        minimizer="point_to_plane", max_iterations=30,
        min_diff_rot=1e-4, min_diff_trans=1e-4,
    )
    gated = dataclasses.replace(
        base, generic_descriptor=("confidence", False, True, 0.5)
    )
    res_gated = icp_mod.register_pair(reading, ref, jnp.eye(4), gated)
    res_plain = icp_mod.register_pair(reading, ref, jnp.eye(4), base)
    _, terr_g = pose_error(res_gated.transform, T_true)
    assert terr_g < 2e-3, terr_g
    # The gate measurably removes pairs: every reading point whose nearest
    # neighbour is a ghost (conf-0) point weighs zero, so the weighted
    # overlap must drop by about the ghost fraction vs the ungated chain.
    assert float(res_gated.overlap_ratio) < float(res_plain.overlap_ratio) - 0.1


def test_max_min_residual_dist_in_loop(rng):
    """MaxDist/MinDist outlier gates run inside the jitted loop and still
    recover the pose on clean data (OutlierFiltersImpl.h:70-107)."""
    ref_pts = make_surface_cloud(rng)
    ref = with_normals(ref_pts)
    T_true = small_transform(rot=0.02, trans=0.08)
    reading_pts = np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )
    reading = pc.from_points(reading_pts)
    cfg = dataclasses.replace(
        BASE_CFG, trimmed_ratio=None, max_residual_dist=0.4,
        min_residual_dist=1e-6,
    )
    res = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(res.transform, T_true)
    assert trans_err < 1e-3, trans_err
    assert rot_err < 1e-3, rot_err
