"""Identical-correspondence parity vs an independent numpy/float64 oracle.

BASELINE.json's acceptance criterion: given identical correspondences and
iteration budget, the minimizers must agree with the reference's closed-form
solves to <=1e-3 m translation / 1e-4 rad rotation. The oracle below is an
independent float64 re-implementation of the reference's math:

- point-to-plane: ``A = wF F^T``, ``b = -wF (d.n)`` with ``F = [p x n ; n]``
  (``ICP.cpp:1513-1567`` calculateOptimizationHessian), solved and turned
  into SE(3) via the atan axis-angle reconstruction
  (``PointToPlane.cpp:340-370``);
- force4DOF: ``F = [(p x n)_z ; n]``, ``x = [yaw, t]``;
- point-to-point: weighted Umeyama/Kabsch with determinant correction
  (``PointToPoint.cpp``).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import minimizers


# ---------------------------------------------------------------------------
# Oracle (numpy, float64) — deliberately written from the reference math,
# sharing no code with the JAX implementation.
# ---------------------------------------------------------------------------


def oracle_p2plane_x(p, q, n, w):
    cross = np.cross(p, n)
    F = np.concatenate([cross, n], axis=1)  # [N, 6]
    wF = w[:, None] * F
    A = wF.T @ F
    d = np.einsum("ni,ni->n", p - q, n)
    b = -(wF.T @ d)
    # Reference: double-precision SVD solve (PointToPlane.cpp:255).
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    return x


def oracle_x_to_transform(x):
    """atan axis-angle reconstruction (PointToPlane.cpp:340-370)."""
    T = np.eye(4)
    nrm = np.linalg.norm(x[:3])
    if nrm > 1e-12:
        angle = np.arctan(nrm)
        axis = x[:3] / nrm
        K = np.array(
            [[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]]
        )
        T[:3, :3] = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    T[:3, 3] = x[3:6]
    return T


def oracle_p2plane_transform(p, q, n, w):
    return oracle_x_to_transform(oracle_p2plane_x(p, q, n, w))


def oracle_p2plane_4dof_transform(p, q, n, w):
    cross_z = p[:, 0] * n[:, 1] - p[:, 1] * n[:, 0]
    F = np.concatenate([cross_z[:, None], n], axis=1)  # [N, 4]
    wF = w[:, None] * F
    A = wF.T @ F
    d = np.einsum("ni,ni->n", p - q, n)
    b = -(wF.T @ d)
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    T = np.eye(4)
    c, s = np.cos(x[0]), np.sin(x[0])
    T[0, 0], T[0, 1], T[1, 0], T[1, 1] = c, -s, s, c
    T[:3, 3] = x[1:4]
    return T


def oracle_p2point_transform(p, q, w):
    w = w / w.sum()
    cp = w @ p
    cq = w @ q
    P, Q = p - cp, q - cq
    H = (w[:, None] * P).T @ Q
    U, _, Vt = np.linalg.svd(H)
    d = np.linalg.det(Vt.T @ U.T)
    R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = cq - R @ cp
    return T


def rot_err(Ta, Tb):
    """Geodesic angle between rotations via atan2(|skew|, cos) — the
    arccos((tr-1)/2) form has a sqrt(eps) precision floor near identity
    (~3e-4 for f32 inputs), far above the 1e-4 tolerance being asserted."""
    R = np.asarray(Ta, np.float64)[:3, :3].T @ np.asarray(Tb, np.float64)[:3, :3]
    s = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return abs(np.arctan2(np.linalg.norm(s), (np.trace(R) - 1) / 2))


def trans_err(Ta, Tb):
    return np.linalg.norm(np.asarray(Ta)[:3, 3] - np.asarray(Tb)[:3, 3])


# ---------------------------------------------------------------------------
# Shared geometry: a well-conditioned correspondence set with mixed weights.
# ---------------------------------------------------------------------------


def make_pairs(rng, n=2000, trans=0.05, rot=0.02, noise=0.002):
    p = rng.uniform(-5, 5, (n, 3))
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    tw = np.r_[rng.normal(size=3) * rot, rng.normal(size=3) * trans]
    T_true = np.asarray(se3.exp_se3(jnp.asarray(tw, jnp.float32)), np.float64)
    q = (T_true[:3, :3] @ p.T).T + T_true[:3, 3] + rng.normal(size=(n, 3)) * noise
    w = rng.uniform(0.0, 1.0, n) * (rng.uniform(size=n) > 0.2)
    return (
        p.astype(np.float32), q.astype(np.float32),
        nrm.astype(np.float32), w.astype(np.float32),
    )


TOL_TRANS = 1e-3  # m   (BASELINE.json criterion)
TOL_ROT = 1e-4  # rad


def ours_p2plane_step(p, q, n, w):
    A, b = minimizers.point_to_plane_normal_equations(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(n), jnp.asarray(w)
    )
    x = minimizers.solve_normal_equations_fast(A, b)
    return np.asarray(minimizers.delta_transform_from_x(x), np.float64)


def test_point_to_plane_single_step(rng):
    p, q, n, w = make_pairs(rng)
    T_ours = ours_p2plane_step(p, q, n, w)
    T_gold = oracle_p2plane_transform(
        p.astype(np.float64), q.astype(np.float64),
        n.astype(np.float64), w.astype(np.float64),
    )
    assert trans_err(T_ours, T_gold) < TOL_TRANS
    assert rot_err(T_ours, T_gold) < TOL_ROT


def test_point_to_plane_iteration_budget(rng):
    """Same pinned correspondences fed to both engines for 5 iterations
    (i <-> i every round, weights fixed): final transforms must agree."""
    p, q, n, w = make_pairs(rng, trans=0.08, rot=0.04)
    K = 5

    T_ours = np.eye(4)
    for _ in range(K):
        src = (T_ours[:3, :3] @ p.astype(np.float64).T).T + T_ours[:3, 3]
        dT = ours_p2plane_step(src.astype(np.float32), q, n, w)
        T_ours = dT @ T_ours

    T_gold = np.eye(4)
    p64, q64 = p.astype(np.float64), q.astype(np.float64)
    n64, w64 = n.astype(np.float64), w.astype(np.float64)
    for _ in range(K):
        src = (T_gold[:3, :3] @ p64.T).T + T_gold[:3, 3]
        dT = oracle_p2plane_transform(src, q64, n64, w64)
        T_gold = dT @ T_gold

    assert trans_err(T_ours, T_gold) < TOL_TRANS
    assert rot_err(T_ours, T_gold) < TOL_ROT


def test_point_to_plane_4dof(rng):
    p, q, n, w = make_pairs(rng)
    A, b = minimizers.point_to_plane_4dof_normal_equations(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(n), jnp.asarray(w)
    )
    x = minimizers.solve_spd_unrolled(A, b)
    T_ours = np.asarray(minimizers.delta_transform_from_x(x, force_4dof=True), np.float64)
    T_gold = oracle_p2plane_4dof_transform(
        p.astype(np.float64), q.astype(np.float64),
        n.astype(np.float64), w.astype(np.float64),
    )
    assert trans_err(T_ours, T_gold) < TOL_TRANS
    assert rot_err(T_ours, T_gold) < TOL_ROT


def test_point_to_point(rng):
    p, q, _n, w = make_pairs(rng)
    T_ours = np.asarray(
        minimizers.point_to_point_transform(jnp.asarray(p), jnp.asarray(q), jnp.asarray(w)),
        np.float64,
    )
    T_gold = oracle_p2point_transform(
        p.astype(np.float64), q.astype(np.float64), w.astype(np.float64)
    )
    assert trans_err(T_ours, T_gold) < TOL_TRANS
    assert rot_err(T_ours, T_gold) < TOL_ROT


def test_point_to_plane_degenerate_minimum_norm(rng):
    """All normals parallel (translation observable on one axis only): both
    solvers must return finite, agreeing solutions on the observable
    subspace — the reference's minimal-norm underdetermined branch
    (PointToPlane.cpp:205-230)."""
    n_pts = 1000
    p = rng.uniform(-5, 5, (n_pts, 3))
    n = np.tile(np.array([0.0, 0.0, 1.0]), (n_pts, 1))
    q = p + np.array([0.0, 0.0, 0.03])
    w = np.ones(n_pts)
    T_ours = ours_p2plane_step(
        p.astype(np.float32), q.astype(np.float32),
        n.astype(np.float32), w.astype(np.float32),
    )
    assert np.all(np.isfinite(T_ours))
    # Observable component: z-translation.
    assert abs(T_ours[2, 3] - 0.03) < TOL_TRANS
