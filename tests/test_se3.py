import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as ScipyRot

from open3d_slam_jax.geometry import se3


def random_rotations(rng, n):
    return ScipyRot.random(n, random_state=np.random.RandomState(1)).as_matrix().astype(np.float32)


def test_exp_log_so3_roundtrip(rng):
    omega = rng.normal(size=(64, 3)).astype(np.float32)
    R = se3.exp_so3(jnp.asarray(omega))
    back = se3.log_so3(R)
    # log might return an equivalent rotation vector; compare rotations.
    R2 = se3.exp_so3(back)
    np.testing.assert_allclose(np.asarray(R), np.asarray(R2), atol=2e-5)


def test_exp_so3_matches_scipy(rng):
    omega = rng.normal(size=(32, 3)).astype(np.float32)
    ours = np.asarray(se3.exp_so3(jnp.asarray(omega)))
    ref = ScipyRot.from_rotvec(omega).as_matrix()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def test_exp_so3_small_angle(rng):
    omega = (rng.normal(size=(8, 3)) * 1e-6).astype(np.float32)
    R = np.asarray(se3.exp_so3(jnp.asarray(omega)))
    ref = ScipyRot.from_rotvec(omega).as_matrix()
    np.testing.assert_allclose(R, ref, atol=1e-6)
    assert not np.any(np.isnan(R))


def test_log_so3_near_pi():
    axis = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    omega = axis * (np.pi - 1e-4)
    R = se3.exp_so3(jnp.asarray(omega))
    back = np.asarray(se3.log_so3(R))
    np.testing.assert_allclose(back, omega, atol=1e-3)


def test_exp_log_se3_roundtrip(rng):
    twist = rng.normal(size=(32, 6)).astype(np.float32) * 0.5
    T = se3.exp_se3(jnp.asarray(twist))
    back = np.asarray(se3.log_se3(T))
    np.testing.assert_allclose(back, twist, atol=1e-4)


def test_transform_inverse(rng):
    twist = rng.normal(size=(8, 6)).astype(np.float32)
    T = se3.exp_se3(jnp.asarray(twist))
    I = np.asarray(T @ se3.transform_inverse(T))
    np.testing.assert_allclose(I, np.broadcast_to(np.eye(4), (8, 4, 4)), atol=1e-5)


def test_apply_transform(rng):
    twist = rng.normal(size=(6,)).astype(np.float32)
    T = se3.exp_se3(jnp.asarray(twist))
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    out = np.asarray(se3.apply_transform(T, jnp.asarray(pts)))
    Tnp = np.asarray(T)
    ref = pts @ Tnp[:3, :3].T + Tnp[:3, 3]
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_quat_roundtrip(rng):
    R = random_rotations(rng, 50)
    q = se3.quat_from_matrix(jnp.asarray(R))
    R2 = np.asarray(se3.matrix_from_quat(q))
    np.testing.assert_allclose(R, R2, atol=1e-5)
    # w >= 0 canonical form
    assert np.all(np.asarray(q)[:, 0] >= 0)


def test_quat_angular_distance(rng):
    R = random_rotations(rng, 10)
    qa = se3.quat_from_matrix(jnp.asarray(R))
    angle = 0.123
    Rd = ScipyRot.from_rotvec([angle, 0, 0]).as_matrix().astype(np.float32)
    qb = se3.quat_from_matrix(jnp.asarray(R @ Rd))
    d = np.asarray(se3.quat_angular_distance(qa, qb))
    np.testing.assert_allclose(d, angle, atol=1e-3)


def test_rigid_from_axis_angle_atan_small_equals_exp(rng):
    # For small omega, atan(||w||) ~ ||w||, so it should match exp_se3.
    x = (rng.normal(size=(16, 6)) * 1e-3).astype(np.float32)
    A = np.asarray(se3.rigid_from_axis_angle_atan(jnp.asarray(x)))
    B = np.asarray(se3.exp_se3(jnp.asarray(x)))
    np.testing.assert_allclose(A[..., :3, :3], B[..., :3, :3], atol=1e-6)
    np.testing.assert_allclose(A[..., :3, 3], x[..., 3:], atol=1e-6)


def test_rigid_from_axis_angle_atan_zero():
    T = np.asarray(se3.rigid_from_axis_angle_atan(jnp.zeros((6,))))
    np.testing.assert_allclose(T, np.eye(4), atol=1e-7)


def test_rpy_roundtrip(rng):
    rpy = (rng.uniform(-1.2, 1.2, size=(20, 3))).astype(np.float32)
    R = se3.matrix_from_rpy(jnp.asarray(rpy))
    back = np.asarray(se3.rpy_from_matrix(R))
    np.testing.assert_allclose(back, rpy, atol=1e-5)


def test_interpolate_transform_endpoints(rng):
    t0 = se3.exp_se3(jnp.asarray(rng.normal(size=(6,)).astype(np.float32)))
    t1 = se3.exp_se3(jnp.asarray(rng.normal(size=(6,)).astype(np.float32)))
    a = np.asarray(se3.interpolate_transform(t0, t1, 0.0))
    b = np.asarray(se3.interpolate_transform(t0, t1, 1.0))
    np.testing.assert_allclose(a, np.asarray(t0), atol=1e-5)
    np.testing.assert_allclose(b, np.asarray(t1), atol=1e-5)
    mid = np.asarray(se3.interpolate_transform(t0, t1, 0.5))
    np.testing.assert_allclose(
        mid[:3, 3], 0.5 * (np.asarray(t0)[:3, 3] + np.asarray(t1)[:3, 3]), atol=1e-5
    )


def test_orthonormalize_rotation(rng):
    R = random_rotations(rng, 4)
    noisy = R + rng.normal(size=R.shape).astype(np.float32) * 1e-3
    T = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    T[:, :3, :3] = noisy
    fixed = np.asarray(se3.orthonormalize_rotation(jnp.asarray(T)))
    Rf = fixed[:, :3, :3]
    np.testing.assert_allclose(Rf @ np.swapaxes(Rf, 1, 2), np.broadcast_to(np.eye(3), (4, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(Rf), np.ones(4), atol=1e-5)


def test_jit_and_vmap_compose():
    f = jax.jit(jax.vmap(lambda t: se3.log_se3(se3.exp_se3(t))))
    x = jnp.ones((4, 6)) * 0.1
    np.testing.assert_allclose(np.asarray(f(x)), np.asarray(x), atol=1e-5)


def test_pure_translation():
    """PureTranslation transformation (TransformationsImpl.cpp:240-300):
    correctParameters projects to identity-rotation, check flags non-pure
    inputs, compute translates only."""
    T = np.asarray(se3.exp_se3(jnp.asarray([0.3, -0.2, 0.1, 1.0, 2.0, -3.0])))
    Tc = np.asarray(se3.pure_translation_correct(jnp.asarray(T)))
    np.testing.assert_allclose(Tc[:3, :3], np.eye(3), atol=1e-7)
    np.testing.assert_allclose(Tc[:3, 3], T[:3, 3], atol=1e-7)
    assert not bool(se3.pure_translation_check(jnp.asarray(T)))
    assert bool(se3.pure_translation_check(jnp.asarray(Tc)))
    pts = jnp.asarray(np.random.default_rng(0).normal(size=(16, 3)).astype(np.float32))
    out = se3.apply_pure_translation(jnp.asarray(Tc), pts)
    np.testing.assert_allclose(np.asarray(out), np.asarray(pts) + T[:3, 3], atol=1e-6)
