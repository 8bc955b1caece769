"""SE(3)/SO(3) math for batched device registration.

All functions are pure jnp, broadcast over arbitrary leading batch dims, and
are safe at the singular points (theta -> 0, theta -> pi) via Taylor guards so
they can live inside jit/vmap/while_loop without NaNs poisoning gradients or
convergence masks.

Conventions
-----------
- Homogeneous transforms are ``[..., 4, 4]`` float32, acting on column points.
- ``exp_se3``/``log_se3`` use the twist layout ``[omega(3), v(3)]`` (rotation
  first) to match the 6-DoF solve layout of the reference ICP chain, where the
  solved increment is ``x = [alpha, beta, gamma, tx, ty, tz]``
  (libpointmatcher ``ErrorMinimizers/PointToPlane.cpp:340-390``).
- ``rigid_from_axis_angle_atan`` reproduces the reference's rotation
  reconstruction ``angle = atan(||omega||)`` (``PointToPlane.cpp:342``), which
  differs from the exponential map for large steps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def identity_transform(batch_shape=(), dtype=jnp.float32) -> jax.Array:
    """``[..., 4, 4]`` identity transforms."""
    eye = jnp.eye(4, dtype=dtype)
    return jnp.broadcast_to(eye, tuple(batch_shape) + (4, 4))


def hat_so3(omega: jax.Array) -> jax.Array:
    """Skew-symmetric matrix of ``[..., 3]`` -> ``[..., 3, 3]``."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zero, -wz, wy], axis=-1),
            jnp.stack([wz, zero, -wx], axis=-1),
            jnp.stack([-wy, wx, zero], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(omega: jax.Array) -> jax.Array:
    """Rodrigues formula, ``[..., 3]`` axis-angle -> ``[..., 3, 3]`` rotation."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks.
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    K = hat_so3(omega)
    eye = jnp.eye(3, dtype=omega.dtype)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: jax.Array) -> jax.Array:
    """Rotation matrix ``[..., 3, 3]`` -> axis-angle ``[..., 3]``.

    Uses the quaternion route, which is stable across the full angle range
    including near pi (where the direct trace formula loses the axis).
    """
    q = quat_from_matrix(R)  # (w, x, y, z), w >= 0
    w = q[..., 0]
    xyz = q[..., 1:]
    n = jnp.linalg.norm(xyz, axis=-1)
    # theta = 2 * atan2(||xyz||, w); axis = xyz / ||xyz||.
    theta = 2.0 * jnp.arctan2(n, w)
    scale = jnp.where(n < 1e-8, 2.0 / jnp.maximum(w, 1e-8), theta / jnp.maximum(n, 1e-12))
    return xyz * scale[..., None]


def _v_matrix(omega: jax.Array) -> jax.Array:
    """Left Jacobian V of SO(3): integrates translation under rotation."""
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (theta - jnp.sin(theta)) / (theta2 * theta))
    K = hat_so3(omega)
    eye = jnp.eye(3, dtype=omega.dtype)
    return eye + b[..., None, None] * K + c[..., None, None] * (K @ K)


def exp_se3(twist: jax.Array) -> jax.Array:
    """Twist ``[..., 6]`` = [omega, v] -> transform ``[..., 4, 4]``."""
    omega = twist[..., :3]
    v = twist[..., 3:]
    R = exp_so3(omega)
    t = jnp.einsum("...ij,...j->...i", _v_matrix(omega), v)
    return _rt_to_matrix(R, t)


def log_se3(T: jax.Array) -> jax.Array:
    """Transform ``[..., 4, 4]`` -> twist ``[..., 6]`` = [omega, v]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = log_so3(R)
    Vinv = _v_matrix_inverse(omega)
    v = jnp.einsum("...ij,...j->...i", Vinv, t)
    return jnp.concatenate([omega, v], axis=-1)


def _v_matrix_inverse(omega: jax.Array) -> jax.Array:
    theta2 = jnp.sum(omega * omega, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS))
    small = theta2 < 1e-8
    half = 0.5 * theta
    cot = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * jnp.cos(half) / jnp.maximum(jnp.sin(half), 1e-12)) / jnp.maximum(theta2, _EPS),
    )
    K = hat_so3(omega)
    eye = jnp.eye(3, dtype=omega.dtype)
    return eye - 0.5 * K + cot[..., None, None] * (K @ K)


def _rt_to_matrix(R: jax.Array, t: jax.Array) -> jax.Array:
    batch = R.shape[:-2]
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=R.dtype), batch + (1, 4)
    )
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    return jnp.concatenate([top, bottom], axis=-2)


def rigid_from_axis_angle_atan(x: jax.Array) -> jax.Array:
    """Build SE(3) from a solved 6-vector the way the reference chain does.

    ``x = [omega(3), t(3)]``; rotation angle is ``atan(||omega||)`` about
    ``omega/||omega||`` and the translation is used verbatim — mirroring
    libpointmatcher ``PointToPlane.cpp:340-370`` (including the NaN->identity
    guard for the zero-rotation case via a stable normalize).
    """
    omega = x[..., :3]
    t = x[..., 3:6]
    n = jnp.linalg.norm(omega, axis=-1)
    angle = jnp.arctan(n)
    axis = omega / jnp.maximum(n, 1e-12)[..., None]
    # Rodrigues with explicit angle about unit axis; angle==0 -> identity.
    R = exp_so3(axis * angle[..., None])
    R = jnp.where((n < 1e-12)[..., None, None], jnp.eye(3, dtype=x.dtype), R)
    return _rt_to_matrix(R, t)


def apply_transform(T: jax.Array, points: jax.Array) -> jax.Array:
    """Apply ``[..., 4, 4]`` to ``[..., N, 3]`` points.

    Written as broadcast arithmetic rather than an einsum: a K=3 product
    gains nothing from a matrix unit, and elementwise f32 math is exact
    under any default matmul precision (the GPU speed of the two forms is
    unmeasured)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    out = jnp.stack(
        [
            R[..., None, 0, 0] * x + R[..., None, 0, 1] * y + R[..., None, 0, 2] * z,
            R[..., None, 1, 0] * x + R[..., None, 1, 1] * y + R[..., None, 1, 2] * z,
            R[..., None, 2, 0] * x + R[..., None, 2, 1] * y + R[..., None, 2, 2] * z,
        ],
        axis=-1,
    )
    return out + t[..., None, :]


def apply_rotation(T: jax.Array, vectors: jax.Array) -> jax.Array:
    """Rotate ``[..., N, 3]`` direction vectors (e.g. normals) by ``[..., 4, 4]``."""
    R = T[..., :3, :3]
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    return jnp.stack(
        [
            R[..., None, 0, 0] * x + R[..., None, 0, 1] * y + R[..., None, 0, 2] * z,
            R[..., None, 1, 0] * x + R[..., None, 1, 1] * y + R[..., None, 1, 2] * z,
            R[..., None, 2, 0] * x + R[..., None, 2, 1] * y + R[..., None, 2, 2] * z,
        ],
        axis=-1,
    )


def transform_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    return _rt_to_matrix(Rt, -jnp.einsum("...ij,...j->...i", Rt, t))


def transform_compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return A @ B


def quat_from_matrix(R: jax.Array) -> jax.Array:
    """Rotation matrix ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w,x,y,z), w>=0.

    Branch-free Shepperd's method: computes all four candidate quaternions and
    selects the numerically best via the largest diagonal combination.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*q_i^2 = 1 + 2*diag_i - tr (or 1 + tr).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        axis=-1,
    )
    best = jnp.argmax(scores, axis=-1)
    cands = jnp.stack([qw, qx, qy, qz], axis=-2)  # [..., which, 4]
    q = jnp.take_along_axis(cands, best[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    q = q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    # Canonicalize sign: w >= 0.
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def matrix_from_quat(q: jax.Array) -> jax.Array:
    """Unit quaternion ``[..., 4]`` (w,x,y,z) -> rotation matrix ``[..., 3, 3]``."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return jnp.stack(
        [
            jnp.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], axis=-1),
            jnp.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], axis=-1),
            jnp.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def quat_angular_distance(q1: jax.Array, q2: jax.Array) -> jax.Array:
    """Angle (rad) between two unit quaternions, matching
    Eigen ``Quaternion::angularDistance`` used by the reference's Differential
    convergence checker (``TransformationCheckersImpl.cpp``)."""
    dot = jnp.abs(jnp.sum(q1 * q2, axis=-1))
    return 2.0 * jnp.arccos(jnp.clip(dot, -1.0, 1.0))


def rotation_angular_distance(R1: jax.Array, R2: jax.Array) -> jax.Array:
    """Angle of R1^T R2 — same metric as quat_angular_distance on matrices."""
    return quat_angular_distance(quat_from_matrix(R1), quat_from_matrix(R2))


def rpy_from_matrix(R: jax.Array) -> jax.Array:
    """Roll-pitch-yaw (XYZ extrinsic) from rotation matrix ``[..., 3, 3]``."""
    pitch = -jnp.arcsin(jnp.clip(R[..., 2, 0], -1.0, 1.0))
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return jnp.stack([roll, pitch, yaw], axis=-1)


def matrix_from_rpy(rpy: jax.Array) -> jax.Array:
    """Roll-pitch-yaw -> rotation (R = Rz(yaw) Ry(pitch) Rx(roll))."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.stack(
        [
            jnp.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], axis=-1),
            jnp.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], axis=-1),
            jnp.stack([-sp, cp * sr, cp * cr], axis=-1),
        ],
        axis=-2,
    )


def slerp(q0: jax.Array, q1: jax.Array, alpha: jax.Array) -> jax.Array:
    """Spherical interpolation between unit quaternions; alpha in [0, 1]."""
    dot = jnp.sum(q0 * q1, axis=-1, keepdims=True)
    q1 = jnp.where(dot < 0, -q1, q1)
    dot = jnp.abs(dot)
    theta = jnp.arccos(jnp.clip(dot, -1.0, 1.0))
    sin_theta = jnp.sin(theta)
    use_lerp = sin_theta < 1e-5
    w0 = jnp.where(use_lerp, 1.0 - alpha, jnp.sin((1.0 - alpha) * theta) / jnp.maximum(sin_theta, 1e-12))
    w1 = jnp.where(use_lerp, alpha, jnp.sin(alpha * theta) / jnp.maximum(sin_theta, 1e-12))
    q = w0 * q0 + w1 * q1
    return q / jnp.maximum(jnp.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def interpolate_transform(T0: jax.Array, T1: jax.Array, alpha: jax.Array) -> jax.Array:
    """Interpolate between two transforms: slerp on rotation, lerp on translation.

    The device analogue of the reference's
    ``TransformInterpolationBuffer::lookup`` interpolation
    (``TransformInterpolationBuffer.cpp:100-141``).
    """
    alpha = jnp.asarray(alpha)
    q = slerp(quat_from_matrix(T0[..., :3, :3]), quat_from_matrix(T1[..., :3, :3]), alpha[..., None])
    t = (1.0 - alpha[..., None]) * T0[..., :3, 3] + alpha[..., None] * T1[..., :3, 3]
    return _rt_to_matrix(matrix_from_quat(q), t)


def orthonormalize_rotation(T: jax.Array) -> jax.Array:
    """Project the rotation block of ``[..., 4, 4]`` back onto SO(3) via SVD.

    Counterpart of the reference's ``RigidTransformation::correctParameters``
    (``TransformationsImpl.cpp``) that repairs drift from accumulated float32
    compositions.
    """
    R = T[..., :3, :3]
    U, _, Vt = jnp.linalg.svd(R)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.ones(T.shape[:-2] + (3,), dtype=T.dtype).at[..., 2].set(det)
    R_fixed = (U * D[..., None, :]) @ Vt
    return _rt_to_matrix(R_fixed, T[..., :3, 3])


def pure_translation_correct(T: jax.Array) -> jax.Array:
    """``PureTranslation::correctParameters`` (TransformationsImpl.cpp:
    263-279): identity rotation block, translation kept — the projection
    onto the pure-translation subgroup."""
    eye = jnp.broadcast_to(jnp.eye(4, dtype=T.dtype), T.shape)
    return eye.at[..., :3, 3].set(T[..., :3, 3])


def pure_translation_check(T: jax.Array) -> jax.Array:
    """``PureTranslation::checkParameters`` (TransformationsImpl.cpp:
    281-300): True iff the rotation block is (approximately) identity."""
    R = T[..., :3, :3]
    eye = jnp.eye(3, dtype=T.dtype)
    return jnp.max(jnp.abs(R - eye), axis=(-2, -1)) < 1e-5


def apply_pure_translation(T: jax.Array, points: jax.Array) -> jax.Array:
    """``PureTranslation::compute`` (TransformationsImpl.cpp:240-260):
    translate only; the rotation block must be identity (mirror the
    reference's TransformationError with a debug-checkable mask instead of
    a throw — jitted code cannot raise)."""
    return points + T[..., :3, 3]
