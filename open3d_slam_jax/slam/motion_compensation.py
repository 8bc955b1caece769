"""Constant-velocity scan undistortion on device.

Analogue of the reference's ``MotionCompensation``
(``MotionCompensation.cpp``): each point of a spinning-LiDAR scan is
acquired at a different instant; given the body motion across the sweep,
every point is re-expressed in the frame of the scan timestamp.

Two timing models, matching the reference:
- explicit per-point times (``times`` extra channel), or
- azimuth phase (``MotionCompensation.cpp:120-139``): time inferred from the
  horizontal angle of the point for a constant-rate spinning sensor.

The correction itself is per-point SE(3) interpolation between the sweep
start/end motion — pure vectorized math, ideal vmap fodder.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops.pointcloud import PointBatch


def phases_from_azimuth(xyz: jax.Array, clockwise: bool = True) -> jax.Array:
    """Relative acquisition phase in [0, 1] from point azimuth.

    Assumes the sweep starts at azimuth 0 (+x axis) and spins a full turn
    during the scan, like the reference's RotationalVelocity model.
    """
    az = jnp.arctan2(xyz[..., 1], xyz[..., 0])  # [-pi, pi]
    phase = (az + jnp.pi) / (2.0 * jnp.pi)
    return 1.0 - phase if clockwise else phase


@functools.partial(jax.jit, static_argnames=())
def undistort(
    batch: PointBatch,
    motion_twist: jax.Array,
    phases: jax.Array,
) -> PointBatch:
    """Undistort a scan given the body twist over the sweep.

    ``motion_twist [6]``: log of T_end^-1 start->end body motion over the
    sweep (omega, v). ``phases [N]`` in [0, 1]: per-point relative
    acquisition time. Each point is moved by ``exp((phase - 1) * twist)`` so
    the whole cloud is expressed in the end-of-sweep frame (the reference
    aligns to the scan timestamp, which stamps the sweep end).
    """
    alpha = phases - 1.0  # 0 at sweep end, -1 at start
    T = se3.exp_se3(alpha[:, None] * motion_twist[None, :])  # [N, 4, 4]
    xyz = jnp.einsum("nij,nj->ni", T[:, :3, :3], batch.xyz) + T[:, :3, 3]
    out = batch.__class__(xyz=xyz, mask=batch.mask, extras=dict(batch.extras))
    if "normals" in out.extras:
        out.extras["normals"] = jnp.einsum(
            "nij,nj->ni", T[:, :3, :3], out.extras["normals"]
        )
    return out


def undistort_with_times(
    batch: PointBatch,
    motion_twist: jax.Array,
    t_start: float,
    t_end: float,
) -> PointBatch:
    """Undistort using the per-point ``times`` extra channel (seconds)."""
    times = batch.extras["times"][..., 0]
    denom = jnp.maximum(t_end - t_start, 1e-9)
    phases = jnp.clip((times - t_start) / denom, 0.0, 1.0)
    return undistort(batch, motion_twist, phases)


def undistort_with_azimuth(
    batch: PointBatch,
    motion_twist: jax.Array,
    clockwise: bool = True,
) -> PointBatch:
    """Undistort inferring per-point time from azimuth (no time channel)."""
    return undistort(batch, motion_twist, phases_from_azimuth(batch.xyz, clockwise))
