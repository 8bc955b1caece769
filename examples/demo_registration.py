"""Minimal registration example (≙ examples/icp_simple.cpp).

Generates a synthetic scan pair, registers with the default chain, prints
the transform and quality observables. Run:
    python examples/demo_registration.py
"""

import numpy as np
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models.cloud_registration import (
    CloudRegistrationConfig, register_clouds)
from open3d_slam_jax.ops import pointcloud as pc


def make_scene(rng, n=6000):
    m = n // 3
    floor = np.c_[rng.uniform(-5, 5, (m, 2)), np.zeros((m, 1))]
    wall = np.c_[np.zeros((m, 1)), rng.uniform(-5, 5, (m, 2))]
    ramp = np.c_[rng.uniform(-5, 5, (m, 1)), np.full((m, 1), 5.0), rng.uniform(0, 3, (m, 1))]
    return (np.vstack([floor, wall, ramp]) + rng.normal(size=(n, 3)) * 0.005).astype(np.float32)


def main():
    rng = np.random.default_rng(0)
    reference = make_scene(rng)
    T_true = np.asarray(se3.exp_se3(jnp.asarray([0.03, -0.02, 0.05, 0.2, -0.1, 0.15], jnp.float32)))
    reading = (reference @ np.linalg.inv(T_true)[:3, :3].T + np.linalg.inv(T_true)[:3, 3]).astype(np.float32)

    res = register_clouds(
        pc.from_points(reading), pc.from_points(reference),
        cfg=CloudRegistrationConfig("GeneralizedIcp", max_correspondence_dist=0.5),
    )
    T = np.asarray(res.transform)
    print("estimated transform:\n", np.round(T, 5))
    print("true transform:\n", np.round(T_true, 5))
    print(f"iterations={int(res.iterations)} overlap={float(res.overlap_ratio):.3f} "
          f"residual={float(res.residual):.5f} converged={bool(res.converged)}")
    print("translation error [m]:", np.linalg.norm(T[:3, 3] - T_true[:3, 3]))


if __name__ == "__main__":
    main()
