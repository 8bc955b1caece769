"""Minimal SLAM example (≙ build_map.cpp / the replay harness).

Simulates a robot driving through a synthetic building, runs the full
pipeline (odometry + mapper + submaps), saves the map and prints errors.
    python examples/demo_slam.py [out_dir]
"""

import sys

import numpy as np
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import checkpoint
from open3d_slam_jax.slam.pipeline import SlamConfig, SlamPipeline


def make_world(rng, n=30000):
    floor = np.c_[rng.uniform(-10, 40, (n // 2, 2)), np.zeros((n // 2, 1))]
    w1 = np.c_[rng.uniform(-10, 40, (n // 4, 1)), np.full((n // 4, 1), 6.0), rng.uniform(0, 3, (n // 4, 1))]
    w2 = np.c_[rng.uniform(-10, 40, (n // 4, 1)), np.full((n // 4, 1), -6.0), rng.uniform(0, 3, (n // 4, 1))]
    pillars = [np.c_[np.full((400, 1), float(x)), rng.uniform(-0.3, 0.3, (400, 1)), rng.uniform(0, 3, (400, 1))]
               for x in range(0, 40, 8)]
    return np.vstack([floor, w1, w2] + pillars).astype(np.float32)


def scan_at(world, pose, rng, m=8000):
    local = (np.linalg.inv(pose) @ np.c_[world, np.ones(len(world))].T).T[:, :3]
    vis = np.where(np.linalg.norm(local, axis=1) < 25.0)[0]
    sel = rng.choice(vis, size=min(m, len(vis)), replace=False)
    return (local[sel] + rng.normal(size=(len(sel), 3)) * 0.01).astype(np.float32)


def main(out_dir="/tmp/demo_slam_out"):
    rng = np.random.default_rng(0)
    world = make_world(rng)
    pipe = SlamPipeline(SlamConfig())

    T = np.eye(4)
    # ~0.25 m per scan = walking speed at a 10 Hz LiDAR (the regime the
    # reference targets; scan-to-scan ICP needs consecutive scans to
    # overlap well within the match radius).
    step = np.asarray(se3.exp_se3(jnp.asarray([0, 0, 0, 0.25, 0, 0], jnp.float32)), np.float64)
    errs = []
    for i in range(60):
        scan = pc.from_points(scan_at(world, T, rng), capacity=16384)
        pipe.process_scan(scan, time=0.1 * i)
        errs.append(np.linalg.norm(pipe.pose[:3, 3] - T[:3, 3]))
        if i % 10 == 0 or i == 59:
            print(f"scan {i:02d}: pose=({pipe.pose[0,3]:6.2f} {pipe.pose[1,3]:6.2f}) err={errs[-1]:.3f} m")
        T = T @ step

    dist = 0.25 * 60
    checkpoint.save_map_artifacts(pipe, out_dir)
    print(f"\nmap + pose graph saved under {out_dir}")
    print(f"final error {errs[-1]:.3f} m over {dist:.0f} m travelled "
          f"({100 * errs[-1] / dist:.2f}% drift)")


if __name__ == "__main__":
    main(*sys.argv[1:])
