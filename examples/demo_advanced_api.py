"""Advanced registration API tour (≙ examples/icp_advance_api.cpp +
examples/icp_customized.cpp).

The reference's "advanced" example builds an ICP chain programmatically
(no YAML), inspects per-iteration behavior, and reads out the estimate's
covariance; "customized" swaps individual chain modules. Here the same
surface is the typed `ICPConfig` + the inspector module:

1. build a chain in code (matcher / outlier filters / minimizer / checkers),
2. register with a persistent-map `ICPSequence` over a stream of readings,
3. trace every iteration with `trace_icp` (transforms, residuals, spectra),
4. read the 6x6 covariance + localizability observables off `ICPResult`.

Run: python examples/demo_advanced_api.py
"""

import numpy as np
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models import inspector
from open3d_slam_jax.models import localizability as xicp
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc


def make_scene(rng, n=8000):
    m = n // 4
    floor = np.c_[rng.uniform(-6, 6, (2 * m, 2)), rng.normal(0, 0.01, (2 * m, 1))]
    wall_x = np.c_[rng.uniform(-6, 6, (m, 1)), np.full((m, 1), 6.0), rng.uniform(0, 3, (m, 1))]
    wall_y = np.c_[np.full((m, 1), -6.0), rng.uniform(-6, 6, (m, 1)), rng.uniform(0, 3, (m, 1))]
    return np.vstack([floor, wall_x, wall_y]).astype(np.float32)


def main():
    rng = np.random.default_rng(0)

    # --- 1. a chain built in code, reference icp_customized.cpp style ------
    cfg = icp_mod.ICPConfig(
        matcher="grid", knn=1, max_match_dist=0.8,          # ≙ KDTreeMatcher
        trimmed_ratio=0.85,                                  # ≙ TrimmedDistOutlierFilter
        robust="cauchy", robust_scale=0.5,                   # ≙ RobustOutlierFilter
        minimizer="point_to_plane",                          # ≙ PointToPlaneErrorMinimizer
        max_iterations=30, min_diff_rot=1e-4, min_diff_trans=1e-4,  # checkers
        degeneracy=xicp.DegeneracyConfig(method="solution_remapping"),  # X-ICP
    )

    world = make_scene(rng)
    reference = pc.from_points(world, capacity=1 << 13)
    reference = normals_mod.estimate_normals(reference, knn=10, max_dist=1.0)

    # --- 2. persistent map + a stream of readings (≙ ICPSequence) ---------
    seq = icp_mod.ICPSequence(cfg)
    seq.set_map(reference)
    true_xis = [
        jnp.asarray([0.02, -0.03, 0.01, 0.10, 0.05, -0.08], jnp.float32),
        jnp.asarray([-0.01, 0.02, 0.02, -0.06, 0.12, 0.04], jnp.float32),
    ]
    for i, xi in enumerate(true_xis):
        T_true = se3.exp_se3(xi)
        Ti = np.linalg.inv(np.asarray(T_true))  # reading = T_true^-1 . world
        moved = world @ Ti[:3, :3].T + Ti[:3, 3]
        reading = pc.from_points(
            (moved + rng.normal(0, 0.005, moved.shape)).astype(np.float32),
            capacity=1 << 13,
        )
        res = seq(reading)
        err_t = float(jnp.linalg.norm(res.transform[:3, 3] - T_true[:3, 3]))
        sigma = np.sqrt(np.diag(np.asarray(res.covariance)))  # ≙ getCovariance
        print(f"scan {i}: iters={int(res.iterations)} overlap={float(res.overlap_ratio):.3f} "
              f"trans_err={err_t * 1e3:.2f}mm  sigma_t=[{sigma[3]:.1e} {sigma[4]:.1e} {sigma[5]:.1e}]")
        assert err_t < 0.02

    # --- 3. per-iteration inspection (≙ VTKFileInspector / icp_advance_api)
    Ti = np.linalg.inv(np.asarray(se3.exp_se3(true_xis[0])))
    moved = world @ Ti[:3, :3].T + Ti[:3, 3]
    reading = pc.from_points(moved.astype(np.float32), capacity=1 << 13)
    trace = inspector.trace_icp(reading, seq._ref, jnp.eye(4), cfg, iterations=12)
    res_first, res_last = float(trace.residuals[0]), float(trace.residuals[-1])
    print(f"trace: residual {res_first:.4f} -> {res_last:.5f} over {trace.residuals.shape[0]} iters")
    print(f"hessian spectrum (final): {np.asarray(trace.eigenvalues[-1]).round(1)}")
    assert res_last < res_first

    perf = inspector.PerformanceInspector()
    perf.add_trace(trace)
    print("performance summary:", perf.summary())


if __name__ == "__main__":
    main()
