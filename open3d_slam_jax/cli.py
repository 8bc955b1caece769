"""Command-line entry points.

Counterparts of the reference's executables:

- ``register``  ≙ ``examples/icp_simple.cpp`` / ``examples/icp.cpp``
  (one registration, optional icp.yaml config)
- ``run-slam``  ≙ ``mapping_node.cpp`` offline replay (directory of scans
  processed deterministically in order)
- ``list-modules`` ≙ ``examples/list_modules.cpp``
- ``compute-overlap`` ≙ ``examples/compute_overlap.cpp``
- ``profile-filters`` ≙ ``examples/filterProfiler.cpp``
- ``bench``     runs the repository benchmark

Usage: ``python -m open3d_slam_jax.cli <command> ...``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np


def _cmd_register(args) -> int:
    import jax.numpy as jnp

    from open3d_slam_jax.config import icp_config_from_yaml
    from open3d_slam_jax.io import load_cloud
    from open3d_slam_jax.models import icp as icp_mod
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops import pointcloud as pc

    ref_pts, ref_extras = load_cloud(args.reference)
    read_pts, read_extras = load_cloud(args.reading)

    if args.config:
        cfg = icp_config_from_yaml(args.config)
    else:
        cfg = icp_mod.ICPConfig(
            knn=1, max_match_dist=args.max_dist, matcher="grid",
            trimmed_ratio=0.85, max_iterations=args.max_iterations,
        )

    cap_r = 1 << int(np.ceil(np.log2(max(len(ref_pts), 2))))
    cap_d = 1 << int(np.ceil(np.log2(max(len(read_pts), 2))))
    reference = pc.from_points(ref_pts, capacity=cap_r, extras=ref_extras)
    if reference.normals is None and cfg.minimizer == "point_to_plane":
        reference = normals_mod.estimate_normals(
            reference, knn=10, max_dist=2.0 * min(cfg.max_match_dist, 1e6)
        )
    reading = pc.from_points(read_pts, capacity=cap_d)

    # Initial guess, reference icp.cpp syntax: "x,y,z" / "r00,r01,r02;r10,...".
    T_init = np.eye(4, dtype=np.float32)
    if args.init_translation:
        try:
            vals = [float(v) for v in args.init_translation.split(",")]
        except ValueError:
            print("--init-translation must be 3 comma-separated numbers", file=sys.stderr)
            return 1
        if len(vals) != 3:
            print("--init-translation must be 3 comma-separated numbers", file=sys.stderr)
            return 1
        T_init[:3, 3] = vals
    if args.init_rotation:
        try:
            rows = [[float(v) for v in r.split(",")] for r in args.init_rotation.split(";")]
        except ValueError:
            print("--init-rotation must be 3 semicolon-separated rows of 3", file=sys.stderr)
            return 1
        R = np.asarray(rows, dtype=np.float32)
        if R.shape != (3, 3):
            print("--init-rotation must be 3 semicolon-separated rows of 3", file=sys.stderr)
            return 1
        # correctParameters: re-orthonormalize a hand-typed rotation.
        # SVD alone can return a reflection (det = -1) for a sign-typo'd
        # input; flip the last singular direction so the result is always a
        # proper rotation (the reference's cross-product rebuild guarantee).
        u, _, vt = np.linalg.svd(R)
        if np.linalg.det(u @ vt) < 0:
            u[:, -1] *= -1
        T_init[:3, :3] = u @ vt

    t0 = time.perf_counter()
    res = icp_mod.register_pair(reading, reference, jnp.asarray(T_init), cfg)
    T = np.asarray(res.transform)
    dt = time.perf_counter() - t0

    print(f"converged: {bool(res.converged)}  iterations: {int(res.iterations)}")
    print(f"overlap: {float(res.overlap_ratio):.3f}  residual: {float(res.residual):.5f}")
    print(f"wall time (incl. compile): {dt:.2f}s")
    print("transform (reading -> reference):")
    np.savetxt(sys.stdout, T, fmt="%12.8f")
    if args.output:
        np.savetxt(args.output, T)
    if args.save_transformed:
        # ≙ icp.cpp isTransfoSaved: write the reading moved into the
        # reference frame by the computed transform, with the full
        # descriptor set preserved (direction-like descriptors rotated, as
        # TransformationsImpl does for normals/observationDirections).
        from open3d_slam_jax.io import save_cloud

        moved = read_pts @ T[:3, :3].T + T[:3, 3]
        out_extras = None
        if read_extras:
            direction_like = ("normals", "observationDirections", "eigVectors")
            out_extras = {}
            for name, vals in read_extras.items():
                v = np.asarray(vals)
                if name in direction_like and v.ndim == 2 and v.shape[1] == 3:
                    v = v @ T[:3, :3].T
                out_extras[name] = v
        save_cloud(args.save_transformed, moved.astype(np.float32), out_extras)
        print(f"transformed reading written to {args.save_transformed}")
    return 0


def _cmd_run_slam(args) -> int:
    from open3d_slam_jax.config import slam_config_from_yaml
    from open3d_slam_jax.io import load_cloud
    from open3d_slam_jax.ops import pointcloud as pc
    from open3d_slam_jax.slam.pipeline import SlamConfig, SlamPipeline

    cfg = slam_config_from_yaml(args.config) if args.config else SlamConfig()
    pipe = SlamPipeline(cfg)

    viz_srv = None
    if getattr(args, "serve_viz", None) is not None:
        from open3d_slam_jax.viz_server import VizServer

        viz_srv = VizServer(host="0.0.0.0", port=args.serve_viz)
        print(f"live viz at http://{viz_srv.host}:{viz_srv.port}/")
    args._viz_srv = viz_srv

    if args.scans.endswith(".bag"):
        return _run_slam_from_bag(args, pipe)

    scans = sorted(glob.glob(os.path.join(args.scans, "*")))
    scans = [s for s in scans if s.lower().endswith((".ply", ".pcd", ".csv", ".vtk"))]
    if not scans:
        print(f"no scans found under {args.scans}", file=sys.stderr)
        return 1
    if args.max_scans:
        scans = scans[: args.max_scans]

    cap = args.capacity
    t_start = time.perf_counter()
    traj_log = []
    for i, path in enumerate(scans):
        pts, _ = load_cloud(path)
        batch = pc.from_points(pts, capacity=cap)
        stats = pipe.process_scan(batch, time=i * 0.1)
        pose = pipe.pose
        traj_log.append(np.asarray(pose[:3, 3]))
        print(
            f"[{i + 1}/{len(scans)}] t=({pose[0, 3]:.2f} {pose[1, 3]:.2f} {pose[2, 3]:.2f}) "
            f"overlap={stats.get('overlap', 0):.2f} inserted={stats.get('inserted')} "
            f"submaps={len(pipe.submaps)}"
        )
        # Throttled live publish (≙ the reference's visualization workers
        # publishing under a cadence, SlamWrapperRos.cpp:275-293).
        if viz_srv is not None and (i % 5 == 0 or i == len(scans) - 1):
            viz_srv.publish(
                map_points=pipe.assembled_map(),
                trajectory=np.asarray(traj_log),
                stats=stats,
            )
    wall = time.perf_counter() - t_start
    print(f"processed {len(scans)} scans in {wall:.1f}s ({len(scans) / wall:.2f} Hz)")

    if args.save_map:
        pipe.save_map(args.save_map)
        print(f"map saved to {args.save_map} ({pipe.assembled_map().shape[0]} points)")
    if args.save_trajectory:
        times = [i * 0.1 for i in range(len(scans))]
        rows = []
        for t in times:
            if pipe.map_pose_buffer.has(t):
                T = pipe.map_pose_buffer.lookup(t)
                rows.append(np.r_[t, T[:3, 3], T[:3, :3].flatten()])
        np.savetxt(args.save_trajectory, np.asarray(rows))
        print(f"trajectory saved to {args.save_trajectory}")
    if args.viz:
        from open3d_slam_jax import viz

        traj = np.asarray([pipe.map_pose_buffer.lookup(i * 0.1)[:3, 3]
                           for i in range(len(scans))
                           if pipe.map_pose_buffer.has(i * 0.1)])
        viz.render_topdown(pipe.assembled_map(), trajectory=traj, path=args.viz)
        print(f"viz written to {args.viz}")
    if getattr(args, "save_checkpoint", None):
        from open3d_slam_jax.slam import checkpoint

        checkpoint.save_pipeline(pipe, args.save_checkpoint)
        print(f"checkpoint saved to {args.save_checkpoint}")
    return 0


def _cmd_merge_sessions(args) -> int:
    """Merge two independently built SLAM sessions (run-level checkpoints)
    into one consistent map: coarse global alignment + concurrent
    inter-session submap registrations + joint pose-graph GN."""
    import json

    from open3d_slam_jax.config import slam_config_from_yaml
    from open3d_slam_jax.slam import checkpoint
    from open3d_slam_jax.slam import multi_session as ms
    from open3d_slam_jax.slam.pipeline import SlamConfig, SlamPipeline

    cfg = slam_config_from_yaml(args.config) if args.config else SlamConfig()
    pipe_a = checkpoint.load_pipeline(SlamPipeline(cfg), args.checkpoint_a)
    pipe_b = checkpoint.load_pipeline(SlamPipeline(cfg), args.checkpoint_b)

    ms_cfg = ms.MultiSessionConfig()
    res = ms.merge_sessions(pipe_a.submaps, pipe_b.submaps, ms_cfg)
    if res is None:
        print("merge failed: no global alignment / no accepted constraint",
              file=sys.stderr)
        return 1
    summary = {
        "T_ab": np.asarray(res.T_ab).tolist(),
        "constraints": len(res.constraints),
        "chi2_before": res.chi2_before,
        "chi2_after": res.chi2_after,
    }
    print(json.dumps(summary))
    if args.save_map:
        from open3d_slam_jax.io import save_ply

        pts = np.concatenate(
            [pipe_a.submaps.map_points(), pipe_b.submaps.map_points()]
        )
        save_ply(args.save_map, pts.astype(np.float32))
        print(f"merged map saved to {args.save_map} ({len(pts)} points)")
    return 0


def _run_slam_from_bag(args, pipe) -> int:
    """Deterministic rosbag replay (≙ RosbagRangeDataProcessorRos): clouds
    drive the pipeline in bag order; odometry messages become external
    priors when the config requests them."""
    import jax.numpy as jnp

    from open3d_slam_jax.geometry import se3
    from open3d_slam_jax.io import rosbag, sensor_msgs
    from open3d_slam_jax.ops import pointcloud as pc

    cap = args.capacity
    n_scans = n_odom = n_imu = 0
    last_odom = None
    traj_log = []
    t_start = time.perf_counter()
    for topic, dtype, stamp, msg in rosbag.read_bag_decoded(args.scans):
        if dtype == "sensor_msgs/PointCloud2":
            if args.max_scans and n_scans >= args.max_scans:
                break
            batch = sensor_msgs.deserialize(msg, capacity=cap)
            ext = None
            if last_odom is not None and pipe.cfg.use_external_odometry:
                q = last_odom.quaternion
                R = np.asarray(
                    se3.matrix_from_quat(
                        jnp.asarray([q[3], q[0], q[1], q[2]], jnp.float32)
                    )
                )
                ext = np.eye(4)
                ext[:3, :3] = R
                ext[:3, 3] = last_odom.position
            stats = pipe.process_scan(batch, time=float(stamp), external_odom_pose=ext)
            n_scans += 1
            pose = pipe.pose
            traj_log.append(np.asarray(pose[:3, 3]))
            viz_srv = getattr(args, "_viz_srv", None)
            if viz_srv is not None and n_scans % 5 == 1:
                viz_srv.publish(
                    map_points=pipe.assembled_map(),
                    trajectory=np.asarray(traj_log),
                    stats=stats,
                )
            print(
                f"[{n_scans}] t={stamp:.3f} pos=({pose[0, 3]:.2f} {pose[1, 3]:.2f} "
                f"{pose[2, 3]:.2f}) overlap={stats.get('overlap', 0):.2f} "
                f"submaps={len(pipe.submaps)}"
            )
        elif dtype in ("nav_msgs/Odometry", "geometry_msgs/PoseStamped"):
            last_odom = msg
            n_odom += 1
        elif dtype == "sensor_msgs/Imu":
            # Buffered for initial-attitude estimation (≙ ImuBuffer path);
            # the pipeline consumes it on the first scan.
            pipe.add_imu(float(stamp), msg.linear_acceleration, msg.angular_velocity)
            n_imu += 1
    wall = time.perf_counter() - t_start
    print(
        f"bag replay: {n_scans} clouds, {n_odom} odometry, {n_imu} imu msgs "
        f"in {wall:.1f}s"
    )
    if args.save_map:
        pipe.save_map(args.save_map)
        print(f"map saved to {args.save_map}")
    if getattr(args, "viz", None):
        from open3d_slam_jax import viz

        viz.render_topdown(
            pipe.assembled_map(), trajectory=np.asarray(traj_log), path=args.viz
        )
        print(f"viz written to {args.viz}")
    return 0


def _cmd_evaluate(args) -> int:
    from open3d_slam_jax import evaluation
    from open3d_slam_jax.config import icp_config_from_yaml
    from open3d_slam_jax.models import icp as icp_mod

    if args.plot and not args.report:
        # Validate before the (potentially long) evaluation runs.
        print("--plot needs --report (the CSV is the plot input)", file=sys.stderr)
        return 1
    reading_chain = reference_chain = None
    if args.protocol and args.config:
        print("--protocol and --config are mutually exclusive", file=sys.stderr)
        return 1
    if args.protocol:
        cfg, reading_chain, reference_chain = evaluation.protocol_config(
            args.protocol
        )
    elif args.config:
        cfg = icp_config_from_yaml(args.config)
    else:
        cfg = icp_mod.ICPConfig(knn=8, max_match_dist=1.0, matcher="grid",
                                trimmed_ratio=0.9)
    cases = evaluation.load_manifest(args.manifest)
    if args.max_cases:
        cases = cases[: args.max_cases]
    results, summary = evaluation.evaluate(
        cases, cfg,
        reading_filters=reading_chain,
        reference_filters=reference_chain,
        device_timing_reps=args.device_timing_reps,
    )
    for r in results:
        print(
            f"{r.name or '?':24s} trans={r.trans_err_m:.4f}m "
            f"rot={r.rot_err_rad:.5f}rad it={r.iterations} "
            f"conv={r.converged} {r.wall_s * 1e3:.0f}ms"
        )
    print(json.dumps(summary))
    if args.report:
        evaluation.write_report(args.report, results, summary)
        print(f"report written to {args.report}")
        if args.plot:
            evaluation.render_report(args.report, args.plot)
            print(f"plot written to {args.plot}")
    elif args.plot:
        print("--plot needs --report (the CSV is the plot input)", file=sys.stderr)
        return 1
    return 0


def _cmd_compute_overlap(args) -> int:
    """≙ ``examples/compute_overlap.cpp``: fraction of cloud A's points with
    a cloud-B point within ``--radius`` (and the reverse)."""
    from open3d_slam_jax.io import load_cloud
    from open3d_slam_jax.ops import pointcloud as pc
    from open3d_slam_jax.slam.constraint_builders import overlap_fraction

    def load(path):
        pts, _ = load_cloud(path)
        cap = 1 << max(int(np.ceil(np.log2(max(len(pts), 2)))), 3)
        return pc.from_points(pts, capacity=cap)

    a, b = load(args.cloud_a), load(args.cloud_b)
    ab = overlap_fraction(a, b, radius=args.radius)
    ba = overlap_fraction(b, a, radius=args.radius)
    print(json.dumps({
        "overlap_a_in_b": round(ab, 4),
        "overlap_b_in_a": round(ba, 4),
        "radius": args.radius,
    }))
    return 0


def _cmd_profile_filters(args) -> int:
    """≙ ``examples/filterProfiler.cpp``: time each DataPointsFilter stage of
    a chain on one cloud. XLA twist: per-stage COMPILE time and
    steady-state device time (median of ``--reps`` blocked runs) are reported
    separately — on XLA the first call is a trace+compile, which the
    reference's single ``clock()`` measurement would conflate."""
    import jax

    from open3d_slam_jax.config.registry import make_filter_chain
    from open3d_slam_jax.io import load_cloud
    from open3d_slam_jax.ops import pointcloud as pc

    if args.cloud:
        pts, extras = load_cloud(args.cloud)
    else:  # synthetic LiDAR-ish cloud, reproducible
        rng = np.random.default_rng(0)
        n = args.points
        floor = np.c_[rng.uniform(-30, 30, (n // 2, 2)), rng.normal(0, 0.02, (n // 2, 1))]
        walls = np.c_[rng.uniform(-30, 30, (n - n // 2, 1)),
                      rng.normal(15, 0.05, (n - n // 2, 1)),
                      rng.uniform(0, 5, (n - n // 2, 1))]
        pts, extras = np.vstack([floor, walls]), None
    cap = 1 << max(int(np.ceil(np.log2(max(len(pts), 2)))), 3)
    batch = pc.from_points(pts, capacity=cap, extras=extras)

    if args.config:
        import yaml

        with open(args.config) as f:
            doc = yaml.safe_load(f)
        if isinstance(doc, dict):
            if "readingDataPointsFilters" not in doc:
                print(
                    f"{args.config}: expected a YAML filter list or an "
                    "icp.yaml with a readingDataPointsFilters section",
                    file=sys.stderr,
                )
                return 1
            spec = doc["readingDataPointsFilters"]
        else:
            spec = doc
    else:  # the reference profiler's own chain (filterProfiler.cpp:47-80)
        spec = [
            {"RandomSamplingDataPointsFilter": {"prob": 0.5}},
            {"VoxelGridDataPointsFilter": {
                "vSizeX": 0.2, "vSizeY": 0.2, "vSizeZ": 0.2,
                "useCentroid": 1 if args.use_centroid else 0,
            }},
            {"SurfaceNormalDataPointsFilter": {"knn": 10}},
        ]

    key = jax.random.PRNGKey(0)
    rows = []
    for item in spec:
        name = item if isinstance(item, str) else next(iter(item))
        stage = jax.jit(make_filter_chain([item]))
        n_in = int(batch.count())
        t0 = time.perf_counter()
        out = stage(batch, key)
        jax.block_until_ready(out.mask)
        compile_ms = (time.perf_counter() - t0) * 1e3
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = stage(batch, key)
            jax.block_until_ready(out.mask)
            times.append((time.perf_counter() - t0) * 1e3)
        p50 = float(np.median(times))
        rows.append({
            "filter": name, "points_in": n_in, "points_out": int(out.count()),
            "compile_ms": round(compile_ms, 2), "p50_ms": round(p50, 3),
            "mpts_per_s": round(n_in / max(p50, 1e-9) / 1e3, 1),
        })
        batch = out
    print(json.dumps({"device": str(jax.devices()[0]), "stages": rows}, indent=2))
    return 0


def _cmd_list_modules(args) -> int:
    from open3d_slam_jax.config.registry import FILTER_REGISTRY

    print("DataPointsFilters:")
    for name in sorted(FILTER_REGISTRY):
        print(f"  {name}")
    print("Matchers:\n  KDTreeMatcher (grid|brute backends)\n  NullMatcher")
    print(
        "OutlierFilters:\n  TrimmedDistOutlierFilter\n  VarTrimmedDistOutlierFilter\n"
        "  MedianDistOutlierFilter\n  SurfaceNormalOutlierFilter\n  RobustOutlierFilter"
        " (cauchy|huber|gm|tukey|welsch|sc|l1|student)"
    )
    print(
        "ErrorMinimizers:\n  PointToPlaneErrorMinimizer (6-DoF / force4DOF)\n"
        "  PointToPointErrorMinimizer\n  PointToPointSimilarityErrorMinimizer"
    )
    print(
        "DegeneracyAwareness:\n  None\n  SolutionRemapping\n"
        "  OptimizedEqualityConstraints / EqualityConstraints"
    )
    print(
        "TransformationCheckers:\n  CounterTransformationChecker\n"
        "  DifferentialTransformationChecker\n  BoundTransformationChecker"
    )
    print(
        "Transformations:\n  RigidTransformation (se3.orthonormalize_rotation)\n"
        "  SimilarityTransformation (similarity minimizer)\n"
        "  PureTranslation (se3.pure_translation_correct/apply_pure_translation)"
    )
    return 0


def _cmd_bench(args) -> int:
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo_root)
    import bench

    bench.main()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="open3d_slam_jax", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    pr = sub.add_parser("register", help="register one scan pair (icp_simple)")
    pr.add_argument("reading")
    pr.add_argument("reference")
    pr.add_argument("--config", help="libpointmatcher-style icp.yaml")
    pr.add_argument("--max-dist", type=float, default=1.0)
    pr.add_argument("--max-iterations", type=int, default=40)
    pr.add_argument("--output", help="write the 4x4 transform here")
    pr.add_argument("--init-translation", default=None, metavar="X,Y,Z",
                    help="initial-guess translation (icp.cpp --initTranslation)")
    pr.add_argument("--init-rotation", default=None, metavar="R00,R01,R02;R10,...",
                    help="initial-guess rotation rows (icp.cpp --initRotation)")
    pr.add_argument("--save-transformed", default=None, metavar="OUT.{ply,pcd,csv,vtk}",
                    help="write the reading moved into the reference frame "
                         "(icp.cpp isTransfoSaved)")
    pr.set_defaults(fn=_cmd_register)

    ps = sub.add_parser("run-slam", help="offline deterministic SLAM replay")
    ps.add_argument("scans", help="directory of scan files (ply/pcd/csv/vtk)")
    ps.add_argument("--config", help="SLAM parameter YAML (reference key names)")
    ps.add_argument("--capacity", type=int, default=65536)
    ps.add_argument("--max-scans", type=int, default=0)
    ps.add_argument("--save-map")
    ps.add_argument("--save-trajectory")
    ps.add_argument("--viz", help="write a top-down PNG render of map + trajectory")
    ps.add_argument(
        "--serve-viz",
        type=int,
        metavar="PORT",
        help="serve a live map dashboard over HTTP during the replay "
        "(0 picks a free port; the RViz-publisher analogue)",
    )
    ps.add_argument("--save-checkpoint", help="run-level .npz checkpoint path")
    ps.set_defaults(fn=_cmd_run_slam)

    pm = sub.add_parser(
        "merge-sessions",
        help="merge two run checkpoints into one map (multi-session)",
    )
    pm.add_argument("checkpoint_a", help="session A run-level .npz")
    pm.add_argument("checkpoint_b", help="session B run-level .npz (re-anchored into A)")
    pm.add_argument("--config", help="SLAM parameter YAML (must match both runs)")
    pm.add_argument("--save-map", help="write the merged map cloud here")
    pm.set_defaults(fn=_cmd_merge_sessions)

    pl = sub.add_parser("list-modules", help="list supported chain modules")
    pl.set_defaults(fn=_cmd_list_modules)

    po = sub.add_parser("compute-overlap", help="overlap fraction between two clouds")
    po.add_argument("cloud_a")
    po.add_argument("cloud_b")
    po.add_argument("--radius", type=float, default=0.5)
    po.set_defaults(fn=_cmd_compute_overlap)

    pf = sub.add_parser(
        "profile-filters", help="per-stage filter timing (filterProfiler)"
    )
    pf.add_argument("--cloud", default=None, help="input cloud (default: synthetic)")
    pf.add_argument("--points", type=int, default=100_000)
    pf.add_argument("--config", default=None,
                    help="YAML filter list or icp.yaml (readingDataPointsFilters)")
    pf.add_argument("--use-centroid", type=int, default=1)
    pf.add_argument("--reps", type=int, default=5)
    pf.set_defaults(fn=_cmd_profile_filters)

    pb = sub.add_parser("bench", help="run the benchmark")
    pb.set_defaults(fn=_cmd_bench)

    pe = sub.add_parser("evaluate", help="eval_solution-style protocol over a manifest")
    pe.add_argument("manifest", help="CSV: reading,reference,gt_00..gt_33[,init_..]")
    pe.add_argument("--config", help="libpointmatcher-style icp.yaml")
    pe.add_argument(
        "--protocol",
        # Kept literal so --help stays import-light; must match
        # evaluation.PROTOCOLS (tested in test_evaluation).
        choices=["Besl92_pt2point", "Chen91_pt2plane"],
        help="official protocol preset (evaluations/official_solutions)",
    )
    pe.add_argument(
        "--device-timing-reps", type=int, default=0,
        help="N>0: also report steady-state per-pair time (N reps)",
    )
    pe.add_argument("--max-cases", type=int, default=0)
    pe.add_argument("--report", help="write the CSV report here")
    pe.add_argument("--plot", help="render the report as a PNG panel "
                                   "(PlotSingleResults.ipynb analogue)")
    pe.set_defaults(fn=_cmd_evaluate)

    args = p.parse_args(argv)
    from open3d_slam_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
