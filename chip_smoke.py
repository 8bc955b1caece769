"""Main-path smoke run on the GPU: the system's real workloads, once, at the
sizes ``bench.py`` defines as production, through the normal entry points.

    python chip_smoke.py [--seed N]       # one card: phases 1-4
    python chip_smoke.py --chips 4        # four cards: the mesh paths only

Phases (one card):

1. device gate: JAX must find an NVIDIA GPU; the card's ``nvidia-smi`` name
   and power limit are printed before any number;
2. batched scan-to-map X-ICP: B=8 registrations of 64k-point readings
   against a 131k-point voxelized map, production chain (its in-round
   linearisation is the Triton pair-GN kernel), checked against the
   generator's ground truth; the same batch again with the plain XLA
   linearisation, and the kernel's normal equations against XLA's on the
   batch's own correspondences;
3. realtime SLAM at 64k points per scan (``RealtimePipeline`` with carving,
   dense map and loop closure on the loopy two-lap run), checked against
   ground truth and, before the first loop closure, against the offline
   ``SlamPipeline`` as the plain reference;
4. pose graphs: the dense 256-node and the PCG 1024-node / 4095-edge graph,
   solved from noisy poses.

With ``--chips 4`` it runs the three mesh paths instead (batch x point
sharded X-ICP on a 2x2 mesh, the edge-sharded pose graph and the
spatial-tile-sharded map on a 4-way mesh), each compared with the same
problem solved on one device.

Each phase prints one JSON line with its numbers and checks; any failed
check raises, so the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``. Data is generated from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np

import bench
import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.slam import pose_graph as pg
from open3d_slam_jax.utils.compile_cache import enable_compile_cache

# Phase 2: the prior error is ~0.1 m / ~0.021 rad; a converged production
# chain lands within a few mm / mrad of the truth.
XICP_MAX_TRANS_ERR_M = 0.02
XICP_MAX_ROT_ERR_RAD = 0.01
# Phase 3: absolute trajectory error over the whole two-lap run, and the
# realtime trajectory against the offline reference over the frames polled
# before the first loop closure (the two differ in reference-rebuild
# timing, so they agree to registration noise, not bit for bit).
RT_ATE_P50_M = 0.10
RT_ATE_MAX_M = 0.50
RT_VS_OFFLINE_P50_M = 0.10
RT_VS_OFFLINE_MAX_M = 0.30
# Phase 4: per-node start noise, and the bounds on the solved graph. The
# odometry edges carry noise, so even the exact optimum sits ~0.1 m from
# the truth at the far side of the 256-node loop; the solve must also beat
# the start.
PG_NOISE_ROT_RAD = 0.01
PG_NOISE_TRANS_M = 0.05
PG_MAX_TRANS_ERR_M = 0.25
PG_CHI2_RATIO = 0.1  # chi2 after / chi2 before
# Phase 2, kernel against the plain XLA linearisation (both f32
# accumulation; the transforms are elementwise, so the matmul precision
# setting does not enter). A pair whose d2 sits at an f32 gate boundary can
# flip, so counts may differ by a few pairs and b (a signed sum) by a
# little more than A. The two chains then agree to registration precision.
PAIR_GN_A_RTOL = 1e-4  # of max|A_xla|
PAIR_GN_B_RTOL = 1e-3  # of max|b_xla|
PAIR_GN_SWR2_RTOL = 1e-3
PAIR_GN_COUNT_ATOL = 2.0  # pairs
KERNEL_VS_XLA_TRANS_M = 1e-3
KERNEL_VS_XLA_ROT_RAD = 1e-3
# Mesh paths: sharded against one device (f32 sums in another order).
MESH_TRANS_ATOL_M = 1e-3
MESH_ROT_ATOL_RAD = 1e-3
MESH_POSE_ATOL = 1e-3


class CheckFailed(AssertionError):
    pass


def check(fields: dict, name: str, ok: bool) -> None:
    fields.setdefault("checks", {})[name] = bool(ok)


def finish_phase(phase: str, fields: dict) -> dict:
    """Print the phase's JSON line; raise if any of its checks failed."""
    print(json.dumps(dict(phase=phase, **fields)), flush=True)
    failed = [k for k, v in fields.get("checks", {}).items() if not v]
    if failed:
        raise CheckFailed(f"{phase}: failed checks {failed}")
    return fields


def pose_errors(T_est, T_true):
    """(translation m, rotation rad) of T_est^-1 T_true. The angle is
    atan2(|skew|, cos): arccos of the trace alone cannot resolve angles
    below ~5e-4 rad from f32 rotations."""
    d = np.linalg.inv(np.asarray(T_est, np.float64)) @ np.asarray(T_true, np.float64)
    R = d[:3, :3]
    s = 0.5 * np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    c = 0.5 * (np.trace(R) - 1.0)
    return float(np.linalg.norm(d[:3, 3])), float(np.arctan2(s, c))


def device_gate() -> dict:
    """Phase 1: refuse anything but a GPU; print the card line."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs an NVIDIA GPU, JAX found {dev.platform!r}"
        )
    card = bench.nvidia_smi_line()
    print(f"card: {card}", flush=True)
    return dict(platform=dev.platform, kind=dev.device_kind,
                count=len(jax.devices()), nvidia_smi=card)


def _chain(cfg):
    @jax.jit
    def run(reads, ref, Ts):
        return jax.vmap(lambda r, T: icp_mod.icp_single(r, ref, T, cfg))(reads, Ts)

    return run


def _pair_gn_vs_xla(prob, cfg):
    """The kernel's normal equations and sums against the plain XLA
    linearisation, on each reading's correspondences at its initial pose
    (the pairs the chain's first round would cache)."""
    from open3d_slam_jax.kernels import pair_gn_pallas as pgk
    from open3d_slam_jax.models import minimizers
    from open3d_slam_jax.ops import cell_list as cell_mod

    ref = prob["ref"]
    max_d2 = cfg.max_match_dist ** 2
    tau = 0.25 * max_d2  # a trim threshold inside the radius

    @jax.jit
    def both(reading, init_T):
        T0 = init_T.at[:3, 3].add(-ref.centroid)  # reference-centred frame
        src = se3.apply_transform(T0, reading.xyz)
        res = cell_mod.cell_match(ref.grid, src, reading.mask, k=1,
                                  max_dist=cfg.max_match_dist)
        valid = res.valid()
        kern = pgk.pair_gn_fused(reading.xyz, res.xyz, res.normals, valid,
                                 T0, tau, max_d2)
        d2 = jnp.sum((src[:, None, :] - res.xyz) ** 2, axis=-1)
        ok = valid & (d2 <= max_d2)
        w = (ok & (d2 <= tau)).astype(jnp.float32)
        A, b = minimizers.point_to_plane_normal_equations_bc(
            src, res.xyz, res.normals, w)
        r = jnp.sum((src[:, None, :] - res.xyz) * res.normals, axis=-1)
        xla = (A, b, jnp.sum(w), jnp.sum(w * r * r),
               jnp.sum(ok.astype(jnp.float32)))
        return kern, xla

    kern, xla = jax.vmap(both)(prob["readings"], prob["init_Ts"])
    kern = [np.asarray(x, np.float64) for x in kern]
    xla = [np.asarray(x, np.float64) for x in xla]
    return dict(
        pairs_per_reading=int(prob["readings"].capacity),
        A_rel_err=float(np.max(np.abs(kern[0] - xla[0])) / np.max(np.abs(xla[0]))),
        b_rel_err=float(np.max(np.abs(kern[1] - xla[1])) / np.max(np.abs(xla[1]))),
        sum_w_abs_err=float(np.max(np.abs(kern[2] - xla[2]))),
        sum_wr2_rel_err=float(np.max(np.abs(kern[3] - xla[3]) / np.maximum(xla[3], 1e-12))),
        n_ok_abs_err=float(np.max(np.abs(kern[4] - xla[4]))),
        mean_weighted_pairs=float(np.mean(xla[2])),
    )


def phase_xicp(seed, n_read=65536, map_cap=131072, batch=8,
               scene_points=400_000, reps=5) -> dict:
    """Phase 2: the batched production X-ICP chain, and its kernel
    against the plain XLA linearisation."""
    _, xicp_cfg = bench.icp_chain_configs()
    t0 = time.perf_counter()
    prob = bench.scan_to_map_problem(
        n_read, map_cap, batch, scene_points, xicp_cfg, seed=seed)
    jax.block_until_ready(prob["ref"])
    setup_s = time.perf_counter() - t0
    args = (prob["readings"], prob["ref"], prob["init_Ts"])
    runs = {}
    for name, cfg in (
        ("kernel", xicp_cfg),
        ("xla", dataclasses.replace(xicp_cfg, fused_kernel=False, moment_cached=False)),
    ):
        chain = _chain(cfg)
        t0 = time.perf_counter()
        res = jax.block_until_ready(chain(*args))
        first_call_s = time.perf_counter() - t0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = jax.block_until_ready(chain(*args))
            ts.append(time.perf_counter() - t0)
        runs[name] = (res, first_call_s, float(np.median(ts)))
    res, first_call_s, call_s = runs["kernel"]
    T = np.asarray(res.transform)
    T_xla = np.asarray(runs["xla"][0].transform)
    errs = [pose_errors(T[i], prob["T_trues"][i]) for i in range(batch)]
    dx = [pose_errors(T[i], T_xla[i]) for i in range(batch)]
    f = dict(
        batch=batch, reading_points=n_read,
        map_points=int(jnp.sum(prob["submap"].mask)),
        setup_s=setup_s, first_call_s=first_call_s,
        call_s_median=call_s, regs_per_s=batch / call_s,
        xla_linearisation=dict(first_call_s=runs["xla"][1],
                               call_s_median=runs["xla"][2],
                               regs_per_s=batch / runs["xla"][2]),
        mean_iterations=float(np.mean(np.asarray(res.iterations))),
        max_trans_err_m=max(e[0] for e in errs),
        max_rot_err_rad=max(e[1] for e in errs),
        kernel_vs_xla_trans_m=max(d[0] for d in dx),
        kernel_vs_xla_rot_rad=max(d[1] for d in dx),
        pair_gn=_pair_gn_vs_xla(prob, xicp_cfg),
        bounds=dict(trans_m=XICP_MAX_TRANS_ERR_M, rot_rad=XICP_MAX_ROT_ERR_RAD,
                    kernel_vs_xla_trans_m=KERNEL_VS_XLA_TRANS_M,
                    kernel_vs_xla_rot_rad=KERNEL_VS_XLA_ROT_RAD,
                    A_rtol=PAIR_GN_A_RTOL, b_rtol=PAIR_GN_B_RTOL,
                    sum_wr2_rtol=PAIR_GN_SWR2_RTOL,
                    count_atol=PAIR_GN_COUNT_ATOL, precision="f32"),
    )
    pg_ = f["pair_gn"]
    check(f, "finite", np.isfinite(T).all())
    check(f, "trans_err", f["max_trans_err_m"] <= XICP_MAX_TRANS_ERR_M)
    check(f, "rot_err", f["max_rot_err_rad"] <= XICP_MAX_ROT_ERR_RAD)
    check(f, "kernel_vs_xla_chain",
          f["kernel_vs_xla_trans_m"] <= KERNEL_VS_XLA_TRANS_M
          and f["kernel_vs_xla_rot_rad"] <= KERNEL_VS_XLA_ROT_RAD)
    check(f, "pair_gn_A", pg_["A_rel_err"] <= PAIR_GN_A_RTOL)
    check(f, "pair_gn_b", pg_["b_rel_err"] <= PAIR_GN_B_RTOL)
    check(f, "pair_gn_sums",
          pg_["sum_w_abs_err"] <= PAIR_GN_COUNT_ATOL
          and pg_["n_ok_abs_err"] <= PAIR_GN_COUNT_ATOL
          and pg_["sum_wr2_rel_err"] <= PAIR_GN_SWR2_RTOL)
    return finish_phase("xicp_batched", f)


def _trans_diffs(A, B):
    return np.linalg.norm(
        np.asarray(A)[:, :3, 3] - np.asarray(B)[:, :3, 3], axis=1)


def phase_realtime(seed, n_pts=65536, n_frames=340, scene_points=400_000,
                   cfg=None, min_closures=1) -> dict:
    """Phase 3: realtime SLAM with carving, dense map and loop closure
    (``cfg`` defaults to the bench's 64k pipeline configuration)."""
    from open3d_slam_jax.slam.pipeline import SlamPipeline
    from open3d_slam_jax.slam.realtime import RealtimePipeline

    cfg = bench.pipeline_cfg_64k() if cfg is None else cfg
    t0 = time.perf_counter()
    scene = bench.synth_scene(scene_points, seed=seed)
    frames, gts = bench._frames_for_run(scene, n_frames, n_pts, seed=seed)
    setup_s = time.perf_counter() - t0

    rt = RealtimePipeline(cfg, poll_every=8)
    t0 = time.perf_counter()
    rt.warmup(frames[0])
    warmup_s = time.perf_counter() - t0
    prefix = {}  # frame -> polled pose, snapshot while no loop closure exists
    t0 = time.perf_counter()
    for i, scan in enumerate(frames):
        rt.process_scan(scan, time=0.1 * i)
        if rt.loop_closure_count == 0:
            snap = {k: r.pose.copy() for k, r in enumerate(rt.frames)
                    if r.pose is not None}
            # A closure that landed during the copy may have corrected it.
            if rt.loop_closure_count == 0:
                prefix = snap
    rt.poll()
    stream_s = time.perf_counter() - t0
    rt.finish()
    traj = rt.trajectory()
    ate = bench._ate(traj, gts)

    n_prefix = max(prefix) + 1 if prefix else 0
    off = SlamPipeline(cfg)
    off_poses = []
    t0 = time.perf_counter()
    for i, scan in enumerate(frames[:n_prefix]):
        off.process_scan(scan, time=0.1 * i)
        off_poses.append(off.pose.copy())
    offline_s = time.perf_counter() - t0
    idx = sorted(prefix)
    diff = (_trans_diffs([prefix[k] for k in idx], [off_poses[k] for k in idx])
            if idx else np.zeros(1))

    f = dict(
        frames=n_frames, points_per_scan=n_pts,
        setup_s=setup_s, warmup_s=warmup_s, stream_s=stream_s,
        mapper_hz=n_frames / stream_s, offline_prefix_s=offline_s,
        submaps=len(rt.submaps.submaps),
        loop_closures=rt.loop_closure_count,
        pose_graph_solves=rt.pose_graph_solves,
        dense_map_points=int(len(rt.dense_map_points())),
        ate_p50_m=float(np.median(ate)), ate_max_m=float(np.max(ate)),
        prefix_frames=n_prefix,
        rt_vs_offline_p50_m=float(np.median(diff)),
        rt_vs_offline_max_m=float(np.max(diff)),
        bounds=dict(ate_p50_m=RT_ATE_P50_M, ate_max_m=RT_ATE_MAX_M,
                    rt_vs_offline_p50_m=RT_VS_OFFLINE_P50_M,
                    rt_vs_offline_max_m=RT_VS_OFFLINE_MAX_M),
    )
    check(f, "finite", np.isfinite(traj).all())
    check(f, "loop_closures", f["loop_closures"] >= min_closures)
    check(f, "pose_graph_solves", f["pose_graph_solves"] >= min_closures)
    check(f, "ate_p50", f["ate_p50_m"] <= RT_ATE_P50_M)
    check(f, "ate_max", f["ate_max_m"] <= RT_ATE_MAX_M)
    check(f, "prefix_frames", n_prefix > 0)
    check(f, "rt_vs_offline_p50", f["rt_vs_offline_p50_m"] <= RT_VS_OFFLINE_P50_M)
    check(f, "rt_vs_offline_max", f["rt_vs_offline_max_m"] <= RT_VS_OFFLINE_MAX_M)
    return finish_phase("realtime_slam", f)


def noisy_start(graph, seed):
    """Per-node random start perturbation (node 0, the gauge, stays)."""
    rng = np.random.default_rng(seed)
    k = graph.poses.shape[0]
    tw = np.c_[rng.normal(0, PG_NOISE_ROT_RAD, (k, 3)),
               rng.normal(0, PG_NOISE_TRANS_M, (k, 3))].astype(np.float32)
    tw[0] = 0.0
    P = np.asarray(jax.vmap(se3.exp_se3)(jnp.asarray(tw)))
    return dataclasses.replace(graph, poses=jnp.asarray(np.asarray(graph.poses) @ P))


def _graph_errors(poses, gt):
    return _trans_diffs(np.asarray(poses)[: len(gt)], gt)


def phase_pose_graph(seed, n_small=256, n_big=1024, e_big=4096) -> dict:
    """Phase 4: both pose-graph rows from noisy poses."""
    rows = {}
    for name, (graph, cfg, gt) in zip(
        ("dense_256", "pcg_1024"),
        bench.pose_graph_problems(11 + seed, n_small, n_big, e_big),
    ):
        g0 = noisy_start(graph, seed + 1)
        chi2_before = float(pg.chi2(g0))
        t0 = time.perf_counter()
        out = jax.block_until_ready(pg.optimize(g0, cfg))
        first_call_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(pg.optimize(g0, cfg))
        solve_s = time.perf_counter() - t0
        chi2_after = float(pg.chi2(out))
        err0 = _graph_errors(g0.poses, gt)
        err1 = _graph_errors(out.poses, gt)
        rows[name] = dict(
            nodes=int(np.asarray(graph.node_mask).sum()),
            edges=int(np.asarray(graph.edge_mask).sum()),
            solver=cfg.solver, first_call_s=first_call_s, solve_s=solve_s,
            chi2_before=chi2_before, chi2_after=chi2_after,
            max_trans_err_before_m=float(err0.max()),
            max_trans_err_after_m=float(err1.max()),
            mean_trans_err_after_m=float(err1.mean()),
        )
    f = dict(rows=rows, bounds=dict(max_trans_err_m=PG_MAX_TRANS_ERR_M,
                                    chi2_ratio=PG_CHI2_RATIO))
    for name, r in rows.items():
        check(f, f"{name}_finite", np.isfinite(r["chi2_after"]))
        check(f, f"{name}_chi2", r["chi2_after"] <= PG_CHI2_RATIO * r["chi2_before"])
        check(f, f"{name}_err", r["max_trans_err_after_m"] <= min(
            PG_MAX_TRANS_ERR_M, r["max_trans_err_before_m"]))
    return finish_phase("pose_graph", f)


def phase_mesh(seed, n_read=65536, map_cap=131072, scene_points=400_000,
               n_small=256, n_big=1024, e_big=4096) -> dict:
    """The three mesh paths on four devices, each against one device."""
    from jax.sharding import Mesh

    from open3d_slam_jax.parallel import (
        register_batch_point_sharded, register_tile_sharded)

    devs = jax.devices()
    if len(devs) < 4:
        raise SystemExit(f"chip_smoke --chips 4: found {len(devs)} devices")
    devs = devs[:4]
    one = np.asarray(devs[:1])
    # The pair-GN kernel does not cover sharded chains (psum'd sums, global
    # trimming quantile): they run the XLA linearisation.
    xicp_cfg = dataclasses.replace(bench.icp_chain_configs()[1], fused_kernel=False)
    batch = 2
    prob = bench.scan_to_map_problem(
        n_read, map_cap, batch, scene_points, xicp_cfg, seed=seed)
    submap, readings, init_Ts = prob["submap"], prob["readings"], prob["init_Ts"]
    f = dict(devices=len(devs), reading_points=n_read,
             map_points=int(jnp.sum(submap.mask)),
             bounds=dict(trans_m=MESH_TRANS_ATOL_M, rot_rad=MESH_ROT_ATOL_RAD,
                         pose_atol=MESH_POSE_ATOL))

    def compare(name, T_mesh, T_one, truths):
        dt = [pose_errors(a, b) for a, b in zip(T_mesh, T_one)]
        gt = [pose_errors(a, b) for a, b in zip(T_mesh, truths)]
        f[name] = dict(max_trans_diff_m=max(d[0] for d in dt),
                       max_rot_diff_rad=max(d[1] for d in dt),
                       max_trans_err_m=max(e[0] for e in gt),
                       max_rot_err_rad=max(e[1] for e in gt))
        check(f, f"{name}_vs_one_device",
              f[name]["max_trans_diff_m"] <= MESH_TRANS_ATOL_M
              and f[name]["max_rot_diff_rad"] <= MESH_ROT_ATOL_RAD)
        check(f, f"{name}_vs_truth",
              f[name]["max_trans_err_m"] <= XICP_MAX_TRANS_ERR_M
              and f[name]["max_rot_err_rad"] <= XICP_MAX_ROT_ERR_RAD)

    # Batch x point-sharded X-ICP on a 2x2 mesh.
    mesh = Mesh(np.asarray(devs).reshape(2, 2), ("batch", "points"))
    mesh1 = Mesh(one.reshape(1, 1), ("batch", "points"))
    t0 = time.perf_counter()
    r4 = jax.block_until_ready(register_batch_point_sharded(
        mesh, readings, submap, init_Ts, xicp_cfg))
    f["batch_point_s"] = time.perf_counter() - t0
    r1 = register_batch_point_sharded(mesh1, readings, submap, init_Ts, xicp_cfg)
    compare("batch_point_xicp", np.asarray(r4.transform), np.asarray(r1.transform),
            prob["T_trues"])

    # Spatial-tile-sharded map on a 4-way mesh (one reading).
    tmesh = Mesh(np.asarray(devs).reshape(1, 4), ("batch", "points"))
    tmesh1 = Mesh(one.reshape(1, 1), ("batch", "points"))
    reading0 = jax.tree.map(lambda x: x[0], readings)
    t0 = time.perf_counter()
    t4 = jax.block_until_ready(register_tile_sharded(
        tmesh, reading0, submap, init_Ts[0], xicp_cfg))
    f["tile_s"] = time.perf_counter() - t0
    t1 = register_tile_sharded(tmesh1, reading0, submap, init_Ts[0], xicp_cfg)
    compare("tile_xicp", np.asarray(t4.transform)[None],
            np.asarray(t1.transform)[None], prob["T_trues"][:1])

    # Edge-sharded pose graph (PCG row) on a 4-way mesh.
    _, (graph, cfg, gt) = bench.pose_graph_problems(11 + seed, n_small, n_big, e_big)
    g0 = noisy_start(graph, seed + 1)
    emesh = Mesh(np.asarray(devs), ("edges",))
    t0 = time.perf_counter()
    p4 = jax.block_until_ready(pg.optimize_edge_sharded(g0, cfg, emesh).poses)
    f["pose_graph_s"] = time.perf_counter() - t0
    p1 = pg.optimize_edge_sharded(g0, cfg, Mesh(one, ("edges",))).poses
    diff = float(np.max(np.abs(np.asarray(p4) - np.asarray(p1))))
    err = float(_graph_errors(p4, gt).max())
    f["pose_graph_pcg"] = dict(max_pose_diff=diff, max_trans_err_m=err)
    check(f, "pose_graph_vs_one_device", diff <= MESH_POSE_ATOL)
    check(f, "pose_graph_vs_truth", err <= PG_MAX_TRANS_ERR_M)
    return finish_phase("mesh", f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chips", type=int, choices=(1, 4), default=1,
                   help="4: run only the mesh paths on four cards")
    args = p.parse_args(argv)

    device = device_gate()
    enable_compile_cache()
    t0 = time.perf_counter()
    if args.chips == 4:
        phase_mesh(args.seed)
    else:
        phase_xicp(args.seed)
        phase_realtime(args.seed)
        phase_pose_graph(args.seed)
    print(f"total_s: {time.perf_counter() - t0:.1f}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
