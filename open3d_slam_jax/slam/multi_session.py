"""Multi-session mapping: merge independently built SLAM sessions.

The BASELINE "multi-session mapping" workload: concurrent submap
registrations + joint loop-closure pose-graph GN. The reference has no
explicit multi-session tool — its building blocks are ``setInitialMap``
(localization on a prior map, ``SlamWrapper.cpp:421-432``) and the
pose-graph machinery (``OptimizationProblem.cpp``); this module composes
the same capabilities as batched device programs:

1. **Global coarse alignment** of session B onto session A: FPFH + device
   RANSAC between assembled-map skeletons (the relocalization path), then
   a full ICP polish.
2. **Concurrent inter-session submap registrations**: every gated
   (A submap, B submap) pair is refined in ONE batched ``register_batch``
   call — the vmapped-ICP workload the chip is designed for — instead of
   the reference's serial per-pair loop.
3. **Joint pose-graph GN on device**: nodes = both sessions' submap
   anchors, odometry edges inside each session, inter-session edges from
   the accepted registrations; solved with the same robust GN/LM as
   in-session loop closure (``slam/pose_graph.py``), optionally sharded
   over a mesh axis.

Session B's submaps (clouds + anchors) are rigidly re-anchored into A's
frame, so after ``merge_sessions`` both collections form one consistent
map.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import place_recognition as pr
from open3d_slam_jax.slam import pose_graph as pg


@dataclasses.dataclass(frozen=True)
class MultiSessionConfig:
    # Global coarse alignment (session-level relocalization).
    skeleton_capacity: int = 16384
    use_fpfh_ransac: bool = True
    fpfh_ratio: float = 0.9  # Lowe test: planar features must not vote
    ransac_hypotheses: int = 8192  # one vmapped pass; cheap on device
    # Seed grid: every (A anchor, B anchor) pairing x yaw sweep ABOUT the
    # paired anchor (the revisited region can be anywhere in either
    # session). Pairings are subsampled evenly above max_anchor_pairs.
    coarse_yaw_hypotheses: int = 16
    max_anchor_pairs: int = 64
    # Funnel widths: raw seeds -> cheap brute prune -> coarse pull-in ICP
    # -> fine polish of the top-k -> coverage-normalized ranking.
    prune_to: int = 96
    polish_top_k: int = 10
    coarse_match_dist: float = 3.0  # raw-prune near radius
    # Two-phase pull-in: a WIDE robust point-to-plane pass first (Cauchy
    # IRLS — wrong-wall matches are down-weighted, so the aperiodic
    # structure ensemble votes for the true offset even from seeds several
    # metres off), then a tight trimmed pass. A single tight pass stalls:
    # from a half-anchor-spacing seed error the true partners sit outside
    # the match radius and ground-plane matches lock the pose.
    pull_in_dist: float = 8.0
    pull_in_robust_scale: float = 2.0
    pull_in_tight_dist: float = 2.0
    # Scoring: normalized overlap = matched(tight) / in-coverage(cov).
    # Plain match ratio is ALIAS-PRONE under partial overlap: shifting B's
    # non-overlapping region into A's span raises it even when structure
    # mismatches. Normalizing by the in-coverage count makes unexplained
    # structure inside the covered region count against the hypothesis.
    tight_dist: float = 0.3
    coverage_dist: float = 4.0
    min_coarse_overlap: float = 0.55  # gate on the NORMALIZED score
    # Inter-session pair search + batched refinement.
    pair_distance: float = 25.0  # anchor gate AFTER coarse alignment
    scan_capacity: int = 16384  # per-submap cloud compaction
    batch_size: int = 8  # pairs per register_batch call (padded)
    min_overlap: float = 0.35
    max_residual: float = 0.3
    icp: icp_mod.ICPConfig = dataclasses.field(
        default_factory=lambda: icp_mod.ICPConfig(
            knn=1,
            max_match_dist=1.0,
            matcher="grid",
            grid_table_size=1 << 15,
            grid_bucket_cap=96,
            trimmed_ratio=0.8,
            minimizer="point_to_plane",
            max_iterations=30,
            min_diff_rot=1e-3,
            min_diff_trans=1e-3,
        )
    )
    pose_graph: pg.PoseGraphConfig = dataclasses.field(
        default_factory=lambda: pg.PoseGraphConfig(iterations=20)
    )


@dataclasses.dataclass
class InterSessionConstraint:
    a_idx: int
    b_idx: int
    T_a_b: np.ndarray  # B submap anchor frame -> A submap anchor frame
    overlap: float
    residual: float
    information: np.ndarray


@dataclasses.dataclass
class MergeResult:
    T_ab: np.ndarray  # session B map frame -> session A map frame (coarse+polish)
    constraints: List[InterSessionConstraint]
    poses_a: np.ndarray  # [nA, 4, 4] optimized anchors (A frame)
    poses_b: np.ndarray  # [nB, 4, 4] optimized anchors (A frame)
    chi2_before: float
    chi2_after: float
    # The OPTIMIZED session transform, distilled from the solved graph:
    # SE(3) mean of ``new_pose_b_j @ inv(original_anchor_b_j)`` over B's
    # submaps. ``T_ab`` above is only the coarse-alignment INPUT — after
    # the joint solve the registration-grade alignment lives in the
    # anchors, and this field surfaces it (the round-4 bench measured the
    # coarse input and reported its 0.11 m error as the converged error).
    T_ab_optimized: Optional[np.ndarray] = None
    # Per-phase wall seconds: {"coarse": .., "register": .., "graph": ..}.
    phase_s: Optional[dict] = None


def session_skeleton(collection, capacity: int) -> pc.PointBatch:
    """Assembled-map skeleton with normals (for global alignment)."""
    pts = collection.map_points()
    if len(pts) > capacity:
        pts = pts[:: len(pts) // capacity + 1][:capacity]
    batch = pc.from_points(np.asarray(pts, np.float32), capacity=capacity)
    return normals_mod.estimate_normals(batch, knn=10)


def _stride_subsample(batch: pc.PointBatch, capacity: int) -> pc.PointBatch:
    """Evenly spaced subsample of the valid points (host-side setup)."""
    mask = np.asarray(batch.mask)
    valid = np.where(mask)[0]
    if len(valid) > capacity:
        valid = valid[np.linspace(0, len(valid) - 1, capacity).astype(int)]
    take = lambda x: np.asarray(x)[valid]  # noqa: E731
    out = pc.from_points(take(batch.xyz).astype(np.float32), capacity=capacity)
    extras = dict(out.extras)
    for k, v in batch.extras.items():
        pad = np.zeros((capacity,) + np.asarray(v).shape[1:], np.asarray(v).dtype)
        pad[: len(valid)] = take(v)
        extras[k] = jnp.asarray(pad)
    return dataclasses.replace(out, extras=extras)


def coverage_scores(
    skel_b: pc.PointBatch,
    skel_a: pc.PointBatch,
    Ts: np.ndarray,
    tight: float,
    r_cov: float,
    chunk: int = 16,
):
    """Coverage-normalized overlap per hypothesis: ``matched / in_coverage``.

    ``matched`` counts B points with an A neighbour within ``tight`` after
    applying the hypothesis; ``in_coverage`` counts B points within
    ``r_cov`` of A's (coarsened) structure — the potentially-visible set.
    Returns ``(scores [H], matched_counts [H])`` as numpy arrays."""
    from open3d_slam_jax.ops import grid_hash
    from open3d_slam_jax.ops import voxel as voxel_mod

    g_t = grid_hash.build_grid(
        skel_a.padded_xyz(), skel_a.mask, 2.0 * tight, 1 << 14, 32
    )
    a_cov = voxel_mod.voxel_downsample(skel_a, r_cov * 0.5)
    g_c = grid_hash.build_grid(
        a_cov.padded_xyz(), a_cov.mask, 2.0 * r_cov, 1 << 9, 192
    )
    xb, mb = skel_b.padded_xyz(), skel_b.mask

    # Grids/clouds are jit ARGUMENTS: closed-over device arrays get
    # embedded as literal HLO constants, which makes compilation slow.
    @jax.jit
    def run(gt, gc, xb, mb, T_chunk):
        def one(T):
            x = xb @ T[:3, :3].T + T[:3, 3]
            mt = grid_hash.grid_match(gt, x, mb, k=1, max_dist=tight)
            mc = grid_hash.grid_match(gc, x, mb, k=1, max_dist=r_cov)
            matched = mt.valid()[:, 0] & mb
            cov = (mc.valid()[:, 0] & mb) | matched
            return matched.sum(), cov.sum()

        return jax.vmap(one)(T_chunk)

    H = len(Ts)
    pad = (-H) % chunk
    Ts_p = np.concatenate([Ts, np.tile(np.eye(4), (pad, 1, 1))]).astype(np.float32)
    m_all, c_all = [], []
    for lo in range(0, H + pad, chunk):
        m, c = run(g_t, g_c, xb, mb, jnp.asarray(Ts_p[lo:lo + chunk]))
        m_all.append(np.asarray(m))
        c_all.append(np.asarray(c))
    m = np.concatenate(m_all)[:H].astype(np.float64)
    c = np.concatenate(c_all)[:H].astype(np.float64)
    return m / np.maximum(c, 1.0), m


def _dedup_transforms(Ts: np.ndarray, order: np.ndarray, keep: int,
                      t_tol: float = 0.75, r_tol: float = 0.15) -> List[int]:
    """Greedy pick of ``keep`` distinct transforms in ranked ``order``."""
    picked: List[int] = []
    for k in order:
        T = Ts[k]
        dup = False
        for j in picked:
            d = np.linalg.inv(Ts[j]) @ T
            rot = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
            if np.linalg.norm(d[:3, 3]) < t_tol and rot < r_tol:
                dup = True
                break
        if not dup:
            picked.append(int(k))
            if len(picked) >= keep:
                break
    return picked


def coarse_align_sessions(
    a, b, cfg: Optional[MultiSessionConfig] = None, seed: int = 0
) -> Optional[np.ndarray]:
    """Session-level global alignment: T_ab such that
    ``T_ab @ x_b ~ x_a`` for overlapping structure.

    A hypothesis funnel (every stage a batched device sweep):

    1. seeds = FPFH-RANSAC (when distinctive features exist) + every
       (A anchor, B anchor) pairing x yaw sweep about the paired anchor;
    2. cheap brute prune on tiny subsamples (raw-seed coverage score);
    3. coarse pull-in ICP (``coarse_match_dist`` basin, brute matcher,
       subsampled skeletons) over the surviving seeds;
    4. fine ICP polish of the top-k distinct coarse winners;
    5. coverage-normalized ranking (see ``MultiSessionConfig`` scoring
       notes) with the ``min_coarse_overlap`` gate.

    Returns None when no hypothesis passes the gate."""
    cfg = cfg or MultiSessionConfig()
    skel_a = session_skeleton(a, cfg.skeleton_capacity)
    skel_b = session_skeleton(b, cfg.skeleton_capacity)

    seeds: List[np.ndarray] = []
    n_fpfh = 0
    if cfg.use_fpfh_ransac:
        pr_cfg = pr.PlaceRecognitionConfig(
            icp=cfg.icp, fpfh_ratio=cfg.fpfh_ratio,
            ransac_hypotheses=cfg.ransac_hypotheses,
        )
        T_coarse = pr.fpfh_coarse_align(skel_b, skel_a, pr_cfg, seed=seed)
        if T_coarse is not None:
            seeds.append(np.asarray(T_coarse, np.float64))
            n_fpfh = 1
    # Anchor-pair x yaw seed grid. Yaw rotates ABOUT the paired anchor
    # (ea.anchor @ R @ inv(eb.anchor)); with exact anchor correspondence
    # and the right yaw this IS the true T_ab, so the seed error is
    # bounded by the anchor spacing / yaw step, independent of map size.
    pairs = [(ea, eb) for ea in a.submaps for eb in b.submaps]
    if len(pairs) > cfg.max_anchor_pairs:
        sel = np.linspace(0, len(pairs) - 1, cfg.max_anchor_pairs).astype(int)
        pairs = [pairs[i] for i in sel]
    yaws = np.linspace(0, 2 * np.pi, cfg.coarse_yaw_hypotheses, endpoint=False)
    # Sub-anchor-spacing XY offsets: anchor pairing quantizes the seed
    # translation to the anchor lattice (submaps form every
    # creation_radius+), but in quasi-periodic scenes the pull-in basin is
    # SMALLER than that spacing — a half-spacing seed error converges to an
    # aliased lattice offset instead of the true one. Half-spacing offsets
    # along the horizontal axes put one seed inside the true basin.
    apos = np.stack([e.anchor[:3, 3] for e in a.submaps])
    offsets = [(0.0, 0.0)]
    if len(apos) > 1:
        dmat = np.linalg.norm(apos[:, None] - apos[None], axis=-1)
        np.fill_diagonal(dmat, np.inf)
        half = float(np.median(dmat.min(axis=1))) / 2.0
        if np.isfinite(half) and half > 0.5:
            offsets += [(half, 0.0), (-half, 0.0), (0.0, half), (0.0, -half)]
    for ea, eb in pairs:
        inv_b = np.linalg.inv(eb.anchor)
        for yaw in yaws:
            R = np.eye(4)
            c, s = np.cos(yaw), np.sin(yaw)
            R[0, 0], R[0, 1], R[1, 0], R[1, 1] = c, -s, s, c
            T0 = ea.anchor @ R @ inv_b
            for ox, oy in offsets:
                T = T0.copy()
                T[0, 3] += ox
                T[1, 3] += oy
                seeds.append(T)
    Ts_seed = np.stack(seeds)

    # Stage 2: brute prune on tiny subsamples — raw coverage score at the
    # pull-in radius. Kills seeds that land B outside A entirely.
    b_tiny = _stride_subsample(skel_b, 512)
    a_tiny = _stride_subsample(skel_a, 1024)

    @jax.jit
    def raw_scores(bt, at, T_all):
        xb = bt.padded_xyz()

        def one(T):
            x = xb @ T[:3, :3].T + T[:3, 3]
            d = jnp.linalg.norm(
                x[:, None, :] - at.padded_xyz()[None, :, :], axis=-1
            )
            d = jnp.where(at.mask[None, :], d, jnp.inf).min(axis=1)
            d = jnp.where(bt.mask, d, jnp.inf)
            near = (d < cfg.coarse_match_dist).sum()
            cov = (d < 2.5 * cfg.coverage_dist).sum()
            return near / jnp.maximum(cov, 1)

        return jax.vmap(one)(T_all)

    RCH = 128
    rpad = (-len(Ts_seed)) % RCH
    Ts_r = np.concatenate(
        [Ts_seed, np.tile(np.eye(4), (rpad, 1, 1))]
    ).astype(np.float32)
    rs = np.concatenate([
        np.asarray(raw_scores(b_tiny, a_tiny, jnp.asarray(Ts_r[lo:lo + RCH])))
        for lo in range(0, len(Ts_r), RCH)
    ])[: len(Ts_seed)]
    rs[:n_fpfh] = np.inf  # the FPFH seed always survives the prune
    keep = np.argsort(-rs)[: cfg.prune_to]
    Ts_pruned = Ts_seed[keep]

    # Stage 3: two-phase coarse pull-in ICP on subsampled skeletons (brute
    # matcher — no cell-capacity tuning at multi-metre radii), chunked
    # over H. See the MultiSessionConfig pull-in notes.
    b_sub = _stride_subsample(skel_b, 1024)
    a_sub = _stride_subsample(skel_a, 2048)
    cfg_wide = dataclasses.replace(
        cfg.icp, matcher="brute", max_match_dist=cfg.pull_in_dist,
        trimmed_ratio=None, robust="cauchy",
        robust_scale=cfg.pull_in_robust_scale,
        max_iterations=20, coarse_iterations=0,
        candidate_refresh_every=0, fast_trimming=False,
        minimizer="point_to_plane",
    )
    cfg_tight = dataclasses.replace(
        cfg.icp, matcher="brute", max_match_dist=cfg.pull_in_tight_dist,
        trimmed_ratio=0.85, max_iterations=15, coarse_iterations=0,
        candidate_refresh_every=0, fast_trimming=False,
        minimizer="point_to_plane",
    )
    CH = 32
    pad = (-len(Ts_pruned)) % CH
    Ts_p = np.concatenate(
        [Ts_pruned, np.tile(np.eye(4), (pad, 1, 1))]
    ).astype(np.float32)
    coarse_T = []
    for lo in range(0, len(Ts_p), CH):
        r = icp_mod.register_hypotheses(
            b_sub, a_sub, jnp.asarray(Ts_p[lo:lo + CH]), cfg_wide
        )
        r2 = icp_mod.register_hypotheses(
            b_sub, a_sub, jnp.asarray(r.transform, jnp.float32), cfg_tight
        )
        coarse_T.append(np.asarray(r2.transform, np.float64))
    coarse_T = np.concatenate(coarse_T)[: len(Ts_pruned)]

    # Stage 4: rank coarse winners, polish top-k distinct with the fine ICP.
    sc, _cnt = coverage_scores(
        b_sub, skel_a, coarse_T, tight=0.4, r_cov=cfg.coverage_dist
    )
    picked = _dedup_transforms(coarse_T, np.argsort(-sc), cfg.polish_top_k)
    if not picked:
        return None
    res = icp_mod.register_hypotheses(
        skel_b, skel_a,
        jnp.asarray(coarse_T[picked], jnp.float32), cfg.icp,
    )
    Ts_fine = np.asarray(res.transform, np.float64)
    residual = np.asarray(res.residual, np.float64)

    # Stage 5: final coverage-normalized ranking + gate.
    score, matched = coverage_scores(
        skel_b, skel_a, Ts_fine, tight=cfg.tight_dist, r_cov=cfg.coverage_dist
    )
    ok = (score >= cfg.min_coarse_overlap) & (matched >= 256)
    if not bool(np.any(ok)):
        return None
    best = int(np.lexsort((residual, np.where(ok, -score, np.inf)))[0])
    return Ts_fine[best]


def _submap_local_cloud(entry, capacity: int) -> pc.PointBatch:
    """Submap cloud expressed in its own anchor frame, with normals."""
    cloud = pc.compact(entry.state.cloud, capacity)
    T_inv = jnp.asarray(np.linalg.inv(entry.anchor), jnp.float32)
    return normals_mod.estimate_normals(cloud.transformed(T_inv), knn=8)


def find_inter_session_constraints(
    a, b, T_ab: np.ndarray, cfg: Optional[MultiSessionConfig] = None,
    mesh=None,
) -> List[InterSessionConstraint]:
    """Refine every gated (A, B) submap pair concurrently.

    Pairs are gated by anchor distance after mapping B's anchors through
    ``T_ab``; the surviving pairs are registered in batched vmapped ICP
    calls (``cfg.batch_size`` problems per dispatch, last batch padded).

    ``mesh``: optional ``jax.sharding.Mesh`` with a "batch" axis — the
    multi-device mode from BASELINE's multi-session workload: each dispatch
    carries ``batch_size * mesh.shape["batch"]`` pair problems sharded
    over the axis (zero-communication DP via
    :func:`parallel.sharded_icp.register_batch_sharded`)."""
    cfg = cfg or MultiSessionConfig()
    pairs = []
    for j, eb in enumerate(b.submaps):
        anchor_b_in_a = T_ab @ eb.anchor
        for i, ea in enumerate(a.submaps):
            d = np.linalg.norm(anchor_b_in_a[:3, 3] - ea.anchor[:3, 3])
            if d <= cfg.pair_distance:
                pairs.append((i, j))
    if not pairs:
        return []

    # Per-submap local clouds, computed once (not per pair).
    a_local = {i: _submap_local_cloud(a.submaps[i], cfg.scan_capacity)
               for i in {i for i, _ in pairs}}
    b_local = {j: _submap_local_cloud(b.submaps[j], cfg.scan_capacity)
               for j in {j for _, j in pairs}}

    out: List[InterSessionConstraint] = []
    BS = cfg.batch_size * (mesh.shape["batch"] if mesh is not None else 1)
    for lo in range(0, len(pairs), BS):
        chunk = pairs[lo:lo + BS]
        pad = BS - len(chunk)
        chunk_p = chunk + [chunk[-1]] * pad  # pad with a copy; results masked
        readings = pc.stack([b_local[j] for _, j in chunk_p])
        refs = pc.stack([a_local[i] for i, _ in chunk_p])
        inits = jnp.asarray(np.stack([
            (np.linalg.inv(a.submaps[i].anchor) @ T_ab @ b.submaps[j].anchor
             ).astype(np.float32)
            for i, j in chunk_p
        ]))
        if mesh is not None:
            from open3d_slam_jax.parallel import sharded_icp

            res = sharded_icp.register_batch_sharded(
                mesh, readings, refs, inits, cfg.icp
            )
        else:
            res = icp_mod.register_batch(readings, refs, inits, cfg.icp)
        overlap = np.asarray(res.overlap_ratio)
        residual = np.asarray(res.residual)
        Ts = np.asarray(res.transform, np.float64)
        for k, (i, j) in enumerate(chunk):
            if overlap[k] < cfg.min_overlap or residual[k] > cfg.max_residual:
                continue
            out.append(InterSessionConstraint(
                a_idx=i,
                b_idx=j,
                T_a_b=Ts[k],
                overlap=float(overlap[k]),
                residual=float(residual[k]),
                information=pr.information_from_quality(
                    float(overlap[k]), float(residual[k])
                ),
            ))
    return out


def merge_sessions(
    a, b, cfg: Optional[MultiSessionConfig] = None,
    T_ab: Optional[np.ndarray] = None, seed: int = 0,
    mesh=None,
) -> Optional[MergeResult]:
    """Merge session B's submap collection into session A's frame.

    Steps: coarse global alignment (unless ``T_ab`` given) -> concurrent
    inter-session submap registrations (sharded over ``mesh``'s "batch"
    axis when given) -> joint pose-graph GN -> rigid re-anchoring of both
    collections. Returns None when alignment fails or no inter-session
    constraint is accepted (collections untouched)."""
    import time as _time

    cfg = cfg or MultiSessionConfig()
    phase_s = {}
    if T_ab is None:
        t0 = _time.perf_counter()
        T_ab = coarse_align_sessions(a, b, cfg, seed=seed)
        phase_s["coarse"] = round(_time.perf_counter() - t0, 2)
        if T_ab is None:
            return None
    T_ab = np.asarray(T_ab, np.float64)
    t0 = _time.perf_counter()
    constraints = find_inter_session_constraints(a, b, T_ab, cfg, mesh=mesh)
    phase_s["register"] = round(_time.perf_counter() - t0, 2)
    if not constraints:
        return None
    t0 = _time.perf_counter()
    anchors_b_orig = [e.anchor.copy() for e in b.submaps]

    nA, nB = len(a.submaps), len(b.submaps)
    n_edges = max(nA - 1, 0) + max(nB - 1, 0) + len(constraints)
    builder = pg.PoseGraphBuilder(node_capacity=nA + nB,
                                  edge_capacity=max(n_edges, 1))
    for e in a.submaps:
        builder.add_node(e.anchor)
    for e in b.submaps:
        builder.add_node(T_ab @ e.anchor)  # B anchors pre-mapped into A frame
    # In-session odometry edges (parent chain), both sessions: relative
    # anchor transforms are frame-invariant under the common premultiply.
    for i, e in enumerate(a.submaps):
        if e.parent is not None:
            builder.add_edge(
                e.parent, i,
                np.linalg.inv(a.submaps[e.parent].anchor) @ e.anchor)
    for j, e in enumerate(b.submaps):
        if e.parent is not None:
            builder.add_edge(
                nA + e.parent, nA + j,
                np.linalg.inv(b.submaps[e.parent].anchor) @ e.anchor)
    for c in constraints:
        builder.add_edge(c.a_idx, nA + c.b_idx, c.T_a_b,
                         info=c.information, is_loop=True)
    graph = builder.build()
    chi2_before = float(pg.chi2(graph))
    out = pg.optimize(graph, cfg.pose_graph)
    chi2_after = float(pg.chi2(dataclasses.replace(graph, poses=out.poses)))
    new_poses = np.asarray(out.poses, np.float64)

    inc_a = {i: new_poses[i] @ np.linalg.inv(a.submaps[i].anchor)
             for i in range(nA)}
    # B increments fold in T_ab: new pose is in A's frame, old anchor in B's.
    inc_b = {j: new_poses[nA + j] @ np.linalg.inv(b.submaps[j].anchor)
             for j in range(nB)}
    a.apply_pose_updates(inc_a)
    b.apply_pose_updates(inc_b)
    # Distill the registration-grade session transform from the solved
    # anchors: each B submap implies T_ab_j = new_pose_j @ inv(anchor_j);
    # average them on the SE(3) manifold about the first. A's own (soft
    # gauge) drift in the solve is removed the same way so the transform
    # is expressed w.r.t. A's ORIGINAL frame.
    def _se3_mean(Ts):
        T0 = Ts[0]
        deltas = jnp.asarray(
            np.stack([np.linalg.inv(T0) @ T for T in Ts]), jnp.float32
        )
        mean_tw = np.asarray(jax.vmap(se3.log_se3)(deltas)).mean(axis=0)
        return T0 @ np.asarray(
            se3.exp_se3(jnp.asarray(mean_tw, jnp.float32)), np.float64
        )

    Ts_j = np.stack([
        new_poses[nA + j] @ np.linalg.inv(anchors_b_orig[j]) for j in range(nB)
    ])
    T_gauge_a = _se3_mean(np.stack([inc_a[i] for i in range(nA)]))
    T_ab_opt = np.linalg.inv(T_gauge_a) @ _se3_mean(Ts_j)
    phase_s["graph"] = round(_time.perf_counter() - t0, 2)
    return MergeResult(
        T_ab=T_ab,
        constraints=constraints,
        poses_a=new_poses[:nA],
        poses_b=new_poses[nA:nA + nB],
        chi2_before=chi2_before,
        chi2_after=chi2_after,
        T_ab_optimized=T_ab_opt,
        phase_s=phase_s,
    )
