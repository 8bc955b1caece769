"""Loop-closure detection by batched multi-hypothesis registration.

Analogue of the reference ``PlaceRecognition`` (``PlaceRecognition.cpp``):
candidate gating (distance / adjacency / consecutiveness / min gap,
``:231-284``), coarse alignment, ICP refinement, and fitness +
drift-consistency acceptance (``:86-128, :182-229``).

Where the reference runs CPU RANSAC on FPFH features for the coarse
alignment, this design *vmaps the refinement over a seed grid*: K yaw
hypotheses (optionally augmented with translation perturbations) refined in
one batched ICP call — the "4096-hypothesis relocalization" configuration is
exactly this with a denser grid. The best hypothesis by weighted residual is
accepted through the same fitness gates as the reference.
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


@dataclasses.dataclass(frozen=True)
class PlaceRecognitionConfig:
    """≙ ``PlaceRecognitionParameters`` — same gating knobs."""

    max_candidate_distance: float = 40.0  # anchor distance gate
    min_submaps_between_candidates: int = 2  # consecutiveness gate
    # BFS hop gate: reject candidates with adjacency distance < this. The
    # reference rejects only DIRECT neighbours of the finished submap
    # (``isAdjacent(i, lastFinished)``, ``PlaceRecognition.cpp:250``), i.e.
    # hop distance 1 — value 2 here. Round 4 shipped 3, which also rejected
    # 2-hop candidates and silently killed the canonical revisit closure
    # (return to the start room creates a submap whose parent chains to the
    # original one in 2 hops).
    min_adjacency_distance: int = 2
    # Verify at most the K NEAREST gated candidates per finished submap
    # (None = all). In dense submap layouts (small creation radius) the
    # distance gate alone admits O(submaps) candidates and the verify
    # stage — FPFH + RANSAC + ICP per candidate, on the same chip as
    # mapping — throttles the realtime stream; the reference's gating
    # (PlaceRecognition.cpp:231-284) exists for exactly this flood.
    max_candidates: Optional[int] = 4
    # Coarse alignment: FPFH + device RANSAC (≙ the reference's
    # RegistrationRANSACBasedOnFeatureMatching) seeded into ICP; falls back
    # to the yaw/translation hypothesis grid when features fail.
    use_fpfh_ransac: bool = True
    fpfh_knn: int = 16
    # Lowe distinctiveness ratio on feature matches (None = off): required
    # in planar-dominated scenes where ground features mutual-match at
    # random and swamp the RANSAC samples.
    fpfh_ratio: Optional[float] = None
    ransac_hypotheses: int = 1024
    ransac_inlier_dist: float = 0.5
    ransac_min_inliers: int = 15
    num_yaw_hypotheses: int = 16
    num_xy_offsets: int = 1  # 1 => center only; 5 => center + 4 offsets
    xy_offset: float = 5.0
    min_overlap: float = 0.35  # ≙ minRefinementFitness
    max_residual: float = 0.3
    max_drift_trans: float = 10.0  # consistency vs current drift estimate
    max_drift_rot: float = 0.6
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


@dataclasses.dataclass
class LoopClosureConstraint:
    source_idx: int
    target_idx: int
    T_target_source: np.ndarray  # relative pose between submap anchors
    overlap: float
    residual: float
    information: np.ndarray  # [6, 6]


def candidate_pairs(
    collection,
    query_idx: int,
    cfg: PlaceRecognitionConfig,
) -> List[int]:
    """Gated loop-closure candidates for a finished submap
    (≙ ``getLoopClosureCandidatesIdxs``, ``PlaceRecognition.cpp:231-284``)."""
    out = []
    q = collection.submaps[query_idx]
    for i, e in enumerate(collection.submaps):
        if i == query_idx or not e.finished:
            continue
        if abs(i - query_idx) < cfg.min_submaps_between_candidates:
            continue
        if collection.adjacency.distance(i, query_idx) < cfg.min_adjacency_distance:
            continue
        d = np.linalg.norm(e.anchor[:3, 3] - q.anchor[:3, 3])
        if d > cfg.max_candidate_distance:
            continue
        out.append((d, i))
    out.sort()
    if cfg.max_candidates is not None:
        out = out[: cfg.max_candidates]
    return [i for _, i in out]


def _seed_grid(T_anchor_rel: np.ndarray, cfg: PlaceRecognitionConfig) -> np.ndarray:
    """Yaw x translation hypothesis grid around the anchor-relative pose."""
    seeds = []
    yaws = np.linspace(0, 2 * np.pi, cfg.num_yaw_hypotheses, endpoint=False)
    offsets = [(0.0, 0.0)]
    if cfg.num_xy_offsets > 1:
        r = cfg.xy_offset
        offsets += [(r, 0.0), (-r, 0.0), (0.0, r), (0.0, -r)][: cfg.num_xy_offsets - 1]
    for yaw in yaws:
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        for ox, oy in offsets:
            T = np.asarray(T_anchor_rel, np.float64).copy()
            T[:3, :3] = R @ T[:3, :3]
            T[0, 3] += ox
            T[1, 3] += oy
            seeds.append(T)
    return np.stack(seeds).astype(np.float32)


def fpfh_coarse_align(
    source: pc.PointBatch,
    target: pc.PointBatch,
    cfg: PlaceRecognitionConfig,
    seed: int = 0,
) -> Optional[np.ndarray]:
    """FPFH features + mutual matching + device RANSAC -> coarse T or None.

    Both clouds must carry normals. The whole path runs on device
    (≙ ``PlaceRecognition.cpp:81-85`` via Open3D on CPU)."""
    import jax as _jax

    from open3d_slam_jax.models import ransac as ransac_mod
    from open3d_slam_jax.ops import fpfh as fpfh_mod
    from open3d_slam_jax.ops import grid_hash

    radius = 2.0 * cfg.icp.max_match_dist
    g_s = grid_hash.build_grid(
        source.padded_xyz(), source.mask, radius, 1 << 14, 32, normals=source.normals
    )
    g_t = grid_hash.build_grid(
        target.padded_xyz(), target.mask, radius, 1 << 14, 32, normals=target.normals
    )
    f_s = fpfh_mod.compute_fpfh(source, g_s, knn=cfg.fpfh_knn)
    f_t = fpfh_mod.compute_fpfh(target, g_t, knn=cfg.fpfh_knn)
    ids, ok = fpfh_mod.mutual_matches(
        f_s, source.mask, f_t, target.mask, ratio=cfg.fpfh_ratio
    )
    if int(jnp.sum(ok)) < cfg.ransac_min_inliers:
        return None
    tgt_pts = target.xyz[jnp.maximum(ids, 0)]
    res = ransac_mod.ransac_align(
        source.xyz, tgt_pts, ok, _jax.random.key(seed),
        ransac_mod.RansacConfig(
            num_hypotheses=cfg.ransac_hypotheses,
            inlier_dist=cfg.ransac_inlier_dist,
            min_inliers=cfg.ransac_min_inliers,
        ),
    )
    if not bool(res.ok):
        return None
    return np.asarray(res.transform, np.float64)


def verify_candidate(
    source_cloud: pc.PointBatch,
    target_cloud: pc.PointBatch,
    T_init: np.ndarray,
    cfg: PlaceRecognitionConfig,
) -> Optional[tuple]:
    """Refine source->target; coarse alignment from FPFH-RANSAC when it
    succeeds, else the seed grid around T_init. Returns (T, overlap,
    residual) of the best accepted hypothesis or None."""
    source_cloud = normals_mod.estimate_normals(
        source_cloud, knn=8, max_dist=2.0 * cfg.icp.max_match_dist
    )
    target = normals_mod.estimate_normals(
        target_cloud, knn=8, max_dist=2.0 * cfg.icp.max_match_dist
    )
    seeds_list = [np.asarray(_seed_grid(T_init, cfg))]
    if cfg.use_fpfh_ransac:
        T_coarse = fpfh_coarse_align(source_cloud, target, cfg)
        if T_coarse is not None:
            # The RANSAC pose replaces the blind grid as the lead seed.
            seeds_list.insert(0, T_coarse[None].astype(np.float32))
    seeds = jnp.asarray(np.concatenate(seeds_list, axis=0))
    res = icp_mod.register_hypotheses(source_cloud, target, seeds, cfg.icp)
    overlap = np.asarray(res.overlap_ratio)
    residual = np.asarray(res.residual)
    score = np.where(overlap >= cfg.min_overlap, residual, np.inf)
    best = int(np.argmin(score))
    if not np.isfinite(score[best]) or residual[best] > cfg.max_residual:
        return None
    T = np.asarray(res.transform)[best].astype(np.float64)
    return T, float(overlap[best]), float(residual[best])


def information_from_quality(overlap: float, residual: float) -> np.ndarray:
    """Information matrix from registration quality (the reference uses
    Open3D's ``GetInformationMatrixFromPointClouds``; this closed form gives
    the same qualitative scaling: tighter residual + higher overlap =>
    stronger constraint)."""
    strength = overlap / max(residual, 1e-3)
    return np.eye(6) * float(np.clip(strength, 1e-2, 1e4))


def build_loop_closure_constraints(
    collection,
    query_idx: int,
    drift_estimate: Optional[np.ndarray] = None,
    cfg: Optional[PlaceRecognitionConfig] = None,
    scan_capacity: int = 16384,
) -> List[LoopClosureConstraint]:
    """Full candidate -> verify -> accept pipeline for one finished submap
    (≙ ``PlaceRecognition::buildLoopClosureConstraints``)."""
    cfg = cfg or PlaceRecognitionConfig()
    out: List[LoopClosureConstraint] = []
    q = collection.submaps[query_idx]
    src_cloud = pc.compact(q.state.cloud, scan_capacity)
    for tgt_idx in candidate_pairs(collection, query_idx, cfg):
        t = collection.submaps[tgt_idx]
        T_rel = np.linalg.inv(t.anchor) @ q.anchor
        # Express the source submap in its own anchor frame for matching.
        src_local = src_cloud.transformed(
            jnp.asarray(np.linalg.inv(q.anchor), jnp.float32)
        )
        tgt_local = pc.compact(t.state.cloud, scan_capacity).transformed(
            jnp.asarray(np.linalg.inv(t.anchor), jnp.float32)
        )
        got = verify_candidate(src_local, tgt_local, T_rel, cfg)
        if got is None:
            continue
        T, overlap, residual = got
        # Drift-consistency: the implied correction must stay bounded
        # (≙ PlaceRecognition.cpp:182-229). ALWAYS enforced (round 5):
        # the reference always runs this check, and without it symmetric
        # geometry produces confidently-registered 90/180-degree-flipped
        # constraints (two parallel corridor walls + ground register
        # cleanly under a half-turn) that wreck the pose graph.
        corr = T @ np.linalg.inv(T_rel)
        dt = np.linalg.norm(corr[:3, 3])
        dr = np.arccos(np.clip((np.trace(corr[:3, :3]) - 1) / 2, -1, 1))
        if dt > cfg.max_drift_trans or dr > cfg.max_drift_rot:
            continue
        out.append(
            LoopClosureConstraint(
                source_idx=query_idx,
                target_idx=tgt_idx,
                T_target_source=T,
                overlap=overlap,
                residual=residual,
                information=information_from_quality(overlap, residual),
            )
        )
    return out
