"""The batched, degeneracy-aware ICP engine.

Fixed-shape JAX re-design of libpointmatcher's ICP chain (``ICP.cpp:902-1349``): one
jitted iteration = match -> outlier weights -> fused 6x6 linearization ->
(optionally constrained) solve -> compose, inside a ``lax.while_loop`` with
per-problem convergence masks. ``vmap`` the whole engine over a leading batch
axis for thousands of concurrent registrations (hypotheses, submap pairs,
sessions).

Chain correspondence with the reference:
- matcher: grid-hash or brute-force KNN (k, maxDist) ≙ KDTreeMatcher
- outlier: trimmed-ratio quantile, surface-normal gate, robust M-weights
  ≙ Trimmed/SurfaceNormal/Robust OutlierFilters, composed by product
- minimizer: point-to-plane normal equations (+ 4-DoF mode) or
  point-to-point Kabsch ≙ PointToPlane/PointToPoint ErrorMinimizers
- degeneracy: none / solution remapping / X-ICP equality constraints
- checkers: Counter (max iterations) + Differential (smoothed deltas)
  ≙ TransformationCheckers
- mean-centering of the reference frame ≙ ``T_refIn_refMean``
  (``ICP.cpp:881-891``) for float32 conditioning.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import localizability as xicp
from open3d_slam_jax.models import minimizers
from open3d_slam_jax.ops import cell_list as cell_mod
from open3d_slam_jax.ops import grid_hash as grid_mod
from open3d_slam_jax.ops import knn as knn_mod
from open3d_slam_jax.ops import outliers
from open3d_slam_jax.ops.pointcloud import PointBatch, masked_centroid


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Static chain configuration (the icp.yaml vocabulary, typed)."""

    # Matcher (≙ param/icp.yaml matcher block: knn, maxDist, epsilon).
    knn: int = 1
    max_match_dist: float = jnp.inf
    # "grid": cell-list spatial hash — expensive 27x-expanded build, one
    #   row-gather per query (production scan-to-map: build once per submap,
    #   query millions of times);
    # "hash": per-cell bucket hash — cheap build (one argsort + one scatter
    #   over M rows), 8 row-gathers per query (scan-to-scan odometry: the
    #   reference is rebuilt EVERY scan and queried only ~refresh-count
    #   times, so build cost dominates);
    # "brute": XLA O(N*M) KNN (no spatial structure to hash).
    matcher: str = "grid"
    grid_table_size: int = 1 << 15
    # Per-cell candidate list capacity: size for the density of the map
    # (points within match radius of a cell; ~40 for a 0.15 m-voxel map at
    # 0.5 m radius).
    grid_bucket_cap: int = 48
    # KDTreeVarDistMatcher (MatchersImpl.h:105-135): name of a reading
    # extras channel holding per-point search radii, clipped to
    # max_match_dist (which stays the grid build radius / upper bound).
    # ≙ the yaml's maxDistField descriptor name. Grid matcher only.
    max_dist_field: Optional[str] = None
    # readingStepDataPointsFilters, sampling case (ICP.cpp:1038): keep each
    # reading point with this probability, re-drawn every iteration. The
    # reference filters before matching; here the drop is applied as a
    # zero weight after matching (identical estimator, fixed shapes).
    reading_step_random_prob: Optional[float] = None
    # General readingStepDataPointsFilters chain (ICP.cpp:1038): any
    # mask-safe (point-selecting) filter chain re-applied to the CURRENT
    # TRANSFORMED reading every iteration, composed as per-point weight
    # masks (the fixed-shape analogue of the reference's per-iteration
    # ``stepReading`` rewrite — identical estimator). Hashable static form:
    # a tuple of (name, ((param, value), ...)) entries; names:
    # "RandomSampling" {prob}, "MaxDist"/"MinDist" {dim, dist}
    # (dim -1 = euclidean norm, 0/1/2 = coordinate), "DistanceLimit"
    # {dim, dist, removeInside}, "BoundingBox" {xMin..zMax, removeInside},
    # "MaxPointCount" {maxCount} (probabilistic thinning to the target
    # count). Coordinates are in the mean-centered reference frame, exactly
    # where the reference applies the chain (stepReading lives in
    # T_refIn_refMean coordinates, ICP.cpp:1023-1038).
    reading_step_filters: Optional[tuple] = None
    # 16-byte packed payloads (cell-frame u16 positions + octahedral
    # normals): halves matcher/cache traffic at ~25 um / 1e-4 rad
    # quantization. Exact 32-byte payloads when False.
    packed_payload: bool = False

    # Outlier filters (≙ outlierFilters block).
    trimmed_ratio: Optional[float] = None  # TrimmedDistOutlierFilter ratio
    # Histogram-based trimming threshold (O(N), resolution maxDist^2/256)
    # instead of the exact nth-element sort — the jitted-loop fast path.
    fast_trimming: bool = False
    # VarTrimmedDistOutlierFilter: auto-tuned trim ratio in [min, max].
    var_trimmed: Optional[tuple] = None  # (min_ratio, max_ratio)
    median_factor: Optional[float] = None  # MedianDistOutlierFilter factor
    normal_angle_max: Optional[float] = None  # SurfaceNormalOutlierFilter (rad)
    robust: Optional[str] = None  # cauchy|huber|gm|tukey|welsch|sc|l1|student
    robust_scale: float = 1.0  # tuning constant (metres); MAD if <= 0
    # MaxDist/MinDistOutlierFilter: hard residual-distance gates (metres).
    max_residual_dist: Optional[float] = None
    min_residual_dist: Optional[float] = None
    # GenericDescriptorOutlierFilter: weight pairs by a 1-D REFERENCE
    # descriptor (an extras channel) gathered at the matched id —
    # (descName, useSoftThreshold, useLargerThan, threshold). The reference
    # uses filteredReference for source="reading" too
    # (OutlierFiltersImpl.cpp:323-328 assigns &filteredReference on both
    # branches), so only the reference source exists here.
    generic_descriptor: Optional[tuple] = None

    # Minimizer (≙ errorMinimizer block; "gicp" ≙ the CloudRegistration
    # facade's GeneralizedIcp default, CloudRegistration.cpp:16-100;
    # "identity" ≙ IdentityErrorMinimizer — no update, diagnostics only).
    minimizer: str = "point_to_plane"  # point_to_plane | point_to_point | similarity | gicp | identity
    gicp_epsilon: float = 1e-3  # disk-covariance small eigenvalue
    force_4dof: bool = False
    force_2d: bool = False

    # Degeneracy awareness (≙ degeneracyAwareness options).
    degeneracy: xicp.DegeneracyConfig = dataclasses.field(
        default_factory=xicp.DegeneracyConfig
    )

    # Checkers (≙ transformationCheckers: Counter + Differential).
    max_iterations: int = 30
    min_diff_rot: float = 1e-3  # rad, smoothed
    min_diff_trans: float = 1e-3  # m, smoothed
    smooth_length: int = 3
    # BoundTransformationChecker: abort (freeze + flag) when the accumulated
    # correction leaves these bounds; inf disables.
    max_rotation_norm: float = jnp.inf  # rad from the initial guess
    max_translation_norm: float = jnp.inf  # m from the initial guess

    # Coarse-to-fine schedule (a throughput lever with no reference
    # analogue — the reference pays full resolution every iteration): run up
    # to ``coarse_iterations`` first on every ``coarse_stride``-th reading
    # point (a static strided slice => 1/stride matching cost), then polish
    # at full resolution under the normal checkers. 0 disables.
    coarse_iterations: int = 0
    coarse_stride: int = 8

    # Candidate caching (grid matcher only): gather each query's 2x2x2
    # bucket payloads once per ``candidate_refresh_every`` iterations and
    # re-rank the cache in between (pure streaming math, no gathers).
    # ``candidate_slack`` widens the grid cell (cell = 2 * (radius + slack))
    # so cached candidates stay exact while the pose moves < slack metres
    # within a round. 0 disables (re-match every iteration, reference-exact).
    candidate_refresh_every: int = 0
    candidate_slack: float = 0.25

    # Anderson acceleration AA(1) on the SE(3) chart (opt-in; AA-ICP,
    # arxiv 1709.05479 / Fast-and-Robust ICP, arxiv 2007.07627): the GN/ICP
    # update is a fixed-point map; mixing the current and previous mapped
    # iterates with the secant-optimal coefficient extrapolates convergence.
    # For a contraction with ratio rho the secant-optimal theta is
    # ~ -1/(1-rho), so the safeguard clamps theta to [-anderson_max, 0]
    # (extrapolation only) and caps the accelerated correction at
    # 10x the plain step norm; non-finite -> plain step. Most useful for
    # vanilla high-iteration chains; the coarse-to-fine cached schedule
    # already converges in ~7 iterations.
    anderson: bool = False
    anderson_max: float = 25.0

    # Fused pair-GN kernel for the cached rounds (Pallas through Triton,
    # kernels/pair_gn_pallas.py; on in the mapper, odometry and bench
    # chains): one streaming kernel per iteration computes distances,
    # frozen-threshold trimming and the full 6x6 normal equations without
    # writing any per-pair intermediate. Applies only to the plain
    # point-to-plane chain (no robust weights / normal gate / sharding);
    # other configs use the XLA path with a warning.
    fused_kernel: bool = False

    # Moment-cached GN rounds (GICP): with pairs, weights and the per-pair
    # GICP precisions M frozen per refresh round, A(T) and b(T) are exact
    # contractions of round-start second-order moment tensors with (R, t) —
    # the in-round iteration costs O(1) instead of O(pairs). One extra
    # streaming pass per round (the moment build) buys ~free iterations.
    # Falls back to the direct path for residual-dependent weights
    # (robust / var-trimmed / median) whose per-iteration re-evaluation
    # cannot be frozen.
    moment_cached: bool = True
    # Staleness threshold for moment rounds, as a multiple of the
    # differential-checker tolerances: a round that converged after moving
    # more than ``scale * (min_diff_rot, min_diff_trans)`` re-verifies on
    # fresh weights (one more refresh round). 1.0 = re-verify until the
    # optimum is stationary at checker precision (most accurate); larger
    # values trade accuracy for fewer refreshes; inf = never re-verify.
    moment_revisit_scale: float = 1.0

    # Multi-device: when set, the reading's point axis is sharded over this
    # mesh axis (inside shard_map); partial 6x6 blocks are psum-reduced and
    # trimming quantiles computed on all-gathered distances. The TP/SP
    # analogue for this workload (SURVEY 2.6): communication is 42 floats
    # per problem per iteration.
    shard_axis: Optional[str] = None


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPResult:
    """Per-problem outputs (the observables the reference exposes on
    ``ICPChainBase``: iterations, overlap, eigenvalues, degeneracy)."""

    transform: jax.Array  # [4, 4] reading -> reference
    iterations: jax.Array  # int32
    converged: jax.Array  # bool (differential checker fired)
    match_ratio: jax.Array  # matched / valid reading points (last iter)
    overlap_ratio: jax.Array  # weighted points used ratio (last iter)
    residual: jax.Array  # weighted RMS point-to-plane residual (last iter)
    eigenvalues: jax.Array  # [6] hessian eigenvalues (ascending, last iter)
    condition_number: jax.Array
    localizability_rot: jax.Array  # [3] 1 = localizable
    localizability_trans: jax.Array  # [3]
    degenerate: jax.Array  # bool, any direction constrained/suppressed
    aborted: jax.Array  # bool, BoundTransformationChecker fired
    # 6x6 covariance of the estimate (Censi-style sensor-noise model reduced
    # to sigma^2 (J^T J)^-1 — the WithCov minimizers' output).
    covariance: jax.Array  # [6, 6]
    # Matcher quality counter (≙ KDTreeMatcher visit/recall monitoring,
    # MatchersImpl.cpp): fraction of valid queries whose candidate row was
    # FULL at the last refresh — the queries whose nearest neighbour could
    # have been displaced by cell-list capacity pressure. 0 in non-cached /
    # non-grid chains. Pair with ``CellList.dropped`` (build-time overflow)
    # for production dense-map recall monitoring.
    match_row_saturation: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPReference:
    """Preprocessed reference side: centered cloud + optional grid hash.

    Build once per reference map (≙ ``ICPSequence::initReference`` /
    ``icp_.initReference`` at ``Mapper.cpp:343`` — the KD-tree build step),
    reuse across many readings / iterations.
    """

    cloud: PointBatch  # centered at centroid
    centroid: jax.Array  # [3]
    grid: object  # CellList ("grid"), GridHash ("hash"), or None


def build_reference(
    reference: PointBatch, cfg: ICPConfig, centroid: Optional[jax.Array] = None
) -> ICPReference:
    """Center the reference at its centroid and (for the grid matcher)
    build the spatial hash. jit/vmap-safe.

    ``centroid`` overrides the computed centroid — required when the
    reference is a spatial TILE of a larger map (tile-sharded mode): every
    shard must center with the same global value or the per-shard transforms
    would live in different frames."""
    c = masked_centroid(reference) if centroid is None else centroid
    centered = dataclasses.replace(
        reference,
        xyz=jnp.where(reference.mask[..., None], reference.xyz - c, reference.xyz),
    )
    grid = None
    if cfg.matcher in ("grid", "hash"):
        import math

        if not math.isfinite(cfg.max_match_dist):
            raise ValueError(
                f"{cfg.matcher} matcher requires a finite max_match_dist "
                "(cell size is 2 * max_match_dist); use matcher='brute' for "
                "unbounded search"
            )
    if cfg.matcher == "grid":
        slack = cfg.candidate_slack if cfg.candidate_refresh_every > 0 else 0.0
        build = (
            cell_mod.build_cell_list_packed
            if cfg.packed_payload
            else cell_mod.build_cell_list
        )
        grid = build(
            centered.padded_xyz(),
            centered.mask,
            cfg.max_match_dist + slack,
            table_size=cfg.grid_table_size,
            list_cap=cfg.grid_bucket_cap,
            normals=centered.normals,  # inlined payload: match => no gathers
        )
    elif cfg.matcher == "hash":
        if cfg.packed_payload:
            raise ValueError("packed_payload is cell-list only (matcher='grid')")
        slack = cfg.candidate_slack if cfg.candidate_refresh_every > 0 else 0.0
        grid = grid_mod.build_grid(
            centered.padded_xyz(),
            centered.mask,
            2.0 * (cfg.max_match_dist + slack),
            table_size=cfg.grid_table_size,
            bucket_cap=cfg.grid_bucket_cap,
            normals=centered.normals,
        )
    return ICPReference(cloud=centered, centroid=c, grid=grid)


def _match(
    src_xyz, src_mask, ref: ICPReference, cfg: ICPConfig, max_dist=None
) -> grid_mod.MatchResult:
    """Correspondences with inlined matched payloads (xyz + normals).

    ``max_dist``: optional per-query ``[N]`` radii (KDTreeVarDistMatcher);
    scalar ``cfg.max_match_dist`` otherwise.
    """
    if max_dist is None:
        max_dist = cfg.max_match_dist
    if cfg.matcher == "grid":
        if cfg.packed_payload:
            return cell_mod.cell_match_packed(
                ref.grid, src_xyz, src_mask, k=cfg.knn, max_dist=max_dist
            )
        return cell_mod.cell_match(
            ref.grid, src_xyz, src_mask, k=cfg.knn, max_dist=max_dist
        )
    if cfg.matcher == "hash":
        return grid_mod.grid_match(
            ref.grid, src_xyz, src_mask, k=cfg.knn, max_dist=max_dist
        )
    res = knn_mod.knn_bruteforce(
        src_xyz, src_mask, ref.cloud.padded_xyz(), ref.cloud.mask,
        k=cfg.knn, max_dist=cfg.max_match_dist,
    )
    ids_safe = jnp.maximum(res.ids, 0)
    q = ref.cloud.xyz[ids_safe]
    mn = (
        ref.cloud.normals[ids_safe]
        if ref.cloud.normals is not None
        else jnp.zeros_like(q)
    )
    return grid_mod.MatchResult(dists=res.dists, ids=res.ids, xyz=q, normals=mn)


def _weights(
    res, reading, matched_normals_flat, cfg: ICPConfig, trim_limit=None,
    ref_desc=None,
):
    """Composed outlier weights [N * k].

    ``trim_limit``: optional precomputed TrimmedDist threshold — the
    pair-cached rounds freeze it at selection time so in-round iterations
    skip the histogram/quantile entirely.
    ``ref_desc``: full reference descriptor values [Nref] for
    GenericDescriptorOutlierFilter (gathered here by matched id)."""
    valid = res.valid()
    w = valid.astype(jnp.float32)
    if cfg.max_residual_dist is not None:
        w = w * outliers.max_dist_weight(res.dists, valid, cfg.max_residual_dist)
    if cfg.min_residual_dist is not None:
        w = w * outliers.min_dist_weight(res.dists, valid, cfg.min_residual_dist)
    if cfg.generic_descriptor is not None:
        if ref_desc is None:
            raise ValueError(
                "generic_descriptor requires the reference descriptor values"
            )
        _, soft, larger, thr = cfg.generic_descriptor
        dm = ref_desc[jnp.maximum(res.ids, 0)]
        w = w * outliers.generic_descriptor_weight(dm, valid, soft, larger, thr)
    if cfg.trimmed_ratio is not None and trim_limit is not None:
        w = w * ((res.dists <= trim_limit) & valid).astype(jnp.float32)
    elif cfg.trimmed_ratio is not None:
        if cfg.shard_axis is not None:
            # Global trimming quantile across all shards of the point axis.
            from open3d_slam_jax.ops.pointcloud import masked_quantile

            d_all = jax.lax.all_gather(res.dists, cfg.shard_axis, tiled=True)
            v_all = jax.lax.all_gather(valid, cfg.shard_axis, tiled=True)
            limit = masked_quantile(d_all.reshape(-1), v_all.reshape(-1), cfg.trimmed_ratio)
            w = w * ((res.dists <= limit) & valid).astype(jnp.float32)
        elif cfg.fast_trimming:
            w = w * outliers.trimmed_dist_histogram(
                res.dists, valid, cfg.trimmed_ratio, cfg.max_match_dist**2
            )
        else:
            w = w * outliers.trimmed_dist(res.dists, valid, cfg.trimmed_ratio)
    if cfg.var_trimmed is not None:
        w = w * outliers.var_trimmed_dist(
            res.dists, valid, cfg.var_trimmed[0], cfg.var_trimmed[1]
        )
    if cfg.median_factor is not None:
        w = w * outliers.median_dist(res.dists, valid, cfg.median_factor)
    if cfg.robust is not None:
        if cfg.robust_scale > 0:
            k2 = cfg.robust_scale**2
        else:
            k2 = jnp.maximum(outliers.mad_scale(res.dists, valid) ** 2, 1e-12)
        w = w * outliers.robust_weight(cfg.robust, res.dists, k2)
    w = w.reshape(-1)
    if cfg.normal_angle_max is not None and reading.normals is not None:
        rn = jnp.repeat(reading.normals, valid.shape[1], axis=0)
        w = w * outliers.surface_normal_gate(
            rn, matched_normals_flat, valid.reshape(-1), cfg.normal_angle_max
        )
    return w


def _solve(
    A, b, src_flat, mn_flat, ddn, pair_mask, cfg: ICPConfig,
    frozen_loc=None, prev_loc=None, step_it=None,
):
    method = cfg.degeneracy.method
    if method == "solution_remapping":
        x, loc = xicp.solve_with_solution_remapping(A, b, cfg.degeneracy)
    elif method in ("equality_constraints", "optimized"):
        if frozen_loc is not None:
            # Round-frozen analysis (DegeneracyConfig.analysis_per_round, or
            # the Optimized method's first-iteration-only contract): reuse
            # the constrained-direction decision; only the KKT solve runs on
            # this iteration's A, b.
            loc = frozen_loc
        elif method == "optimized":
            # kOptimizedEqualityConstraints detects on the FIRST iteration
            # only (ICP.cpp:2220-2226); later iterations reuse the decision.
            def _fresh():
                return xicp.analyze_optimized(
                    A, b, src_flat, mn_flat, pair_mask, cfg.degeneracy,
                    axis_name=cfg.shard_axis, with_spectrum=False,
                )

            if prev_loc is None or step_it is None:
                loc = _fresh()
            else:
                loc = jax.lax.cond(step_it == 0, _fresh, lambda: prev_loc)
        else:
            # Ternary-level detection re-analyzes every iteration
            # (ICP.cpp:1702 forces re-analysis).
            loc = xicp.analyze_equality_constraints(
                A, b, src_flat, mn_flat, ddn, pair_mask, cfg.degeneracy,
                axis_name=cfg.shard_axis, with_spectrum=False,
            )
        x = xicp.solve_with_equality_constraints(A, b, loc)
    else:
        # Fast path: damped LU; spectral diagnostics are computed once from
        # the final hessian after the loop (carried in the state), not per
        # iteration (a 6x6 eigh lowers to a sequential loop).
        x = minimizers.solve_normal_equations_fast(A, b)
        loc = xicp._identity_result(A.dtype)
    return x, loc


def _reading_step_mask(src, mask, step_it, filters) -> jax.Array:
    """Per-iteration reading-step filter chain as a [N] keep mask.

    ``src`` is the CURRENT transformed reading (centered reference frame),
    matching where the reference applies readingStepDataPointsFilters
    (ICP.cpp:1038). Each filter is (name, ((param, value), ...)).
    """
    keep = mask
    for idx, (name, params) in enumerate(filters):
        p = dict(params)
        if name == "RandomSampling":
            key = jax.random.fold_in(jax.random.PRNGKey(17 + 31 * idx), step_it)
            keep = keep & (
                jax.random.uniform(key, (src.shape[0],)) < float(p["prob"])
            )
        elif name in ("MaxDist", "MinDist", "DistanceLimit"):
            # Reference semantics (MaxDist.cpp:77-99): dim -1 compares the
            # euclidean norm against |dist|; a single axis compares the
            # SIGNED coordinate against dist (strict inequalities).
            dim = int(p.get("dim", -1))
            dist = float(p.get("dist", p.get("maxDist", p.get("minDist", jnp.inf))))
            if dim < 0:
                d = jnp.linalg.norm(src, axis=-1)
                lim = abs(dist)
            else:
                d = src[:, dim]
                lim = dist
            if name == "MaxDist":
                inside = d < lim
            elif name == "MinDist":
                inside = d > lim
            else:  # DistanceLimit: removeInside=1 keeps d >= dist
                inside = d < lim
                if bool(int(p.get("removeInside", 1))):
                    inside = ~inside
            keep = keep & inside
        elif name == "BoundingBox":
            lo = jnp.asarray(
                [float(p.get("xMin", -jnp.inf)), float(p.get("yMin", -jnp.inf)),
                 float(p.get("zMin", -jnp.inf))], src.dtype)
            hi = jnp.asarray(
                [float(p.get("xMax", jnp.inf)), float(p.get("yMax", jnp.inf)),
                 float(p.get("zMax", jnp.inf))], src.dtype)
            inside = jnp.all((src >= lo) & (src <= hi), axis=-1)
            keep = keep & (~inside if bool(int(p.get("removeInside", 1))) else inside)
        elif name == "MaxPointCount":
            # Probabilistic thinning to the target count (the reference
            # shuffles and truncates; a fixed-shape engine thins by the
            # equivalent keep probability, re-drawn per iteration).
            target = float(p["maxCount"])
            n_now = jnp.maximum(jnp.sum(keep.astype(src.dtype)), 1.0)
            prob = jnp.minimum(target / n_now, 1.0)
            key = jax.random.fold_in(jax.random.PRNGKey(23 + 31 * idx), step_it)
            keep = keep & (jax.random.uniform(key, (src.shape[0],)) < prob)
        elif name == "Identity":
            pass
        else:
            raise ValueError(f"unknown reading-step filter {name!r}")
    return keep


def _strided(batch: PointBatch, stride: int) -> PointBatch:
    """Static strided subsample (smaller capacity => cheaper matching)."""
    return PointBatch(
        xyz=batch.xyz[::stride],
        mask=batch.mask[::stride],
        extras={k: v[::stride] for k, v in batch.extras.items()},
    )


def _run_gn_loop(reading, ref, T0, cfg: ICPConfig, max_iterations: int):
    """The matched/weighted/linearized GN loop on one fixed reading shape."""
    dtype = reading.xyz.dtype
    S = cfg.smooth_length

    def _allsum(v):
        return jax.lax.psum(v, cfg.shard_axis) if cfg.shard_axis is not None else v

    n_valid = jnp.maximum(_allsum(reading.count().astype(dtype)), 1.0)

    # GenericDescriptorOutlierFilter: the 1-D reference descriptor column,
    # resolved once per reference (matched values are gathered per pair).
    gd_vals = None
    if cfg.generic_descriptor is not None:
        gd_name = cfg.generic_descriptor[0]
        if gd_name not in ref.cloud.extras:
            raise ValueError(
                f"generic_descriptor: reference has no extras channel "
                f"{gd_name!r} (have {sorted(ref.cloud.extras)})"
            )
        gd_vals = ref.cloud.extras[gd_name][..., 0].astype(dtype)

    # KDTreeVarDistMatcher: per-point search radii from a reading channel.
    var_md = None
    if cfg.max_dist_field is not None:
        if cfg.matcher != "grid" or cfg.packed_payload:
            raise ValueError(
                "max_dist_field (KDTreeVarDistMatcher) requires the unpacked "
                "grid matcher"
            )
        var_md = jnp.minimum(
            reading.extras[cfg.max_dist_field][..., 0].astype(dtype),
            cfg.max_match_dist,
        )

    def gn_update(T, src, res, trim_limit=None, step_it=None, frozen_loc=None, prev_loc=None):
        # Pair axis M: cfg.knn for gathered matches, full candidate capacity
        # for the masked candidate-major layout (extra slots carry w = 0).
        m = res.ids.shape[1]
        A_out = jnp.zeros((6, 6), src.dtype)
        q = res.xyz.reshape(-1, 3)
        mn = res.normals.reshape(-1, 3)
        w = _weights(res, reading, mn, cfg, trim_limit=trim_limit, ref_desc=gd_vals)
        if cfg.reading_step_random_prob is not None and step_it is not None:
            # Per-iteration reading-step random sampling (ICP.cpp:1038):
            # deterministic key folded with the iteration counter.
            kkey = jax.random.fold_in(jax.random.PRNGKey(17), step_it)
            keep = jax.random.uniform(kkey, (src.shape[0],)) < cfg.reading_step_random_prob
            w = w * jnp.repeat(keep, m).astype(w.dtype)
        if cfg.reading_step_filters is not None and step_it is not None:
            # General per-iteration reading-step chain (ICP.cpp:1038).
            keep = _reading_step_mask(
                src, reading.mask, step_it, cfg.reading_step_filters
            )
            w = w * jnp.repeat(keep, m).astype(w.dtype)
        src_flat = jnp.repeat(src, m, axis=0)
        pair_mask = res.valid().reshape(-1)

        if cfg.minimizer == "identity":
            # IdentityErrorMinimizer: no update; diagnostics only.
            dT = jnp.eye(4, dtype=src.dtype)
            loc = xicp._identity_result(dtype)
            resid = jnp.sqrt(
                _allsum(jnp.sum(w * jnp.sum((src_flat - q) ** 2, -1)))
                / jnp.maximum(_allsum(jnp.sum(w)), 1e-9)
            )
        elif cfg.minimizer == "point_to_point":
            dT = minimizers.point_to_point_transform(src_flat, q, w, axis_name=cfg.shard_axis)
            loc = xicp._identity_result(dtype)
            resid = jnp.sqrt(
                _allsum(jnp.sum(w * jnp.sum((src_flat - q) ** 2, -1)))
                / jnp.maximum(_allsum(jnp.sum(w)), 1e-9)
            )
        elif cfg.minimizer == "similarity":
            # PointToPointSimilarityErrorMinimizer: Umeyama with isotropic
            # scale (``PointToPointSimilarity.cpp``); the scaled rotation
            # composes into T like the reference's similarity chain.
            dT, _scale = minimizers.point_to_point_similarity_transform(
                src_flat, q, w
            )
            loc = xicp._identity_result(dtype)
            resid = jnp.sqrt(
                _allsum(jnp.sum(w * jnp.sum((src_flat - q) ** 2, -1)))
                / jnp.maximum(_allsum(jnp.sum(w)), 1e-9)
            )
        elif cfg.minimizer == "gicp":
            if reading.normals is None:
                raise ValueError("gicp minimizer requires reading normals")
            src_n = se3.apply_rotation(T, reading.normals)
            src_n_flat = jnp.repeat(src_n, cfg.knn, axis=0)
            A, b = minimizers.gicp_normal_equations(
                src_flat, src_n_flat, q, mn, w, epsilon=cfg.gicp_epsilon
            )
            A, b = _allsum(A), _allsum(b)
            A_out = A
            x = minimizers.solve_normal_equations_fast(A, b)
            loc = xicp._identity_result(dtype)
            dT = minimizers.delta_transform_from_x(x)
            rvec = src_flat - q
            resid = jnp.sqrt(
                _allsum(jnp.sum(w * jnp.sum(rvec * rvec, -1)))
                / jnp.maximum(_allsum(jnp.sum(w)), 1e-9)
            )
        else:
            if cfg.force_2d:
                A, b = minimizers.point_to_plane_2d_normal_equations(src_flat, q, mn, w)
                A, b = _allsum(A), _allsum(b)
                x = minimizers.solve_spd_unrolled(A, b)
                loc = xicp._identity_result(dtype)
                dT = minimizers.delta_transform_from_x(x, force_2d=True)
            elif cfg.force_4dof:
                A, b = minimizers.point_to_plane_4dof_normal_equations(src_flat, q, mn, w)
                A, b = _allsum(A), _allsum(b)
                x = minimizers.solve_spd_unrolled(A, b)
                loc = xicp._identity_result(dtype)
                dT = minimizers.delta_transform_from_x(x, force_4dof=True)
            else:
                w2 = w.reshape(res.ids.shape)
                A, b = minimizers.point_to_plane_normal_equations_bc(
                    src, res.xyz, res.normals, w2
                )
                A, b = _allsum(A), _allsum(b)
                A_out = A
                if cfg.degeneracy.method != "none":
                    if frozen_loc is None and cfg.degeneracy.method != "optimized":
                        ddn = jnp.sum((src_flat - q) * mn, axis=-1)
                    else:
                        ddn = None  # unused when the analysis is frozen/binary
                    x, loc = _solve(
                        A, b, src_flat, mn, ddn, pair_mask & (w > 0), cfg,
                        frozen_loc=frozen_loc, prev_loc=prev_loc, step_it=step_it,
                    )
                else:
                    x = minimizers.solve_normal_equations_fast(A, b)
                    loc = xicp._identity_result(dtype)
                dT = minimizers.delta_transform_from_x(x)
            r2 = jnp.sum((src[:, None, :] - res.xyz) * res.normals, axis=-1)
            wr = w.reshape(res.ids.shape)
            resid = jnp.sqrt(
                _allsum(jnp.sum(wr * r2 * r2))
                / jnp.maximum(_allsum(jnp.sum(wr)), 1e-9)
            )

        match_ratio = _allsum(jnp.sum(pair_mask.astype(dtype))) / (n_valid * cfg.knn)
        overlap = _allsum(jnp.sum((w > 0).astype(dtype))) / (n_valid * cfg.knn)
        return dT, loc, match_ratio, overlap, resid, A_out

    def one_iteration(s):
        T, it = s["T"], s["it"]
        src = se3.apply_transform(T, reading.xyz)
        res = _match(src, reading.mask, ref, cfg, max_dist=var_md)
        return gn_update(T, src, res, step_it=it, prev_loc=s["loc"])

    loc0 = xicp._identity_result(dtype)
    state0 = dict(
        T=T0,
        it=jnp.asarray(0, jnp.int32),
        done=jnp.asarray(False),
        drot=jnp.full((S,), 1e9, dtype),
        dtrans=jnp.full((S,), 1e9, dtype),
        loc=loc0,
        match_ratio=jnp.asarray(0.0, dtype),
        overlap=jnp.asarray(0.0, dtype),
        resid=jnp.asarray(0.0, dtype),
        converged=jnp.asarray(False),
        aborted=jnp.asarray(False),
        A=jnp.zeros((6, 6), dtype),
        aa_G=jnp.zeros((6,), dtype),
        aa_f=jnp.zeros((6,), dtype),
        aa_have=jnp.asarray(False),
        # Moment-cached rounds: the NEXT round is a fresh-weight
        # re-verification of a convergence reached on stale weights.
        revisit=jnp.asarray(False),
        # Matcher quality: candidate-row saturation at the last refresh.
        row_sat=jnp.asarray(0.0, dtype),
    )

    def cond(s):
        return (s["it"] < max_iterations) & ~s["done"]

    def advance(s, step_out):
        dT, loc, match_ratio, overlap, resid, A_out = step_out
        T_new = dT @ s["T"]
        if cfg.anderson:
            # AA(1): u_{k+1} = G(u_k) - theta (G(u_k) - G(u_{k-1})),
            # theta = <f_k, f_k - f_{k-1}> / ||f_k - f_{k-1}||^2 with
            # f_k = G(u_k) - u_k, all in the se(3) log chart.
            xi_G = se3.log_se3(T_new)
            f_k = xi_G - se3.log_se3(s["T"])
            df = f_k - s["aa_f"]
            denom = jnp.sum(df * df)
            theta = jnp.where(
                s["aa_have"] & (denom > 1e-14), jnp.sum(f_k * df) / denom, 0.0
            )
            theta = jnp.clip(
                jnp.where(jnp.isfinite(theta), theta, 0.0),
                -cfg.anderson_max, 0.0,
            )
            xi_acc = xi_G - theta * (xi_G - s["aa_G"])
            # Trust guard: cap the accelerated correction at 10x the plain
            # step; runaway extrapolation falls back to the plain step.
            corr = jnp.linalg.norm(xi_acc - xi_G)
            fnorm = jnp.linalg.norm(f_k)
            ok = jnp.isfinite(corr) & (corr <= 10.0 * fnorm + 1e-12)
            xi_acc = jnp.where(ok, xi_acc, xi_G)
            T_new = se3.exp_se3(xi_acc)
            aa_state = dict(aa_G=xi_G, aa_f=f_k, aa_have=jnp.asarray(True))
        else:
            aa_state = dict(
                aa_G=s["aa_G"], aa_f=s["aa_f"], aa_have=s["aa_have"]
            )
        # Differential checker deltas between consecutive transforms.
        dr = se3.rotation_angular_distance(T_new[:3, :3], s["T"][:3, :3])
        dt = jnp.linalg.norm(T_new[:3, 3] - s["T"][:3, 3])
        drot = jnp.roll(s["drot"], 1).at[0].set(dr)
        dtrans = jnp.roll(s["dtrans"], 1).at[0].set(dt)
        mean_rot = jnp.mean(drot)
        mean_trans = jnp.mean(dtrans)
        converged = (mean_rot < cfg.min_diff_rot) & (mean_trans < cfg.min_diff_trans)
        # BoundTransformationChecker: accumulated correction vs T0.
        tot_rot = se3.rotation_angular_distance(T_new[:3, :3], T0[:3, :3])
        tot_trans = jnp.linalg.norm(T_new[:3, 3] - T0[:3, 3])
        aborted = s["aborted"] | (tot_rot > cfg.max_rotation_norm) | (
            tot_trans > cfg.max_translation_norm
        )
        # On abort the reference throws and the caller keeps the prior:
        # freeze at T0 and stop iterating.
        T_new = jnp.where(aborted, T0, T_new)
        return dict(
            T=T_new,
            it=s["it"] + 1,
            done=converged | aborted,
            drot=drot,
            dtrans=dtrans,
            loc=loc,
            match_ratio=match_ratio,
            overlap=overlap,
            resid=resid,
            converged=converged & ~aborted,
            aborted=aborted,
            A=A_out,
            revisit=s["revisit"],
            row_sat=s["row_sat"],
            **aa_state,
        )

    if cfg.candidate_refresh_every > 0 and cfg.matcher in ("grid", "hash"):
        # Candidate-cached mode: gather the 2x2x2 payload superset once per
        # round, then run ``candidate_refresh_every`` elementwise GN iterations
        # against the cache. Exact while the pose moves less than the grid's
        # slack margin per round (cell = 2 * (radius + slack)); fixed-length
        # scans keep it vmap-friendly (no data-dependent gathers).
        R = cfg.candidate_refresh_every
        # Static eligibility for the moment-cached GICP rounds (the trim
        # limit exists iff fast_trimming, which is static). Kept in sync
        # with the per-round ``moment_ok`` below.
        minimizer_moment_ok = (
            cfg.minimizer == "gicp" and reading.normals is not None
        ) or (
            cfg.minimizer == "point_to_plane"
            and not cfg.force_2d
            and not cfg.force_4dof
            # Degeneracy handling composes when its per-iteration input is
            # just (A, b): SolutionRemapping always, the binary Optimized
            # method always (first-iteration-frozen by construction), X-ICP
            # ternary equality constraints when the analysis freezes per
            # round.
            and (
                cfg.degeneracy.method in ("none", "solution_remapping", "optimized")
                or (
                    cfg.degeneracy.method == "equality_constraints"
                    and cfg.degeneracy.analysis_per_round
                )
            )
        )
        moment_eligible = (
            cfg.moment_cached
            and minimizer_moment_ok
            and cfg.shard_axis is None
            and cfg.robust is None
            and cfg.var_trimmed is None
            and cfg.median_factor is None
            and cfg.reading_step_random_prob is None
            and cfg.reading_step_filters is None
            and (cfg.trimmed_ratio is None or cfg.fast_trimming)
        )
        # Moment rounds re-freeze weights at each refresh: convergence on
        # stale weights forces one more (>=1 iteration) round, so the round
        # count must not bind before the iteration budget does.
        rounds = max_iterations if moment_eligible else -(-max_iterations // R)

        def masked(s, step_out):
            new = advance(s, step_out)
            active = ~s["done"] & (s["it"] < max_iterations)
            return jax.tree.map(lambda old, nw: jnp.where(active, nw, old), s, new)

        max_d2 = (
            var_md[:, None] ** 2 if var_md is not None else cfg.max_match_dist**2
        )

        def round_body(s):
            src0 = se3.apply_transform(s["T"], reading.xyz)
            if cfg.packed_payload:
                rows, valid, org = cell_mod.gather_packed_candidates(
                    ref.grid, src0, reading.mask
                )
                res0 = cell_mod.match_from_packed(
                    rows, valid, org, ref.grid.cell_size, src0, reading.mask,
                    cfg.max_match_dist, cfg.knn,
                )
            else:
                if cfg.matcher == "hash":
                    rows, valid = grid_mod.gather_candidates(
                        ref.grid, src0, reading.mask
                    )
                else:
                    rows, valid = cell_mod.gather_cell_candidates(
                        ref.grid, src0, reading.mask
                    )
                res0 = grid_mod.match_from_candidates(
                    rows, valid, src0, reading.mask,
                    var_md if var_md is not None else cfg.max_match_dist,
                    cfg.knn,
                )

            # Matcher recall counter: queries whose candidate row is FULL
            # may have lost a nearer neighbour to capacity pressure
            # (MatchersImpl.cpp visit-counter analogue). Frozen on `done`
            # lanes so the value is from the last active refresh.
            full_rows = jnp.sum(valid.astype(dtype), axis=1) >= valid.shape[1]
            sat = _allsum(jnp.sum((full_rows & reading.mask).astype(dtype))) / n_valid
            s = dict(s, row_sat=jnp.where(s["done"], s["row_sat"], sat))

            # Round-frozen trimming: locate the TrimmedDist threshold once
            # per round from the selection distances (histogram path), so
            # in-round iterations skip the scatter-add + cumsum entirely.
            trim_limit = None
            if cfg.trimmed_ratio is not None and cfg.fast_trimming and cfg.shard_axis is None:
                trim_limit = outliers.trimmed_dist_limit(
                    res0.dists, res0.valid(), cfg.trimmed_ratio,
                    cfg.max_match_dist**2,
                )
            # Pair caching: correspondences are SELECTED once per round (the
            # top-k compaction over [N, cap] candidates is the expensive
            # step) and held fixed for the round's iterations; distances,
            # radius gating, trimming weights, and the linearization are
            # recomputed from the moving pose every iteration. Selection
            # staleness is bounded by the same slack margin as candidate
            # staleness, so this matches the cache-mode contract.
            pair_ok = res0.ids >= 0

            # Round-frozen X-ICP analysis: the constrained-direction decision
            # is computed ONCE per refresh round from the round-start pose and
            # the freshly selected pairs, then reused by every in-round
            # iteration (which still solves its own KKT on fresh A, b). Same
            # staleness bound as the pair cache. Saves the ~dozen 64k-element
            # alignment/contribution streams on R-1 of R iterations. For the
            # binary Optimized method the reference detects on the FIRST
            # iteration only (ICP.cpp:2220-2226), so the analysis runs in
            # round 0 and every later round reuses the carried decision.
            frozen_loc = None
            if (
                cfg.degeneracy.method in ("equality_constraints", "optimized")
                and (
                    cfg.degeneracy.analysis_per_round
                    or cfg.degeneracy.method == "optimized"
                )
                and cfg.minimizer == "point_to_plane"
                and not cfg.force_2d
                and not cfg.force_4dof
            ):

                def _round_analysis():
                    q0 = res0.xyz.reshape(-1, 3)
                    mn0 = res0.normals.reshape(-1, 3)
                    w0 = _weights(
                        res0, reading, mn0, cfg, trim_limit=trim_limit,
                        ref_desc=gd_vals,
                    )
                    src0_flat = jnp.repeat(src0, res0.ids.shape[1], axis=0)
                    pm0 = res0.valid().reshape(-1)
                    A0, b0 = minimizers.point_to_plane_normal_equations_bc(
                        src0, res0.xyz, res0.normals, w0.reshape(res0.ids.shape)
                    )
                    A0, b0 = _allsum(A0), _allsum(b0)
                    if cfg.degeneracy.method == "optimized":
                        return xicp.analyze_optimized(
                            A0, b0, src0_flat, mn0, pm0 & (w0 > 0),
                            cfg.degeneracy, axis_name=cfg.shard_axis,
                            with_spectrum=False,
                        )
                    ddn0 = jnp.sum((src0_flat - q0) * mn0, axis=-1)
                    return xicp.analyze_equality_constraints(
                        A0, b0, src0_flat, mn0, ddn0, pm0 & (w0 > 0),
                        cfg.degeneracy, axis_name=cfg.shard_axis,
                        with_spectrum=False,
                    )

                if cfg.degeneracy.method == "optimized":
                    frozen_loc = jax.lax.cond(
                        s["it"] == 0, _round_analysis, lambda: s["loc"]
                    )
                else:
                    frozen_loc = _round_analysis()

            # Moment-cached rounds (GICP and point-to-plane): freeze pairs,
            # weights (and for GICP the per-pair precisions M) at round
            # start, then every in-round iteration reconstructs the exact
            # GN system from second-order moment tensors — O(1) per
            # iteration, no per-pair work at all (see
            # ``minimizers.gicp_moments`` / ``point_to_plane_moments``).
            # Residual-dependent weight families (robust / var-trimmed /
            # median) re-evaluate per iteration by design and fall through
            # to the direct path. An explicitly enabled fused kernel takes
            # priority over the moment path.
            moment_ok = moment_eligible and (
                cfg.trimmed_ratio is None or trim_limit is not None
            )

            fused_ok = (
                cfg.fused_kernel
                and cfg.minimizer == "point_to_plane"
                and not cfg.force_4dof
                and not cfg.force_2d
                # X-ICP is fusable when the analysis freezes per round: the
                # in-round iteration then needs only A, b (the kernel's
                # outputs) + the frozen-direction KKT solve.
                and (cfg.degeneracy.method == "none" or frozen_loc is not None)
                and cfg.shard_axis is None
                and cfg.var_trimmed is None
                and cfg.median_factor is None
                and cfg.robust is None
                and cfg.normal_angle_max is None
                and cfg.reading_step_random_prob is None
                and cfg.reading_step_filters is None
                and cfg.max_residual_dist is None
                and cfg.min_residual_dist is None
                and cfg.generic_descriptor is None
                and var_md is None
                # The kernel applies trimming as a frozen threshold; without
                # one (fast_trimming off) it would silently drop trimming.
                and (cfg.trimmed_ratio is None or trim_limit is not None)
            )
            if cfg.fused_kernel and not fused_ok:
                import warnings

                warnings.warn(
                    "fused_kernel=True but this chain is outside the fused "
                    "pair-GN kernel's coverage (point-to-plane, 6-DoF, no "
                    "robust/normal-gate/sharding, frozen trimming and "
                    "degeneracy analysis); using the XLA "
                    + ("moment-cached" if moment_ok else "direct")
                    + " linearisation",
                    stacklevel=2,
                )
            if fused_ok:
                from open3d_slam_jax.kernels import pair_gn_pallas as pgk

                soa = pgk.prepare_pairs(
                    reading.xyz, res0.xyz, res0.normals, pair_ok
                )
                tau = trim_limit if trim_limit is not None else jnp.inf
                denom = n_valid * cfg.knn

                def fused_step(T):
                    A, b, sw, swr2, nok = pgk.pair_gn_step(soa, T, tau, max_d2)
                    if frozen_loc is not None:
                        x = xicp.solve_with_equality_constraints(A, b, frozen_loc)
                        loc = frozen_loc
                    else:
                        x = minimizers.solve_spd_unrolled(A, b)
                        loc = xicp._identity_result(dtype)
                    dT = minimizers.delta_transform_from_x(x)
                    resid = jnp.sqrt(swr2 / jnp.maximum(sw, 1e-9))
                    return dT, loc, nok / denom, sw / denom, resid, A

            moment_ok = moment_ok and not fused_ok
            if moment_ok:
                k_pairs = res0.ids.shape[1]
                q0m = res0.xyz.reshape(-1, 3)
                mn0m = res0.normals.reshape(-1, 3)
                w0m = _weights(
                    res0, reading, mn0m, cfg, trim_limit=trim_limit,
                    ref_desc=gd_vals,
                )
                p0_flat = jnp.repeat(reading.xyz, k_pairs, axis=0)
                denom_m = n_valid * cfg.knn
                frozen_mr = jnp.sum(pair_ok.astype(dtype)) / denom_m
                frozen_ov = jnp.sum((w0m > 0).astype(dtype)) / denom_m

                if cfg.minimizer == "gicp":
                    src_n0 = se3.apply_rotation(s["T"], reading.normals)
                    mom = minimizers.gicp_moments(
                        p0_flat,
                        jnp.repeat(src_n0, k_pairs, axis=0),
                        q0m, mn0m, w0m, epsilon=cfg.gicp_epsilon,
                    )

                    def moment_system(T):
                        return minimizers.gicp_system_from_moments(T, mom)

                else:  # point_to_plane
                    mom = minimizers.point_to_plane_moments(
                        p0_flat, q0m, mn0m, w0m
                    )

                    def moment_system(T):
                        return minimizers.point_to_plane_system_from_moments(
                            T, mom
                        )

                def moment_step(T):
                    A, b, resid = moment_system(T)
                    if cfg.degeneracy.method == "solution_remapping":
                        x, loc = xicp.solve_with_solution_remapping(
                            A, b, cfg.degeneracy
                        )
                    elif frozen_loc is not None:
                        x = xicp.solve_with_equality_constraints(A, b, frozen_loc)
                        loc = frozen_loc
                    else:
                        x = minimizers.solve_normal_equations_fast(A, b)
                        loc = xicp._identity_result(dtype)
                    dT = minimizers.delta_transform_from_x(x)
                    return dT, loc, frozen_mr, frozen_ov, resid, A

            def inner_cond(st):
                si, i = st
                return (i < R) & ~si["done"] & (si["it"] < max_iterations)

            def inner_body(st):
                si, i = st
                if fused_ok:
                    return masked(si, fused_step(si["T"])), i + 1
                if moment_ok:
                    return masked(si, moment_step(si["T"])), i + 1
                src = se3.apply_transform(si["T"], reading.xyz)
                d2 = jnp.sum((src[:, None, :] - res0.xyz) ** 2, axis=-1)
                invalid = ~pair_ok | (d2 > max_d2)
                res = grid_mod.MatchResult(
                    dists=jnp.where(invalid, jnp.inf, d2),
                    ids=jnp.where(invalid, knn_mod.INVALID_ID, res0.ids),
                    xyz=res0.xyz,
                    normals=res0.normals,
                )
                return (
                    masked(
                        si,
                        gn_update(
                            si["T"], src, res,
                            trim_limit=trim_limit, step_it=si["it"],
                            frozen_loc=frozen_loc,
                        ),
                    ),
                    i + 1,
                )

            # while_loop (not a fixed scan): converged problems stop paying
            # for the remaining round iterations. Under vmap the trip count
            # is the max over the batch; ``masked`` keeps lanes correct.
            T_round0 = s["T"]
            if moment_ok:
                # Entering a fresh-weight re-verification round: prime the
                # differential-checker rings with exactly the tolerance
                # values, so the smoothed mean after ONE fresh iteration is
                # below tolerance iff that iteration's own delta is —
                # i.e. a truly-converged pose confirms in a single cheap
                # iteration instead of flushing the ring for ring-size
                # iterations.
                s = dict(
                    s,
                    drot=jnp.where(
                        s["revisit"],
                        jnp.full_like(s["drot"], cfg.min_diff_rot),
                        s["drot"],
                    ),
                    dtrans=jnp.where(
                        s["revisit"],
                        jnp.full_like(s["dtrans"], cfg.min_diff_trans),
                        s["dtrans"],
                    ),
                )
            s, _ = jax.lax.while_loop(
                inner_cond, inner_body, (s, jnp.asarray(0, jnp.int32))
            )
            if moment_ok:
                # Weights/M were frozen at the round-start pose. A round
                # that converged after moving beyond the differential
                # tolerance did so on stale weights: clear `done` so the
                # next round re-matches, re-freezes, and re-verifies
                # convergence at the improved pose.
                dr_rnd = se3.rotation_angular_distance(
                    s["T"][:3, :3], T_round0[:3, :3]
                )
                dt_rnd = jnp.linalg.norm(s["T"][:3, 3] - T_round0[:3, 3])
                stale = (dr_rnd > cfg.moment_revisit_scale * cfg.min_diff_rot) | (
                    dt_rnd > cfg.moment_revisit_scale * cfg.min_diff_trans
                )
                revisit = stale & s["converged"] & (s["it"] < max_iterations)
                s = dict(
                    s,
                    done=s["done"] & ~revisit,
                    converged=s["converged"] & ~revisit,
                    revisit=revisit,
                )
            return s

        def rounds_cond(st):
            s, r = st
            return (r < rounds) & ~s["done"] & (s["it"] < max_iterations)

        def rounds_body(st):
            s, r = st
            return round_body(s), r + 1

        final, _ = jax.lax.while_loop(
            rounds_cond, rounds_body, (state0, jnp.asarray(0, jnp.int32))
        )
        return final

    def body(s):
        return advance(s, one_iteration(s))

    return jax.lax.while_loop(cond, body, state0)


def icp_single(
    reading: PointBatch,
    ref: ICPReference,
    init_T: jax.Array,
    cfg: ICPConfig,
) -> ICPResult:
    """Register one reading against a prebuilt reference. vmap for batches."""
    dtype = reading.xyz.dtype

    # Work in the reference-centered frame: T' = Trans(-c) . T_init.
    shift = jnp.eye(4, dtype=dtype).at[:3, 3].set(-ref.centroid)
    unshift = jnp.eye(4, dtype=dtype).at[:3, 3].set(ref.centroid)
    T0 = shift @ init_T

    coarse_iters = jnp.asarray(0, jnp.int32)
    if cfg.coarse_iterations > 0 and cfg.coarse_stride > 1:
        coarse = _strided(reading, cfg.coarse_stride)
        cstate = _run_gn_loop(coarse, ref, T0, cfg, cfg.coarse_iterations)
        T0 = cstate["T"]
        coarse_iters = cstate["it"]

    final = _run_gn_loop(reading, ref, T0, cfg, cfg.max_iterations)
    final["it"] = final["it"] + coarse_iters

    T_out = unshift @ final["T"]
    loc = final["loc"]
    degenerate = (jnp.min(loc.localizability_rot) < 0.5) | (
        jnp.min(loc.localizability_trans) < 0.5
    )
    # Spectral diagnostics + covariance from the FINAL hessian, once.
    w6, V6 = jnp.linalg.eigh(final["A"])
    inv = jnp.where(jnp.abs(w6) > 1e-7 * jnp.max(jnp.abs(w6)), 1.0 / w6, 0.0)
    cov = (V6 * inv[None, :]) @ V6.T * jnp.maximum(final["resid"], 1e-6) ** 2
    have_A = jnp.max(jnp.abs(final["A"])) > 0
    eig_out = jnp.where(have_A, w6, loc.eigenvalues6)
    cond_out = jnp.where(
        have_A,
        jnp.max(jnp.abs(w6)) / jnp.maximum(jnp.min(jnp.abs(w6)), 1e-30),
        loc.condition_number,
    )
    return ICPResult(
        transform=T_out,
        iterations=final["it"],
        converged=final["converged"],
        match_ratio=final["match_ratio"],
        overlap_ratio=final["overlap"],
        residual=final["resid"],
        eigenvalues=eig_out,
        condition_number=cond_out,
        localizability_rot=loc.localizability_rot,
        localizability_trans=loc.localizability_trans,
        degenerate=degenerate,
        aborted=final["aborted"],
        covariance=cov,
        match_row_saturation=final["row_sat"],
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_pair(
    reading: PointBatch,
    reference: PointBatch,
    init_T: jax.Array,
    cfg: ICPConfig,
) -> ICPResult:
    """Convenience one-shot: build reference + run (≙ ``ICP::operator()``,
    ``ICP.cpp:793-844``)."""
    ref = build_reference(reference, cfg)
    return icp_single(reading, ref, init_T, cfg)


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_batch(
    readings: PointBatch,
    references: PointBatch,
    init_Ts: jax.Array,
    cfg: ICPConfig,
) -> ICPResult:
    """Batched registration: leading axis B on every input."""
    def one(reading, reference, T):
        return icp_single(reading, build_reference(reference, cfg), T, cfg)

    return jax.vmap(one)(readings, references, init_Ts)


@functools.partial(jax.jit, static_argnames=("cfg",))
def register_hypotheses(
    reading: PointBatch,
    reference: PointBatch,
    init_Ts: jax.Array,
    cfg: ICPConfig,
) -> ICPResult:
    """Multi-hypothesis registration: one reading/reference pair, ``[H, 4, 4]``
    initial poses (the relocalization workload — reference analogue is a
    serial loop over RANSAC seeds in ``PlaceRecognition.cpp``)."""
    ref = build_reference(reference, cfg)
    return jax.vmap(lambda T: icp_single(reading, ref, T, cfg))(init_Ts)


class ICPSequence:
    """Persistent-reference ICP object (≙ ``ICPSequence``,
    ``ICP.cpp:1356-1510``): set a map once (the expensive build), then
    register a stream of readings against it.

    Thin stateful wrapper over :func:`build_reference` + :func:`icp_single`
    for users porting reference code; new code can use those directly.
    """

    def __init__(self, cfg: ICPConfig):
        self.cfg = cfg
        self._ref: Optional[ICPReference] = None

    def has_map(self) -> bool:
        return self._ref is not None

    def set_map(self, reference: PointBatch) -> None:
        """≙ ``setMap`` / ``initReference`` — builds normals grid etc."""
        self._ref = build_reference(reference, self.cfg)

    def clear_map(self) -> None:
        self._ref = None

    def __call__(self, reading: PointBatch, init_T=None) -> ICPResult:
        if self._ref is None:
            raise RuntimeError("ICPSequence: no map set (call set_map first)")
        if init_T is None:
            init_T = jnp.eye(4)
        return icp_single(reading, self._ref, init_T, self.cfg)
