"""X-ICP degeneracy awareness, vectorized.

Re-implements the reference fork's headline feature — localizability-aware
ICP solving (``ICP.cpp:1569-2503``, ``PointToPlane.cpp:402-505``) — as pure
masked array math:

- ``solution_remapping``: LOAM-style eigenvalue gating. 6x6 eigh of the
  optimization hessian; directions with eigenvalue < threshold are projected
  out of the solution: ``P = V diag(keep) V^T`` (equivalent to the
  reference's ``(V^T)^-1 V_zeroed^T`` for orthogonal V,
  ``ICP.cpp:1622-1667``).
- ``optimized`` (kOptimizedEqualityConstraints, the production
  ``param/icp.yaml`` method; ``ICP.cpp:2185-2446``): per-subspace 3x3
  eigenanalysis + per-point alignment contributions with weak/strong cosine
  gates, then a BINARY decision per direction — localizable iff
  ``combined >= enoughInformationThreshold`` or
  ``high >= insufficientInformationThreshold``
  (``detectLocalizability``, ``ICP.cpp:2129-2160``). Non-localizable
  directions are locked with constraint value 0; there is no partial
  re-solve. The reference runs this detection on the FIRST iteration only
  (``ICP.cpp:2220-2226`` early-returns afterwards), so the engine computes
  it once per GN phase and freezes the result.
- ``equality_constraints`` (kEqualityConstraints / the Ternary-level
  family, ``ICP.cpp:1698-2157``): same alignment machinery but a TERNARY
  categorization per direction (localizable / partially localizable with a
  re-sampled 3-DoF partial solve supplying a non-zero constraint value /
  non-localizable), re-evaluated every iteration
  (``detectLocalizabilityWithTernaryLevelDetection`` forces re-analysis at
  ``ICP.cpp:1702``). Both families share the equality-constrained KKT solve
  (``PointToPlane.cpp:459-505``, identical for both at
  ``PointToPlane.cpp:311-316``).

All shapes fixed; the KKT system is always 12x12 with inactive constraint
rows zeroed (min-norm symmetric pseudo-solve keeps them inert, matching the
reference's Jacobi-SVD solve of the rank-deficient augmented system).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.models.minimizers import (
    solve_normal_equations,
    solve_symmetric_indefinite,
)
from open3d_slam_jax.ops.normals import eigh3x3


@dataclasses.dataclass(frozen=True)
class DegeneracyConfig:
    """Static configuration mirroring ``LocalizabilityDetectionParameters``
    (``PointMatcher.h:686-733``). Thresholds are contribution *sums* and thus
    scale with point count, exactly like the reference defaults."""

    # none | solution_remapping | optimized (binary, first-iteration-only:
    # kOptimizedEqualityConstraints) | equality_constraints (ternary with
    # partial 3-DoF constraint re-solve: kEqualityConstraints /
    # TernaryLevelDetection).
    method: str = "none"
    solution_remapping_threshold: float = 150.0
    # Use the condition-number variant of solution remapping (2019 flag).
    use_condition_number_threshold: bool = False
    high_information_threshold: float = 350.0
    enough_information_threshold: float = 150.0
    insufficient_information_threshold: float = 40.0
    weak_alignment_cos: float = 0.17364818  # cos(80 deg)
    strong_alignment_cos: float = 0.70710678  # cos(45 deg)
    # Freeze the localizability analysis per candidate-refresh round instead
    # of recomputing it every iteration (candidate-cached grid mode only).
    # The constrained-direction decision is geometric and changes on the
    # same slow timescale as the pair selection, so this shares the pair
    # cache's staleness contract; the KKT solve still runs on each
    # iteration's fresh normal equations. The reference recomputes per
    # iteration (ICP.cpp:1079-1172) — set False for reference-exact cadence.
    analysis_per_round: bool = True


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LocalizabilityResult:
    """Per-problem analysis outputs (the observables ``ICPChainBase``
    exposes: eigenvalues, condition number, degenerate directions)."""

    eigenvalues6: jax.Array  # [6] of the full hessian (ascending)
    condition_number: jax.Array  # scalar
    # 1.0 = localizable, 0.0 = non-localizable, per direction.
    localizability_rot: jax.Array  # [3]
    localizability_trans: jax.Array  # [3]
    rotation_eigenvectors: jax.Array  # [3, 3] columns
    translation_eigenvectors: jax.Array  # [3, 3] columns
    constraint_values_rot: jax.Array  # [3]
    constraint_values_trans: jax.Array  # [3]


def _identity_result(dtype=jnp.float32) -> LocalizabilityResult:
    return LocalizabilityResult(
        eigenvalues6=jnp.zeros((6,), dtype),
        condition_number=jnp.asarray(1.0, dtype),
        localizability_rot=jnp.ones((3,), dtype),
        localizability_trans=jnp.ones((3,), dtype),
        rotation_eigenvectors=jnp.eye(3, dtype=dtype),
        translation_eigenvectors=jnp.eye(3, dtype=dtype),
        constraint_values_rot=jnp.zeros((3,), dtype),
        constraint_values_trans=jnp.zeros((3,), dtype),
    )


def solve_with_solution_remapping(A, b, cfg: DegeneracyConfig):
    """Unconstrained solve followed by degenerate-direction projection."""
    w, V = jnp.linalg.eigh(A)  # ascending
    cond = jnp.max(jnp.abs(w)) / jnp.maximum(jnp.min(jnp.abs(w)), 1e-30)
    thresh = (
        cond
        if cfg.use_condition_number_threshold
        else jnp.asarray(cfg.solution_remapping_threshold, A.dtype)
    )
    keep = (w >= thresh).astype(A.dtype)
    x = solve_normal_equations(A, b)
    P = (V * keep[None, :]) @ V.T
    x = P @ x
    res = _identity_result(A.dtype)
    res = dataclasses.replace(
        res,
        eigenvalues6=w,
        condition_number=cond,
        # Report which of the 6 directions were suppressed, split by the
        # dominant subspace of each eigenvector.
        localizability_rot=jnp.ones((3,), A.dtype),
        localizability_trans=jnp.ones((3,), A.dtype),
    )
    return x, res


def _subspace_contributions(
    align_vecs, eigvecs, point_mask, cfg: DegeneracyConfig, strict_weak: bool = False
):
    """Contribution sums of each point against each of 3 eigenvectors.

    ``align_vecs [P, 3]`` unit-ish alignment vectors, ``eigvecs [3, 3]``
    columns. Returns (combined [3], high [3], weak_mask [P, 3],
    strong_mask [P, 3]) following
    ``countContributionValuesAndCheckWhetherProblemIsConstrainedVeryWell``
    (``ICP.cpp:2050-2100``) — without the early-exit truncation (which only
    saves CPU time in the reference; sums past the exit point only increase,
    and the decision thresholds compare identically).

    ``strict_weak``: the Optimized method's ``detectLocalizability``
    (``ICP.cpp:2129-2160``) gates the combined sum with a STRICT
    ``> minimalAlignmentCosine`` where the ternary counter uses ``>=``.
    """
    a = jnp.abs(align_vecs @ eigvecs)  # [P, 3]
    a = jnp.where(point_mask[:, None], a, 0.0)
    strong = a > cfg.strong_alignment_cos
    weak = a > cfg.weak_alignment_cos if strict_weak else a >= cfg.weak_alignment_cos
    high = jnp.sum(jnp.where(strong, a, 0.0), axis=0)
    combined = jnp.sum(jnp.where(weak, a, 0.0), axis=0)
    return combined, high, weak, strong


def _alignment_geometry(A, src_xyz, matched_normals, pair_mask, dtype, allsum):
    """Shared setup for both X-ICP detection families: per-subspace 3x3
    eigenvectors and the per-point alignment vectors
    (``eigenAnalysis`` ``ICP.cpp:1581-1591`` + alignment vectors
    ``ICP.cpp:1760-1790``: translation -> matched normals, rotation ->
    cross(p - center, n) normalized only when ||.|| >= 1)."""
    rot_w, rot_V = eigh3x3(A[:3, :3][None])
    tr_w, tr_V = eigh3x3(A[3:, 3:][None])
    rot_V, tr_V = rot_V[0], tr_V[0]

    count = jnp.maximum(allsum(jnp.sum(pair_mask.astype(dtype))), 1.0)
    center = allsum(jnp.sum(jnp.where(pair_mask[:, None], src_xyz, 0.0), axis=0)) / count
    crosses = jnp.cross(src_xyz - center, matched_normals)
    cnorm = jnp.linalg.norm(crosses, axis=-1, keepdims=True)
    crosses = jnp.where(cnorm >= 1.0, crosses / jnp.maximum(cnorm, 1e-30), crosses)
    return rot_V, tr_V, crosses


def analyze_optimized(
    A,
    b,
    src_xyz,
    matched_normals,
    pair_mask,
    cfg: DegeneracyConfig,
    axis_name=None,
    with_spectrum: bool = False,
):
    """Binary X-ICP localizability detection — kOptimizedEqualityConstraints
    (``detectLocalizabilityWithOptimizedMethod``, ``ICP.cpp:2185-2446``).

    Per direction: localizable iff
    ``combined >= enough_information_threshold`` or
    ``high >= insufficient_information_threshold`` (the Optimized method
    reads the LOWER threshold pair — it never uses
    ``high_information_threshold``). Non-localizable directions are locked
    at constraint value 0; there is no partial 3-DoF re-solve. The reference
    computes this once, on the first iteration (``ICP.cpp:2220-2226``); the
    engine mirrors that by freezing the returned result for the whole phase.
    """
    dtype = A.dtype

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    rot_V, tr_V, crosses = _alignment_geometry(
        A, src_xyz, matched_normals, pair_mask, dtype, allsum
    )
    if with_spectrum:
        w6, _ = jnp.linalg.eigh(A)
        cond = jnp.max(jnp.abs(w6)) / jnp.maximum(jnp.min(jnp.abs(w6)), 1e-30)
    else:
        w6 = jnp.zeros((6,), dtype)
        cond = jnp.asarray(1.0, dtype)

    comb_r, high_r, _, _ = _subspace_contributions(
        crosses, rot_V, pair_mask, cfg, strict_weak=True
    )
    comb_t, high_t, _, _ = _subspace_contributions(
        matched_normals, tr_V, pair_mask, cfg, strict_weak=True
    )
    comb_r, high_r = allsum(comb_r), allsum(high_r)
    comb_t, high_t = allsum(comb_t), allsum(high_t)

    def localizable(comb, high):
        return (comb >= cfg.enough_information_threshold) | (
            high >= cfg.insufficient_information_threshold
        )

    loc_r = localizable(comb_r, high_r)
    loc_t = localizable(comb_t, high_t)

    return LocalizabilityResult(
        eigenvalues6=w6,
        condition_number=cond,
        localizability_rot=loc_r.astype(dtype),
        localizability_trans=loc_t.astype(dtype),
        rotation_eigenvectors=rot_V,
        translation_eigenvectors=tr_V,
        constraint_values_rot=jnp.zeros((3,), dtype),
        constraint_values_trans=jnp.zeros((3,), dtype),
    )


def _partial_constraint_values(
    sel_w,  # [P, 3] per-direction selection weights (0/1)
    normals,  # [P, 3] matched reference normals
    crosses,  # [P, 3] normalized rotation alignment vectors' raw crosses
    deltas_dot_n,  # [P] (p - q) . n per pair
    eigvecs,  # [3, 3]
    is_rotation: bool,
    axis_name=None,
):
    """3-DoF re-solve on the selected subset, projected onto each direction
    (``solveSimpleOptimizationProblemForPartialConstraints``,
    ``ICP.cpp:2504-2797``). Vectorized over the 3 directions."""
    basis = crosses if is_rotation else normals  # [P, 3]

    def per_dir(sel, v):
        A3 = jnp.einsum("p,pi,pj->ij", sel, basis, basis)
        b3 = -jnp.einsum("p,pi,p->i", sel, basis, deltas_dot_n)
        if axis_name is not None:
            A3 = jax.lax.psum(A3, axis_name)
            b3 = jax.lax.psum(b3, axis_name)
        x3 = solve_normal_equations(A3, b3)
        return v @ x3

    return jax.vmap(per_dir, in_axes=(1, 1))(sel_w, eigvecs)  # [3]


def analyze_equality_constraints(
    A,
    b,
    src_xyz,
    matched_normals,
    deltas_dot_n,
    pair_mask,
    cfg: DegeneracyConfig,
    axis_name=None,
    with_spectrum: bool = True,
):
    """Full X-ICP ternary localizability analysis for one problem.

    ``src_xyz [P, 3]``: transformed reading points of valid pairs (frame
    does not matter for the decision — alignment dot products are rotation
    invariant when eigenvectors live in the same frame).
    Returns a LocalizabilityResult; categories 0 => direction constrained.
    """
    dtype = A.dtype

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    rot_V, tr_V, crosses = _alignment_geometry(
        A, src_xyz, matched_normals, pair_mask, dtype, allsum
    )

    # The 6x6 spectrum is diagnostics only (the detection itself uses the
    # 3x3 subspace analyses); the ICP loop re-derives it once from the final
    # hessian after convergence, so skip the per-iteration eigh there.
    if with_spectrum:
        w6, _ = jnp.linalg.eigh(A)
        cond = jnp.max(jnp.abs(w6)) / jnp.maximum(jnp.min(jnp.abs(w6)), 1e-30)
    else:
        w6 = jnp.zeros((6,), dtype)
        cond = jnp.asarray(1.0, dtype)

    comb_r, high_r, weak_r, strong_r = _subspace_contributions(crosses, rot_V, pair_mask, cfg)
    comb_t, high_t, weak_t, strong_t = _subspace_contributions(matched_normals, tr_V, pair_mask, cfg)
    comb_r, high_r = allsum(comb_r), allsum(high_r)
    comb_t, high_t = allsum(comb_t), allsum(high_t)

    def categorize(comb, high):
        localizable = (comb >= cfg.high_information_threshold) | (
            high >= cfg.enough_information_threshold
        )
        mixed = (~localizable) & (comb >= cfg.enough_information_threshold)
        high_part = (~localizable) & (~mixed) & (high >= cfg.insufficient_information_threshold)
        none_ = ~(localizable | mixed | high_part)
        return localizable, mixed, high_part, none_

    loc_r, mix_r, hi_r, non_r = categorize(comb_r, high_r)
    loc_t, mix_t, hi_t, non_t = categorize(comb_t, high_t)

    # Partial-constraint selection: mixed -> all weakly contributing points,
    # high -> only strongly contributing points (``detectSubspaceLocalizability``).
    sel_r = jnp.where(mix_r[None, :], weak_r.astype(dtype), jnp.where(hi_r[None, :], strong_r.astype(dtype), 0.0))
    sel_t = jnp.where(mix_t[None, :], weak_t.astype(dtype), jnp.where(hi_t[None, :], strong_t.astype(dtype), 0.0))
    sel_r = sel_r * pair_mask[:, None].astype(dtype)
    sel_t = sel_t * pair_mask[:, None].astype(dtype)

    cons_r = _partial_constraint_values(sel_r, matched_normals, crosses, deltas_dot_n, rot_V, True, axis_name)
    cons_t = _partial_constraint_values(sel_t, matched_normals, crosses, deltas_dot_n, tr_V, False, axis_name)
    # Non-localizable or localizable directions get value 0 (locked / inert).
    cons_r = jnp.where(mix_r | hi_r, cons_r, 0.0)
    cons_t = jnp.where(mix_t | hi_t, cons_t, 0.0)

    return LocalizabilityResult(
        eigenvalues6=w6,
        condition_number=cond,
        localizability_rot=loc_r.astype(dtype),
        localizability_trans=loc_t.astype(dtype),
        rotation_eigenvectors=rot_V,
        translation_eigenvectors=tr_V,
        constraint_values_rot=cons_r,
        constraint_values_trans=cons_t,
    )


def solve_with_equality_constraints(A, b, loc: LocalizabilityResult):
    """KKT solve with per-direction equality constraints.

    Constrained directions (localizability == 0) contribute border rows
    ``v^T x = c`` with the eigenvector padded into its subspace slots
    (``generateConstrainedOptimizationProblem``). Fixed 12x12 system; rows of
    unconstrained directions are zero and stay inert under the min-norm
    symmetric pseudo-solve.
    """
    dtype = A.dtype
    con_rot = 1.0 - loc.localizability_rot  # [3] 1 => constrained
    con_tr = 1.0 - loc.localizability_trans

    # Constraint rows [6, 6]: first 3 from rotation subspace, last 3 trans.
    C = jnp.zeros((6, 6), dtype)
    C = C.at[:3, :3].set((loc.rotation_eigenvectors * con_rot[None, :]).T)
    C = C.at[3:, 3:].set((loc.translation_eigenvectors * con_tr[None, :]).T)
    d = jnp.concatenate([
        loc.constraint_values_rot * con_rot,
        loc.constraint_values_trans * con_tr,
    ])

    M = jnp.zeros((12, 12), dtype)
    M = M.at[:6, :6].set(A)
    M = M.at[:6, 6:].set(C.T)
    M = M.at[6:, :6].set(C)
    rhs = jnp.concatenate([b, d])
    x_lam = solve_symmetric_indefinite(M, rhs)
    return x_lam[:6]
