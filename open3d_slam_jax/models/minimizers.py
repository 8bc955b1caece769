"""Error minimizers: fused linearization + 6-DoF solves.

Fixed-shape JAX re-design of libpointmatcher's ``ErrorMinimizers``:

- :func:`point_to_plane_normal_equations` fuses the residual/Jacobian pass of
  the reference's ``calculateOptimizationHessian`` (``ICP.cpp:1513-1566``):
  ``A = sum_i w_i J_i J_i^T``, ``b = -sum_i w_i J_i ((p_i - q_i) . n_i)``
  with ``J_i = [p_i x n_i ; n_i]`` — one einsum pass, no [N, 6, 6]
  intermediate.
- :func:`solve_normal_equations` mirrors ``solvePossiblyUnderdeterminedLinear
  System`` (``PointToPlane.cpp:112-265``): for symmetric (possibly singular)
  ``A`` the Jacobi-SVD minimum-norm solve is exactly the eigh-based
  pseudoinverse solve, which is cheap and batched on device.
- :func:`point_to_point_transform` is the weighted Kabsch/Umeyama solve of
  ``ErrorMinimizers/PointToPoint.cpp``.

``x`` layout everywhere: ``[omega(3), t(3)]`` (rotation first), matching the
reference solution vector.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3


def point_to_plane_pairs(src_xyz, ref_xyz, ref_normals, weights):
    """Per-pair point-to-plane residual terms.

    Args: ``src_xyz [P, 3]`` transformed reading points, ``ref_xyz [P, 3]``
    matched reference points, ``ref_normals [P, 3]``, ``weights [P]``
    (0 for invalid pairs). Returns (J ``[P, 6]``, r ``[P]``) with
    J = [p x n ; n] and r = (p - q) . n.
    """
    cross = jnp.cross(src_xyz, ref_normals)
    J = jnp.concatenate([cross, ref_normals], axis=-1)
    r = jnp.sum((src_xyz - ref_xyz) * ref_normals, axis=-1)
    return J, r


def point_to_plane_normal_equations(src_xyz, ref_xyz, ref_normals, weights):
    """Weighted 6x6 normal equations (A, b) for point-to-plane.

    Assembled as 21+6 explicit elementwise reductions instead of a
    [6,P]x[P,6] matmul: exact f32 sums under any default matmul precision
    (a K=6 product gains nothing from a matrix unit)."""
    J, r = point_to_plane_pairs(src_xyz, ref_xyz, ref_normals, weights)
    wJ = J * weights[:, None]
    # Upper triangle of A via elementwise products; mirror for symmetry.
    cols_w = [wJ[:, i] for i in range(6)]
    cols = [J[:, i] for i in range(6)]
    A = jnp.zeros((6, 6), src_xyz.dtype)
    for i in range(6):
        for j in range(i, 6):
            v = jnp.sum(cols_w[i] * cols[j])
            A = A.at[i, j].set(v)
            if i != j:
                A = A.at[j, i].set(v)
    b = -jnp.stack([jnp.sum(cols_w[i] * r) for i in range(6)])
    return A, b


def point_to_plane_normal_equations_bc(src_xyz, ref_xyz, ref_normals, weights):
    """Candidate-major point-to-plane normal equations.

    ``src_xyz [N, 3]`` is broadcast against matched candidates
    ``ref_xyz/ref_normals [N, M, 3]`` and ``weights [N, M]`` (0 for masked
    pairs) — no materialized ``jnp.repeat`` of the source points, every
    column product is a fused [N, M] elementwise pass. Identical sums to
    :func:`point_to_plane_normal_equations` on the flattened pairs.
    """
    p = src_xyz[:, None, :]
    n = ref_normals
    cross = jnp.cross(jnp.broadcast_to(p, n.shape), n)
    r = jnp.sum((p - ref_xyz) * n, axis=-1)
    cols = [cross[..., 0], cross[..., 1], cross[..., 2], n[..., 0], n[..., 1], n[..., 2]]
    cols_w = [c * weights for c in cols]
    A = jnp.zeros((6, 6), src_xyz.dtype)
    for i in range(6):
        for j in range(i, 6):
            v = jnp.sum(cols_w[i] * cols[j])
            A = A.at[i, j].set(v)
            if i != j:
                A = A.at[j, i].set(v)
    b = -jnp.stack([jnp.sum(cols_w[i] * r) for i in range(6)])
    return A, b


def point_to_plane_4dof_normal_equations(src_xyz, ref_xyz, ref_normals, weights):
    """4-DoF (yaw + translation) variant: J = [(p x n)_z ; n], x = [yaw, t].

    Mirrors the reference's force4DOF mode which keeps only the z-row of the
    cross product (``PointToPlane.cpp`` force4DOF paths)."""
    cross_z = src_xyz[..., 0] * ref_normals[..., 1] - src_xyz[..., 1] * ref_normals[..., 0]
    J = jnp.concatenate([cross_z[:, None], ref_normals], axis=-1)  # [P, 4]
    r = jnp.sum((src_xyz - ref_xyz) * ref_normals, axis=-1)
    wJ = J * weights[:, None]
    A = jnp.einsum("pi,pj->ij", wJ, J)
    b = -jnp.einsum("pi,p->i", wJ, r)
    return A, b


def point_to_plane_2d_normal_equations(src_xyz, ref_xyz, ref_normals, weights):
    """force2D variant: minimize in SE(2) on the XY plane, x = [theta, tx, ty].

    Mirrors the reference's force2D mode (``PointToPlane.cpp:788`` drops the
    z row; the 2-D wedge ``px*ny - py*nx`` replaces the cross product and the
    output transform is ``Rz(theta)`` applied raw — the 2-D branch at
    ``PointToPlane.cpp:388`` uses ``Eigen::Rotation2D(x0)`` without atan)."""
    wedge = src_xyz[..., 0] * ref_normals[..., 1] - src_xyz[..., 1] * ref_normals[..., 0]
    n2 = ref_normals[..., :2]
    J = jnp.concatenate([wedge[:, None], n2], axis=-1)  # [P, 3]
    d2 = src_xyz[..., :2] - ref_xyz[..., :2]
    r = jnp.sum(d2 * n2, axis=-1)
    wJ = J * weights[:, None]
    A = jnp.einsum("pi,pj->ij", wJ, J)
    b = -jnp.einsum("pi,p->i", wJ, r)
    return A, b


def gicp_normal_equations(
    src_xyz, src_normals, ref_xyz, ref_normals, weights, epsilon: float = 1e-3
):
    """Generalized-ICP (plane-to-plane) 6x6 normal equations.

    Segal et al.'s GICP with disk covariances derived from normals:
    ``C = I - (1 - eps) n n^T`` (eigenvalues (1, 1, eps) about the normal).
    Per-pair 3-vector residual ``r = p - q`` weighted by
    ``M = (C_q + C_p')^-1`` (``C_p'`` already rotated — pass rotated source
    normals). This is the cost behind the reference's
    ``RegistrationGeneralizedICP`` facade default
    (``CloudRegistration.cpp:16-100``).

    Jacobian of r wrt x = [omega, t]: ``dr/domega = -[p]_x``, ``dr/dt = I``.
    Returns (A [6,6], b [6]).
    """
    eye = jnp.eye(3, dtype=src_xyz.dtype)
    k = 1.0 - epsilon
    # M = (2I - k(nq nq^T + np np^T))^-1, closed-form 3x3 inverse per pair.
    S = 2.0 * eye - k * (
        jnp.einsum("pi,pj->pij", ref_normals, ref_normals)
        + jnp.einsum("pi,pj->pij", src_normals, src_normals)
    )
    M = _inv3x3(S)

    r = src_xyz - ref_xyz  # [P, 3]
    Px = _hat(src_xyz)  # [P, 3, 3]
    # J = [-[p]x | I] as two 3x3 blocks; A = J^T M J assembled blockwise.
    MP = jnp.einsum("pij,pjk->pik", M, -Px)  # M * J_omega
    w = weights[:, None, None]
    A_oo = jnp.einsum("pji,pjk->ik", -Px * w, MP)
    A_ot = jnp.einsum("pji,pjk->ik", -Px * w, M)
    A_tt = jnp.einsum("pij->ij", M * w)
    A = jnp.zeros((6, 6), src_xyz.dtype)
    A = A.at[:3, :3].set(A_oo)
    A = A.at[:3, 3:].set(A_ot)
    A = A.at[3:, :3].set(A_ot.T)
    A = A.at[3:, 3:].set(A_tt)
    Mr = jnp.einsum("pij,pj->pi", M, r) * weights[:, None]
    b_o = -jnp.einsum("pji,pj->i", -Px, Mr)
    b_t = -jnp.sum(Mr, axis=0)
    b = jnp.concatenate([b_o, b_t])
    return A, b


# Generators of the skew map: [p]_x = sum_d p_d * _GEN[d]. Used to turn
# per-pair cross-product sums into contractions of precomputed moments.
_GEN = jnp.asarray(
    [
        [[0.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]],
        [[0.0, 0.0, 1.0], [0.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 0.0]],
    ]
)


def point_to_plane_moments(p0, q, ref_normals, weights):
    """Round-frozen sufficient statistics for the point-to-plane GN system.

    Same collapse as :func:`gicp_moments`: with the pair set, weights and
    reference normals frozen for a refresh round, every entry of the
    point-to-plane ``A(T), b(T)`` (``J = [p x n ; n]``,
    ``r = n.(p - q)``, ``p = R p0 + t``) is at most quadratic in ``p`` —
    exactly reconstructible from second-order moments of
    ``(p0, n, s = n.q)``. One streaming pass per round; O(1) per in-round
    iteration. ≙ the per-iteration ``calculateOptimizationHessian`` pass
    (``ICP.cpp:1513-1566``) amortized across a cached round.

    Args: ``p0 [P, 3]`` reading points (reading frame, fixed), ``q [P, 3]``
    matched reference points, ``ref_normals [P, 3]``, ``weights [P]``.
    """
    n = ref_normals
    s = jnp.sum(n * q, axis=-1)  # frozen plane offsets n.q
    ws = weights * s
    return dict(
        N2=jnp.einsum("p,pf,pg,pc,ph->fgch", weights, p0, p0, n, n),
        N1=jnp.einsum("p,pf,pc,ph->fch", weights, p0, n, n),
        N0=jnp.einsum("p,pc,ph->ch", weights, n, n),
        Q1=jnp.einsum("p,pf,pc->fc", ws, p0, n),  # sum w s p0 n^T
        Q0=jnp.einsum("p,pc->c", ws, n),  # sum w s n
        Q2=jnp.sum(ws * s),  # sum w s^2
        n0=jnp.sum(weights),
    )


def point_to_plane_system_from_moments(T, mom):
    """Exact point-to-plane normal equations ``(A, b, resid)`` at pose ``T``
    from round-frozen moments — O(1) per iteration.

    Mirrors :func:`point_to_plane_normal_equations` exactly: ``A`` uses
    ``J = [p x n ; n]`` with ``p x n = sum_d p_d (G_d n)`` expanded through
    the moments; ``resid`` is the weighted RMS of ``n.(p - q)``."""
    R, t = T[:3, :3], T[:3, 3]
    G = _GEN.astype(R.dtype)
    N2, N1, N0 = mom["N2"], mom["N1"], mom["N0"]
    # Current-pose moments: M1[d,c,h] = sum w p_d n_c n_h,
    # M2[d,e,c,h] = sum w p_d p_e n_c n_h.
    RN1 = jnp.einsum("df,fch->dch", R, N1)
    M1 = RN1 + t[:, None, None] * N0
    RRN2 = jnp.einsum("df,eg,fgch->dech", R, R, N2)
    M2 = (
        RRN2
        + t[:, None, None, None] * RN1[None]
        + t[None, :, None, None] * RN1[:, None]
        + (t[:, None] * t[None, :])[..., None, None] * N0
    )
    # Q1'[d,c] = sum w s p_d n_c at the current pose.
    Q1p = jnp.einsum("df,fc->dc", R, mom["Q1"]) + t[:, None] * mom["Q0"]

    A_tt = N0
    A_ot = jnp.einsum("dac,dcb->ab", G, M1)  # sum w (p x n) n^T
    A_oo = jnp.einsum("dac,ebh,dech->ab", G, G, M2)
    A = jnp.zeros((6, 6), R.dtype)
    A = A.at[:3, :3].set(A_oo)
    A = A.at[:3, 3:].set(A_ot)
    A = A.at[3:, :3].set(A_ot.T)
    A = A.at[3:, 3:].set(A_tt)

    # b = -sum w J r with r = n.p - s.
    vec_np = jnp.einsum("dac,dece->a", G, M2)  # sum w (p x n)(n.p)
    vec_s = jnp.einsum("dac,dc->a", G, Q1p)  # sum w (p x n) s
    b_o = -(vec_np - vec_s)
    b_t = -(jnp.einsum("eae->a", M1) - mom["Q0"])
    b = jnp.concatenate([b_o, b_t])

    n0 = jnp.maximum(mom["n0"], 1e-9)
    snp2 = jnp.einsum("eheh->", M2)  # sum w (n.p)^2
    ssnp = jnp.einsum("ee->", Q1p)  # sum w s (n.p)
    resid = jnp.sqrt(jnp.maximum(snp2 - 2.0 * ssnp + mom["Q2"], 0.0) / n0)
    return A, b, resid


def gicp_moments(p0, src_normals0, q, ref_normals, weights, epsilon: float = 1e-3):
    """Round-frozen sufficient statistics for the GICP GN system.

    The in-round GN iteration needs ``A(T), b(T)`` for the *fixed* pair set
    selected at refresh time. With per-pair ``M_i`` (the GICP precision,
    frozen at the round-start rotation) and weights ``w_i`` frozen for the
    round, every entry of ``A`` and ``b`` is at most quadratic in
    ``p_i = R p0_i + t`` — so the whole per-pair reduction collapses to a
    fixed set of second-order moment tensors contracted with ``(R, t)``
    (:func:`gicp_system_from_moments`). One streaming pass here (~the cost
    of one direct iteration) makes every subsequent in-round iteration
    O(1). Matches the pair-cached contract of ``models/icp.py``: staleness
    is bounded by the candidate-cache slack margin. ≙ the role of the
    per-iteration error minimizer in ``ICP.cpp:1079-1172`` with Segal-style
    frozen match covariances.

    Args: ``p0 [P, 3]`` reading points in the READING frame (fixed),
    ``src_normals0 [P, 3]`` reading normals rotated by the round-start
    pose, ``q / ref_normals [P, 3]`` matched reference points/normals
    (reference-centered frame), ``weights [P]`` frozen round weights.
    """
    eye = jnp.eye(3, dtype=p0.dtype)
    k = 1.0 - epsilon
    S = 2.0 * eye - k * (
        jnp.einsum("pi,pj->pij", ref_normals, ref_normals)
        + jnp.einsum("pi,pj->pij", src_normals0, src_normals0)
    )
    M = _inv3x3(S) * weights[:, None, None]  # w-absorbed precision
    Mq = jnp.einsum("pij,pj->pi", M, q)
    return dict(
        S0=jnp.sum(M, axis=0),  # [3,3]   sum w M
        S1=jnp.einsum("pd,pab->dab", p0, M),  # [3,3,3]   sum w p0_d M
        S2=jnp.einsum("pd,pe,pab->deab", p0, p0, M),  # [3,3,3,3]
        Y0=jnp.sum(Mq, axis=0),  # [3]     sum w M q
        Y1=jnp.einsum("pd,pa->da", p0, Mq),  # [3,3]   sum w p0_d (M q)
        # Plain (un-whitened) moments for the RMS residual readout.
        n0=jnp.sum(weights),
        n1=jnp.einsum("p,pa->a", weights, p0),
        nq=jnp.einsum("p,pa->a", weights, q),
        npp=jnp.sum(weights * jnp.sum(p0 * p0, -1)),
        nqq=jnp.sum(weights * jnp.sum(q * q, -1)),
        C=jnp.einsum("p,pa,pb->ab", weights, q, p0),  # sum w q p0^T
    )


def gicp_system_from_moments(T, mom):
    """Exact GICP normal equations ``(A, b, resid)`` at pose ``T`` from
    round-frozen moments — O(1) per iteration, no per-pair work.

    Algebra mirrors :func:`gicp_normal_equations` exactly (same sign
    conventions), with ``p = R p0 + t`` expanded through the moments:
    ``A_oo = -sum w [p]x M [p]x``, ``A_ot = sum w [p]x M``,
    ``A_tt = sum w M``, ``b_o = -sum w [p]x M r``, ``b_t = -sum w M r``.
    ``resid`` is the weighted RMS of ``|p - q|`` (the same readout the
    direct path reports)."""
    R, t = T[:3, :3], T[:3, 3]
    G = _GEN.astype(R.dtype)
    S0, S1, S2, Y0, Y1 = mom["S0"], mom["S1"], mom["S2"], mom["Y0"], mom["Y1"]
    # First/second moments of the CURRENT p: W1[d] = sum w p_d M,
    # W2[d,e] = sum w p_d p_e M.
    RS1 = jnp.einsum("de,eab->dab", R, S1)
    W1 = RS1 + t[:, None, None] * S0
    RRS2 = jnp.einsum("df,eg,fgab->deab", R, R, S2)
    W2 = (
        RRS2
        + t[:, None, None, None] * RS1[None, :, :, :]
        + t[None, :, None, None] * RS1[:, None, :, :]
        + (t[:, None] * t[None, :])[:, :, None, None] * S0
    )
    Z1 = jnp.einsum("de,ea->da", R, Y1) + t[:, None] * Y0  # sum w p_d (M q)

    A_ot = jnp.einsum("dij,djk->ik", G, W1)  # sum w [p]x M
    A_oo = -jnp.einsum("dij,dejk,ekl->il", G, W2, G)
    A_tt = S0
    A = jnp.zeros((6, 6), R.dtype)
    A = A.at[:3, :3].set(A_oo)
    A = A.at[:3, 3:].set(A_ot)
    A = A.at[3:, :3].set(A_ot.T)
    A = A.at[3:, 3:].set(A_tt)

    u = jnp.einsum("bab->a", W1)  # sum w M p
    v2 = jnp.einsum("dbab->da", W2)  # v2[d] = sum w p_d (M p)
    b_o = -jnp.einsum("dij,dj->i", G, v2 - Z1)
    b_t = -(u - Y0)
    b = jnp.concatenate([b_o, b_t])

    # Weighted RMS |p - q|: |p|^2 = |p0|^2 + 2 t.(R p0) + |t|^2 and
    # p.q = q^T R p0 + t.q, where C_{ab} = sum w q_a p0_b gives
    # sum w q^T R p0 = sum_{ab} C_{ab} R_{ab}.
    n0 = jnp.maximum(mom["n0"], 1e-9)
    spp = mom["npp"] + 2.0 * jnp.dot(t, R @ mom["n1"]) + n0 * jnp.dot(t, t)
    spq = jnp.sum(mom["C"] * R) + jnp.dot(t, mom["nq"])
    r2 = spp - 2.0 * spq + mom["nqq"]
    resid = jnp.sqrt(jnp.maximum(r2, 0.0) / n0)
    return A, b, resid


def _hat(v):
    """Batched skew matrices ``[P, 3] -> [P, 3, 3]``."""
    z = jnp.zeros_like(v[:, 0])
    return jnp.stack(
        [
            jnp.stack([z, -v[:, 2], v[:, 1]], -1),
            jnp.stack([v[:, 2], z, -v[:, 0]], -1),
            jnp.stack([-v[:, 1], v[:, 0], z], -1),
        ],
        axis=-2,
    )


def _inv3x3(S):
    """Closed-form batched 3x3 inverse (adjugate / det) — elementwise only."""
    a, b_, c = S[:, 0, 0], S[:, 0, 1], S[:, 0, 2]
    d, e, f = S[:, 1, 0], S[:, 1, 1], S[:, 1, 2]
    g, h, i = S[:, 2, 0], S[:, 2, 1], S[:, 2, 2]
    A_ = e * i - f * h
    B_ = -(d * i - f * g)
    C_ = d * h - e * g
    det = a * A_ + b_ * B_ + c * C_
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1.0)
    adj = jnp.stack(
        [
            jnp.stack([A_, -(b_ * i - c * h), b_ * f - c * e], -1),
            jnp.stack([B_, a * i - c * g, -(a * f - c * d)], -1),
            jnp.stack([C_, -(a * h - b_ * g), a * e - b_ * d], -1),
        ],
        axis=-2,
    )
    return adj * inv_det[:, None, None]


def solve_spd_unrolled(A: jax.Array, b: jax.Array, damping: float = 1e-6) -> jax.Array:
    """Damped Cholesky solve of a small symmetric PSD system, FULLY UNROLLED.

    Inside a jitted ICP loop, LAPACK-style ops (eigh, LU, even
    ``jnp.linalg.solve``) on a 6x6 lower to sequential HLO loops (or a
    library call per iteration). A statically unrolled Cholesky is ~90
    scalar fused ops. Trace-scaled Tikhonov keeps
    near-singular systems tame (the reference's QR/SVD fallback territory).
    """
    n = A.shape[-1]
    tr = jnp.trace(A) / n
    lam = damping * jnp.maximum(tr, 1e-12)
    a = [[A[i, j] for j in range(n)] for i in range(n)]
    for i in range(n):
        a[i][i] = a[i][i] + lam
    # Cholesky: L lower-triangular with A = L L^T.
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][i] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    # Forward/back substitution.
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


def solve_normal_equations_fast(A: jax.Array, b: jax.Array, damping: float = 1e-6) -> jax.Array:
    """In-loop fast path: see :func:`solve_spd_unrolled`."""
    return solve_spd_unrolled(A, b, damping)


def solve_normal_equations(A: jax.Array, b: jax.Array, rcond: float = 1e-7) -> jax.Array:
    """Minimum-norm least-squares solve of symmetric ``A x = b``.

    Equivalent to the reference's double-precision Jacobi-SVD solve for
    symmetric PSD systems; eigenvalues below ``rcond * max_eig`` are treated
    as zero (rank-deficient => minimum-norm solution, the behaviour of the
    QR-rank fallback in ``PointToPlane.cpp:194-240``).
    """
    w, V = jnp.linalg.eigh(A)
    aw = jnp.abs(w)
    cutoff = rcond * jnp.max(aw, axis=-1, keepdims=True)
    inv_w = jnp.where(aw > cutoff, 1.0 / w, 0.0)
    return V @ (inv_w * (V.T @ b))


def solve_symmetric_indefinite(M: jax.Array, rhs: jax.Array, rcond: float = 1e-7) -> jax.Array:
    """Min-norm pseudo-solve for symmetric *indefinite* systems (the KKT
    matrix of the equality-constrained solve). Same eigh route —
    symmetric indefinite matrices diagonalize orthogonally too."""
    return solve_normal_equations(M, rhs, rcond)


def delta_transform_from_x(
    x: jax.Array, force_4dof: bool = False, force_2d: bool = False
) -> jax.Array:
    """Solved increment -> SE(3), using the reference's atan axis-angle
    reconstruction (``PointToPlane.cpp:340-370``)."""
    if force_2d:
        # 2-D branch (PointToPlane.cpp:388): raw Rotation2D(theta), z fixed.
        theta = x[..., 0]
        c, s = jnp.cos(theta), jnp.sin(theta)
        T = jnp.zeros(x.shape[:-1] + (4, 4), x.dtype)
        T = T.at[..., 0, 0].set(c)
        T = T.at[..., 0, 1].set(-s)
        T = T.at[..., 1, 0].set(s)
        T = T.at[..., 1, 1].set(c)
        T = T.at[..., 2, 2].set(1.0)
        T = T.at[..., 0, 3].set(x[..., 1])
        T = T.at[..., 1, 3].set(x[..., 2])
        T = T.at[..., 3, 3].set(1.0)
        return T
    if force_4dof:
        yaw = x[..., 0]
        zeros = jnp.zeros_like(yaw)
        omega = jnp.stack([zeros, zeros, yaw], axis=-1)
        R = se3.exp_so3(omega)
        T = jnp.zeros(x.shape[:-1] + (4, 4), x.dtype)
        T = T.at[..., :3, :3].set(R)
        T = T.at[..., :3, 3].set(x[..., 1:4])
        T = T.at[..., 3, 3].set(1.0)
        return T
    return se3.rigid_from_axis_angle_atan(x)


def point_to_point_transform(src_xyz, ref_xyz, weights, axis_name=None) -> jax.Array:
    """Weighted Kabsch/Umeyama closed-form rigid alignment p -> q.

    The reference's PointToPointErrorMinimizer (``PointToPoint.cpp``):
    cross-covariance SVD with det-correction, translation from weighted
    centroids. Returns ``[4, 4]``. With ``axis_name``, the point axis is
    sharded and all sums are psum-reduced.
    """

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    w = weights / jnp.maximum(allsum(jnp.sum(weights)), 1e-12)
    cp = allsum(jnp.einsum("p,pi->i", w, src_xyz))
    cq = allsum(jnp.einsum("p,pi->i", w, ref_xyz))
    P = src_xyz - cp
    Q = ref_xyz - cq
    H = allsum(jnp.einsum("p,pi,pj->ij", w, P, Q))
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0], H.dtype)).at[2, 2].set(d)
    R = Vt.T @ D @ U.T
    t = cq - R @ cp
    T = jnp.eye(4, dtype=src_xyz.dtype)
    T = T.at[:3, :3].set(R)
    T = T.at[:3, 3].set(t)
    return T


def point_to_point_similarity_transform(src_xyz, ref_xyz, weights):
    """PointToPointSimilarityErrorMinimizer: Umeyama with isotropic scale.
    Returns (``[4, 4]`` transform with scaled rotation, scale scalar)."""
    w = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    cp = jnp.einsum("p,pi->i", w, src_xyz)
    cq = jnp.einsum("p,pi->i", w, ref_xyz)
    P = src_xyz - cp
    Q = ref_xyz - cq
    H = jnp.einsum("p,pi,pj->ij", w, P, Q)
    U, S, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    ds = jnp.array([1.0, 1.0, 1.0], H.dtype).at[2].set(d)
    R = Vt.T @ jnp.diag(ds) @ U.T
    var_p = jnp.einsum("p,pi,pi->", w, P, P)
    scale = jnp.sum(S * ds) / jnp.maximum(var_p, 1e-12)
    T = jnp.eye(4, dtype=src_xyz.dtype)
    T = T.at[:3, :3].set(scale * R)
    T = T.at[:3, 3].set(cq - scale * (R @ cp))
    return T, scale
