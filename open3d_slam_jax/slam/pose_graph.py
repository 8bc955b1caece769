"""On-device pose-graph optimization.

On-device replacement for the reference's ``OptimizationProblem``
(``OptimizationProblem.cpp``), which delegates to Open3D's CPU
``GlobalOptimization`` (Levenberg-Marquardt). Here the whole solver is one
jitted Gauss-Newton/LM loop:

- nodes: fixed-capacity ``[K, 4, 4]`` submap poses + validity mask;
- edges: fixed-capacity arrays (i, j, measured relative pose, 6x6
  information, loop-closure flag, validity) — odometry edges certain,
  loop-closure edges robustified by Huber (≙ the certain/uncertain edge
  split at ``OptimizationProblem.cpp:50-121``);
- residual per edge: ``log(T_meas^-1 (T_i^-1 T_j))`` with exact per-edge
  Jacobians from forward-mode AD (vmapped);
- two linear solvers per GN iteration, chosen by config (``solver``):
  * ``dense``: scatter-add into a dense ``6K x 6K`` Hessian + Cholesky —
    wins for small K (one big dense factorization);
  * ``pcg``: 6x6-BLOCK-SPARSE normal equations — block-diagonal ``[K,6,6]``
    + per-edge off-diagonal ``[E,6,6]`` blocks assembled by segment-sum,
    solved by preconditioned conjugate gradients with a block-Jacobi
    preconditioner (batched 6x6 inverses). O(E) memory and O(E·36) per
    matvec instead of O(K²) memory / O(K³) factorization — the scalable
    path for the reference's own 500-submap graphs
    (``SubmapCollection.cpp:29``) and beyond (``OptimizationProblem.cpp:
    25-121`` delegates to Open3D's sparse LM for the same reason);
- gauge: strong prior pinning node 0;
- multi-host: shard the edge arrays and psum the assembled blocks (dense:
  (H, g); pcg: (D, g) once per GN iteration + the off-diagonal scatter per
  matvec) — the multi-device configuration (``axis_name``,
  :func:`optimize_edge_sharded`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Fixed-capacity pose graph state."""

    poses: jax.Array  # [K, 4, 4]
    node_mask: jax.Array  # [K]
    edge_i: jax.Array  # [E] int32
    edge_j: jax.Array  # [E] int32
    edge_T: jax.Array  # [E, 4, 4] measured i_T_j
    edge_info: jax.Array  # [E, 6, 6] information matrices
    edge_is_loop: jax.Array  # [E] bool
    edge_mask: jax.Array  # [E] bool


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iterations: int = 15
    # LM lambda (scaled by diag). Small: heavier damping over-relaxes the
    # soft modes of loopy graphs into slow geometric step decay (measured:
    # 1e-4 converges to a 0.3% WORSE cost and needs 3x the iterations).
    damping: float = 1e-6
    # Robust kernel on loop-closure edges: "huber" | "dcs" | "none".
    # DEFAULT CHANGED round 5 (dcs -> huber): DCS drives the weight of any
    # strongly-violated constraint to ~0, so a single genuinely-drifted
    # loop closure — the one measurement the subsystem exists to apply —
    # produces a near-zero gradient and the graph never moves (the EVAL_r04
    # protocol-4 null result reduced to a 4-node unit test:
    # tests/test_realtime.py::test_pose_graph_solve_applies_nonzero_increment;
    # chi2 32 held at 32 under dcs, converges to 0.2 under huber). Gross
    # outliers are instead rejected UPSTREAM by the reference's
    # drift-consistency gate (PlaceRecognition.cpp:182-229); DCS remains
    # available for many-redundant-loop workloads.
    robust_kernel: str = "huber"
    huber_delta: float = 1.0  # kernel scale on loop-closure residual norm
    gauge_weight: float = 1e6
    # Linear solver: "dense" (6K x 6K Cholesky), "pcg" (block-sparse
    # preconditioned CG), or "auto" (pcg above auto_pcg_nodes).
    solver: str = "auto"
    auto_pcg_nodes: int = 128
    # PCG controls: iteration cap and relative-residual tolerance. A
    # block-Jacobi-preconditioned pose graph typically converges in a few
    # dozen iterations; the while_loop exits early at tolerance.
    cg_iterations: int = 100
    cg_tol: float = 1e-5
    # PCG preconditioner: "tridiag" solves the graph's block-tridiagonal
    # chain part exactly per CG iteration via cyclic reduction (log2 K
    # batched levels); "jacobi" = batched 6x6 block-diagonal inverses.
    # DEFAULT CHANGED round 5 (tridiag -> jacobi): measured same-process on
    # 1024-node/4095-edge graphs (tools/probe_r5_pg.py), jacobi reaches the
    # IDENTICAL converged chi2 at 30.9 vs 24.6 solves/s (bench graph) and
    # 18.7 vs 14.7 (long-loop-heavy graph) — the cyclic-reduction apply's
    # log2(K) sequential 6x6 levels cost more per CG iteration than the
    # extra CG iterations jacobi needs under the cg_tol early exit.
    # KNOWN ISSUE (tridiag only): the cyclic-reduction upward
    # reconstruction mis-shapes for node capacities whose reduction levels
    # go odd (e.g. K=33); power-of-two capacities (the production configs)
    # are unaffected. Pad node_capacity to a power of two when selecting
    # tridiag explicitly.
    pcg_precond: str = "jacobi"
    # GN-level early exit (≙ Open3D GlobalOptimizationConvergenceCriteria:
    # the reference's LM stops on relative cost decrease): stop when the
    # edge cost improves by less than gn_rel_tol relatively OR the RMS
    # per-DoF update norm falls below gn_step_tol. `iterations` stays the
    # hard cap. 0 disables (fixed-iteration scan, the round-2 behavior).
    gn_rel_tol: float = 1e-4
    gn_step_tol: float = 1e-6
    # First-order optimality exit: stop when the gradient infinity norm
    # falls below gn_grad_tol x its value at the initial linearization.
    # The dominant early-exit in practice — the gradient drops ~4 orders in
    # the first two GN iterations while the remaining "progress" is
    # zero-gradient soft-mode sliding at the float32 cost noise floor.
    gn_grad_tol: float = 1e-3
    # Gradient-plateau exit: after substantial first-order progress
    # (ginf < 0.05 g0), stop when the gradient stops decreasing
    # (ginf > plateau_ratio x previous) — the solver has hit its numeric /
    # CG-inexactness floor. Handles warm starts where g0 itself is small.
    gn_plateau_ratio: float = 0.5
    # Both gradient exits are gated on the cost ALSO having coarsely
    # plateaued (rel decrease < gn_rel_coarse): on large-error graphs the
    # first GN step slashes the gradient by orders of magnitude while the
    # cost is still falling fast — exiting there would leave metres of
    # unrecovered drift.
    gn_rel_coarse: float = 1e-2


def empty_graph(num_nodes: int, num_edges: int, dtype=jnp.float32) -> PoseGraph:
    return PoseGraph(
        poses=jnp.broadcast_to(jnp.eye(4, dtype=dtype), (num_nodes, 4, 4)),
        node_mask=jnp.zeros((num_nodes,), bool),
        edge_i=jnp.zeros((num_edges,), jnp.int32),
        edge_j=jnp.zeros((num_edges,), jnp.int32),
        edge_T=jnp.broadcast_to(jnp.eye(4, dtype=dtype), (num_edges, 4, 4)),
        edge_info=jnp.broadcast_to(jnp.eye(6, dtype=dtype), (num_edges, 6, 6)),
        edge_is_loop=jnp.zeros((num_edges,), bool),
        edge_mask=jnp.zeros((num_edges,), bool),
    )


def _edge_residual(T_i, T_j, T_meas, xi_i, xi_j):
    """r(xi) = log( T_meas^-1 (T_i exp(xi_i))^-1 (T_j exp(xi_j)) )."""
    Ti = T_i @ se3.exp_se3(xi_i)
    Tj = T_j @ se3.exp_se3(xi_j)
    rel = se3.transform_inverse(Ti) @ Tj
    return se3.log_se3(se3.transform_inverse(T_meas) @ rel)


def _edge_terms(T_i, T_j, T_meas):
    """Residual at xi=0 and Jacobians wrt xi_i, xi_j (forward-mode AD)."""
    zero = jnp.zeros((6,), T_i.dtype)
    r = _edge_residual(T_i, T_j, T_meas, zero, zero)
    Ji = jax.jacfwd(lambda a: _edge_residual(T_i, T_j, T_meas, a, zero))(zero)
    Jj = jax.jacfwd(lambda b: _edge_residual(T_i, T_j, T_meas, zero, b))(zero)
    return r, Ji, Jj


def _robust_weight(r, info, is_loop, delta, kernel: str):
    """IRLS weight on the Mahalanobis norm of loop-closure residuals.

    "dcs" (Dynamic Covariance Scaling, Agarwal et al. 2013): the standard
    gross-outlier rejector for wrong loop closures — ``min(1, 2d^2/(d^2+X^2))
    squared``; unlike Huber it drives the weight to ~0 for large residuals,
    so a bogus loop cannot collapse a consistent chain (the failure mode the
    reference avoids by Open3D's edge pruning).
    """
    m2 = jnp.einsum("i,ij,j->", r, info, r)
    if kernel == "none":
        return jnp.ones(())
    if kernel == "huber":
        m = jnp.sqrt(jnp.maximum(m2, 1e-12))
        w = jnp.where(m <= delta, 1.0, delta / m)
    elif kernel == "dcs":
        d2 = delta * delta
        s = jnp.minimum(1.0, 2.0 * d2 / (d2 + m2))
        w = s * s
    else:
        raise ValueError(f"unknown robust kernel: {kernel}")
    return jnp.where(is_loop, w, 1.0)


# ---------------------------------------------------------------------------
# Block-tridiagonal cyclic reduction (the chain preconditioner).
#
# A pose graph always contains the odometry chain (consecutive submap
# edges); its block-tridiagonal Hessian part T is SPD (chain edges
# contribute full PSD 2x2-block pairs, other edges only their PSD diagonal
# blocks, damping makes it definite). Solving T z = r exactly via cyclic
# reduction — log2(K) levels of BATCHED 6x6 eliminations, each level
# halving the system — gives a preconditioner under which CG converges in
# O(#off-chain edges^0.5)-ish iterations instead of O(K) (block-Jacobi
# propagates information ONE hop per iteration along the chain; CR
# propagates it globally). This is the on-device answer to the
# reference's sparse CPU factorization (Open3D LM inside
# OptimizationProblem.cpp:25-44).
# ---------------------------------------------------------------------------


def _cr_factor(D, C):
    """Factor the block tridiagonal (D [K,6,6] diagonal, C [K,6,6] upper
    off-diagonal: C[k] couples k and k+1, C[K-1] must be zero) into
    per-level elimination operators. Returns a tuple-tree of static-shape
    arrays (jit-friendly)."""
    levels = []
    B, Cc = D, C
    n = B.shape[0]
    while n > 1:
        if n % 2:
            # Pad to even with an identity block decoupled from the rest.
            B = jnp.concatenate([B, jnp.eye(6, dtype=B.dtype)[None]], axis=0)
            Cc = jnp.concatenate([Cc, jnp.zeros((1, 6, 6), B.dtype)], axis=0)
            n += 1
        Bo = B[1::2]  # odd blocks (eliminated)
        Be = B[0::2]
        C_even = Cc[0::2]  # C_{2p}: couples even 2p -> odd 2p+1
        C_odd = Cc[1::2]  # C_{2p+1}: couples odd 2p+1 -> even 2p+2
        Binv = jnp.linalg.inv(Bo)
        # L_p = C_{2p-1}^T B_{2p-1}^{-1} (left neighbor of even 2p), 0 at p=0.
        C_odd_m1 = jnp.concatenate([jnp.zeros((1, 6, 6), B.dtype), C_odd[:-1]], axis=0)
        Binv_m1 = jnp.concatenate([jnp.zeros((1, 6, 6), B.dtype), Binv[:-1]], axis=0)
        L = jnp.einsum("pba,pbc->pac", C_odd_m1, Binv_m1)
        # R_p = C_{2p} B_{2p+1}^{-1} (right neighbor), rows beyond the odd
        # count are zero because C_even is zero there.
        m = Bo.shape[0]
        R = jnp.einsum("pab,pbc->pac", C_even[:m], Binv)
        R = jnp.concatenate([R, jnp.zeros((Be.shape[0] - m, 6, 6), B.dtype)], axis=0)
        C_even_pad = jnp.concatenate(
            [C_even[:m], jnp.zeros((Be.shape[0] - m, 6, 6), B.dtype)], 0
        )
        # B'_p = B_{2p} - L_p C_{2p-1} - R_p C_{2p}^T.
        B_new = (
            Be
            - jnp.einsum("pab,pbc->pac", L, C_odd_m1)
            - jnp.einsum("pab,pcb->pac", R, C_even_pad)
        )
        # C'_p = -C_{2p} B_{2p+1}^{-1} C_{2p+1} = -R_p C_{2p+1}.
        C_new = -jnp.einsum(
            "pab,pbc->pac", R,
            jnp.concatenate([C_odd, jnp.zeros((Be.shape[0] - m, 6, 6), B.dtype)], 0),
        )
        # The last even block must not couple beyond the end.
        C_new = C_new.at[-1].set(jnp.zeros((6, 6), B.dtype))
        levels.append((L, R, Binv, C_even[:m], C_odd[:m]))
        B, Cc = B_new, C_new
        n = B.shape[0]
    root_inv = jnp.linalg.inv(B[0])
    return tuple(levels), root_inv


def _cr_solve(fact, f):
    """Solve T x = f with the cyclic-reduction factorization."""
    levels, root_inv = fact
    f_odds = []
    for L, R, Binv, C_even, C_odd in levels:
        n = f.shape[0]
        if n % 2:
            f = jnp.concatenate([f, jnp.zeros((1, 6), f.dtype)], axis=0)
        fo = f[1::2]
        fe = f[0::2]
        fo_m1 = jnp.concatenate([jnp.zeros((1, 6), f.dtype), fo[:-1]], axis=0)
        m = fo.shape[0]
        fo_pad = jnp.concatenate([fo, jnp.zeros((fe.shape[0] - m, 6), f.dtype)], axis=0)
        f = fe - jnp.einsum("pab,pb->pa", L, fo_m1) - jnp.einsum(
            "pab,pb->pa", R, fo_pad
        )
        f_odds.append(fo)
    x = jnp.einsum("ab,b->a", root_inv, f[0])[None]
    for (L, R, Binv, C_even, C_odd), fo in zip(reversed(levels), reversed(f_odds)):
        m = fo.shape[0]
        xe = x  # even solution at this level
        xe_q = xe[:m]
        xe_q1 = jnp.concatenate([xe[1 : m + 1], jnp.zeros((max(0, m + 1 - xe.shape[0]), 6), x.dtype)], axis=0)
        xo = jnp.einsum(
            "qab,qb->qa",
            Binv,
            fo
            - jnp.einsum("qba,qb->qa", C_even, xe_q)
            - jnp.einsum("qab,qb->qa", C_odd, xe_q1),
        )
        n_full = xe.shape[0] + m
        x_full = jnp.zeros((n_full, 6), x.dtype)
        x_full = x_full.at[0::2].set(xe)
        x_full = x_full.at[1::2].set(xo)
        x = x_full
    return x


@functools.partial(jax.jit, static_argnames=("cfg", "axis_name"))
def optimize(
    graph: PoseGraph,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    axis_name: Optional[str] = None,
) -> PoseGraph:
    """Run GN/LM; returns the graph with optimized poses.

    With ``axis_name`` (inside shard_map), edge arrays are shard-local and
    (H, g) are psum-reduced; poses are replicated.
    """
    K = graph.poses.shape[0]
    dtype = graph.poses.dtype
    use_pcg = cfg.solver == "pcg" or (cfg.solver == "auto" and K >= cfg.auto_pcg_nodes)

    def allsum(v):
        return jax.lax.psum(v, axis_name) if axis_name is not None else v

    # One-hot edge->node matrices: every edge->node reduction below is an
    # [E, K]^T x [E, ...] matmul instead of a scatter-add. O(K*E) work, a
    # workaround for slow scatter-adds on the first target; unmeasured on
    # the H100 against segment_sum (ROADMAP speed 11). Padded
    # edges point at node 0 but carry zero blocks (w = 0), so they
    # contribute nothing.
    onehot_i = jax.nn.one_hot(graph.edge_i, K, dtype=dtype)
    onehot_j = jax.nn.one_hot(graph.edge_j, K, dtype=dtype)

    def edge_blocks(poses):
        """Per-edge GN blocks (shared by both solvers)."""
        Ti = poses[graph.edge_i]
        Tj = poses[graph.edge_j]
        r, Ji, Jj = jax.vmap(_edge_terms)(Ti, Tj, graph.edge_T)
        w_h = jax.vmap(_robust_weight, in_axes=(0, 0, 0, None, None))(
            r, graph.edge_info, graph.edge_is_loop, cfg.huber_delta, cfg.robust_kernel
        )
        w = w_h * graph.edge_mask.astype(dtype)
        Wi = graph.edge_info * w[:, None, None]  # [E, 6, 6]

        JiW = jnp.einsum("eab,ebc->eac", jnp.swapaxes(Ji, 1, 2), Wi)
        JjW = jnp.einsum("eab,ebc->eac", jnp.swapaxes(Jj, 1, 2), Wi)
        Hii = JiW @ Ji
        Hij = JiW @ Jj
        Hjj = JjW @ Jj
        gi = jnp.einsum("eab,eb->ea", JiW, r)
        gj = jnp.einsum("eab,eb->ea", JjW, r)
        # psum: the cost drives the GN early exit, whose trip count must be
        # identical on every shard (a shard-local cost would deadlock the
        # collectives inside the loop).
        cost = allsum(jnp.sum(w * jnp.einsum("ei,eij,ej->e", r, graph.edge_info, r)))
        return Hii, Hij, Hjj, gi, gj, cost

    def diag_extra(D_diag, lam):
        """Gauge prior on node 0 + inactive-node pinning + LM damping, as
        the [K, 6] addition to the block diagonal's diagonal. ``lam`` is
        the ADAPTIVE damping (starts at cfg.damping; raised on rejected
        steps — see the accept/reject loop below)."""
        gauge = jnp.zeros((K, 6), dtype).at[0, :].set(cfg.gauge_weight)
        inactive = (~graph.node_mask).astype(dtype)[:, None] * cfg.gauge_weight
        damp = lam * (D_diag + 1.0)
        return gauge + inactive + damp

    def gn_iter_dense(poses, lam):
        Hii, Hij, Hjj, gi, gj, cost = edge_blocks(poses)
        Hji = jnp.swapaxes(Hij, 1, 2)
        # Assemble in the [K, 6, K, 6] layout (reshape to [6K, 6K] is free)
        # via one-hot contractions: H[k,a,l,b] = sum_e oh_i[e,k] oh_i[e,l]
        # Hii[e,a,b] + ... Each term is one einsum.
        H = (
            jnp.einsum("ek,el,eab->kalb", onehot_i, onehot_i, Hii)
            + jnp.einsum("ek,el,eab->kalb", onehot_i, onehot_j, Hij)
            + jnp.einsum("ek,el,eab->kalb", onehot_j, onehot_i, Hji)
            + jnp.einsum("ek,el,eab->kalb", onehot_j, onehot_j, Hjj)
        )
        g = jnp.einsum("ek,ea->ka", onehot_i, gi) + jnp.einsum(
            "ek,ea->ka", onehot_j, gj
        )

        H = allsum(H)
        g = allsum(g)
        ginf = jnp.max(jnp.abs(g))

        Hd = H.reshape(6 * K, 6 * K)
        gd = g.reshape(6 * K)

        diag_idx = jnp.arange(6 * K)
        extra = diag_extra(jnp.diagonal(Hd).reshape(K, 6), lam).reshape(-1)
        Hd = Hd.at[diag_idx, diag_idx].add(extra)

        # Hd is SPD (gauge + inactive pinning + LM damping on the diagonal),
        # so Cholesky + triangular solves replace LU-with-pivoting.
        L = jnp.linalg.cholesky(Hd)
        y = jax.scipy.linalg.solve_triangular(L, gd, lower=True)
        dx = -jax.scipy.linalg.solve_triangular(L, y, lower=True, trans=1).reshape(K, 6)
        new_poses = poses @ se3.exp_se3(dx)
        return new_poses, cost, jnp.sum(dx * dx), ginf

    def gn_iter_pcg(poses, lam):
        Hii, Hij, Hjj, gi, gj, cost = edge_blocks(poses)
        # Block diagonal [K, 6, 6] + gradient [K, 6] by one-hot matmul; one
        # psum per GN iteration when edges are sharded.
        D = jnp.einsum("ek,eab->kab", onehot_i, Hii) + jnp.einsum(
            "ek,eab->kab", onehot_j, Hjj
        )
        g = jnp.einsum("ek,ea->ka", onehot_i, gi) + jnp.einsum(
            "ek,ea->ka", onehot_j, gj
        )
        D = allsum(D)
        g = allsum(g)
        ginf = jnp.max(jnp.abs(g))

        d6 = jnp.arange(6)
        D = D.at[:, d6, d6].add(diag_extra(D[:, d6, d6], lam))

        if cfg.pcg_precond == "tridiag":
            # Chain (block-tridiagonal) preconditioner: extract the
            # consecutive-node off-diagonal blocks and factor T = (D, C)
            # once per GN iteration by cyclic reduction.
            chain_up = (graph.edge_j == graph.edge_i + 1) & graph.edge_mask
            chain_dn = (graph.edge_i == graph.edge_j + 1) & graph.edge_mask
            C = jnp.einsum(
                "ek,eab->kab",
                onehot_i * chain_up[:, None].astype(dtype),
                Hij,
            ) + jnp.einsum(
                "ek,eab->kab",
                onehot_j * chain_dn[:, None].astype(dtype),
                jnp.swapaxes(Hij, 1, 2),
            )
            C = allsum(C)
            C = C.at[K - 1].set(jnp.zeros((6, 6), dtype))
            fact = _cr_factor(D, C)

            def precond(r):
                return _cr_solve(fact, r)[:K]

        elif cfg.pcg_precond == "jacobi":
            # Block-Jacobi: batched 6x6 inverses of the damped diagonal.
            Minv = jnp.linalg.inv(D)

            def precond(r):
                return jnp.einsum("kab,kb->ka", Minv, r)

        else:
            raise ValueError(f"unknown pcg_precond {cfg.pcg_precond!r}")

        def matvec(x):
            y = jnp.einsum("kab,kb->ka", D, x)
            off = jnp.einsum(
                "ek,ea->ka", onehot_i, jnp.einsum("eab,eb->ea", Hij, x[graph.edge_j])
            ) + jnp.einsum(
                "ek,ea->ka",
                onehot_j,
                jnp.einsum("eab,ea->eb", Hij, x[graph.edge_i]),  # Hij^T x_i
            )
            return y + allsum(off)

        # PCG on H dx = -g, x0 = 0.
        b = -g
        b2 = jnp.sum(b * b)
        tol2 = (cfg.cg_tol**2) * b2

        z0 = precond(b)
        state0 = (
            jnp.asarray(0, jnp.int32),
            jnp.zeros((K, 6), dtype),  # x
            b,  # r
            z0,  # z
            z0,  # p
            jnp.sum(b * z0),  # rz
            b2,  # r2
        )

        def cg_cond(st):
            i, _, _, _, _, _, r2 = st
            return (i < cfg.cg_iterations) & (r2 > tol2)

        def cg_body(st):
            i, x, r, z, p, rz, _ = st
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = jnp.sum(r * z)
            beta = rz_new / jnp.maximum(rz, 1e-30)
            p = z + beta * p
            return (i + 1, x, r, z, p, rz_new, jnp.sum(r * r))

        _, dx, *_ = jax.lax.while_loop(cg_cond, cg_body, state0)
        new_poses = poses @ se3.exp_se3(dx)
        return new_poses, cost, jnp.sum(dx * dx), ginf

    gn_iter = gn_iter_pcg if use_pcg else gn_iter_dense

    # Deferred-reject Levenberg-Marquardt (one blocks-eval per iteration):
    # each iteration evaluates the cost at the CURRENT poses (free — the
    # same linearization that produces the step) and compares it against
    # the best cost seen. An improvement accepts the PREVIOUS step and
    # lowers the damping; a regression restarts from the best poses with
    # raised damping. Well-conditioned graphs accept every step, so lam
    # stays at cfg.damping and behavior matches plain GN; graphs with
    # multi-metre loop residuals (where fixed-damping GN oscillates and
    # chi2 can grow — the realtime corridor protocol's failure mode) get
    # true LM control. Returns the best-cost poses.
    lam0 = jnp.asarray(cfg.damping, dtype)

    def lm_step(cur, best, cost_best, lam, it, g0, prev_ginf):
        new_poses, cost_cur, step2, ginf = gn_iter(cur, lam)
        improved = cost_cur < cost_best
        best_n = jnp.where(improved, cur, best)
        cost_best_n = jnp.minimum(cost_cur, cost_best)
        lam_n = jnp.where(
            improved,
            jnp.maximum(lam * 0.5, cfg.damping),
            jnp.minimum(lam * 8.0, 1e5),
        )
        cur_n = jnp.where(improved, new_poses, best_n)
        g0 = jnp.where(it == 0, jnp.maximum(ginf, 1e-20), g0)
        rel = jnp.abs(cost_best - cost_cur) / jnp.maximum(jnp.abs(cost_best), 1e-20)
        n_dof = 6.0 * jnp.maximum(jnp.sum(graph.node_mask.astype(dtype)), 1.0)
        cost_coarse_flat = rel < cfg.gn_rel_coarse
        done = improved & (
            (rel < cfg.gn_rel_tol)
            | (step2 / n_dof < cfg.gn_step_tol**2)
            | (cost_coarse_flat & (it > 0) & (ginf < cfg.gn_grad_tol * g0))
            | (
                cost_coarse_flat
                & (it > 1)
                & (ginf < 0.05 * g0)
                & (ginf > cfg.gn_plateau_ratio * prev_ginf)
            )
        )
        return cur_n, best_n, cost_best_n, lam_n, g0, ginf, done

    init = (
        graph.poses,  # cur
        graph.poses,  # best
        jnp.asarray(jnp.inf, dtype),  # cost_best
        lam0,
        jnp.asarray(0, jnp.int32),  # it
        jnp.asarray(0.0, dtype),  # g0
        jnp.asarray(jnp.inf, dtype),  # prev_ginf
        jnp.asarray(False),  # done
    )

    if cfg.gn_rel_tol <= 0:
        # Fixed-iteration scan (reference-exact cadence), same LM control.
        def scan_body(st, _):
            cur, best, cost_best, lam, it, g0, pginf, _ = st
            cur, best, cost_best, lam, g0, ginf, _ = lm_step(
                cur, best, cost_best, lam, it, g0, pginf
            )
            return (cur, best, cost_best, lam, it + 1, g0, ginf, False), None

        st, _ = jax.lax.scan(scan_body, init, None, length=cfg.iterations)
        cur, best, cost_best = st[0], st[1], st[2]
    else:
        # GN-level early exit (≙ Open3D's LM convergence criteria): most
        # graphs converge in a handful of iterations; paying the full cap
        # every solve dominates the wall cost otherwise.
        def gn_cond(st):
            it, done = st[4], st[7]
            return (it < cfg.iterations) & ~done

        def gn_body(st):
            cur, best, cost_best, lam, it, g0, pginf, _ = st
            cur, best, cost_best, lam, g0, ginf, done = lm_step(
                cur, best, cost_best, lam, it, g0, pginf
            )
            return (cur, best, cost_best, lam, it + 1, g0, ginf, done)

        st = jax.lax.while_loop(gn_cond, gn_body, init)
        cur, best, cost_best = st[0], st[1], st[2]
    # ``cur`` holds the last proposed step whose cost was never evaluated;
    # ``best`` is the lowest-cost iterate. Prefer ``cur`` only when it was
    # just accepted (it extends best); evaluating it costs one more pass —
    # instead return best unless no step was ever accepted.
    poses = jnp.where(jnp.isfinite(cost_best), best, graph.poses)
    return dataclasses.replace(graph, poses=poses)


def optimize_edge_sharded(graph: PoseGraph, cfg: PoseGraphConfig, mesh) -> PoseGraph:
    """:func:`optimize` with the edge arrays split over every axis of
    ``mesh`` (the edge capacity must divide by its device count); (H, g)
    are psum-reduced and the poses stay replicated."""
    from jax.sharding import PartitionSpec as P

    axes = tuple(mesh.axis_names)
    e = P(axes)
    spec = PoseGraph(
        poses=P(), node_mask=P(), edge_i=e, edge_j=e, edge_T=e,
        edge_info=e, edge_is_loop=e, edge_mask=e,
    )
    run = jax.jit(jax.shard_map(
        lambda g: optimize(g, cfg, axis_name=axes).poses,
        mesh=mesh, in_specs=(spec,), out_specs=P(), check_vma=False,
    ))
    return dataclasses.replace(graph, poses=run(graph))


def chi2(graph: PoseGraph) -> jax.Array:
    """Total weighted squared error of active edges (diagnostic)."""
    Ti = graph.poses[graph.edge_i]
    Tj = graph.poses[graph.edge_j]
    zero = jnp.zeros((graph.edge_i.shape[0], 6), graph.poses.dtype)
    r = jax.vmap(_edge_residual)(Ti, Tj, graph.edge_T, zero, zero)
    m2 = jnp.einsum("ei,eij,ej->e", r, graph.edge_info, r)
    return jnp.sum(jnp.where(graph.edge_mask, m2, 0.0))


# ---------------------------------------------------------------------------
# Host-side graph builder (≙ OptimizationProblem's edge bookkeeping).
# ---------------------------------------------------------------------------


class PoseGraphBuilder:
    """Accumulates nodes/edges on host, exports a device PoseGraph."""

    def __init__(self, node_capacity: int = 128, edge_capacity: int = 512):
        import numpy as np

        self.K = node_capacity
        self.E = edge_capacity
        self._np = np
        self.poses = np.tile(np.eye(4, dtype=np.float32), (node_capacity, 1, 1))
        self.node_count = 0
        self.edges = []

    def add_node(self, pose) -> int:
        if self.node_count >= self.K:
            raise ValueError("node capacity exceeded")
        self.poses[self.node_count] = self._np.asarray(pose, self._np.float32)
        self.node_count += 1
        return self.node_count - 1

    def add_edge(self, i: int, j: int, T_meas, info=None, is_loop=False) -> None:
        if len(self.edges) >= self.E:
            raise ValueError("edge capacity exceeded")
        info = self._np.eye(6, dtype=self._np.float32) if info is None else info
        self.edges.append((i, j, self._np.asarray(T_meas, self._np.float32), info, is_loop))

    def build(self) -> PoseGraph:
        np = self._np
        g = empty_graph(self.K, self.E)
        ei = np.zeros(self.E, np.int32)
        ej = np.zeros(self.E, np.int32)
        eT = np.tile(np.eye(4, dtype=np.float32), (self.E, 1, 1))
        einfo = np.tile(np.eye(6, dtype=np.float32), (self.E, 1, 1))
        eloop = np.zeros(self.E, bool)
        emask = np.zeros(self.E, bool)
        for n, (i, j, T, info, is_loop) in enumerate(self.edges):
            ei[n], ej[n], eT[n], einfo[n], eloop[n], emask[n] = i, j, T, info, is_loop, True
        nmask = np.zeros(self.K, bool)
        nmask[: self.node_count] = True
        return dataclasses.replace(
            g,
            poses=jnp.asarray(self.poses),
            node_mask=jnp.asarray(nmask),
            edge_i=jnp.asarray(ei),
            edge_j=jnp.asarray(ej),
            edge_T=jnp.asarray(eT),
            edge_info=jnp.asarray(einfo),
            edge_is_loop=jnp.asarray(eloop),
            edge_mask=jnp.asarray(emask),
        )
