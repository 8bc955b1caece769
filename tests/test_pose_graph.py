import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.slam import pose_graph as pg


def T_of(twist):
    return np.asarray(se3.exp_se3(jnp.asarray(twist, jnp.float32)))


def relative(Ta, Tb):
    return np.linalg.inv(Ta) @ Tb


@pytest.mark.slow
def test_chain_with_drift_and_loop_closure(rng):
    """Classic square loop: odometry drifts, loop closure snaps it shut."""
    n = 9
    # Ground truth: walk a square (8 steps of 1m, turning 90deg every 2).
    gt = [np.eye(4, dtype=np.float32)]
    step = T_of([0, 0, 0, 1, 0, 0])
    turn = T_of([0, 0, np.pi / 2, 1, 0, 0])
    for i in range(1, n):
        inc = turn if i % 2 == 0 else step
        gt.append((gt[-1] @ inc).astype(np.float32))

    # Odometry measurements with bias drift.
    drift = T_of([0, 0, 0.02, 0.02, 0.0, 0.0])
    builder = pg.PoseGraphBuilder(node_capacity=16, edge_capacity=32)
    est = [np.eye(4, dtype=np.float32)]
    meas = []
    for i in range(1, n):
        m = (relative(gt[i - 1], gt[i]) @ drift).astype(np.float32)
        meas.append(m)
        est.append((est[-1] @ m).astype(np.float32))
    for i, p in enumerate(est):
        builder.add_node(p)
    for i, m in enumerate(meas):
        builder.add_edge(i, i + 1, m)
    # Loop closure: node n-1 observes node 0 at the true relative pose.
    builder.add_edge(n - 1, 0, relative(gt[n - 1], gt[0]), is_loop=True)

    graph = builder.build()
    before = float(pg.chi2(graph))
    out = pg.optimize(graph, pg.PoseGraphConfig(iterations=20))
    after = float(pg.chi2(out))
    assert after < before * 0.5

    # Drifted endpoint error shrinks substantially after optimization.
    drift_before = np.linalg.norm(est[n - 1][:3, 3] - gt[n - 1][:3, 3])
    poses = np.asarray(out.poses)
    drift_after = np.linalg.norm(poses[n - 1][:3, 3] - gt[n - 1][:3, 3])
    assert drift_after < drift_before * 0.6, (drift_before, drift_after)
    # Gauge: node 0 pinned at identity.
    np.testing.assert_allclose(poses[0], np.eye(4), atol=1e-3)


def test_perfect_measurements_stay_put(rng):
    builder = pg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, 5):
        gt.append((gt[-1] @ T_of([0.01 * i, 0, 0.05, 1, 0.1, 0])).astype(np.float32))
    for p in gt:
        builder.add_node(p)
    for i in range(4):
        builder.add_edge(i, i + 1, relative(gt[i], gt[i + 1]))
    out = pg.optimize(builder.build(), pg.PoseGraphConfig(iterations=10))
    np.testing.assert_allclose(np.asarray(out.poses)[:5], np.stack(gt), atol=1e-3)


def test_robust_kernels_on_bad_loop(rng):
    """Kernel trade-off on a grossly wrong loop closure (node 5 claimed at
    node 0, 5 m violation): DCS REJECTS it outright (endpoint stays at its
    odometric position), huber — the round-5 default, because DCS also
    rejects GENUINE drift corrections (the EVAL_r04 null result) — merely
    downweights it; gross outliers are expected to die upstream at the
    drift-consistency gate (PlaceRecognition.cpp:182-229)."""
    def build():
        builder = pg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
        gt = [np.eye(4, dtype=np.float32)]
        for i in range(1, 6):
            gt.append((gt[-1] @ T_of([0, 0, 0, 1, 0, 0])).astype(np.float32))
        for p in gt:
            builder.add_node(p)
        for i in range(5):
            builder.add_edge(i, i + 1, relative(gt[i], gt[i + 1]))
        # Bogus loop closure claiming node 5 is at node 0.
        builder.add_edge(5, 0, np.eye(4, dtype=np.float32), is_loop=True)
        return builder.build()

    out = pg.optimize(build(), pg.PoseGraphConfig(
        iterations=15, huber_delta=0.5, robust_kernel="dcs"))
    assert np.asarray(out.poses)[5][0, 3] > 3.5  # DCS: outlier rejected

    out_h = pg.optimize(build(), pg.PoseGraphConfig(
        iterations=15, huber_delta=0.5))
    x5 = np.asarray(out_h.poses)[5][0, 3]
    assert 2.5 < x5 < 4.9, x5  # huber: bounded influence, not rejection


def test_huber_default_applies_genuine_drift_correction(rng):
    """The round-4 failure mode, pinned at the solver level: a loop edge
    contradicting a drifted chain MUST move the graph under the DEFAULT
    config (DCS silently rejected it: chi2 32 stayed 32)."""
    builder = pg.PoseGraphBuilder(node_capacity=8, edge_capacity=16)
    anchors = []
    for i in range(4):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 4.0 * i + (0.8 if i == 3 else 0.0)  # drifted chain end
        anchors.append(T)
        builder.add_node(T)
    for i in range(3):
        builder.add_edge(i, i + 1, relative(anchors[i], anchors[i + 1]))
    T_rel = np.eye(4, dtype=np.float32)
    T_rel[0, 3] = 12.0  # the TRUE relative pose node0 -> node3
    builder.add_edge(0, 3, T_rel, info=np.eye(6) * 50.0, is_loop=True)
    g = builder.build()
    out = pg.optimize(g, pg.PoseGraphConfig(iterations=30))
    x3 = float(np.asarray(out.poses)[3][0, 3])
    import dataclasses as _dc

    assert abs(x3 - 12.0) < 0.1, x3
    assert float(pg.chi2(_dc.replace(g, poses=out.poses))) < 1.0


def test_inactive_nodes_pinned(rng):
    builder = pg.PoseGraphBuilder(node_capacity=8, edge_capacity=8)
    builder.add_node(np.eye(4))
    builder.add_node(T_of([0, 0, 0, 1, 0, 0]))
    builder.add_edge(0, 1, T_of([0, 0, 0, 1.1, 0, 0]))
    out = pg.optimize(builder.build(), pg.PoseGraphConfig(iterations=5))
    poses = np.asarray(out.poses)
    # Unused capacity slots stay identity.
    np.testing.assert_allclose(poses[5], np.eye(4), atol=1e-4)
    assert np.all(np.isfinite(poses))


def _loop_graph(n, node_cap=None, edge_cap=None, n_loops=1, drift_rot=0.02,
                drift_trans=0.02, seed=0):
    """Drifting loop trajectory + loop closures (shared fixture builder)."""
    rng = np.random.default_rng(seed)
    gt = [np.eye(4, dtype=np.float32)]
    step = T_of([0, 0, 2 * np.pi / n, 0.4, 0, 0])
    for i in range(1, n):
        gt.append((gt[-1] @ step).astype(np.float32))
    drift = T_of([0, 0, drift_rot, drift_trans, 0, 0])
    builder = pg.PoseGraphBuilder(
        node_capacity=node_cap or n, edge_capacity=edge_cap or (n + n_loops)
    )
    est = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        m = (relative(gt[i - 1], gt[i]) @ drift).astype(np.float32)
        est.append((est[-1] @ m).astype(np.float32))
    for p in est:
        builder.add_node(p)
    for i in range(1, n):
        builder.add_edge(i - 1, i, relative(gt[i - 1], gt[i]) @ drift)
    for k in range(n_loops):
        i = int(rng.integers(0, n // 2))
        j = (i + n // 2) % n
        builder.add_edge(i, j, relative(gt[i], gt[j]), is_loop=True)
    return builder.build(), gt, est


def test_pcg_matches_dense(rng):
    """The block-sparse PCG solver must reproduce the dense-Cholesky result
    on the same graph (same GN iterations, tight CG tolerance)."""
    graph, gt, est = _loop_graph(24, n_loops=2)
    dense = pg.optimize(graph, pg.PoseGraphConfig(iterations=12, solver="dense"))
    pcg = pg.optimize(
        graph,
        pg.PoseGraphConfig(iterations=12, solver="pcg", cg_tol=1e-8, cg_iterations=400),
    )
    np.testing.assert_allclose(
        np.asarray(pcg.poses), np.asarray(dense.poses), atol=2e-3
    )
    assert float(pg.chi2(pcg)) <= float(pg.chi2(dense)) * 1.2 + 1e-6


@pytest.mark.slow
def test_pcg_large_graph_converges(rng):
    """1024-node / ~4096-edge graph (the scalable-solver acceptance config):
    PCG drives the drifted trajectory back to ground truth on device. A
    dense [6144 x 6144] factorization is the O(K^3) path this replaces."""
    n = 1024
    rng2 = np.random.default_rng(3)
    # Mild per-step drift: large graphs accumulate it into metres of
    # endpoint error while loop residuals stay inside the robust kernel's
    # acceptance region (a gross systematic drift would push consistent
    # loops into DCS's rejection zone — the kernel working as designed).
    graph, gt, est = _loop_graph(
        n, edge_cap=4352, n_loops=64, drift_rot=3e-4, drift_trans=2e-3, seed=3
    )
    # Densify with random consistent (non-loop-flagged) constraints up to
    # ~4096 edges to exercise the off-diagonal scatter at target scale.
    import dataclasses as dc

    extra = 4096 - (n - 1) - 64
    ei = np.asarray(graph.edge_i).copy()
    ej = np.asarray(graph.edge_j).copy()
    eT = np.asarray(graph.edge_T).copy()
    eloop = np.asarray(graph.edge_is_loop).copy()
    emask = np.asarray(graph.edge_mask).copy()
    base = n - 1 + 64
    for k in range(extra):
        i = int(rng2.integers(0, n - 8))
        j = i + int(rng2.integers(2, 8))
        ei[base + k], ej[base + k] = i, j
        eT[base + k] = relative(gt[i], gt[j])
        eloop[base + k] = False
        emask[base + k] = True
    graph = dc.replace(
        graph,
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej), edge_T=jnp.asarray(eT),
        edge_is_loop=jnp.asarray(eloop), edge_mask=jnp.asarray(emask),
    )
    assert int(np.sum(emask)) == 4096
    out = pg.optimize(
        graph, pg.PoseGraphConfig(iterations=15, solver="pcg", huber_delta=50.0)
    )
    poses = np.asarray(out.poses)
    # Endpoint drift largely removed.
    drift_before = np.linalg.norm(est[n - 1][:3, 3] - gt[n - 1][:3, 3])
    drift_after = np.linalg.norm(poses[n - 1][:3, 3] - gt[n - 1][:3, 3])
    assert drift_after < drift_before * 0.2, (drift_before, drift_after)
    assert float(pg.chi2(out)) < float(pg.chi2(graph)) * 0.1


def test_auto_solver_selects_by_size(rng):
    """'auto' uses dense below the node threshold and PCG above — both must
    produce a consistent optimum on the same small graph."""
    graph, _, _ = _loop_graph(12)
    lo = pg.optimize(graph, pg.PoseGraphConfig(iterations=10, solver="auto", auto_pcg_nodes=4096))
    hi = pg.optimize(graph, pg.PoseGraphConfig(iterations=10, solver="auto", auto_pcg_nodes=1))
    np.testing.assert_allclose(np.asarray(lo.poses), np.asarray(hi.poses), atol=2e-3)
