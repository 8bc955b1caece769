"""Multi-session merge: coarse alignment, concurrent inter-session submap
registration, joint pose-graph GN, rigid re-anchoring (BASELINE workload
"multi-session mapping"; composes reference capabilities SlamWrapper.cpp:
421-432 setInitialMap + OptimizationProblem.cpp pose graph)."""

import copy

import numpy as np
import jax.numpy as jnp
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import multi_session as ms
from open3d_slam_jax.slam import submap_collection as sc


def make_world(rng, n=14000):
    """Structured world spanning x in [0, 36]: ground + cross walls +
    columns — constrains all 6 DoF everywhere along the corridor."""
    n_g = n // 2
    ground = np.c_[rng.uniform(0, 36, (n_g, 1)), rng.uniform(-6, 6, (n_g, 1)),
                   rng.normal(0, 0.01, (n_g, 1))]
    rest = []
    m = (n - n_g) // 12
    # APERIODIC structure (irregular wall spacing + heights) so global
    # alignment has a unique attractor — no aliasing between sessions.
    for x, h in [(2.5, 3.0), (7.0, 4.5), (10.5, 2.0), (17.0, 5.0),
                 (24.5, 3.5), (31.0, 2.5)]:  # cross walls (normal = x)
        rest.append(np.c_[np.full((m, 1), x), rng.uniform(-6, 6, (m, 1)),
                          rng.uniform(0, h, (m, 1))])
    for x0, x1, y, h in [(0, 5, 6.0, 4.0), (5, 13, -6.0, 2.5),
                         (13, 19, 6.0, 5.0), (19, 24, -6.0, 3.0),
                         (24, 31, 6.0, 2.0), (31, 36, -6.0, 4.5)]:
        rest.append(np.c_[rng.uniform(x0, x1, (m, 1)),
                          np.full((m, 1), y), rng.uniform(0, h, (m, 1))])
    pts = np.vstack([ground] + rest).astype(np.float32)
    return pts + rng.normal(size=pts.shape).astype(np.float32) * 0.01


def build_session(world, poses_world, T_session_world, rng, radius=12.0):
    """Insert one scan per pose into a fresh collection whose map frame is
    ``T_session_world @ world`` (i.e. the session's private frame)."""
    cfg = sc.SubmapCollectionConfig(
        submap_capacity=16384, submap_voxel_size=0.1, submap_crop_radius=20.0,
        creation_radius=7.0, activation_radius=8.0, min_scans_before_switch=1,
    )
    coll = sc.SubmapCollection(cfg)
    for pose_w in poses_world:
        d = np.linalg.norm(world - pose_w[:3, 3][None, :], axis=1)
        near = world[d < radius]
        sel = near[rng.choice(len(near), size=min(4000, len(near)), replace=False)]
        scan_sensor = (np.linalg.inv(pose_w)[:3, :3] @ sel.T).T + np.linalg.inv(pose_w)[:3, 3]
        pose_s = T_session_world @ pose_w
        coll.insert_scan(
            pc.from_points(scan_sensor.astype(np.float32), capacity=4096),
            pose_s, pose_s,
        )
    for i in range(len(coll.submaps)):
        coll._finish(i)
    return coll


def path_poses(xs):
    out = []
    for x in xs:
        T = np.eye(4)
        T[:3, 3] = [x, 0.0, 1.2]
        out.append(T)
    return out


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(7)
    world = make_world(rng)
    # Session A maps x in [2, 18] in the world frame itself.
    a = build_session(world, path_poses([2, 6, 10, 14, 18]), np.eye(4), rng)
    # Session B maps x in [14, 34] in its own frame: offset by T_ab_true.
    T_ab_true = np.asarray(
        se3.exp_se3(jnp.asarray([0.0, 0.0, 0.25, 2.0, -1.5, 0.0], jnp.float32)),
        np.float64,
    )
    b = build_session(world, path_poses([14, 18, 22, 26, 30, 34]),
                      np.linalg.inv(T_ab_true), rng)
    return world, a, b, T_ab_true


@pytest.mark.slow
def test_find_constraints_and_merge_with_known_coarse(sessions):
    # merge_sessions re-anchors the collections IN PLACE; deepcopy so the
    # module-scoped fixture stays pristine for the other tests.
    world, a0, b0, T_ab_true = sessions
    a, b = copy.deepcopy(a0), copy.deepcopy(b0)
    # Simulate a coarse-alignment error of ~0.15 m / ~1.7 deg.
    T_coarse = T_ab_true @ np.asarray(
        se3.exp_se3(jnp.asarray([0.01, -0.02, 0.015, 0.08, -0.06, 0.05],
                                jnp.float32)), np.float64)
    cfg = ms.MultiSessionConfig(scan_capacity=8192, batch_size=4,
                                pair_distance=15.0)
    anchors_b0 = [e.anchor.copy() for e in b.submaps]
    res = ms.merge_sessions(a, b, cfg, T_ab=T_coarse)
    assert res is not None
    # Constraints must exist in the overlap region (B submaps near x 14-18).
    assert len(res.constraints) >= 1
    for c in res.constraints:
        assert c.overlap >= cfg.min_overlap
        assert c.residual <= cfg.max_residual
    # Joint optimization reduced (or held) the graph error.
    assert res.chi2_after <= res.chi2_before + 1e-6
    # B's re-anchored submaps must land on T_ab_true @ original anchor.
    errs = []
    for e, a0 in zip(b.submaps, anchors_b0):
        gt = T_ab_true @ a0
        errs.append(np.linalg.norm(e.anchor[:3, 3] - gt[:3, 3]))
    # Submaps constrained by inter-session edges are tightly corrected;
    # far-end B submaps hang off odometry edges and keep the same accuracy.
    assert max(errs) < 0.12, errs
    # Registration-grade session transform (round 5): the OPTIMIZED
    # transform distilled from the solved anchors must recover T_ab_true
    # to constraint quality — far beyond the 0.15 m coarse input.
    d = np.linalg.inv(res.T_ab_optimized) @ T_ab_true
    assert np.linalg.norm(d[:3, 3]) < 0.03, res.T_ab_optimized
    rot = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
    assert rot < 0.01, rot
    assert res.phase_s is not None and "register" in res.phase_s
    # The merged maps must actually overlap: mean NN distance from B's
    # points (in A's frame now) to the world structure is small.
    pts_b = b.submaps[0].state.cloud
    mask = np.asarray(pts_b.mask)
    pb = np.asarray(pts_b.xyz)[mask][::37]
    d = np.linalg.norm(pb[:, None, :] - world[None, :], axis=-1).min(1)
    assert np.median(d) < 0.1, np.median(d)


@pytest.mark.slow
def test_coarse_align_sessions_recovers_offset(sessions):
    world, a, b, T_ab_true = sessions
    cfg = ms.MultiSessionConfig(skeleton_capacity=8192)
    T = ms.coarse_align_sessions(a, b, cfg)
    assert T is not None
    delta = np.linalg.inv(T) @ T_ab_true
    terr = np.linalg.norm(delta[:3, 3])
    rerr = np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1))
    assert terr < 0.2, terr
    assert rerr < 0.05, rerr


@pytest.mark.slow
def test_find_constraints_mesh_sharded_matches_local(sessions):
    """The multi-device mode: pair refinement sharded over a "batch" mesh axis
    must accept the same constraints as the local vmapped path."""
    import jax
    from jax.sharding import Mesh

    world, a, b, T_ab_true = sessions
    cfg = ms.MultiSessionConfig(scan_capacity=8192, batch_size=2,
                                pair_distance=15.0)
    local = ms.find_inter_session_constraints(a, b, T_ab_true, cfg)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("batch",))
    sharded = ms.find_inter_session_constraints(a, b, T_ab_true, cfg, mesh=mesh)
    assert [(c.a_idx, c.b_idx) for c in local] == \
        [(c.a_idx, c.b_idx) for c in sharded]
    for cl, cs in zip(local, sharded):
        np.testing.assert_allclose(cl.T_a_b, cs.T_a_b, atol=1e-4)


def test_merge_returns_none_without_overlap():
    rng = np.random.default_rng(3)
    world = make_world(rng, n=6000)
    a = build_session(world, path_poses([2, 6]), np.eye(4), rng)
    b = build_session(world, path_poses([28, 34]), np.eye(4), rng)
    cfg = ms.MultiSessionConfig(scan_capacity=8192, batch_size=4,
                                pair_distance=6.0)
    # Known (identity) coarse alignment but disjoint coverage: no gated
    # pairs -> no constraints -> None, collections untouched.
    anchors = [e.anchor.copy() for e in b.submaps]
    assert ms.merge_sessions(a, b, cfg, T_ab=np.eye(4)) is None
    for e, a0 in zip(b.submaps, anchors):
        np.testing.assert_allclose(e.anchor, a0)
