"""Three-way comparison of the X-ICP degeneracy-awareness methods.

The reference implements THREE distinct detection flows (ICP.cpp):

- SolutionRemapping (``ICP.cpp:2447-2503``): eigenvalue gate + projection.
- kOptimizedEqualityConstraints (``ICP.cpp:2185-2446``): BINARY per-direction
  decision (``detectLocalizability``, ICP.cpp:2129-2160) computed on the
  first iteration only; non-localizable directions locked at constraint 0.
- kEqualityConstraints / ternary-level detection (``ICP.cpp:1698-2157``):
  3-level categorization with partial 3-DoF constraint re-solves, every
  iteration.

These tests pin the categorical decisions of each method on the canonical
degenerate geometries (corridor / plane / cylinder) and the specific input
regimes where the Optimized and Ternary decisions DIFFER by design.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models import localizability as xicp
from open3d_slam_jax.models.localizability import DegeneracyConfig
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc


@pytest.fixture
def rng():
    return np.random.default_rng(7)


BASE_CFG = icp_mod.ICPConfig(
    knn=1,
    max_match_dist=0.5,
    matcher="brute",
    trimmed_ratio=0.9,
    minimizer="point_to_plane",
    max_iterations=30,
    min_diff_rot=1e-4,
    min_diff_trans=1e-4,
)


def with_normals(pts):
    b = pc.from_points(pts)
    return normals_mod.estimate_normals(b, knn=10, orient_towards=(0.0, 0.0, 10.0))


def corridor_cloud(rng, n=3000):
    m = n // 3
    floor = np.c_[rng.uniform(-5, 5, (m, 2)), np.zeros((m, 1))]
    w1 = np.c_[rng.uniform(-5, 5, (m, 1)), np.full((m, 1), 1.0), rng.uniform(0, 2, (m, 1))]
    w2 = np.c_[rng.uniform(-5, 5, (m, 1)), np.full((m, 1), -1.0), rng.uniform(0, 2, (m, 1))]
    return np.vstack([floor, w1, w2]).astype(np.float32)


def plane_cloud(rng, n=3000):
    """Flat ground only: z translation + x/y tilt observable, x/y slide and
    z rotation unobservable."""
    pts = np.c_[rng.uniform(-5, 5, (n, 2)), np.zeros((n, 1))]
    return pts.astype(np.float32)


def cylinder_cloud(rng, n=3000, radius=2.0):
    """Vertical cylinder wall: slide along and rotation about the axis are
    unobservable (radial normals carry no z or tangential information)."""
    phi = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(0, 4, n)
    pts = np.c_[radius * np.cos(phi), radius * np.sin(phi), z]
    return pts.astype(np.float32)


def make_cfg(method, **deg_kwargs):
    return icp_mod.ICPConfig(
        **{**BASE_CFG.__dict__, "degeneracy": DegeneracyConfig(method=method, **deg_kwargs)}
    )


def register(reading_pts, ref, cfg, init=None):
    init = jnp.eye(4) if init is None else init
    return icp_mod.register_pair(pc.from_points(reading_pts), ref, init, cfg)


def shifted(ref_pts, twist):
    T_true = se3.exp_se3(jnp.asarray(twist, jnp.float32))
    return np.asarray(
        se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
    )


# ---------------------------------------------------------------------------
# Corridor: all three methods must refuse to move along the corridor axis.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "method", ["solution_remapping", "optimized", "equality_constraints"]
)
def test_corridor_axis_locked_by_all_methods(rng, method):
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0, 0, 0, 0.5, 0, 0])
    kwargs = {"solution_remapping_threshold": 150.0} if method == "solution_remapping" else {}
    res = register(reading_pts, ref, make_cfg(method, **kwargs))
    T = np.asarray(res.transform)
    assert abs(T[0, 3]) < 0.05, (method, T[0, 3])
    if method != "solution_remapping":
        assert bool(res.degenerate)
        assert float(jnp.min(res.localizability_trans)) < 0.5


def test_corridor_optimized_and_ternary_agree_on_category(rng):
    """On a hard-degenerate corridor both constraint families categorize the
    same directions (the divergence regime is tested separately)."""
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0, 0, 0, 0.3, 0, 0])
    res_o = register(reading_pts, ref, make_cfg("optimized"))
    res_t = register(reading_pts, ref, make_cfg("equality_constraints"))
    np.testing.assert_array_equal(
        np.asarray(res_o.localizability_trans) > 0.5,
        np.asarray(res_t.localizability_trans) > 0.5,
    )


# ---------------------------------------------------------------------------
# Plane / cylinder categorical decisions.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["optimized", "equality_constraints"])
def test_plane_categories(rng, method):
    """Ground plane: exactly one localizable translation direction (the
    normal) and exactly two localizable rotations (the tilts)."""
    ref_pts = plane_cloud(rng)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0, 0, 0, 0, 0, 0.05])
    res = register(reading_pts, ref, make_cfg(method))
    assert int(np.sum(np.asarray(res.localizability_trans) > 0.5)) == 1
    assert int(np.sum(np.asarray(res.localizability_rot) > 0.5)) == 2
    assert bool(res.degenerate)
    # The lone localizable translation eigenvector is the plane normal (z).
    V = np.asarray(res.transform)  # sanity: z offset recovered despite locks
    assert abs(V[2, 3] - 0.05) < 0.02


@pytest.mark.parametrize("method", ["optimized", "equality_constraints"])
def test_cylinder_categories(rng, method):
    """Cylinder wall: translation along + rotation about the axis are
    non-localizable; everything else is."""
    ref_pts = cylinder_cloud(rng)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0, 0, 0, 0.02, 0.02, 0.0])
    res = register(reading_pts, ref, make_cfg(method))
    assert int(np.sum(np.asarray(res.localizability_trans) > 0.5)) == 2
    assert int(np.sum(np.asarray(res.localizability_rot) > 0.5)) == 2
    assert bool(res.degenerate)


# ---------------------------------------------------------------------------
# The designed divergence between Optimized and Ternary.
# ---------------------------------------------------------------------------


def test_optimized_vs_ternary_divergence():
    """A direction whose combined contribution lands in
    [enoughInformationThreshold, highInformationThreshold) with no strong
    contributors: the Optimized method (combined >= enough => localizable,
    ICP.cpp:2129-2160) declares it LOCALIZABLE, while ternary-level
    detection (localizable only if combined >= high or high >= enough,
    ICP.cpp:2085-2100) declares it partially localizable => category
    non-localizable with a partial-constraint re-solve."""
    cfg = DegeneracyConfig(method="optimized")  # thresholds: 350/150/40
    P = 500
    # Normals at cos^-1(0.5) from x and cos^-1(0.866) from y: weak-only for
    # the x eigenvector (0.17 < 0.5 < 0.707), strong for y.
    normals = np.tile(np.array([0.5, np.sqrt(3) / 2, 0.0], np.float32), (P, 1))
    src = np.random.default_rng(0).uniform(-1, 1, (P, 3)).astype(np.float32)
    mask = np.ones((P,), bool)
    # Translation block diag(1,2,3): ascending eigenvectors = x, y, z cols.
    A = np.diag([9.0, 8.0, 7.0, 1.0, 2.0, 3.0]).astype(np.float32)
    b = np.zeros((6,), np.float32)
    ddn = np.zeros((P,), np.float32)

    res_o = xicp.analyze_optimized(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(src), jnp.asarray(normals),
        jnp.asarray(mask), cfg,
    )
    res_t = xicp.analyze_equality_constraints(
        jnp.asarray(A), jnp.asarray(b), jnp.asarray(src), jnp.asarray(normals),
        jnp.asarray(ddn), jnp.asarray(mask), cfg,
    )
    # x direction: combined = 500 * 0.5 = 250, high = 0.
    assert np.asarray(res_o.localizability_trans)[0] == 1.0  # 250 >= 150
    assert np.asarray(res_t.localizability_trans)[0] == 0.0  # 250 < 350, 0 < 150
    # y direction: combined = high = 433 -> localizable for both.
    assert np.asarray(res_o.localizability_trans)[1] == 1.0
    assert np.asarray(res_t.localizability_trans)[1] == 1.0
    # z direction: zero contribution -> non-localizable for both.
    assert np.asarray(res_o.localizability_trans)[2] == 0.0
    assert np.asarray(res_t.localizability_trans)[2] == 0.0
    # Optimized never produces partial constraint values.
    np.testing.assert_array_equal(np.asarray(res_o.constraint_values_trans), 0.0)


def test_optimized_binary_thresholds():
    """The Optimized decision reads (enough, insufficient) — never the
    high_information_threshold (detectLocalizability, ICP.cpp:2129-2160)."""
    cfg = DegeneracyConfig(
        method="optimized",
        enough_information_threshold=250.0,
        insufficient_information_threshold=180.0,
    )
    P = 300
    # Strong alignment (1.0) with x for all points: high = combined = 300.
    normals = np.tile(np.array([1.0, 0.0, 0.0], np.float32), (P, 1))
    src = np.random.default_rng(1).uniform(-1, 1, (P, 3)).astype(np.float32)
    A = np.diag([9.0, 8.0, 7.0, 1.0, 2.0, 3.0]).astype(np.float32)
    res = xicp.analyze_optimized(
        jnp.asarray(A), jnp.zeros((6,)), jnp.asarray(src), jnp.asarray(normals),
        jnp.ones((P,), bool), cfg,
    )
    # 300 >= 250 (enough) -> localizable on x even though 300 < 350 (high).
    assert np.asarray(res.localizability_trans)[0] == 1.0
    # Drop to 200 points: combined = 200 < 250 but high = 200 >= 180.
    res2 = xicp.analyze_optimized(
        jnp.asarray(A), jnp.zeros((6,)), jnp.asarray(src[:200]),
        jnp.asarray(normals[:200]), jnp.ones((200,), bool), cfg,
    )
    assert np.asarray(res2.localizability_trans)[0] == 1.0
    # 100 points: combined = high = 100 < both thresholds -> non-localizable.
    res3 = xicp.analyze_optimized(
        jnp.asarray(A), jnp.zeros((6,)), jnp.asarray(src[:100]),
        jnp.asarray(normals[:100]), jnp.ones((100,), bool), cfg,
    )
    assert np.asarray(res3.localizability_trans)[0] == 0.0


def test_optimized_well_constrained_matches_vanilla(rng):
    """Fully-localizable problems: the Optimized chain is exactly vanilla
    point-to-plane (all KKT rows inert)."""
    m = 700
    floor = np.c_[rng.uniform(-3, 3, (m, 2)), np.zeros((m, 1))]
    wallx = np.c_[np.zeros((m, 1)), rng.uniform(-3, 3, (m, 2))]
    wally = np.c_[rng.uniform(-3, 3, (m, 1)), np.full((m, 1), 3.0), rng.uniform(0, 3, (m, 1))]
    ref_pts = np.vstack([floor, wallx, wally]).astype(np.float32)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0.03, -0.02, 0.01, 0.1, -0.05, 0.08])
    res_o = register(reading_pts, ref, make_cfg("optimized"))
    res_v = register(reading_pts, ref, BASE_CFG)
    assert not bool(res_o.degenerate)
    np.testing.assert_allclose(
        np.asarray(res_o.transform), np.asarray(res_v.transform), atol=1e-4
    )


def test_registry_maps_method_names(tmp_path):
    """OptimizedEqualityConstraints (production icp.yaml) -> the binary
    'optimized' method with the yaml's thresholds; TernaryLevelDetection /
    EqualityConstraints -> the ternary 'equality_constraints' method."""
    from open3d_slam_jax.config import icp_config_from_yaml

    base = """
readingDataPointsFilters: []
referenceDataPointsFilters: []
matcher:
  KDTreeMatcher: {knn: 1, maxDist: 0.5}
outlierFilters:
  - TrimmedDistOutlierFilter: {ratio: 0.9}
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker: {maxIterationCount: 30}
degeneracyAwareness:
  %s
"""
    opt = base % (
        "OptimizedEqualityConstraints: {enoughInformationThreshold: 250, "
        "insufficientInformationThreshold: 180}"
    )
    p = tmp_path / "opt.yaml"
    p.write_text(opt)
    cfg = icp_config_from_yaml(str(p))
    assert cfg.degeneracy.method == "optimized"
    assert cfg.degeneracy.enough_information_threshold == 250.0
    assert cfg.degeneracy.insufficient_information_threshold == 180.0

    for name in ("TernaryLevelDetection", "EqualityConstraints"):
        p2 = tmp_path / f"{name}.yaml"
        p2.write_text(base % (name + ": {}"))
        cfg2 = icp_config_from_yaml(str(p2))
        assert cfg2.degeneracy.method == "equality_constraints", name


def test_optimized_with_cached_rounds_and_moments(rng):
    """The optimized method composes with the candidate-cached / moment /
    fused production schedule (grid matcher), matching the brute chain."""
    ref_pts = corridor_cloud(rng)
    ref = with_normals(ref_pts)
    reading_pts = shifted(ref_pts, [0, 0, 0, 0.4, 0.05, 0.02])
    cached_cfg = icp_mod.ICPConfig(
        **{
            **BASE_CFG.__dict__,
            "matcher": "grid",
            "fast_trimming": True,
            "candidate_refresh_every": 5,
            "degeneracy": DegeneracyConfig(method="optimized"),
        }
    )
    res = register(reading_pts, ref, cached_cfg)
    T = np.asarray(res.transform)
    assert abs(T[0, 3]) < 0.05, T[0, 3]
    assert bool(res.degenerate)
    assert abs(T[1, 3] - 0.05) < 0.03


def test_cadence_parity_on_degenerate_sequence(rng):
    """Sequence-level cadence parity (round-4 item): registering a SEQUENCE
    of degenerate corridor scans with ``analysis_per_round=True`` (the perf
    default: analysis frozen per candidate-refresh round) must produce the
    SAME constrained-direction decisions and poses within tolerance as
    ``analysis_per_round=False`` (the reference's per-iteration cadence,
    ``ICP.cpp:1079-1172``). Single registrations are covered above; this
    pins the agreement when decisions feed forward through a trajectory
    (each scan's init is the previous scan's estimate)."""
    ref_pts = corridor_cloud(rng, n=4000)
    ref = with_normals(ref_pts)

    def run_sequence(per_round: bool):
        cfg = icp_mod.ICPConfig(
            **{
                **BASE_CFG.__dict__,
                "matcher": "grid",
                "fast_trimming": True,
                "candidate_refresh_every": 5,
                "max_iterations": 20,
                "degeneracy": DegeneracyConfig(
                    method="optimized",
                    enough_information_threshold=250.0,
                    insufficient_information_threshold=180.0,
                    analysis_per_round=per_round,
                ),
            }
        )
        poses, locs = [], []
        init = jnp.eye(4)
        # A drift along the corridor axis (x: unobservable) + observable
        # lateral/vertical motion; each scan registers with the previous
        # estimate as its prior, like the mapper loop.
        for k in range(1, 6):
            twist = [0, 0, 0, 0.3 * k, 0.04 * k, 0.02 * k]
            reading_pts = shifted(ref_pts, twist)
            res = register(reading_pts, ref, cfg, init=init)
            poses.append(np.asarray(res.transform))
            locs.append(
                np.r_[
                    np.asarray(res.localizability_trans),
                    np.asarray(res.localizability_rot),
                ]
            )
            init = res.transform
        return np.stack(poses), np.stack(locs)

    poses_r, locs_r = run_sequence(True)
    poses_i, locs_i = run_sequence(False)
    # Identical constrained-direction decisions at every step.
    np.testing.assert_array_equal(locs_r, locs_i)
    # Corridor axis (x) non-localizable throughout.
    assert np.all(locs_r[:, 0] == 0.0)
    # Pose agreement: the observable directions must match tightly; the
    # unobservable x stays pinned at the prior under both cadences.
    dt = np.abs(poses_r[:, :3, 3] - poses_i[:, :3, 3])
    assert np.max(dt) < 5e-3, dt
    for a, b in zip(poses_r, poses_i):
        dR = a[:3, :3].T @ b[:3, :3]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        assert ang < 1e-3
