"""Golden-transform parity vs the reference C++ chain.

Replicates libpointmatcher's regression harness (``utest.cpp:52-160``): run
ICP on the bundled Hokuyo clouds (cloud.00000.vtk as reference,
cloud.00001.vtk as reading) and compare against the checked-in golden
transforms ``examples/data/icp_data/*.ref_trans`` with the same acceptance
criterion: median |T_ours . data - T_golden . data| / median |T_ours . data|
< 5% (homogeneous coordinates, like ``median_coeff``).

Our chain uses the device ops (grid matcher, masked trimming) and mild
downsampling for CPU test speed; the 5% criterion is designed to absorb
such chain differences (the reference's own configs use random sampling).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REF_DATA = "/root/reference/libpointmatcher/examples/data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(REF_DATA), reason="reference data not mounted"
)

from open3d_slam_jax.io import load_vtk  # noqa: E402
from open3d_slam_jax.models import icp as icp_mod  # noqa: E402
from open3d_slam_jax.ops import filters, voxel  # noqa: E402
from open3d_slam_jax.ops import normals as normals_mod  # noqa: E402
from open3d_slam_jax.ops import pointcloud as pc  # noqa: E402


def load_golden(name):
    path = os.path.join(REF_DATA, "icp_data", name + ".ref_trans")
    return np.loadtxt(path, dtype=np.float64)


def median_rel_err(T_ours, T_golden, data_pts):
    """The utest acceptance metric on homogeneous 4xN features."""
    h = np.c_[data_pts, np.ones((len(data_pts), 1), np.float32)].T  # 4 x N
    ours = np.asarray(T_ours, np.float64) @ h
    gold = np.asarray(T_golden, np.float64) @ h
    med_diff = np.median(np.abs(ours - gold))
    med_data = np.median(np.abs(ours))
    return med_diff / med_data


@pytest.fixture(scope="module")
def clouds():
    ref_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00000.vtk"))
    read_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00001.vtk"))
    # Reference side: voxel 0.3 + grid normals (≙ SamplingSurfaceNormal).
    ref = pc.from_points(ref_pts, capacity=32768)
    ref = voxel.voxel_downsample(ref, 0.3, capacity=16384)
    ref = normals_mod.estimate_normals(ref, knn=10, max_dist=2.0)
    # Reading side: deterministic random subsample for speed.
    read = pc.from_points(read_pts, capacity=32768)
    read = filters.max_point_count(read, jax.random.key(0), 8192)
    read = pc.compact(read, 8192)
    return ref, read, read_pts


GOLDEN_CFG = icp_mod.ICPConfig(
    knn=1,
    max_match_dist=2.0,
    matcher="grid",
    grid_table_size=1 << 15,
    grid_bucket_cap=256,  # radius 2.0 m on a 0.3 m-voxel map needs deep lists
    trimmed_ratio=0.75,
    minimizer="point_to_plane",
    max_iterations=40,
    min_diff_rot=0.001,
    min_diff_trans=0.01,
    smooth_length=4,
)


@pytest.mark.parametrize(
    "golden_name",
    [
        "defaultIdentityDataPointsFilter",
        "defaultMaxDistDataPointsFilter",
        "defaultMaxPointCountDataPointsFilter",
        "defaultRemoveNaNDataPointsFilter",
        "SamplingSurfaceNormalDataPointsFilter1",
        "defaultRobustOutlierFilter",
    ],
)
def test_golden_transform_parity(clouds, golden_name):
    ref, read, read_full = clouds
    golden = load_golden(golden_name)
    res = icp_mod.register_pair(read, ref, jnp.eye(4), GOLDEN_CFG)
    err = median_rel_err(np.asarray(res.transform), golden, read_full)
    assert err < 0.05, f"{golden_name}: rel err {err:.4f} vs golden\n{np.asarray(res.transform)}\n{golden}"


# ---------------------------------------------------------------------------
# Per-config golden harness: every icp_data/*.yaml chain is built through the
# registry (filters + matcher + outlier filters + minimizer + checkers) and
# run against its own .ref_trans, exactly like utest.cpp's directory loop.
# ---------------------------------------------------------------------------

import dataclasses  # noqa: E402
import glob  # noqa: E402
import math  # noqa: E402

from open3d_slam_jax.config import registry  # noqa: E402

ICP_DATA = os.path.join(REF_DATA, "icp_data")
ALL_GOLDEN_YAMLS = sorted(
    os.path.splitext(os.path.basename(p))[0]
    for p in glob.glob(os.path.join(ICP_DATA, "*.yaml"))
)


@pytest.fixture(scope="module")
def raw_clouds():
    """Deterministically subsampled Hokuyo pair (CPU-speed deviation; the 5%
    median criterion absorbs sampling differences — the chains themselves
    run RandomSampling)."""
    ref_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00000.vtk"))
    read_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00001.vtk"))
    ref = pc.from_points(ref_pts, capacity=32768)
    ref = pc.compact(filters.max_point_count(ref, jax.random.key(7), 16384), 16384)
    read = pc.from_points(read_pts, capacity=32768)
    read = pc.compact(filters.max_point_count(read, jax.random.key(8), 8192), 8192)
    return ref, read, read_pts


def _speed_overrides(cfg):
    """The yamls' KDTreeMatcher carries no maxDist (unbounded k-d search);
    brute-force knn over the full pair is O(N*M) on CPU. A 1.5 m match
    radius is effectively unbounded here (consecutive indoor scans, initial
    offset well under 1 m) and lets the grid matcher run."""
    if math.isfinite(cfg.max_match_dist) and cfg.matcher != "brute":
        return cfg
    return dataclasses.replace(
        cfg,
        max_match_dist=1.5,
        matcher="grid",
        grid_table_size=1 << 15,
        grid_bucket_cap=256 if cfg.knn == 1 else 128,
    )


@pytest.mark.slow
@pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="numerics-parity tier (one fresh XLA program per yaml chain) runs "
    "on CPU, like the 6-golden smoke above",
)
@pytest.mark.parametrize("name", ALL_GOLDEN_YAMLS)
def test_per_config_golden(raw_clouds, name):
    doc = registry.load_yaml(os.path.join(ICP_DATA, name + ".yaml"))
    cfg = _speed_overrides(registry.icp_config_from_dict(doc))
    ref0, read0, read_full = raw_clouds
    ref = registry.make_filter_chain(doc.get("referenceDataPointsFilters"))(
        ref0, jax.random.key(0)
    )
    read = registry.make_filter_chain(doc.get("readingDataPointsFilters"))(
        read0, jax.random.key(1)
    )
    res = icp_mod.register_pair(read, ref, jnp.eye(4), cfg)
    golden = load_golden(name)
    err = median_rel_err(np.asarray(res.transform), golden, read_full)
    assert err < 0.05, (
        f"{name}: rel err {err:.4f}\nours:\n{np.asarray(res.transform)}\n"
        f"golden:\n{golden}"
    )


@pytest.mark.slow
def test_golden_force4dof(clouds):
    """The 4-DoF (yaw + translation) golden config: knn=10 matcher, trimmed
    0.8 + normal-angle gate, force4DOF point-to-plane."""
    ref, read, read_full = clouds
    import dataclasses

    from open3d_slam_jax.ops import normals as normals_mod

    golden = load_golden("force4DOFForPointToPlaneMinimizer")
    read_n = normals_mod.estimate_normals(read, knn=12, max_dist=2.0)
    # The golden used knn=10 matching; matching budget matters for 4-DoF.
    cfg = dataclasses.replace(
        GOLDEN_CFG, knn=10, max_match_dist=1.5, grid_bucket_cap=192,
        trimmed_ratio=0.8, normal_angle_max=0.42, force_4dof=True,
        max_iterations=60, min_diff_rot=1e-4, min_diff_trans=1e-3,
    )
    res = icp_mod.register_pair(read_n, ref, jnp.eye(4), cfg)
    err = median_rel_err(np.asarray(res.transform), golden, read_full)
    assert err < 0.05, f"4DOF rel err {err:.4f}"
    # The solution is genuinely 4-DoF: no roll/pitch.
    T = np.asarray(res.transform)
    assert abs(T[2, 0]) < 1e-5 and abs(T[2, 1]) < 1e-5


# ---------------------------------------------------------------------------
# UNDILUTED golden parity: full clouds, the yaml's OWN matcher semantics.
# The per-config harness above swaps the unbounded KDTree for a 1.5 m grid
# radius and subsamples both clouds for CPU speed; these three runs make the
# strong claim instead — the registry translation of the yaml as-is
# (unbounded KDTreeMatcher -> exact streaming brute knn) on the FULL bundled
# Hokuyo pair, only the yaml's own configured filters applied. Measured rel
# err ~0.3% vs the C++ golden (criterion 5%, utest.cpp:137-154).
# ---------------------------------------------------------------------------

UNDILUTED_YAMLS = [
    "defaultIdentityDataPointsFilter",        # identity reading + surfel reference
    "SamplingSurfaceNormalDataPointsFilter1", # surfel decimation chain
    "defaultRobustOutlierFilter",             # no filters at all; knn=10 matching + robust weights
]


@pytest.mark.slow
@pytest.mark.skipif(
    jax.default_backend() != "cpu",
    reason="exact-brute parity tier runs on CPU (one fresh program per "
    "chain)",
)
@pytest.mark.parametrize("name", UNDILUTED_YAMLS)
def test_per_config_golden_undiluted(name):
    doc = registry.load_yaml(os.path.join(ICP_DATA, name + ".yaml"))
    cfg = registry.icp_config_from_dict(doc)  # NO speed overrides
    ref_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00000.vtk"))
    read_pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00001.vtk"))
    ref0 = pc.from_points(ref_pts, capacity=25600)
    read0 = pc.from_points(read_pts, capacity=25600)
    ref = registry.make_filter_chain(doc.get("referenceDataPointsFilters"))(
        ref0, jax.random.key(0)
    )
    read = registry.make_filter_chain(doc.get("readingDataPointsFilters"))(
        read0, jax.random.key(1)
    )
    res = icp_mod.register_pair(read, ref, jnp.eye(4), cfg)
    golden = load_golden(name)
    err = median_rel_err(np.asarray(res.transform), golden, read_pts)
    assert err < 0.05, (
        f"{name} (undiluted): rel err {err:.4f}\n"
        f"ours:\n{np.asarray(res.transform)}\ngolden:\n{golden}"
    )
