"""Per-iteration reading-step filter chains + matcher quality counters.

Reference: ICP.cpp:1038 (readingStepDataPointsFilters.apply(stepReading)
every iteration), MaxDist.cpp:77-99 (signed single-axis / norm semantics),
MatchersImpl.cpp (matcher visit counters).
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from open3d_slam_jax.config import registry
from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models.icp import _reading_step_mask
from open3d_slam_jax.ops import cell_list as cell_mod
from open3d_slam_jax.ops import pointcloud as pc


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _scene(rng, n=4096):
    pts = np.c_[rng.uniform(-8, 8, (n, 2)), 0.05 * rng.normal(size=(n, 1))]
    k = n // 4
    pts[:k, 2] = rng.uniform(0, 3, k)
    pts[:k, 0] = np.round(pts[:k, 0] / 4) * 4
    return pts.astype(np.float32)


def test_reading_step_mask_semantics():
    src = jnp.asarray([[0.5, 0, 0], [2.0, 0, 0], [-3.0, 0, 0], [0, 4.0, 0]])
    mask = jnp.ones((4,), bool)
    it = jnp.asarray(0, jnp.int32)
    # MaxDist dim -1: norm < |dist|
    keep = _reading_step_mask(src, mask, it, (("MaxDist", (("dim", -1), ("dist", 2.5))),))
    np.testing.assert_array_equal(np.asarray(keep), [True, True, False, False])
    # MaxDist single axis: SIGNED coordinate < dist (MaxDist.cpp:90-98)
    keep = _reading_step_mask(src, mask, it, (("MaxDist", (("dim", 0), ("dist", 1.0))),))
    np.testing.assert_array_equal(np.asarray(keep), [True, False, True, True])
    # MinDist dim -1: norm > dist
    keep = _reading_step_mask(src, mask, it, (("MinDist", (("dim", -1), ("dist", 1.0))),))
    np.testing.assert_array_equal(np.asarray(keep), [False, True, True, True])
    # DistanceLimit removeInside=1 keeps the far side
    keep = _reading_step_mask(
        src, mask, it,
        (("DistanceLimit", (("dim", -1), ("dist", 2.5), ("removeInside", 1))),))
    np.testing.assert_array_equal(np.asarray(keep), [False, False, True, True])
    # BoundingBox removeInside=1 drops the box
    keep = _reading_step_mask(
        src, mask, it,
        (("BoundingBox", (("xMin", -1.0), ("xMax", 1.0), ("yMin", -1.0),
                          ("yMax", 1.0), ("zMin", -1.0), ("zMax", 1.0),
                          ("removeInside", 1))),))
    np.testing.assert_array_equal(np.asarray(keep), [False, True, True, True])
    # RandomSampling: deterministic per iteration, differs across iterations
    f = (("RandomSampling", (("prob", 0.5),)),)
    big = jnp.zeros((4096, 3))
    bigmask = jnp.ones((4096,), bool)
    k0 = _reading_step_mask(big, bigmask, jnp.asarray(0, jnp.int32), f)
    k0b = _reading_step_mask(big, bigmask, jnp.asarray(0, jnp.int32), f)
    k1 = _reading_step_mask(big, bigmask, jnp.asarray(1, jnp.int32), f)
    assert np.array_equal(np.asarray(k0), np.asarray(k0b))
    assert not np.array_equal(np.asarray(k0), np.asarray(k1))
    assert 0.4 < float(jnp.mean(k0)) < 0.6
    # MaxPointCount thins to ~ the target
    k = _reading_step_mask(
        big, bigmask, jnp.asarray(0, jnp.int32),
        (("MaxPointCount", (("maxCount", 1024),)),))
    assert 700 < int(jnp.sum(k)) < 1400


def test_reading_step_chain_matches_prefiltered(rng):
    """A geometric step filter must act like pre-masking the same points
    (identity-neighbourhood registration: the filter decision is stable)."""
    scene = _scene(rng)
    ref_b = pc.from_points(scene, capacity=4096)
    read_pts = scene[rng.permutation(len(scene))[:2048]]
    T_true = np.asarray(se3.exp_se3(jnp.asarray([0.004, -0.003, 0.005, 0.03, -0.02, 0.01], jnp.float32)))
    moved = (read_pts @ T_true[:3, :3].T + T_true[:3, 3]).astype(np.float32)

    base = icp_mod.ICPConfig(
        knn=1, max_match_dist=1.0, matcher="brute", minimizer="point_to_plane",
        max_iterations=12, moment_cached=False,
    )
    chain = (("BoundingBox", (("xMin", -4.0), ("xMax", 4.0), ("yMin", -20.0),
                              ("yMax", 20.0), ("zMin", -20.0), ("zMax", 20.0),
                              ("removeInside", 0))),)
    cfg_f = dataclasses.replace(base, reading_step_filters=chain)

    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops import grid_hash
    g = grid_hash.build_grid(ref_b.padded_xyz(), ref_b.mask, 1.0, 1 << 12, 32)
    ref_b = normals_mod.estimate_normals_grid(ref_b, g, knn=8, max_dist=1.0)

    reading = pc.from_points(moved, capacity=2048)
    res_f = icp_mod.register_pair(reading, ref_b, jnp.eye(4), cfg_f)

    # Pre-mask the same region (filter measured at the true pose).
    inside = np.abs(read_pts[:, 0]) <= 4.0
    pre = dataclasses.replace(
        reading, mask=reading.mask & jnp.asarray(inside))
    res_p = icp_mod.register_pair(pre, ref_b, jnp.eye(4), base)

    T_f = np.asarray(res_f.transform)
    T_p = np.asarray(res_p.transform)
    delta = np.linalg.inv(T_f) @ T_p
    assert np.linalg.norm(delta[:3, 3]) < 5e-3
    # Registering the moved reading recovers T_true^-1; the composition
    # T_f @ T_true must be ~identity. The scene is deliberately
    # plane-dominated, so absolute recovery is looser than the equivalence
    # assertion above (the real check).
    err = T_f @ T_true
    assert np.linalg.norm(err[:3, 3]) < 5e-2


def test_registry_reading_step_chain(tmp_path):
    import yaml
    doc = {
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
        "errorMinimizer": {"PointToPlaneErrorMinimizer": {}},
        "readingStepDataPointsFilters": [
            {"MaxDistDataPointsFilter": {"dim": -1, "maxDist": 10.0}},
            {"RandomSamplingDataPointsFilter": {"prob": 0.5}},
        ],
    }
    p = tmp_path / "icp.yaml"
    p.write_text(yaml.safe_dump(doc))
    cfg = registry.icp_config_from_yaml(str(p))
    assert cfg.reading_step_filters == (
        ("MaxDist", (("dim", -1), ("dist", 10.0))),
        ("RandomSampling", (("prob", 0.5),)),
    )
    assert cfg.reading_step_random_prob is None

    # Single RandomSampling keeps the dedicated fast path.
    doc["readingStepDataPointsFilters"] = [
        {"RandomSamplingDataPointsFilter": {"prob": 0.25}}]
    p.write_text(yaml.safe_dump(doc))
    cfg = registry.icp_config_from_yaml(str(p))
    assert cfg.reading_step_random_prob == 0.25
    assert cfg.reading_step_filters is None

    # Descriptor-mutating filters are rejected.
    doc["readingStepDataPointsFilters"] = [
        {"SurfaceNormalDataPointsFilter": {"knn": 5}}]
    p.write_text(yaml.safe_dump(doc))
    with pytest.raises(KeyError):
        registry.icp_config_from_yaml(str(p))


def test_cell_list_overflow_counter(rng):
    pts = rng.uniform(-0.2, 0.2, (512, 3)).astype(np.float32)  # one dense cell
    xyz = jnp.asarray(pts)
    mask = jnp.ones((512,), bool)
    cl_small = cell_mod.build_cell_list(xyz, mask, 0.5, table_size=1 << 8, list_cap=16)
    cl_big = cell_mod.build_cell_list(xyz, mask, 0.5, table_size=1 << 8, list_cap=2048)
    assert int(cl_small.dropped) > 0
    assert int(cl_big.dropped) == 0


def test_match_row_saturation_surfaces(rng):
    """Row saturation reads high under capacity pressure (dense map, tiny
    cap) and ~0 when the lists have headroom (sparse map, large cap)."""
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops import grid_hash

    def prep(points, capacity):
        b = pc.from_points(points.astype(np.float32), capacity=capacity)
        g = grid_hash.build_grid(b.padded_xyz(), b.mask, 1.0, 1 << 14, 32)
        return normals_mod.estimate_normals_grid(b, g, knn=8, max_dist=1.0)

    scene = _scene(rng, n=8192)
    dense = np.repeat(scene, 4, axis=0) + rng.normal(
        size=(len(scene) * 4, 3)).astype(np.float32) * 0.01
    # ~40 pts/m^2: well under cap 256 per 0.75 m cell.
    sparse = scene[rng.permutation(len(scene))[:2048]]
    reading = pc.from_points(scene[:2048], capacity=2048)

    def run(ref_b, cap):
        cfg = icp_mod.ICPConfig(
            knn=1, max_match_dist=0.5, matcher="grid", grid_table_size=1 << 12,
            grid_bucket_cap=cap, minimizer="point_to_plane", max_iterations=4,
            candidate_refresh_every=4, moment_cached=False,
        )
        return icp_mod.register_pair(reading, ref_b, jnp.eye(4), cfg)

    sat_small = float(run(prep(dense, 32768), 8).match_row_saturation)
    sat_big = float(run(prep(sparse, 2048), 256).match_row_saturation)
    assert sat_small > 0.3
    assert sat_big < 0.05
