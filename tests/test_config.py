import io
import os

import jax
import numpy as np
import pytest

from open3d_slam_jax.config import (
    icp_config_from_dict,
    icp_config_from_yaml,
    make_filter_chain,
    slam_config_from_dict,
)
from open3d_slam_jax.ops import pointcloud as pc

REF_ICP_YAML = "/root/reference/open3d_slam_rsl/ros/open3d_slam_ros/param/icp.yaml"


ICP_DOC = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.5
referenceDataPointsFilters:
  - SurfaceNormalDataPointsFilter:
      knn: 10
matcher:
  KDTreeMatcher:
    knn: 1
    maxDist: 0.5
    epsilon: 0.01
outlierFilters:
  - TrimmedDistOutlierFilter:
      ratio: 0.9
errorMinimizer:
  PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker:
      maxIterationCount: 30
  - DifferentialTransformationChecker:
      minDiffRotErr: 0.001
      minDiffTransErr: 0.008
      smoothLength: 3
"""


def test_icp_config_from_yaml_doc():
    cfg = icp_config_from_yaml(io.StringIO(ICP_DOC))
    assert cfg.knn == 1
    assert cfg.max_match_dist == 0.5
    assert cfg.matcher == "grid"
    assert cfg.trimmed_ratio == 0.9
    assert cfg.minimizer == "point_to_plane"
    assert cfg.max_iterations == 30
    assert cfg.min_diff_rot == 0.001
    assert cfg.min_diff_trans == 0.008
    assert cfg.smooth_length == 3


@pytest.mark.skipif(not os.path.exists(REF_ICP_YAML), reason="reference not mounted")
def test_reference_production_icp_yaml_loads():
    """The actual production icp.yaml from the reference repo must load."""
    cfg = icp_config_from_yaml(REF_ICP_YAML)
    assert cfg.knn >= 1
    assert cfg.minimizer in ("point_to_plane", "point_to_point")
    assert cfg.max_iterations > 0


def test_unknown_module_raises():
    with pytest.raises(KeyError):
        icp_config_from_dict({"matcher": {"MadeUpMatcher": {}}})


def test_filter_chain_runs(rng):
    chain = make_filter_chain(
        [
            {"MaxDistDataPointsFilter": {"maxDist": 2.0}},
            {"RandomSamplingDataPointsFilter": {"prob": 0.5}},
            {"VoxelGridDataPointsFilter": {"vSizeX": 0.2}},
        ]
    )
    b = pc.from_points(rng.uniform(-5, 5, (2000, 3)).astype(np.float32))
    out = chain(b, jax.random.key(0))
    assert int(out.count()) < 2000
    assert out.capacity == 2000


def test_filter_chain_surface_normal(rng):
    chain = make_filter_chain([{"SurfaceNormalDataPointsFilter": {"knn": 6}}])
    b = pc.from_points(rng.uniform(-1, 1, (300, 3)).astype(np.float32))
    out = chain(b, jax.random.key(0))
    assert "normals" in out.extras


def test_slam_config_from_reference_style_tree():
    doc = {
        "odometry": {
            "scan_processing": {
                "voxel_size": 0.25,
                "scan_cropping": {"cropping_radius_max": 45.0, "cropping_radius_min": 1.5},
            },
            "scan_matching": {
                "icp": {"max_correspondence_dist": 0.8, "max_n_iter": 25},
                "cloud_registration_type": "PointToPlaneIcp",
            },
        },
        "mapper_localizer": {
            "min_movement_between_mapping_steps": 0.05,
            "is_attempt_loop_closures": False,
            "scan_to_map_registration": {
                "icp": {"max_correspondence_dist": 0.6, "max_n_iter": 35},
                "scan_to_map_refinement_type": "PointToPlaneIcp",
                "scan_processing": {"voxel_size": 0.2},
            },
        },
        "map_builder": {"map_voxel_size": 0.12},
        "submap": {"submap_size": 25.0, "min_num_range_data": 7},
        "place_recognition": {"min_refinement_fitness": 0.6},
        "global_optimization": {"loop_closure_preference": 2.0},
    }
    cfg = slam_config_from_dict(doc)
    assert cfg.odometry.voxel_size == 0.25
    assert cfg.odometry.max_range == 45.0
    assert cfg.odometry.icp.max_match_dist == 0.8
    assert cfg.odometry.icp.max_iterations == 25
    assert cfg.mapper.min_movement_for_insertion == 0.05
    assert cfg.mapper.icp.max_match_dist == 0.6
    assert cfg.mapper.scan_voxel_size == 0.2
    assert cfg.mapper.submap_voxel_size == 0.12
    assert cfg.submaps.creation_radius == 25.0
    assert cfg.submaps.min_scans_before_switch == 7
    assert cfg.place_recognition.min_overlap == 0.6
    assert not cfg.loop_closure_enabled


def test_slam_config_empty_dict_gives_defaults():
    cfg = slam_config_from_dict({})
    assert cfg.mapper.icp.minimizer == "point_to_plane"
    assert cfg.loop_closure_enabled


def test_var_trimmed_and_median_yaml():
    doc = {
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
        "outlierFilters": [
            {"VarTrimmedDistOutlierFilter": {"minRatio": 0.1, "maxRatio": 0.9}},
            {"MedianDistOutlierFilter": {"factor": 2.0}},
        ],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
    }
    cfg = icp_config_from_dict(doc)
    assert cfg.var_trimmed == (0.1, 0.9)
    assert cfg.median_factor == 2.0


def test_maxmin_and_generic_descriptor_yaml():
    doc = {
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 0.5}},
        "outlierFilters": [
            {"MaxDistOutlierFilter": {"maxDist": 0.4}},
            {"MinDistOutlierFilter": {"minDist": 0.01}},
            {"GenericDescriptorOutlierFilter": {
                "source": "reference", "descName": "observationCount",
                "useSoftThreshold": 1, "useLargerThan": 1, "threshold": 0.2,
            }},
        ],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
    }
    cfg = icp_config_from_dict(doc)
    assert cfg.max_residual_dist == 0.4
    assert cfg.min_residual_dist == 0.01
    assert cfg.generic_descriptor == ("observationCount", True, True, 0.2)
