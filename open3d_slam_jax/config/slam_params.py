"""SLAM parameter tree loader — the Lua dictionary analogue.

The reference configures the SLAM system through a Cartographer-style Lua
tree (``parameter_structure_definitions.lua`` + per-robot overrides, loaded
by ``LuaLoader.cpp`` into ``SlamParameters``). Here the same *structure and
key names* are accepted as a plain nested dict (YAML/JSON), so a reference
user's parameter values carry over key-for-key:

    odometry.scan_matching.icp.max_n_iter      -> OdometryConfig.icp.max_iterations
    mapper_localizer.scan_to_map_registration. -> MapperConfig.*
    submap.submap_size                         -> SubmapCollectionConfig.creation_radius
    place_recognition.*                        -> PlaceRecognitionConfig.*
    global_optimization.*                      -> PoseGraphConfig.*
    motion_compensation.*                      -> (pipeline undistortion)

Unknown keys are ignored with a warning list returned alongside, mirroring
the permissive Lua loader.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.slam.mapper import MapperConfig
from open3d_slam_jax.slam.odometry import OdometryConfig
from open3d_slam_jax.slam.pipeline import SlamConfig
from open3d_slam_jax.slam.place_recognition import PlaceRecognitionConfig
from open3d_slam_jax.slam.pose_graph import PoseGraphConfig
from open3d_slam_jax.slam.submap_collection import SubmapCollectionConfig


def _get(d: dict, *path, default=None):
    for p in path:
        if not isinstance(d, dict) or p not in d:
            return default
        d = d[p]
    return d


def _icp_from_tree(tree: dict, base: icp_mod.ICPConfig) -> icp_mod.ICPConfig:
    """ICP_PARAMETERS + cloud_registration_type -> ICPConfig updates."""
    kw: Dict[str, Any] = {}
    icp = _get(tree, "icp", default={}) or {}
    if "max_correspondence_dist" in icp:
        kw["max_match_dist"] = float(icp["max_correspondence_dist"])
    if "max_n_iter" in icp:
        kw["max_iterations"] = int(icp["max_n_iter"])
    reg_type = tree.get("cloud_registration_type") or tree.get("scan_to_map_refinement_type")
    if reg_type:
        mapping = {
            "PointToPlaneIcp": "point_to_plane",
            "PointToPointIcp": "point_to_point",
            "GeneralizedIcp": "gicp",
        }
        kw["minimizer"] = mapping.get(str(reg_type), "point_to_plane")
    return dataclasses.replace(base, **kw) if kw else base


def slam_config_from_dict(doc: dict) -> SlamConfig:
    doc = doc or {}

    # --- odometry ---
    od = OdometryConfig()
    sp = _get(doc, "odometry", "scan_processing", default={}) or {}
    od_kw: Dict[str, Any] = {}
    if "voxel_size" in sp:
        od_kw["voxel_size"] = float(sp["voxel_size"])
    crop = sp.get("scan_cropping", {}) or {}
    if "cropping_radius_max" in crop:
        od_kw["max_range"] = float(crop["cropping_radius_max"])
    if "cropping_radius_min" in crop:
        od_kw["min_range"] = float(crop["cropping_radius_min"])
    od_icp = _icp_from_tree(_get(doc, "odometry", "scan_matching", default={}) or {}, od.icp)
    od = dataclasses.replace(od, icp=od_icp, **od_kw)

    # --- mapper ---
    mp = MapperConfig()
    ml = _get(doc, "mapper_localizer", default={}) or {}
    s2m = ml.get("scan_to_map_registration", {}) or {}
    mp_kw: Dict[str, Any] = {}
    if "min_movement_between_mapping_steps" in ml:
        mp_kw["min_movement_for_insertion"] = float(ml["min_movement_between_mapping_steps"])
    msp = s2m.get("scan_processing", {}) or {}
    if "voxel_size" in msp:
        mp_kw["scan_voxel_size"] = float(msp["voxel_size"])
    mcrop = msp.get("scan_cropping", {}) or {}
    if "cropping_radius_max" in mcrop:
        mp_kw["scan_crop_radius"] = float(mcrop["cropping_radius_max"])
    mb = _get(doc, "map_builder", default={}) or {}
    if "map_voxel_size" in mb:
        mp_kw["submap_voxel_size"] = float(mb["map_voxel_size"])
    carving_enabled = bool(ml.get("is_carving_enabled", False))
    if carving_enabled:
        mp_kw["carving_enabled"] = True
    mp_icp = _icp_from_tree(s2m, mp.icp)
    mp = dataclasses.replace(mp, icp=mp_icp, **mp_kw)

    # --- submaps ---
    sub = SubmapCollectionConfig()
    sd = _get(doc, "submap", default={}) or {}
    sub_kw: Dict[str, Any] = {}
    if "submap_size" in sd:
        sub_kw["creation_radius"] = float(sd["submap_size"])
        sub_kw["activation_radius"] = float(sd["submap_size"]) * 1.1
    if "min_num_range_data" in sd:
        sub_kw["min_scans_before_switch"] = int(sd["min_num_range_data"])
    if "adjacency_based_revisiting_min_fitness" in sd:
        sub_kw["min_fitness_for_switch"] = float(sd["adjacency_based_revisiting_min_fitness"])
    if "map_voxel_size" in mb:
        sub_kw["submap_voxel_size"] = float(mb["map_voxel_size"])
    carv = mb.get("space_carving", {}) or {}
    if carving_enabled:
        sub_kw["carve_every_n"] = int(float(carv.get("carve_space_every_n_scans", 10)))
        if "truncation_distance" in carv:
            sub_kw["carve_range_margin"] = float(carv["truncation_distance"])
    sub = dataclasses.replace(sub, **sub_kw)

    # --- place recognition / loop closure consistency ---
    prc = PlaceRecognitionConfig()
    pr_d = _get(doc, "place_recognition", default={}) or {}
    pr_kw: Dict[str, Any] = {}
    if "min_icp_refinement_fitness" in pr_d:
        pr_kw["min_overlap"] = float(pr_d["min_icp_refinement_fitness"])
    elif "min_refinement_fitness" in pr_d:
        pr_kw["min_overlap"] = float(pr_d["min_refinement_fitness"])
    cc = (
        pr_d.get("consistency_check")  # ≙ PLACE_RECOGNITION_PARAMETERS key
        or pr_d.get("loop_closure_consistency_check")
        or {}
    )
    if "max_drift_x" in cc:
        pr_kw["max_drift_trans"] = float(cc["max_drift_x"])
    if "max_drift_yaw" in cc:
        pr_kw["max_drift_rot"] = math.radians(float(cc["max_drift_yaw"]))
    prc = dataclasses.replace(prc, **pr_kw)

    # --- pose graph ---
    pgc = PoseGraphConfig()
    go = _get(doc, "global_optimization", default={}) or {}
    if "loop_closure_preference" in go:
        pgc = dataclasses.replace(pgc, huber_delta=float(go["loop_closure_preference"]))

    lc_enabled = bool(_get(doc, "mapper_localizer", "is_attempt_loop_closures", default=True))
    dense_enabled = bool(_get(doc, "mapper_localizer", "is_build_dense_map", default=False))
    dmb = _get(doc, "dense_map_builder", default={}) or {}

    # --- motion compensation + IMU attitude init (round-2 wiring) ---
    from open3d_slam_jax.slam.pipeline import MotionCompensationConfig

    mc_d = _get(doc, "motion_compensation", default={}) or {}
    mc = MotionCompensationConfig(
        enabled=bool(mc_d.get("is_undistort_scan", False)),
        scan_duration=float(mc_d.get("scan_duration", 0.1)),
        clockwise=bool(mc_d.get("is_spinning_clockwise", True)),
    )
    use_imu = bool(
        _get(doc, "odometry", "use_IMU_for_attitude_initialization", default=False)
    )
    use_ext_odom = bool(
        _get(doc, "odometry", "use_odometry_topic_instead_of_scan_to_scan",
             default=False)
    )

    return SlamConfig(
        build_dense_map=dense_enabled,
        dense_map_voxel=float(dmb.get("map_voxel_size", 0.05)),
        odometry=od,
        mapper=mp,
        submaps=sub,
        place_recognition=prc,
        pose_graph=pgc,
        loop_closure_enabled=lc_enabled,
        motion_compensation=mc,
        use_imu_attitude_init=use_imu,
        use_external_odometry=use_ext_odom,
    )


def slam_config_from_yaml(path_or_stream) -> SlamConfig:
    from open3d_slam_jax.config.registry import load_yaml

    return slam_config_from_dict(load_yaml(path_or_stream))


def slam_config_from_lua(path: str, search_dirs=None) -> SlamConfig:
    """Load one of the reference's shipped ``param_*.lua`` files
    (``LuaLoader.cpp`` analogue; includes + deepcopy resolved by
    :mod:`open3d_slam_jax.config.lua`)."""
    from open3d_slam_jax.config.lua import load_lua

    return slam_config_from_dict(load_lua(path, search_dirs))
