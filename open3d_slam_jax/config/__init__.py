from open3d_slam_jax.config.registry import (
    icp_config_from_dict,
    icp_config_from_yaml,
    load_yaml,
    make_filter_chain,
    FILTER_REGISTRY,
)
from open3d_slam_jax.config.lua import load_lua, loads_lua
from open3d_slam_jax.config.slam_params import (
    slam_config_from_dict,
    slam_config_from_lua,
    slam_config_from_yaml,
)

__all__ = [
    "icp_config_from_dict",
    "icp_config_from_yaml",
    "load_yaml",
    "load_lua",
    "loads_lua",
    "make_filter_chain",
    "FILTER_REGISTRY",
    "slam_config_from_dict",
    "slam_config_from_lua",
    "slam_config_from_yaml",
]
