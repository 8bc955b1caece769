from open3d_slam_jax.parallel import mesh as mesh_util
from open3d_slam_jax.parallel.mesh import make_mesh
from open3d_slam_jax.parallel.sharded_icp import (
    partition_tiles,
    register_batch_point_sharded,
    register_batch_sharded,
    register_point_sharded,
    register_tile_sharded,
)

__all__ = [
    "mesh_util",
    "make_mesh",
    "partition_tiles",
    "register_batch_point_sharded",
    "register_batch_sharded",
    "register_point_sharded",
    "register_tile_sharded",
]
