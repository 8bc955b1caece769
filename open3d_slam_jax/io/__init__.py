from open3d_slam_jax.io.pointcloud_io import (
    load_cloud,
    save_cloud,
    load_csv,
    load_vtk,
    load_ply,
    save_ply,
    save_csv,
    save_vtk,
    load_pcd,
    save_pcd,
)

__all__ = [
    "load_cloud",
    "save_cloud",
    "load_csv",
    "load_vtk",
    "load_ply",
    "save_ply",
    "save_csv",
    "save_vtk",
    "load_pcd",
    "save_pcd",
]
