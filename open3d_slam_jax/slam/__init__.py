from open3d_slam_jax.slam import (
    mapper,
    motion_compensation,
    multi_session,
    odometry,
    pipeline,
    place_recognition,
    pose_graph,
    submap,
    submap_collection,
    transform_buffer,
)

__all__ = [
    "mapper",
    "motion_compensation",
    "multi_session",
    "odometry",
    "pipeline",
    "place_recognition",
    "pose_graph",
    "submap",
    "submap_collection",
    "transform_buffer",
]
