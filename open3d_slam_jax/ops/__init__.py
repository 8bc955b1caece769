from open3d_slam_jax.ops.pointcloud import (
    PointBatch,
    from_points,
    compact,
    masked_mean,
    masked_centroid,
    masked_quantile,
    PAD_COORD,
)

__all__ = [
    "PointBatch",
    "from_points",
    "compact",
    "masked_mean",
    "masked_centroid",
    "masked_quantile",
    "PAD_COORD",
]
