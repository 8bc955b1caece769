from open3d_slam_jax.utils import timing

__all__ = ["timing"]
