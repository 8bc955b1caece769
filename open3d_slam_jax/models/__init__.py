from open3d_slam_jax.models import icp, localizability, minimizers

__all__ = ["icp", "localizability", "minimizers"]
