"""CloudRegistration facade.

Mirrors the reference's ``CloudRegistration`` hierarchy
(``CloudRegistration.{hpp,cpp}``): a uniform
``register_clouds(source, target, init)`` over the three registration types
(PointToPoint / PointToPlane / Generalized ICP), handling the per-type
preprocessing policy (normal estimation where the cost needs it) exactly
like the reference's ``estimateNormalsOrCovariancesIfNeeded``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax.numpy as jnp

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc

REGISTRATION_TYPES = ("PointToPointIcp", "PointToPlaneIcp", "GeneralizedIcp")

_MINIMIZERS = {
    "PointToPointIcp": "point_to_point",
    "PointToPlaneIcp": "point_to_plane",
    "GeneralizedIcp": "gicp",
}


@dataclasses.dataclass(frozen=True)
class CloudRegistrationConfig:
    """≙ ``CloudRegistrationParameters`` (icp knobs + registration type)."""

    registration_type: str = "GeneralizedIcp"
    max_correspondence_dist: float = 1.0
    max_iterations: int = 50
    normals_knn: int = 10
    icp_overrides: Optional[dict] = None

    def icp_config(self) -> icp_mod.ICPConfig:
        if self.registration_type not in REGISTRATION_TYPES:
            raise ValueError(
                f"unknown registration type {self.registration_type}; "
                f"options: {REGISTRATION_TYPES}"
            )
        kw = dict(
            knn=1,
            max_match_dist=self.max_correspondence_dist,
            matcher="grid",
            grid_table_size=1 << 14,
            grid_bucket_cap=96,
            trimmed_ratio=0.9,
            minimizer=_MINIMIZERS[self.registration_type],
            max_iterations=self.max_iterations,
        )
        kw.update(self.icp_overrides or {})
        return icp_mod.ICPConfig(**kw)


def register_clouds(
    source: pc.PointBatch,
    target: pc.PointBatch,
    init_T=None,
    cfg: Optional[CloudRegistrationConfig] = None,
) -> icp_mod.ICPResult:
    """Uniform registration entry point (≙ ``registerClouds``)."""
    cfg = cfg or CloudRegistrationConfig()
    icp_cfg = cfg.icp_config()
    needs_target_normals = icp_cfg.minimizer in ("point_to_plane", "gicp")
    needs_source_normals = icp_cfg.minimizer == "gicp"
    radius = 2.0 * cfg.max_correspondence_dist
    if needs_target_normals and target.normals is None:
        target = normals_mod.estimate_normals(target, knn=cfg.normals_knn, max_dist=radius)
    if needs_source_normals and source.normals is None:
        source = normals_mod.estimate_normals(source, knn=cfg.normals_knn, max_dist=radius)
    if init_T is None:
        init_T = jnp.eye(4)
    return icp_mod.register_pair(source, target, init_T, icp_cfg)
