"""Pose-graph constraint builders between submaps.

Analogue of the reference's ``constraint_builders.cpp:33-118``: odometry
constraints between parent/child submaps — anchored on their relative poses,
optionally refined by registering the overlapping regions, with an
information matrix scaled by overlap quality (the reference calls Open3D's
``GetInformationMatrixFromPointClouds``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.models.cloud_registration import (
    CloudRegistrationConfig,
    register_clouds,
)
from open3d_slam_jax.ops import pointcloud as pc


@dataclasses.dataclass
class OdometryConstraint:
    parent_idx: int
    child_idx: int
    T_parent_child: np.ndarray
    information: np.ndarray
    refined: bool


def overlap_fraction(a: pc.PointBatch, b: pc.PointBatch, radius: float = 0.5) -> float:
    """Fraction of a's points with a b-point within ``radius``
    (≙ ``computeIndicesOfOverlappingPoints``, ``helpers.cpp:320``)."""
    from open3d_slam_jax.ops import cell_list

    cl = cell_list.build_cell_list(
        b.padded_xyz(), b.mask, radius, 1 << 13, 64
    )
    res = cell_list.cell_match(cl, a.padded_xyz(), a.mask, k=1, max_dist=radius)
    valid = np.asarray(res.valid())[:, 0]
    n = max(int(np.asarray(a.mask).sum()), 1)
    return float(valid.sum() / n)


def build_odometry_constraints(
    collection,
    refine: bool = False,
    refine_cfg: Optional[CloudRegistrationConfig] = None,
    scan_capacity: int = 8192,
    min_overlap_for_refinement: float = 0.2,
) -> List[OdometryConstraint]:
    """Constraints between each submap and its parent
    (≙ ``computeOdometryConstraints`` + ``refineOdometryConstraints``)."""
    out: List[OdometryConstraint] = []
    for i, e in enumerate(collection.submaps):
        if e.parent is None:
            continue
        p = collection.submaps[e.parent]
        T_rel = np.linalg.inv(p.anchor) @ e.anchor
        info = np.eye(6)
        refined = False
        if refine:
            child_local = pc.compact(e.state.cloud, scan_capacity).transformed(
                jnp.asarray(np.linalg.inv(e.anchor), jnp.float32)
            )
            parent_local = pc.compact(p.state.cloud, scan_capacity).transformed(
                jnp.asarray(np.linalg.inv(p.anchor), jnp.float32)
            )
            ov = overlap_fraction(child_local, parent_local, radius=1.0)
            if ov >= min_overlap_for_refinement:
                res = register_clouds(
                    child_local, parent_local,
                    jnp.asarray(T_rel, jnp.float32),
                    refine_cfg or CloudRegistrationConfig(max_iterations=20),
                )
                if bool(res.converged) and float(res.overlap_ratio) > 0.3:
                    T_rel = np.asarray(res.transform, np.float64)
                    info = np.eye(6) * float(
                        np.clip(res.overlap_ratio / max(float(res.residual), 1e-3), 1e-2, 1e4)
                    )
                    refined = True
        out.append(
            OdometryConstraint(
                parent_idx=e.parent,
                child_idx=i,
                T_parent_child=T_rel,
                information=info,
                refined=refined,
            )
        )
    return out
