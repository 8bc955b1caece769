"""Submap lifecycle management (host-side control, device-side banks).

Analogue of the reference ``SubmapCollection`` (``SubmapCollection.cpp``):
submap creation/activation by robot proximity (``:94-148``), scan insertion
with an overlap transition region (``:189-245``), finished-submap queue
feeding feature computation and loop-closure candidate search, pose-graph
update application (``:322-373``), and the ``AdjacencyMatrix``
(``AdjacencyMatrix.hpp``) with BFS distances.

The collection itself is cheap host bookkeeping; each submap's point bank
lives on device (``slam.submap.SubmapState``).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import submap as submap_mod


class AdjacencyMatrix:
    """Undirected submap adjacency + BFS hop distance
    (≙ ``AdjacencyMatrix.hpp:16-35``)."""

    def __init__(self):
        self._adj: Dict[int, Set[int]] = {}

    def add_edge(self, i: int, j: int) -> None:
        self._adj.setdefault(i, set()).add(j)
        self._adj.setdefault(j, set()).add(i)

    def is_adjacent(self, i: int, j: int) -> bool:
        return j in self._adj.get(i, set())

    def distance(self, src: int, dst: int) -> int:
        """BFS hop count; large sentinel if disconnected."""
        if src == dst:
            return 0
        seen = {src}
        frontier = deque([(src, 0)])
        while frontier:
            node, d = frontier.popleft()
            for nb in self._adj.get(node, ()):
                if nb == dst:
                    return d + 1
                if nb not in seen:
                    seen.add(nb)
                    frontier.append((nb, d + 1))
        return 1 << 30


@dataclasses.dataclass
class SubmapEntry:
    state: submap_mod.SubmapState
    anchor: np.ndarray  # [4, 4] creation pose (map frame)
    parent: Optional[int]
    finished: bool = False


@dataclasses.dataclass(frozen=True)
class SubmapCollectionConfig:
    """≙ ``SubmapParameters`` (radius, max points, adjacency-based switching)."""

    submap_capacity: int = 131072
    submap_voxel_size: float = 0.15
    submap_crop_radius: float = 50.0
    creation_radius: float = 20.0  # create a new submap beyond this distance
    activation_radius: float = 22.0  # switch to an existing submap within
    min_scans_before_switch: int = 5  # ≙ minNumRangeData_
    # Force a new submap once the active bank holds this many valid points
    # (≙ maxNumPoints_, SubmapCollection.cpp:114-116). None -> 90% of
    # capacity, i.e. roll a new submap before the fixed bank saturates and
    # voxel aggregation would start dropping geometry silently.
    max_num_points: Optional[int] = None
    # Consistency gate when re-activating an adjacent submap: fraction of the
    # current scan overlapping the candidate submap
    # (≙ isSwitchingSubmapsConsistant + adjacencyBasedRevisitingMinFitness_).
    min_fitness_for_switch: float = 0.4
    # Space carving cadence on scan insertion (≙ carveSpaceEveryNscans_,
    # Submap.cpp:56-80); 0 disables carving in the production path.
    carve_every_n: int = 0
    carve_angle_tol: float = 0.01
    carve_range_margin: float = 0.3


class SubmapCollection:
    """Owns the submaps; mirrors the reference's insert/activate/finish flow."""

    def __init__(self, cfg: Optional[SubmapCollectionConfig] = None):
        self.cfg = cfg or SubmapCollectionConfig()
        self.submaps: List[SubmapEntry] = []
        self.adjacency = AdjacencyMatrix()
        self.active_idx: int = -1
        self.finished_queue: List[int] = []
        self._scans_in_active = 0
        self._force_new_submap = False  # ≙ isForceNewSubmapCreation_

    @property
    def _max_points(self) -> int:
        if self.cfg.max_num_points is not None:
            return self.cfg.max_num_points
        return int(0.9 * self.cfg.submap_capacity)

    def __len__(self) -> int:
        return len(self.submaps)

    @property
    def active(self) -> SubmapEntry:
        return self.submaps[self.active_idx]

    def _create_submap(self, pose: np.ndarray, parent: Optional[int]) -> int:
        entry = SubmapEntry(
            state=submap_mod.create(self.cfg.submap_capacity),
            anchor=np.asarray(pose, np.float64).copy(),
            parent=parent,
        )
        self.submaps.append(entry)
        idx = len(self.submaps) - 1
        if parent is not None:
            self.adjacency.add_edge(parent, idx)
        return idx

    def _switch_consistent(
        self, scan: Optional[pc.PointBatch], T_map_scan, candidate: int
    ) -> bool:
        """Consistency gate before re-activating an adjacent submap
        (≙ ``isSwitchingSubmapsConsistant``, ``SubmapCollection.cpp:390-402``):
        enough of the scan must overlap the candidate's cloud."""
        if scan is None:
            return True
        from open3d_slam_jax.slam.constraint_builders import overlap_fraction

        posed = scan.transformed(jnp.asarray(T_map_scan, jnp.float32))
        fit = overlap_fraction(
            posed, self.submaps[candidate].state.cloud,
            radius=max(self.cfg.submap_voxel_size, 1e-3),
        )
        return fit > self.cfg.min_fitness_for_switch

    def update_active_submap(
        self,
        robot_pose: np.ndarray,
        scan: Optional[pc.PointBatch] = None,
    ) -> Tuple[int, bool]:
        """(≙ ``updateActiveSubmap``, ``SubmapCollection.cpp:94-148``):
        pick/create the active submap for the current robot pose. Returns
        (active index, switched)."""
        cfg = self.cfg
        if not self.submaps:
            self.active_idx = self._create_submap(robot_pose, None)
            self._scans_in_active = 0
            return self.active_idx, True

        cur = self.active_idx
        if self._force_new_submap:
            # Bank saturation: roll a new submap instead of silently dropping
            # geometry (≙ the maxNumPoints_ force-new path).
            self._force_new_submap = False
            self._finish(cur)
            self.active_idx = self._create_submap(robot_pose, cur)
            self._scans_in_active = 0
            return self.active_idx, True

        if self._scans_in_active < cfg.min_scans_before_switch:
            return cur, False

        pos = np.asarray(robot_pose)[:3, 3]
        d_cur = np.linalg.norm(self.submaps[cur].anchor[:3, 3] - pos)
        if d_cur <= cfg.creation_radius:
            return cur, False

        # Closest existing submap (proximity activation).
        dists = [np.linalg.norm(e.anchor[:3, 3] - pos) for e in self.submaps]
        best = int(np.argmin(dists))
        if dists[best] <= cfg.activation_radius and best != cur:
            if self.adjacency.is_adjacent(cur, best) and self._switch_consistent(
                scan, robot_pose, best
            ):
                self._finish(cur)
                self.active_idx = best
                self._scans_in_active = 0
                return best, True
            # Inconsistent or non-adjacent candidate: only spawn a new submap
            # once we have traveled past the active one's radius
            # (SubmapCollection.cpp:137-143); until then keep the active map.
            if d_cur <= cfg.activation_radius:
                return cur, False

        # Nothing close (or candidate rejected far from home): new submap.
        self._finish(cur)
        self.active_idx = self._create_submap(robot_pose, cur)
        self._scans_in_active = 0
        return self.active_idx, True

    def _finish(self, idx: int) -> None:
        e = self.submaps[idx]
        if not e.finished:
            e.finished = True
            self.finished_queue.append(idx)

    def insert_scan(
        self,
        scan: pc.PointBatch,
        T_map_scan: np.ndarray,
        robot_pose: np.ndarray,
        raw_scan: Optional[pc.PointBatch] = None,
    ) -> Tuple[int, bool]:
        """Insert into the active submap, handling activation/creation,
        periodic space carving (≙ ``Submap::insertScan`` with
        ``isPerformCarving``), and bank-saturation force-new arming."""
        idx, switched = self.update_active_submap(robot_pose, scan=scan)
        e = self.submaps[idx]
        T = jnp.asarray(T_map_scan, jnp.float32)
        if (
            self.cfg.carve_every_n > 0
            and self._scans_in_active > 0
            and self._scans_in_active % self.cfg.carve_every_n == 0
        ):
            # Carve BEFORE merging, with the raw (uncropped) scan when the
            # caller has one — exactly the reference order (Submap.cpp:56-86).
            e.state = submap_mod.carve(
                e.state,
                raw_scan if raw_scan is not None else scan,
                T,
                angle_tol=self.cfg.carve_angle_tol,
                range_margin=self.cfg.carve_range_margin,
            )
        e.state = submap_mod.insert_scan(
            e.state,
            scan,
            T,
            self.cfg.submap_voxel_size,
            self.cfg.submap_crop_radius,
        )
        self._scans_in_active += 1
        # Arm the force-new flag once the bank nears saturation so the next
        # scan opens a fresh submap instead of silently dropping points.
        occupancy = int(jnp.sum(e.state.cloud.mask))
        if occupancy >= self._max_points:
            self._force_new_submap = True
        return idx, switched

    def pop_finished(self) -> Optional[int]:
        return self.finished_queue.pop(0) if self.finished_queue else None

    def apply_pose_updates(self, increments: Dict[int, np.ndarray]) -> None:
        """Rigidly move submaps by optimized increments; un-optimized
        submaps inherit their parent's increment
        (≙ ``SubmapCollection::transform`` parent-chain propagation,
        ``SubmapCollection.cpp:322-373``)."""
        resolved: Dict[int, np.ndarray] = {}

        def resolve(i: int) -> np.ndarray:
            if i in resolved:
                return resolved[i]
            if i in increments:
                resolved[i] = np.asarray(increments[i], np.float64)
            elif self.submaps[i].parent is not None:
                resolved[i] = resolve(self.submaps[i].parent)
            else:
                resolved[i] = np.eye(4)
            return resolved[i]

        for i, e in enumerate(self.submaps):
            T = resolve(i)
            if not np.allclose(T, np.eye(4), atol=1e-9):
                e.state = submap_mod.transform_submap(e.state, jnp.asarray(T, jnp.float32))
                e.anchor = T @ e.anchor

    def map_points(self, max_per_submap: Optional[int] = None) -> np.ndarray:
        """Assembled map (all submaps concatenated, host numpy)."""
        outs = []
        for e in self.submaps:
            m = np.asarray(e.state.cloud.mask)
            pts = np.asarray(e.state.cloud.xyz)[m]
            if max_per_submap is not None and len(pts) > max_per_submap:
                pts = pts[:: len(pts) // max_per_submap + 1]
            outs.append(pts)
        return np.concatenate(outs, axis=0) if outs else np.zeros((0, 3), np.float32)
