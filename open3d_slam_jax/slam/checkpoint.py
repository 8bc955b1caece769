"""Checkpoint / resume of the full SLAM state.

The reference checkpoints at the map level: PCD dumps of submaps + a pose
graph JSON (``SlamWrapper.cpp:499-517``, ``OptimizationProblem.cpp:142-149``),
and "resume" means relocalizing on the saved map. This module does both —
the map-level artifact (PLY + JSON, interoperable) and a *full run-level*
checkpoint (single ``.npz``) capturing what the reference cannot: submap
banks, anchors, adjacency, pose buffers, loop-closure constraints and the
live pose, so a stream can continue exactly where it stopped.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING

import jax.numpy as jnp
import numpy as np

if TYPE_CHECKING:
    from open3d_slam_jax.slam.pipeline import SlamPipeline


def save_pipeline(pipe: "SlamPipeline", path: str) -> None:
    """Full run-level checkpoint into one .npz."""
    arrays = {}
    meta = {
        "n_submaps": len(pipe.submaps),
        "active_idx": pipe.submaps.active_idx,
        "scan_count": pipe._scan_count,
        "scans_since_reinit": pipe._scans_since_reinit,
        "initialized": pipe._initialized,
        "ref_submap_idx": pipe._ref_submap_idx,
        "ref_center": (
            np.asarray(pipe._ref_center).tolist()
            if getattr(pipe, "_ref_center", None) is not None
            else None
        ),
        "parents": [e.parent if e.parent is not None else -1 for e in pipe.submaps.submaps],
        "finished": [bool(e.finished) for e in pipe.submaps.submaps],
        "adjacency": sorted(
            [i, j]
            for i, nbrs in pipe.submaps.adjacency._adj.items()
            for j in nbrs
            if i < j
        ),
        "loop_constraints": [
            dict(
                source=c.source_idx, target=c.target_idx,
                T=np.asarray(c.T_target_source).tolist(),
                overlap=c.overlap, residual=c.residual,
                information=np.asarray(c.information).tolist(),
            )
            for c in pipe._loop_constraints
        ],
    }
    meta["last_scan_time"] = pipe._last_scan_time
    meta["attitude_initialized"] = bool(pipe._attitude_initialized)
    meta["force_new_submap"] = bool(pipe.submaps._force_new_submap)
    arrays["last_motion_twist"] = np.asarray(pipe._last_motion_twist)
    arrays["imu_times"] = np.asarray(pipe.imu_buffer._times)
    arrays["imu_acc"] = (
        np.stack(pipe.imu_buffer._acc) if pipe.imu_buffer._acc else np.zeros((0, 3))
    )
    arrays["imu_gyro"] = (
        np.stack(pipe.imu_buffer._gyro) if pipe.imu_buffer._gyro else np.zeros((0, 3))
    )
    arrays["map_pose"] = np.asarray(pipe._map_pose)
    arrays["last_insert_pose"] = (
        np.asarray(pipe._last_insert_pose)
        if pipe._last_insert_pose is not None
        else np.full((4, 4), np.nan)
    )
    arrays["prev_odom_pose"] = (
        np.asarray(pipe._prev_odom_pose)
        if pipe._prev_odom_pose is not None
        else np.full((4, 4), np.nan)
    )
    # Pose buffers.
    arrays["odom_times"] = np.asarray(pipe.odom_buffer._times)
    arrays["odom_poses"] = (
        np.stack(pipe.odom_buffer._poses) if pipe.odom_buffer._poses else np.zeros((0, 4, 4))
    )
    arrays["map_times"] = np.asarray(pipe.map_pose_buffer._times)
    arrays["map_poses"] = (
        np.stack(pipe.map_pose_buffer._poses)
        if pipe.map_pose_buffer._poses
        else np.zeros((0, 4, 4))
    )
    # The live matching reference is a SNAPSHOT of the active submap taken
    # at the last re-init — by design stale relative to the bank (newer
    # scans were inserted since). Bit-exact resume requires the snapshot
    # itself, not a rebuild from the current bank.
    if pipe._ref is not None:
        refc = pipe._ref.cloud
        arrays["ref_patch_xyz"] = np.asarray(refc.xyz)  # centered frame
        arrays["ref_centroid"] = np.asarray(pipe._ref.centroid)
        arrays["ref_patch_mask"] = np.asarray(refc.mask)
        if refc.normals is not None:
            arrays["ref_patch_normals"] = np.asarray(refc.normals)
    arrays["submap_scans_in_active"] = np.asarray(pipe.submaps._scans_in_active)
    arrays["finished_queue"] = np.asarray(pipe.submaps.finished_queue, np.int64)
    for i, e in enumerate(pipe.submaps.submaps):
        arrays[f"submap_{i}_xyz"] = np.asarray(e.state.cloud.xyz)
        arrays[f"submap_{i}_mask"] = np.asarray(e.state.cloud.mask)
        arrays[f"submap_{i}_pose"] = np.asarray(e.state.pose)
        arrays[f"submap_{i}_num_scans"] = np.asarray(e.state.num_scans)
        arrays[f"submap_{i}_anchor"] = np.asarray(e.anchor)
    np.savez_compressed(path, meta=json.dumps(meta), **arrays)


def load_pipeline(pipe: "SlamPipeline", path: str) -> "SlamPipeline":
    """Restore a checkpoint into a freshly constructed pipeline (configs
    must match — capacities are validated)."""
    import dataclasses

    from open3d_slam_jax.ops.pointcloud import PointBatch
    from open3d_slam_jax.slam import submap as submap_mod
    from open3d_slam_jax.slam.place_recognition import LoopClosureConstraint
    from open3d_slam_jax.slam.submap_collection import SubmapEntry

    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))

    pipe.submaps.submaps = []
    for i in range(meta["n_submaps"]):
        xyz = jnp.asarray(data[f"submap_{i}_xyz"])
        if xyz.shape[0] != pipe.cfg.submaps.submap_capacity:
            raise ValueError(
                f"checkpoint submap capacity {xyz.shape[0]} != config "
                f"{pipe.cfg.submaps.submap_capacity}"
            )
        state = submap_mod.SubmapState(
            cloud=PointBatch(xyz=xyz, mask=jnp.asarray(data[f"submap_{i}_mask"]), extras={}),
            pose=jnp.asarray(data[f"submap_{i}_pose"]),
            num_scans=jnp.asarray(data[f"submap_{i}_num_scans"]),
        )
        parent = meta["parents"][i]
        entry = SubmapEntry(
            state=state,
            anchor=np.asarray(data[f"submap_{i}_anchor"], np.float64),
            parent=None if parent < 0 else parent,
            finished=bool(meta["finished"][i]),
        )
        pipe.submaps.submaps.append(entry)
    pipe.submaps.active_idx = meta["active_idx"]
    for i, j in meta["adjacency"]:
        pipe.submaps.adjacency.add_edge(int(i), int(j))
    pipe._loop_constraints = [
        LoopClosureConstraint(
            source_idx=c["source"], target_idx=c["target"],
            T_target_source=np.asarray(c["T"]),
            overlap=c["overlap"], residual=c["residual"],
            information=np.asarray(c["information"]),
        )
        for c in meta["loop_constraints"]
    ]
    pipe._map_pose = np.asarray(data["map_pose"], np.float64)
    lip = np.asarray(data["last_insert_pose"])
    pipe._last_insert_pose = None if np.any(np.isnan(lip)) else lip.astype(np.float64)
    pop = np.asarray(data["prev_odom_pose"])
    pipe._prev_odom_pose = None if np.any(np.isnan(pop)) else pop.astype(np.float64)
    for t, T in zip(data["odom_times"], data["odom_poses"]):
        pipe.odom_buffer.push(float(t), T)
    for t, T in zip(data["map_times"], data["map_poses"]):
        pipe.map_pose_buffer.push(float(t), T)
    pipe._scan_count = meta["scan_count"]
    pipe._initialized = bool(meta["initialized"])
    pipe.submaps._scans_in_active = int(data["submap_scans_in_active"])
    pipe.submaps.finished_queue = [int(v) for v in data["finished_queue"]]
    if pipe._initialized and "ref_patch_xyz" in data:
        # Restore the matching reference bit-exactly from its checkpointed
        # snapshot: centered cloud + centroid as saved, grid rebuilt
        # deterministically from the identical centered coordinates.
        from open3d_slam_jax.models import icp as icp_mod
        from open3d_slam_jax.ops import cell_list as cell_mod

        extras = {}
        if "ref_patch_normals" in data:
            extras["normals"] = jnp.asarray(data["ref_patch_normals"])
        centered = PointBatch(
            xyz=jnp.asarray(data["ref_patch_xyz"]),
            mask=jnp.asarray(data["ref_patch_mask"]),
            extras=extras,
        )
        icp_cfg = pipe.cfg.mapper.icp
        slack = icp_cfg.candidate_slack if icp_cfg.candidate_refresh_every > 0 else 0.0
        grid = cell_mod.build_cell_list(
            centered.padded_xyz(), centered.mask,
            icp_cfg.max_match_dist + slack,
            table_size=icp_cfg.grid_table_size,
            list_cap=icp_cfg.grid_bucket_cap,
            normals=centered.normals,
        ) if icp_cfg.matcher == "grid" else None
        pipe._ref = icp_mod.ICPReference(
            cloud=centered, centroid=jnp.asarray(data["ref_centroid"]), grid=grid
        )
        pipe._ref_submap_idx = meta.get("ref_submap_idx", pipe.submaps.active_idx)
        center = meta.get("ref_center")
        pipe._ref_center = None if center is None else np.asarray(center)
    elif pipe._initialized and meta["n_submaps"] > 0:
        pipe._rebuild_reference()
    pipe._scans_since_reinit = meta["scans_since_reinit"]
    # Motion subsystem state (round-2 fields; tolerate older checkpoints).
    pipe._last_scan_time = meta.get("last_scan_time")
    pipe._attitude_initialized = bool(meta.get("attitude_initialized", False))
    pipe.submaps._force_new_submap = bool(meta.get("force_new_submap", False))
    if "last_motion_twist" in data:
        pipe._last_motion_twist = np.asarray(data["last_motion_twist"], np.float64)
    if "imu_times" in data:
        for t, a, g in zip(data["imu_times"], data["imu_acc"], data["imu_gyro"]):
            pipe.imu_buffer.push(float(t), a, g)
    return pipe


def save_map_artifacts(pipe: "SlamPipeline", out_dir: str) -> None:
    """Reference-style map-level artifacts: assembled map PLY, per-submap
    PLYs, pose-graph JSON (≙ saveMap/saveSubmaps + pose graph dump)."""
    from open3d_slam_jax.io import save_ply

    os.makedirs(out_dir, exist_ok=True)
    save_ply(os.path.join(out_dir, "map.ply"), pipe.assembled_map())
    graph = {"nodes": [], "edges": []}
    for i, e in enumerate(pipe.submaps.submaps):
        m = np.asarray(e.state.cloud.mask)
        save_ply(
            os.path.join(out_dir, f"submap_{i:03d}.ply"),
            np.asarray(e.state.cloud.xyz)[m],
        )
        graph["nodes"].append({"id": i, "pose": e.anchor.tolist()})
        if e.parent is not None:
            graph["edges"].append({"from": e.parent, "to": i, "type": "odometry"})
    for c in pipe._loop_constraints:
        graph["edges"].append(
            {"from": c.target_idx, "to": c.source_idx, "type": "loop",
             "T": np.asarray(c.T_target_source).tolist()}
        )
    with open(os.path.join(out_dir, "pose_graph.json"), "w") as f:
        json.dump(graph, f, indent=2)
