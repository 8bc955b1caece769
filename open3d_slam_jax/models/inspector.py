"""Registration inspectors — per-iteration observability.

Counterpart of libpointmatcher's ``Inspector`` family
(``InspectorsImpl.h:60-158``): the ``PerformanceInspector`` collects named
stats; the ``VTKFileInspector`` dumps per-iteration clouds/matches for
offline replay of the optimization.

Here the trace is captured *on device* by running the ICP chain under a
fixed-length ``lax.scan`` that records the transform, residual, match ratio
and hessian spectrum at every iteration (no host round-trips inside the
loop), then dumped to PLY + JSON on request.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops.pointcloud import PointBatch


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ICPTrace:
    """Per-iteration observables of one registration."""

    transforms: jax.Array  # [I, 4, 4] pose after each iteration
    residuals: jax.Array  # [I]
    match_ratios: jax.Array  # [I]
    overlaps: jax.Array  # [I]
    eigenvalues: jax.Array  # [I, 6]
    delta_rot: jax.Array  # [I] per-iteration rotation change
    delta_trans: jax.Array  # [I]


@functools.partial(jax.jit, static_argnames=("cfg", "iterations"))
def trace_icp(
    reading: PointBatch,
    ref: icp_mod.ICPReference,
    init_T: jax.Array,
    cfg: icp_mod.ICPConfig,
    iterations: int = 30,
) -> ICPTrace:
    """Run ``iterations`` ICP steps recording everything (no early exit —
    the inspector wants the full optimization trajectory)."""
    dtype = reading.xyz.dtype
    shift = jnp.eye(4, dtype=dtype).at[:3, 3].set(-ref.centroid)
    unshift = jnp.eye(4, dtype=dtype).at[:3, 3].set(ref.centroid)
    T0 = shift @ init_T

    # Reuse the engine's single-iteration math via a 1-iteration loop run.
    one_cfg = dataclasses.replace(
        cfg, max_iterations=1, coarse_iterations=0, candidate_refresh_every=0,
        min_diff_rot=0.0, min_diff_trans=0.0,
    )

    def step(T, _):
        st = icp_mod._run_gn_loop(reading, ref, T, one_cfg, 1)
        out = (
            unshift @ st["T"],
            st["resid"],
            st["match_ratio"],
            st["overlap"],
            st["loc"].eigenvalues6,
            st["drot"][0],
            st["dtrans"][0],
        )
        return st["T"], out

    _, (Ts, res, mr, ov, eig, dr, dt) = jax.lax.scan(step, T0, None, length=iterations)
    return ICPTrace(
        transforms=Ts, residuals=res, match_ratios=mr, overlaps=ov,
        eigenvalues=eig, delta_rot=dr, delta_trans=dt,
    )


def dump_trace(
    trace: ICPTrace,
    reading: PointBatch,
    ref: icp_mod.ICPReference,
    out_dir: str,
    every: int = 1,
    max_points: int = 20000,
    fmt: str = "ply",
    binary: bool = False,
) -> str:
    """Write per-iteration reading clouds (posed) + reference + stats JSON
    (≙ VTKFileInspector's dumpIteration). Returns the stats path.

    ``fmt="vtk"`` writes the series as legacy VTK polydata files named like
    the reference's VTKFileInspector output
    (``point_cloud-reading-<iter>.vtk`` / ``point_cloud-reference.vtk``,
    InspectorsImpl.cpp openStream naming) — loadable by ParaView and the
    reference's own tooling; ``binary=True`` uses big-endian binary VTK.
    """
    from open3d_slam_jax.io import save_ply
    from open3d_slam_jax.io.pointcloud_io import save_vtk

    os.makedirs(out_dir, exist_ok=True)
    mask = np.asarray(reading.mask)
    pts = np.asarray(reading.xyz)[mask][:max_points]
    ref_mask = np.asarray(ref.cloud.mask)
    ref_pts = (np.asarray(ref.cloud.xyz) + np.asarray(ref.centroid))[ref_mask][:max_points]

    if fmt == "vtk":
        save_vtk(os.path.join(out_dir, "point_cloud-reference.vtk"), ref_pts, binary=binary)
    elif fmt == "ply":
        save_ply(os.path.join(out_dir, "reference.ply"), ref_pts)
    else:
        raise ValueError(f"unknown inspector dump format {fmt!r} (ply|vtk)")

    Ts = np.asarray(trace.transforms)
    for i in range(0, len(Ts), every):
        posed = (pts @ Ts[i][:3, :3].T + Ts[i][:3, 3]).astype(np.float32)
        if fmt == "vtk":
            save_vtk(
                os.path.join(out_dir, f"point_cloud-reading-{i}.vtk"),
                posed, binary=binary,
            )
        else:
            save_ply(os.path.join(out_dir, f"reading_iter_{i:03d}.ply"), posed)

    stats = {
        "iterations": int(len(Ts)),
        "residuals": np.asarray(trace.residuals).tolist(),
        "match_ratios": np.asarray(trace.match_ratios).tolist(),
        "overlaps": np.asarray(trace.overlaps).tolist(),
        "delta_rot": np.asarray(trace.delta_rot).tolist(),
        "delta_trans": np.asarray(trace.delta_trans).tolist(),
        "eigenvalues_final": np.asarray(trace.eigenvalues[-1]).tolist(),
        "final_transform": Ts[-1].tolist(),
    }
    path = os.path.join(out_dir, "stats.json")
    with open(path, "w") as f:
        json.dump(stats, f, indent=2)
    return path


class PerformanceInspector:
    """Named-stat collector (≙ PerformanceInspector's addStat channel)."""

    def __init__(self):
        self.stats: dict = {}

    def add_stat(self, name: str, value: float) -> None:
        self.stats.setdefault(name, []).append(float(value))

    def add_trace(self, trace: ICPTrace) -> None:
        self.add_stat("IterationsCount", len(np.asarray(trace.residuals)))
        self.add_stat("OverlapRatio", float(np.asarray(trace.overlaps)[-1]))
        self.add_stat("Residual", float(np.asarray(trace.residuals)[-1]))

    def summary(self) -> dict:
        return {
            k: dict(count=len(v), mean=float(np.mean(v)), last=v[-1])
            for k, v in self.stats.items()
        }
