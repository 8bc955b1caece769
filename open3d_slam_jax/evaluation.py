"""Batch registration evaluation harness.

Counterpart of libpointmatcher's ``evaluations/eval_solution.cpp``: run a
registration protocol over a dataset of (reading, reference, ground-truth,
initial-guess) tuples, recording per-case pose error and timing, and emit
the summary table that fills ``BASELINE.md`` (time quantiles + error
quantiles, ≙ the stats the reference prints and its notebook plots).

Where the reference walks pairs with a thread pool, here all pairs with a
shared reference shape run as ONE vmapped device batch.

Dataset manifest: CSV with columns
    reading,reference,gt_00..gt_33[,init_00..init_33]
(16 row-major floats for each pose; init defaults to identity), the moral
equivalent of the ETH "Challenging datasets" protocol files
(``evaluations/official_solutions/*.yaml``).
"""

from __future__ import annotations

import csv
import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp


@dataclasses.dataclass
class EvalCase:
    reading: np.ndarray  # [n, 3]
    reference: np.ndarray  # [m, 3]
    T_gt: np.ndarray  # [4, 4]
    T_init: np.ndarray  # [4, 4]
    name: str = ""


@dataclasses.dataclass
class EvalResult:
    name: str
    rot_err_rad: float
    trans_err_m: float
    iterations: int
    converged: bool
    overlap: float
    wall_s: float


def pose_errors(T_est: np.ndarray, T_gt: np.ndarray) -> Tuple[float, float]:
    delta = np.linalg.inv(T_est) @ T_gt
    rot = float(np.arccos(np.clip((np.trace(delta[:3, :3]) - 1) / 2, -1, 1)))
    trans = float(np.linalg.norm(delta[:3, 3]))
    return rot, trans


def load_manifest(path: str) -> List[EvalCase]:
    from open3d_slam_jax.io import load_cloud

    cases = []
    with open(path) as f:
        for row in csv.DictReader(f):
            gt = np.array([float(row[f"gt_{i}{j}"]) for i in range(4) for j in range(4)]).reshape(4, 4)
            if "init_00" in row:
                init = np.array(
                    [float(row[f"init_{i}{j}"]) for i in range(4) for j in range(4)]
                ).reshape(4, 4)
            else:
                init = np.eye(4)
            reading, _ = load_cloud(row["reading"])
            reference, _ = load_cloud(row["reference"])
            cases.append(EvalCase(reading, reference, gt, init, name=row["reading"]))
    return cases


# ---------------------------------------------------------------------------
# Official protocol presets (≙ evaluations/official_solutions/*.yaml).
# Embedded as literal documents (semantic translation of the reference
# protocol files, cited per entry) so the harness runs them without the
# reference checkout present.
# ---------------------------------------------------------------------------

PROTOCOLS = {
    # ≙ evaluations/official_solutions/Besl92_pt2point.yaml: MinDist 1.0 +
    # 5% random sampling on both sides, unbounded knn=1 KDTree, trimmed
    # 0.75, point-to-point, counter 150 + differential 1e-3/1e-2 smooth 4.
    "Besl92_pt2point": {
        "readingDataPointsFilters": [
            {"MinDistDataPointsFilter": {"minDist": 1.0}},
            {"RandomSamplingDataPointsFilter": {"prob": 0.05}},
        ],
        "referenceDataPointsFilters": [
            {"MinDistDataPointsFilter": {"minDist": 1.0}},
            {"RandomSamplingDataPointsFilter": {"prob": 0.05}},
        ],
        "matcher": {"KDTreeMatcher": {"knn": 1, "epsilon": 3.16}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.75}}],
        "errorMinimizer": "PointToPointErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 150}},
            {"DifferentialTransformationChecker": {
                "minDiffRotErr": 0.001, "minDiffTransErr": 0.01,
                "smoothLength": 4}},
        ],
    },
    # ≙ evaluations/official_solutions/Chen91_pt2plane.yaml: same gates but
    # surfel-decimated reference (SamplingSurfaceNormal knn=7 ratio=0.1),
    # trimmed 0.7, point-to-plane.
    "Chen91_pt2plane": {
        "readingDataPointsFilters": [
            {"MinDistDataPointsFilter": {"minDist": 1.0}},
            {"RandomSamplingDataPointsFilter": {"prob": 0.05}},
        ],
        "referenceDataPointsFilters": [
            {"MinDistDataPointsFilter": {"minDist": 1.0}},
            {"SamplingSurfaceNormalDataPointsFilter": {
                "knn": 7, "samplingMethod": 1, "ratio": 0.1}},
        ],
        "matcher": {"KDTreeMatcher": {"knn": 1, "epsilon": 3.16}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.7}}],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 150}},
            {"DifferentialTransformationChecker": {
                "minDiffRotErr": 0.001, "minDiffTransErr": 0.01,
                "smoothLength": 4}},
        ],
    },
}


def protocol_config(name: str, matcher_backend: str = "grid"):
    """(icp_config, reading_chain, reference_chain) for an official
    protocol preset. Chains are ``(PointBatch, key) -> PointBatch``.

    ``matcher_backend`` follows :func:`registry.icp_config_from_dict`
    semantics: the protocol's unbounded KDTreeMatcher always maps to the
    exact streaming brute matcher (maxDist=inf), whatever backend is
    passed for bounded configs.
    """
    from open3d_slam_jax.config import registry

    if name not in PROTOCOLS:
        raise KeyError(f"unknown protocol {name!r} (known: {sorted(PROTOCOLS)})")
    doc = PROTOCOLS[name]
    cfg = registry.icp_config_from_dict(doc, matcher_backend=matcher_backend)
    reading_chain = registry.make_filter_chain(doc.get("readingDataPointsFilters"))
    reference_chain = registry.make_filter_chain(doc.get("referenceDataPointsFilters"))
    return cfg, reading_chain, reference_chain


def evaluate(
    cases: Sequence[EvalCase],
    icp_config,
    reading_capacity: int = 16384,
    reference_capacity: int = 32768,
    normals_knn: int = 10,
    reading_filters=None,
    reference_filters=None,
    device_timing_reps: int = 0,
    seed: int = 0,
) -> Tuple[List[EvalResult], dict]:
    """Run the protocol; returns per-case results + the summary table.

    ``reading_filters`` / ``reference_filters``: optional
    ``(PointBatch, key) -> PointBatch`` chains applied before registration
    (≙ the protocol yaml's DataPointsFilters; see :func:`protocol_config`).
    Reference-side normals are estimated only when the chain did not
    already produce them (≙ the reference estimating normals via
    SamplingSurfaceNormal inside the chain).

    ``device_timing_reps > 0``: after the accuracy pass, each case's
    registration is re-run that many times, compiled and each call waited
    for with ``block_until_ready`` — the steady-state per-pair time,
    reported as ``device_p50_s`` (the ``eval_solution.cpp``
    per-registration timing column). The first
    case's ``wall_s`` still includes compilation; use the summary's
    ``wall_p50_s``/``device_p50_s`` for throughput claims.
    """
    import jax as _jax

    from open3d_slam_jax.models import icp as icp_mod
    from open3d_slam_jax.ops import normals as normals_mod
    from open3d_slam_jax.ops import pointcloud as pc

    results: List[EvalResult] = []
    device_times: List[float] = []
    key = _jax.random.key(seed)
    for case in cases:
        key, k_read, k_ref = _jax.random.split(key, 3)
        reference = pc.from_points(case.reference, capacity=reference_capacity)
        if reference_filters is not None:
            reference = reference_filters(reference, k_ref)
        if reference.normals is None and icp_config.minimizer != "point_to_point":
            reference = normals_mod.estimate_normals(
                reference, knn=normals_knn,
                max_dist=4.0 * min(icp_config.max_match_dist, 1e6),
            )
        reading = pc.from_points(case.reading, capacity=reading_capacity)
        if reading_filters is not None:
            reading = reading_filters(reading, k_read)
        if icp_config.minimizer == "gicp" and reading.normals is None:
            reading = normals_mod.estimate_normals(
                reading, knn=normals_knn,
                max_dist=4.0 * min(icp_config.max_match_dist, 1e6),
            )
        t0 = time.perf_counter()
        res = icp_mod.register_pair(
            reading, reference, jnp.asarray(case.T_init, jnp.float32), icp_config
        )
        T = np.asarray(res.transform)  # sync
        wall = time.perf_counter() - t0
        rot, trans = pose_errors(T, case.T_gt)
        results.append(
            EvalResult(
                name=case.name,
                rot_err_rad=rot,
                trans_err_m=trans,
                iterations=int(res.iterations),
                converged=bool(res.converged),
                overlap=float(res.overlap_ratio),
                wall_s=wall,
            )
        )
        if device_timing_reps > 0:
            from open3d_slam_jax.utils.timing import time_device_fn

            def _reg(init_T, reading_, reference_):
                return icp_mod.register_pair(
                    reading_, reference_, init_T, icp_config
                ).transform

            device_times.append(
                time_device_fn(
                    _reg,
                    (jnp.asarray(case.T_init, jnp.float32), reading, reference),
                    iters=device_timing_reps,
                )
            )

    trans = np.array([r.trans_err_m for r in results])
    rot = np.array([r.rot_err_rad for r in results])
    walls = np.array([r.wall_s for r in results])
    summary = dict(
        cases=len(results),
        converged_frac=float(np.mean([r.converged for r in results])),
        trans_err_p50_m=float(np.median(trans)),
        trans_err_p95_m=float(np.percentile(trans, 95)),
        rot_err_p50_rad=float(np.median(rot)),
        rot_err_p95_rad=float(np.percentile(rot, 95)),
        wall_p50_s=float(np.median(walls)),
        wall_mean_s=float(np.mean(walls)),
        device=str(_jax.devices()[0]),
    )
    if device_times:
        summary["device_p50_s"] = float(np.median(device_times))
        summary["device_mean_s"] = float(np.mean(device_times))
    return results, summary


def write_report(path: str, results: Sequence[EvalResult], summary: dict) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "trans_err_m", "rot_err_rad", "iterations", "converged", "overlap", "wall_s"])
        for r in results:
            w.writerow([r.name, r.trans_err_m, r.rot_err_rad, r.iterations, r.converged, r.overlap, r.wall_s])
        w.writerow([])
        for k, v in summary.items():
            w.writerow([k, v])


def read_report(path: str) -> Tuple[List[dict], dict]:
    """Parse a :func:`write_report` CSV back into (rows, summary)."""
    rows: List[dict] = []
    summary: dict = {}
    header: List[str] = []
    with open(path, newline="") as f:
        for rec in csv.reader(f):
            if not rec or not any(rec) or rec[0].startswith("#"):
                continue
            if not header:
                if rec[0] == "name":
                    header = rec
                continue
            if len(rec) == len(header):
                try:
                    row = dict(zip(header, rec))
                    for k in ("trans_err_m", "rot_err_rad", "overlap", "wall_s"):
                        row[k] = float(row[k])
                    row["iterations"] = int(row["iterations"])
                    row["converged"] = row["converged"] == "True"
                    rows.append(row)
                    continue
                except ValueError:
                    pass  # fall through: a summary/other-protocol row
            summary[rec[0]] = rec[1] if len(rec) > 1 else ""
    return rows, summary


def render_report(csv_path: str, png_path: str) -> None:
    """Visual evaluation report (≙ the reference's result-plotting notebook,
    ``evaluations/jupyter/PlotSingleResults.ipynb``): error distributions,
    per-case wall time, and the error/overlap scatter, rendered from a
    :func:`write_report` CSV. Offline tooling — uses matplotlib (Agg)."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "render_report needs matplotlib; install it or use the CSV directly"
        ) from e

    rows, summary = read_report(csv_path)
    if not rows:
        raise ValueError(f"no result rows in {csv_path}")
    te = np.array([r["trans_err_m"] for r in rows])
    re_ = np.array([r["rot_err_rad"] for r in rows])
    ws = np.array([r["wall_s"] for r in rows])
    ov = np.array([r["overlap"] for r in rows])
    conv = np.array([r["converged"] for r in rows])

    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    fig.suptitle(f"evaluation report — {len(rows)} cases", fontsize=13)

    ax = axes[0, 0]
    ax.hist(te * 1e3, bins=min(30, max(5, len(te))), color="#4878cf", alpha=0.85)
    ax.axvline(float(np.median(te)) * 1e3, color="k", ls="--", lw=1,
               label=f"median {np.median(te) * 1e3:.2f} mm")
    ax.set_xlabel("translation error [mm]")
    ax.set_ylabel("cases")
    ax.legend(frameon=False)

    ax = axes[0, 1]
    ax.hist(np.degrees(re_), bins=min(30, max(5, len(re_))), color="#d65f5f", alpha=0.85)
    ax.axvline(float(np.degrees(np.median(re_))), color="k", ls="--", lw=1,
               label=f"median {np.degrees(np.median(re_)):.3f} deg")
    ax.set_xlabel("rotation error [deg]")
    ax.set_ylabel("cases")
    ax.legend(frameon=False)

    ax = axes[1, 0]
    ax.bar(np.arange(len(ws)), ws * 1e3, color="#6acc65")
    ax.set_xlabel("case index")
    ax.set_ylabel("wall time [ms]")

    ax = axes[1, 1]
    ax.scatter(ov[conv], te[conv] * 1e3, s=18, c="#4878cf", label="converged")
    if (~conv).any():
        ax.scatter(ov[~conv], te[~conv] * 1e3, s=22, c="#d65f5f", marker="x",
                   label="not converged")
    ax.set_xlabel("overlap ratio")
    ax.set_ylabel("translation error [mm]")
    ax.set_yscale("log")
    ax.legend(frameon=False)

    for a in axes.flat:
        a.spines[["top", "right"]].set_visible(False)
    fig.tight_layout(rect=(0, 0, 1, 0.96))
    fig.savefig(png_path, dpi=110)
    plt.close(fig)
