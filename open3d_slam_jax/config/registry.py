"""Name -> op registry speaking the reference's YAML vocabulary.

The reference instantiates its ICP chain from YAML via the ``Registrar``
factory (``Registrar.h:185-227``, module names registered in
``Registry.cpp:60-130``); production config at
``ros/open3d_slam_ros/param/icp.yaml``. This module accepts those exact
files: the same module names and parameter keys are translated into the
engine's typed configs, so a user of the reference can bring their
icp.yaml unchanged.

Two registries:
- :data:`FILTER_REGISTRY`: DataPointsFilter names -> callables
  ``(PointBatch, key, params) -> PointBatch``;
- the ICP chain translator :func:`icp_config_from_dict` covering matcher /
  outlierFilters / errorMinimizer / transformationCheckers / degeneracy
  options.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

import jax

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.models.localizability import DegeneracyConfig
from open3d_slam_jax.ops import filters, voxel
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops.pointcloud import PointBatch


def load_yaml(path_or_stream) -> dict:
    import yaml

    if hasattr(path_or_stream, "read"):
        return yaml.safe_load(path_or_stream)
    with open(path_or_stream) as f:
        return yaml.safe_load(f)


def _f(params: dict, key: str, default):
    v = params.get(key, default)
    return type(default)(v) if default is not None else v


# ---------------------------------------------------------------------------
# DataPointsFilters (Registry.cpp:67-96 names).
# ---------------------------------------------------------------------------


def _identity(b, key, p):
    return b


def _remove_nan(b, key, p):
    return filters.remove_nan(b)


def _max_dist(b, key, p):
    dim = int(p.get("dim", -1))
    d = float(p.get("maxDist", 1.0))
    if dim < 0:
        return filters.max_dist(b, d)
    return filters.axis_dist(b, dim, d, keep_inside=True)


def _min_dist(b, key, p):
    dim = int(p.get("dim", -1))
    d = float(p.get("minDist", 1.0))
    if dim < 0:
        return filters.min_dist(b, d)
    return filters.axis_dist(b, dim, d, keep_inside=False)


def _bounding_box(b, key, p):
    lo = [float(p.get("xMin", -1)), float(p.get("yMin", -1)), float(p.get("zMin", -1))]
    hi = [float(p.get("xMax", 1)), float(p.get("yMax", 1)), float(p.get("zMax", 1))]
    return filters.bounding_box(b, lo, hi, remove_inside=bool(int(p.get("removeInside", 1))))


def _distance_limit(b, key, p):
    return filters.distance_limit(
        b,
        axis=int(p.get("dim", -1)),
        dist=float(p.get("dist", 1.0)),
        keep_inside=bool(int(p.get("removeInside", 0))) is False,
    )


def _max_quantile(b, key, p):
    return filters.max_quantile_on_axis(b, int(p.get("dim", 0)), float(p.get("ratio", 0.5)))


def _random_sampling(b, key, p):
    return filters.random_sampling(b, key, float(p.get("prob", 0.75)))


def _max_point_count(b, key, p):
    return filters.max_point_count(b, key, int(p.get("maxCount", 1000)))


def _fix_step(b, key, p):
    return filters.fix_step_sampling(b, int(float(p.get("startStep", 10))))


def _voxel_grid(b, key, p):
    size = float(p.get("vSizeX", 0.2))
    if bool(int(p.get("useCentroid", 1))):
        return voxel.voxel_downsample(b, size)
    return voxel.voxel_first_point(b, size)


def _octree_grid(b, key, p):
    # Octree sampling at a fixed leaf size is voxel sampling (the reference's
    # OctreeGridDataPointsFilter with samplingMethod=centroid).
    return voxel.voxel_downsample(b, float(p.get("maxSizeByNode", 0.2)))


def _surface_normal(b, key, p):
    return normals_mod.estimate_normals(
        b,
        knn=int(p.get("knn", 5)),
        return_eigen=bool(int(p.get("keepEigenValues", 0))),
    )


def _sampling_surface_normal(b, key, p):
    out = normals_mod.estimate_normals(b, knn=int(p.get("knn", 5)))
    ratio = float(p.get("ratio", 0.5))
    if ratio < 1.0:
        out = filters.random_sampling(out, key, ratio)
    return out


def _orient_normals(b, key, p):
    return filters.orient_normals(
        b,
        towards=(0.0, 0.0, 0.0),
        toward_center=bool(int(p.get("towardCenter", 1))),
    )


def _observation_direction(b, key, p):
    return filters.observation_direction(
        b, sensor=(float(p.get("x", 0)), float(p.get("y", 0)), float(p.get("z", 0)))
    )


def _shadow(b, key, p):
    return filters.shadow_filter(b, eps=float(p.get("eps", 0.1)))


def _simple_sensor_noise(b, key, p):
    return filters.simple_sensor_noise(b, gain=float(p.get("gain", 1.0)))


def _incidence_angle(b, key, p):
    return filters.incidence_angle(b)


def _cut_at_descriptor(b, key, p):
    return filters.cut_at_descriptor_threshold(
        b,
        name=str(p.get("descName", "")),
        threshold=float(p.get("threshold", 0.0)),
        use_larger_than=bool(int(p.get("useLargerThan", 1))),
    )


def _max_density(b, key, p):
    return filters.max_density(b, key, float(p.get("maxDensity", 10.0)))


def _normal_space(b, key, p):
    return filters.normal_space_sampling(
        b, key, target_count=int(float(p.get("nbSample", 5000)))
    )


def _covariance_sampling(b, key, p):
    return filters.covariance_sampling(b, target_count=int(float(p.get("nbSample", 5000))))


def _remove_sensor_bias(b, key, p):
    return filters.remove_sensor_bias(
        b,
        sensor_type=int(p.get("sensorType", 0)),
        angle_threshold_deg=float(p.get("angleThreshold", 88.0)),
    )


def _hidden_point_removal(b, key, p):
    # Host-side (scipy convex hull), exactly like the reference's Open3D CPU
    # path — not jittable; runs between device stages.
    import numpy as np

    vp = (
        float(p.get("vPositionX", 0.0)),
        float(p.get("vPositionY", 0.0)),
        float(p.get("vPositionZ", 0.0)),
    )
    xyz = np.asarray(b.xyz)
    mask = np.asarray(b.mask)
    keep_valid = filters.hidden_point_removal(
        xyz[mask], vp, radius=float(p.get("radius", 100.0))
    )
    keep = np.zeros(b.capacity, bool)
    keep[np.flatnonzero(mask)[keep_valid]] = True
    return b.with_mask(jax.numpy.asarray(keep))


def _organized_surface_normal(b, key, p):
    # The reference reads the cloud's 2-D indexGrid (organized scans,
    # PointMatcher.h:222-405). An organized PointBatch carries the same
    # grid (pc.from_organized); flat batches may supply the range-image
    # shape via ``rows``/``cols`` (row-major layout assumed).
    from open3d_slam_jax.ops import pointcloud as _pc

    if b.index_grid is not None:
        img, valid = _pc.organized_view(b)
        n_img = normals_mod.estimate_normals_organized(img, valid)
        # Scatter image normals back to the point axis through the grid.
        g = b.index_grid.reshape(-1)
        n_flat = jax.numpy.zeros((b.capacity, 3), b.xyz.dtype)
        n_flat = n_flat.at[jax.numpy.maximum(g, 0)].set(
            jax.numpy.where((g >= 0)[:, None], n_img.reshape(-1, 3), 0.0)
        )
        return b.with_extras(normals=n_flat)
    if "rows" not in p or "cols" not in p:
        raise KeyError(
            "OrganizedCloudSurfaceNormalDataPointsFilter needs an organized "
            "batch (index_grid) or 'rows'/'cols' params; row-major "
            "[rows*cols] layout assumed"
        )
    rows, cols = int(p["rows"]), int(p["cols"])
    if rows * cols != b.capacity:
        raise ValueError(
            f"rows*cols = {rows * cols} != point capacity {b.capacity}"
        )
    img = b.xyz.reshape(rows, cols, 3)
    valid = b.mask.reshape(rows, cols)
    n = normals_mod.estimate_normals_organized(img, valid)
    return b.with_extras(normals=n.reshape(-1, 3))


def _elipsoids(b, key, p):
    from open3d_slam_jax.ops import surfels

    return surfels.elipsoids(
        b,
        box_size=float(p.get("maxBoxDim", 0.2)),
        min_planarity=float(p.get("minPlanarity", 0.0)),
        keep_covariances=bool(int(p.get("keepCovariances", 0))),
    )


def _gestalt(b, key, p):
    from open3d_slam_jax.ops import surfels

    ratio = float(p.get("ratio", 0.1))
    kp = filters.random_sampling(b, key, ratio)
    desc = surfels.gestalt(b, kp.xyz, kp.mask, radius=float(p.get("radius", 5.0)))
    extras = dict(kp.extras)
    extras["gestaltMeans"] = desc["means"]
    extras["gestaltVariances"] = desc["variances"]
    extras["normals"] = desc["normals"]
    import dataclasses as _dc

    return _dc.replace(kp, extras=extras)


FILTER_REGISTRY: Dict[str, Callable] = {
    "IdentityDataPointsFilter": _identity,
    "RemoveNaNDataPointsFilter": _remove_nan,
    "MaxDistDataPointsFilter": _max_dist,
    "MinDistDataPointsFilter": _min_dist,
    "BoundingBoxDataPointsFilter": _bounding_box,
    "DistanceLimitDataPointsFilter": _distance_limit,
    "MaxQuantileOnAxisDataPointsFilter": _max_quantile,
    "RandomSamplingDataPointsFilter": _random_sampling,
    "MaxPointCountDataPointsFilter": _max_point_count,
    "FixStepSamplingDataPointsFilter": _fix_step,
    "VoxelGridDataPointsFilter": _voxel_grid,
    "OctreeGridDataPointsFilter": _octree_grid,
    "SurfaceNormalDataPointsFilter": _surface_normal,
    "SamplingSurfaceNormalDataPointsFilter": _sampling_surface_normal,
    "OrientNormalsDataPointsFilter": _orient_normals,
    "ObservationDirectionDataPointsFilter": _observation_direction,
    "ShadowDataPointsFilter": _shadow,
    "SimpleSensorNoiseDataPointsFilter": _simple_sensor_noise,
    "IncidenceAngleDataPointsFilter": _incidence_angle,
    "CutAtDescriptorThresholdDataPointsFilter": _cut_at_descriptor,
    "MaxDensityDataPointsFilter": _max_density,
    "NormalSpaceDataPointsFilter": _normal_space,
    "CovarianceSamplingDataPointsFilter": _covariance_sampling,
    "RemoveSensorBiasDataPointsFilter": _remove_sensor_bias,
    "ElipsoidsDataPointsFilter": _elipsoids,
    "GestaltDataPointsFilter": _gestalt,
    "HiddenPointRemovalDataPointsFilter": _hidden_point_removal,
    "OrganizedCloudSurfaceNormalDataPointsFilter": _organized_surface_normal,
}


def make_filter_chain(spec: Optional[List]) -> Callable:
    """Build ``(PointBatch, key) -> PointBatch`` from a YAML filter list
    (list of name-> params dicts, reference style)."""
    steps = []
    for item in spec or []:
        if isinstance(item, str):
            name, params = item, {}
        else:
            (name, params), = item.items()
            params = params or {}
        if name not in FILTER_REGISTRY:
            raise KeyError(
                f"unknown DataPointsFilter '{name}' (known: {sorted(FILTER_REGISTRY)})"
            )
        steps.append((FILTER_REGISTRY[name], params))

    def chain(batch: PointBatch, rng_key) -> PointBatch:
        for fn, params in steps:
            rng_key, sub = jax.random.split(rng_key)
            batch = fn(batch, sub, params)
        return batch

    return chain


# ---------------------------------------------------------------------------
# ICP chain translation (icp.yaml vocabulary -> ICPConfig).
# ---------------------------------------------------------------------------


def _single(d):
    if isinstance(d, str):
        return d, {}
    (name, params), = d.items()
    return name, (params or {})


def icp_config_from_dict(doc: dict, matcher_backend: str = "grid") -> icp_mod.ICPConfig:
    """Translate a libpointmatcher icp.yaml document into an ICPConfig.

    Unknown/unsupported modules raise. The reading/reference filter chains
    are returned separately by :func:`make_filter_chain` — call it on
    ``doc["readingDataPointsFilters"]`` etc.
    """
    kw: Dict[str, Any] = {}

    # Matcher.
    if "matcher" in doc:
        name, p = _single(doc["matcher"])
        if name not in ("KDTreeMatcher", "KDTreeVarDistMatcher", "NullMatcher"):
            raise KeyError(f"unknown matcher {name}")
        kw["knn"] = int(p.get("knn", 1))
        max_dist = float(p.get("maxDist", math.inf))
        kw["max_match_dist"] = max_dist
        kw["matcher"] = matcher_backend if math.isfinite(max_dist) else "brute"
        if name == "KDTreeVarDistMatcher":
            # Per-point radii from a reading descriptor at match time
            # (MatchersImpl.h:105-135); maxDist stays the build/upper bound,
            # which the VarDist matcher needs finite.
            kw["max_dist_field"] = str(p.get("maxDistField", "maxSearchDist"))
            if not math.isfinite(max_dist):
                raise ValueError(
                    "KDTreeVarDistMatcher needs a finite maxDist as the "
                    "grid build radius / per-point radius upper bound"
                )
            kw["matcher"] = "grid"

    # Outlier filters (composed).
    for item in doc.get("outlierFilters", []) or []:
        name, p = _single(item)
        if name == "TrimmedDistOutlierFilter":
            kw["trimmed_ratio"] = float(p.get("ratio", 0.85))
        elif name == "SurfaceNormalOutlierFilter":
            kw["normal_angle_max"] = float(p.get("maxAngle", 1.42))
        elif name == "RobustOutlierFilter":
            kw["robust"] = str(p.get("robustFct", "cauchy"))
            kw["robust_scale"] = float(p.get("tuning", 1.0))
        elif name == "VarTrimmedDistOutlierFilter":
            kw["var_trimmed"] = (
                float(p.get("minRatio", 0.05)), float(p.get("maxRatio", 0.99))
            )
        elif name == "MedianDistOutlierFilter":
            kw["median_factor"] = float(p.get("factor", 1.5))
        elif name == "MaxDistOutlierFilter":
            kw["max_residual_dist"] = float(p.get("maxDist", 1.0))
        elif name == "MinDistOutlierFilter":
            kw["min_residual_dist"] = float(p.get("minDist", 1.0))
        elif name == "GenericDescriptorOutlierFilter":
            # OutlierFiltersImpl.h:196-221. The reference binds
            # filteredReference for BOTH source values
            # (OutlierFiltersImpl.cpp:323-328), so `source` is accepted
            # but only the reference-descriptor semantics exist.
            kw["generic_descriptor"] = (
                str(p.get("descName", "none")),
                bool(int(p.get("useSoftThreshold", 0))),
                bool(int(p.get("useLargerThan", 1))),
                float(p.get("threshold", 0.1)),
            )
        elif name in ("NullOutlierFilter",):
            pass
        else:
            raise KeyError(f"unsupported outlier filter {name}")

    # Error minimizer.
    if "errorMinimizer" in doc:
        name, p = _single(doc["errorMinimizer"])
        mapping = {
            "PointToPlaneErrorMinimizer": "point_to_plane",
            "PointToPlaneWithCovErrorMinimizer": "point_to_plane",
            "PointToPointErrorMinimizer": "point_to_point",
            "PointToPointWithCovErrorMinimizer": "point_to_point",
            "PointToPointSimilarityErrorMinimizer": "similarity",
            "IdentityErrorMinimizer": "identity",
        }
        if name not in mapping:
            raise KeyError(f"unknown errorMinimizer {name}")
        kw["minimizer"] = mapping[name]
        kw["force_4dof"] = bool(int(p.get("force4DOF", 0)))
        kw["force_2d"] = bool(int(p.get("force2D", 0)))
        if kw["force_2d"] and kw["force_4dof"]:
            # Reference: ConfigurationError (PointToPlane.cpp:68).
            raise ValueError("force2D cannot be used together with force4DOF")

    # readingStepDataPointsFilters (ICP.cpp:1038): applied to the reading
    # every iteration. Mask-safe (point-selecting) filters compose as
    # per-iteration weight masks in the jitted loop (identical estimator,
    # fixed shapes); a chain of just one RandomSampling keeps the dedicated
    # fast path. Descriptor-mutating filters (normals etc.) cannot run
    # per-iteration in a fixed-shape engine and are rejected explicitly.
    step_chain = []
    for item in doc.get("readingStepDataPointsFilters", []) or []:
        name, p = _single(item)
        if name == "RandomSamplingDataPointsFilter":
            step_chain.append(("RandomSampling", (("prob", float(p.get("prob", 0.75))),)))
        elif name == "MaxDistDataPointsFilter":
            step_chain.append(("MaxDist", (
                ("dim", int(p.get("dim", -1))),
                ("dist", float(p.get("maxDist", 1.0))),
            )))
        elif name == "MinDistDataPointsFilter":
            step_chain.append(("MinDist", (
                ("dim", int(p.get("dim", -1))),
                ("dist", float(p.get("minDist", 1.0))),
            )))
        elif name == "DistanceLimitDataPointsFilter":
            step_chain.append(("DistanceLimit", (
                ("dim", int(p.get("dim", -1))),
                ("dist", float(p.get("dist", 1.0))),
                ("removeInside", int(p.get("removeInside", 1))),
            )))
        elif name == "BoundingBoxDataPointsFilter":
            step_chain.append(("BoundingBox", tuple(
                (k, float(p.get(k, d))) for k, d in (
                    ("xMin", -1.0), ("xMax", 1.0), ("yMin", -1.0),
                    ("yMax", 1.0), ("zMin", -1.0), ("zMax", 1.0),
                )) + (("removeInside", int(p.get("removeInside", 1))),),
            ))
        elif name == "MaxPointCountDataPointsFilter":
            step_chain.append(("MaxPointCount", (
                ("maxCount", int(p.get("maxCount", 1000))),
            )))
        elif name == "IdentityDataPointsFilter":
            pass
        else:
            raise KeyError(
                f"unsupported readingStepDataPointsFilter {name} (mask-safe "
                "filters only: RandomSampling/MaxDist/MinDist/DistanceLimit/"
                "BoundingBox/MaxPointCount/Identity run per-iteration in the "
                "jitted loop)"
            )
    if len(step_chain) == 1 and step_chain[0][0] == "RandomSampling":
        kw["reading_step_random_prob"] = dict(step_chain[0][1])["prob"]
    elif step_chain:
        kw["reading_step_filters"] = tuple(step_chain)

    # Checkers.
    for item in doc.get("transformationCheckers", []) or []:
        name, p = _single(item)
        if name == "CounterTransformationChecker":
            kw["max_iterations"] = int(p.get("maxIterationCount", 40))
        elif name == "DifferentialTransformationChecker":
            kw["min_diff_rot"] = float(p.get("minDiffRotErr", 0.001))
            kw["min_diff_trans"] = float(p.get("minDiffTransErr", 0.001))
            kw["smooth_length"] = int(p.get("smoothLength", 3))
        elif name == "BoundTransformationChecker":
            kw["max_rotation_norm"] = float(p.get("maxRotationNorm", math.inf))
            kw["max_translation_norm"] = float(p.get("maxTranslationNorm", math.inf))
        else:
            raise KeyError(f"unknown transformationChecker {name}")

    # X-ICP degeneracy awareness. The production icp.yaml nests the method
    # name with its params: ``degeneracyAwareness: {OptimizedEqualityConstraints:
    # {enoughInformationThreshold: ...}}`` (``ICP.cpp:117-210`` YAML loading).
    # kOptimizedEqualityConstraints (the production method) is the BINARY
    # first-iteration-only detection (ICP.cpp:2185-2446);
    # kEqualityConstraints / kInequalityConstraints run the ternary-level
    # detection with partial 3-DoF constraint re-solves every iteration
    # (ICP.cpp:1698-2157). The reference's inequality QP solve is an
    # unimplemented stub upstream (PointToPlane.cpp:402-450 logs an error),
    # so InequalityConstraints maps to the equality KKT here too.
    method_map = {
        "None": "none",
        "SolutionRemapping": "solution_remapping",
        "OptimizedEqualityConstraints": "optimized",
        "EqualityConstraints": "equality_constraints",
        "TernaryLevelDetection": "equality_constraints",
        "InequalityConstraints": "equality_constraints",
    }
    deg_doc = doc.get("degeneracyAwareness", None)
    if deg_doc:
        if isinstance(deg_doc, str):
            method_name, deg = deg_doc, {}
        else:
            (method_name, deg), = deg_doc.items()
            deg = deg or {}
        if method_name not in method_map:
            raise KeyError(f"unknown degeneracyAwareness method {method_name}")

        def angle(key, default):
            for k in (key + "Threshold", key):
                if k in deg:
                    return math.cos(math.radians(float(deg[k])))
            return math.cos(math.radians(default))

        kw["degeneracy"] = DegeneracyConfig(
            method=method_map[method_name],
            solution_remapping_threshold=float(deg.get("threshold", 150.0)),
            use_condition_number_threshold=bool(int(deg.get("use2019", 0))),
            high_information_threshold=float(deg.get("highInformationThreshold", 350.0)),
            enough_information_threshold=float(deg.get("enoughInformationThreshold", 150.0)),
            insufficient_information_threshold=float(
                deg.get("insufficientInformationThreshold", 40.0)
            ),
            weak_alignment_cos=angle("point2NormalMinimalAlignmentAngle", 80.0),
            strong_alignment_cos=angle("point2NormalStrongAlignmentAngle", 45.0),
        )

    return icp_mod.ICPConfig(**kw)


def icp_config_from_yaml(path_or_stream, matcher_backend: str = "grid") -> icp_mod.ICPConfig:
    return icp_config_from_dict(load_yaml(path_or_stream), matcher_backend)
