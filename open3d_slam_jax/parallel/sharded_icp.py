"""Sharded registration entry points.

Scaling modes over a ("batch", "points") mesh:

- :func:`register_batch_sharded` — DP: B independent registrations sharded
  over the "batch" axis. Zero communication; linear scaling. This is the
  production throughput path (thousands of concurrent scan-to-map /
  hypothesis / multi-session problems).
- :func:`register_point_sharded` — SP/TP: ONE registration whose reading
  point axis is sharded over the "points" axis; each device matches its
  slice against the (replicated) reference and partial 6x6 normal-equation
  blocks are psum-reduced (42 floats/iteration — the Hessian-block
  all-reduce promised in SURVEY 2.6). Use for huge scans or when chips
  outnumber problems.

Both compose (:func:`register_batch_point_sharded`): a (batch, points)
mesh runs B problems, each split P ways. :func:`register_tile_sharded`
splits the reference map itself by spatial tile.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops.pointcloud import PointBatch


def register_batch_sharded(
    mesh: Mesh,
    readings: PointBatch,
    references: PointBatch,
    init_Ts: jax.Array,
    cfg: icp_mod.ICPConfig,
) -> icp_mod.ICPResult:
    """B-problem data parallelism: inputs sharded on their leading axis over
    "batch"; per-problem grid build + ICP run entirely on the owning device.
    """
    bsharding = NamedSharding(mesh, P("batch"))

    def put(tree):
        return jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P(*(("batch",) + (None,) * (x.ndim - 1))))),
            tree,
        )

    readings = put(readings)
    references = put(references)
    init_Ts = jax.device_put(init_Ts, NamedSharding(mesh, P("batch", None, None)))
    return icp_mod.register_batch(readings, references, init_Ts, cfg)


def register_point_sharded(
    mesh: Mesh,
    reading: PointBatch,
    reference: PointBatch,
    init_T: jax.Array,
    cfg: icp_mod.ICPConfig,
) -> icp_mod.ICPResult:
    """Single-problem point sharding via shard_map over the "points" axis.

    The reference cloud is replicated (each shard builds the same grid —
    cheaper than halo exchange at LiDAR map sizes); the reading is split.
    All reductions inside the ICP loop go through ``psum`` hooks enabled by
    ``cfg.shard_axis``.
    """
    n_shards = mesh.shape["points"]
    if reading.capacity % n_shards != 0:
        raise ValueError(
            f"reading capacity {reading.capacity} not divisible by points axis {n_shards}"
        )
    cfg_sharded = dataclasses.replace(cfg, shard_axis="points")

    pspec_read = jax.tree.map(lambda _: P("points"), reading)
    pspec_ref = jax.tree.map(lambda _: P(), reference)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(pspec_read, pspec_ref, P()),
        out_specs=jax.tree.map(lambda _: P(), _result_structure()),
        check_vma=False,
    )
    def run(reading_shard, reference_full, T0):
        ref = icp_mod.build_reference(reference_full, cfg_sharded)
        return icp_mod.icp_single(reading_shard, ref, T0, cfg_sharded)

    return jax.jit(run)(reading, reference, init_T)


def register_batch_point_sharded(
    mesh: Mesh,
    readings: PointBatch,
    reference: PointBatch,
    init_Ts: jax.Array,
    cfg: icp_mod.ICPConfig,
) -> icp_mod.ICPResult:
    """B registrations against one shared reference on a ("batch",
    "points") mesh: problems split over "batch", each reading's point axis
    split over "points" (partial 6x6 blocks psum-reduced over "points");
    the reference is replicated and each device builds its grid."""
    n_b, n_p = mesh.shape["batch"], mesh.shape["points"]
    if readings.xyz.shape[0] % n_b or readings.capacity % n_p:
        raise ValueError(
            f"readings [{readings.xyz.shape[0]}, {readings.capacity}] do not "
            f"split over a {n_b}x{n_p} mesh"
        )
    cfg_sharded = dataclasses.replace(cfg, shard_axis="points")
    read_specs = jax.tree.map(
        lambda x: P(*(("batch", "points") + (None,) * (x.ndim - 2))), readings
    )
    ref_specs = jax.tree.map(lambda _: P(), reference)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(read_specs, ref_specs, P("batch")),
        out_specs=jax.tree.map(lambda _: P("batch"), _result_structure()),
        check_vma=False,
    )
    def run(reading_shard, reference_full, T_shard):
        ref = icp_mod.build_reference(reference_full, cfg_sharded)
        return jax.vmap(
            lambda r, T: icp_mod.icp_single(r, ref, T, cfg_sharded)
        )(reading_shard, T_shard)

    return jax.jit(run)(readings, reference, init_Ts)


# ---------------------------------------------------------------------------
# Spatial-tile reference sharding (the map-too-large mode, SURVEY 2.6/5).
# ---------------------------------------------------------------------------


def partition_tiles(
    reading: PointBatch,
    reference: PointBatch,
    init_T,
    n_tiles: int,
    halo: float,
    tile_capacity=None,
    reading_tile_capacity=None,
):
    """Partition a registration problem into ``n_tiles`` spatial tiles.

    The reference map is cut along its longest axis at equal-count quantile
    boundaries; tile i holds the reference points of slab i EXPANDED by
    ``halo`` on both sides, so every correspondence within ``halo`` of an
    owned reading point is locally available (the halo-exchange analogue of
    context-parallel attention). Reading points are assigned to exactly one
    owning tile by their init-transformed coordinate — ownership is
    exclusive, so psum-reduced normal-equation blocks count every pair once.

    Host-side setup (numpy), run once per (reference, shard count). Returns
    ``(reading_tiles, reference_tiles, axis, cuts)`` with leading dim
    ``n_tiles``, ready to shard over the mesh's point axis.
    """
    import numpy as np

    from open3d_slam_jax.ops.pointcloud import PAD_COORD

    ref_xyz = np.asarray(reference.xyz)
    ref_mask = np.asarray(reference.mask)
    pts = ref_xyz[ref_mask]
    if len(pts) == 0:
        raise ValueError("empty reference")
    axis = int(np.argmax(pts.max(axis=0) - pts.min(axis=0)))
    cuts = np.quantile(pts[:, axis], np.linspace(0.0, 1.0, n_tiles + 1))
    cuts[0], cuts[-1] = -np.inf, np.inf

    T0 = np.asarray(init_T)
    read_xyz_t = (
        np.asarray(reading.xyz) @ T0[:3, :3].T + T0[:3, 3]
    )
    read_mask = np.asarray(reading.mask)

    def bucket(batch, xyz_for_assign, mask, lo_pad, hi_pad, cap):
        sels = []
        for i in range(n_tiles):
            lo = cuts[i] - lo_pad
            hi = cuts[i + 1] + (hi_pad if i < n_tiles - 1 else 0.0)
            if i == 0:
                lo = -np.inf
            sel = mask & (xyz_for_assign[:, axis] >= lo) & (xyz_for_assign[:, axis] < hi)
            sels.append(np.where(sel)[0])
        counts = [len(s) for s in sels]
        if cap is None:
            cap = 1 << max(int(np.ceil(np.log2(max(max(counts), 1)))), 3)
        if max(counts) > cap:
            raise ValueError(
                f"tile capacity {cap} < largest tile {max(counts)}; raise "
                "tile_capacity or shrink halo"
            )
        xyz_np = np.asarray(batch.xyz)
        out_xyz = np.full((n_tiles, cap, 3), PAD_COORD, xyz_np.dtype)
        out_mask = np.zeros((n_tiles, cap), bool)
        out_extras = {
            k: np.zeros((n_tiles, cap) + np.asarray(v).shape[1:], np.asarray(v).dtype)
            for k, v in batch.extras.items()
        }
        for i, s in enumerate(sels):
            out_xyz[i, : len(s)] = xyz_np[s]
            out_mask[i, : len(s)] = True
            for k, v in batch.extras.items():
                out_extras[k][i, : len(s)] = np.asarray(v)[s]
        return PointBatch(
            xyz=jnp.asarray(out_xyz),
            mask=jnp.asarray(out_mask),
            extras={k: jnp.asarray(v) for k, v in out_extras.items()},
        )

    reference_tiles = bucket(reference, ref_xyz, ref_mask, halo, halo, tile_capacity)
    reading_tiles = bucket(reading, read_xyz_t, read_mask, 0.0, 0.0, reading_tile_capacity)
    return reading_tiles, reference_tiles, axis, cuts


def register_tile_sharded(
    mesh: Mesh,
    reading: PointBatch,
    reference: PointBatch,
    init_T: jax.Array,
    cfg: icp_mod.ICPConfig,
    halo_margin: float = 0.5,
    tile_capacity=None,
    reading_tile_capacity=None,
) -> icp_mod.ICPResult:
    """ONE registration with the REFERENCE MAP sharded by spatial tile.

    Unlike :func:`register_point_sharded` (reference replicated), each device
    holds only its slab of the map (+ halo), so per-device map memory drops
    ~1/P — the mode where the map itself exceeds one device's memory.
    Each device matches its owned reading points against its local tile and
    the 6x6 normal-equation blocks ride a psum (42 floats/iter);
    results are numerically equivalent to replicated/single-device mode
    (same correspondences; summation order differs only within f32 rounding).

    The halo must cover ``max_match_dist`` (+ candidate slack) plus the
    expected in-registration motion (``halo_margin``); reading ownership is
    fixed from the init transform, exactly like a halo-exchange stencil.

    ≙ SURVEY 2.6/5's spatial-tiling design; locality structure inspired by
    the reference's ``VoxelHashMap.hpp:104-159``.
    """
    n_tiles = mesh.shape["points"]
    slack = cfg.candidate_slack if cfg.candidate_refresh_every > 0 else 0.0
    halo = cfg.max_match_dist + slack + halo_margin
    reading_tiles, reference_tiles, _axis, _cuts = partition_tiles(
        reading, reference, init_T, n_tiles, halo,
        tile_capacity, reading_tile_capacity,
    )
    from open3d_slam_jax.ops.pointcloud import masked_centroid

    centroid = masked_centroid(reference)  # GLOBAL frame shift, shared by all
    cfg_sharded = dataclasses.replace(cfg, shard_axis="points")

    spec_tiled = lambda tree: jax.tree.map(  # noqa: E731
        lambda x: P(*(("points",) + (None,) * (x.ndim - 1))), tree
    )

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(
            spec_tiled(reading_tiles),
            spec_tiled(reference_tiles),
            P(),
            P(),
        ),
        out_specs=jax.tree.map(lambda _: P(), _result_structure()),
        check_vma=False,
    )
    def run(reading_tile, reference_tile, T0, c):
        reading_local = jax.tree.map(lambda x: x[0], reading_tile)
        reference_local = jax.tree.map(lambda x: x[0], reference_tile)
        ref = icp_mod.build_reference(reference_local, cfg_sharded, centroid=c)
        return icp_mod.icp_single(reading_local, ref, T0, cfg_sharded)

    return jax.jit(run)(reading_tiles, reference_tiles, init_T, centroid)


def _result_structure():
    """A template ICPResult for out_specs tree mapping."""
    z = jnp.zeros(())
    return icp_mod.ICPResult(
        transform=z, iterations=z, converged=z, match_ratio=z,
        overlap_ratio=z, residual=z, eigenvalues=z, condition_number=z,
        localizability_rot=z, localizability_trans=z, degenerate=z, aborted=z,
        covariance=z, match_row_saturation=z,
    )
