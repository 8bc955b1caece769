"""Multi-device tests on the virtual 8-CPU mesh (conftest forces
xla_force_host_platform_device_count=8). Skipped when fewer than 8 devices
are visible (e.g. when JAX started a backend before conftest ran)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual mesh"
)

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod
from open3d_slam_jax.ops import normals as normals_mod
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.parallel import make_mesh, register_batch_sharded, register_point_sharded

from tests.test_icp import BASE_CFG, make_surface_cloud, pose_error, small_transform, with_normals


def test_device_count():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_register_batch_sharded(rng):
    mesh = make_mesh(batch=8)
    B = 8
    readings, refs, trues = [], [], []
    for i in range(B):
        ref_pts = make_surface_cloud(rng, 600)
        T_true = small_transform(0.02 + 0.005 * i, 0.05)
        read_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
        refs.append(with_normals(ref_pts, capacity=640))
        readings.append(pc.from_points(read_pts, capacity=640))
        trues.append(T_true)
    res = register_batch_sharded(
        mesh, pc.stack(readings), pc.stack(refs),
        jnp.tile(jnp.eye(4), (B, 1, 1)), BASE_CFG,
    )
    for i in range(B):
        rot_err, trans_err = pose_error(np.asarray(res.transform)[i], trues[i])
        assert trans_err < 3e-3, (i, trans_err)


@pytest.mark.slow
def test_register_point_sharded_matches_single(rng):
    mesh = make_mesh(batch=1, points=8)
    ref_pts = make_surface_cloud(rng, 1500)
    ref = with_normals(ref_pts, capacity=2048)
    T_true = small_transform()
    read_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(read_pts, capacity=2048)

    res_sharded = register_point_sharded(mesh, reading, ref, jnp.eye(4), BASE_CFG)
    res_single = icp_mod.register_pair(reading, ref, jnp.eye(4), BASE_CFG)

    np.testing.assert_allclose(
        np.asarray(res_sharded.transform), np.asarray(res_single.transform), atol=1e-4
    )
    rot_err, trans_err = pose_error(np.asarray(res_sharded.transform), T_true)
    assert trans_err < 1e-3


def test_point_sharded_grid_matcher(rng):
    mesh = make_mesh(batch=2, points=4)
    ref_pts = make_surface_cloud(rng, 1500)
    ref = with_normals(ref_pts, capacity=2048)
    T_true = small_transform()
    read_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(read_pts, capacity=2048)
    import dataclasses
    cfg = dataclasses.replace(BASE_CFG, matcher="grid", grid_table_size=1 << 13, grid_bucket_cap=32)
    res = register_point_sharded(mesh, reading, ref, jnp.eye(4), cfg)
    rot_err, trans_err = pose_error(np.asarray(res.transform), T_true)
    assert trans_err < 2e-3


@pytest.mark.slow
def test_pose_graph_edge_sharded_matches_single(rng):
    """Multi-host pose-graph GN: edges sharded over the mesh, (H, g)
    psum-reduced — must match the single-device optimization."""
    import dataclasses
    from jax.sharding import Mesh, PartitionSpec as P

    from open3d_slam_jax.slam import pose_graph as pg
    from tests.test_pose_graph import T_of, relative

    n = 9
    gt = [np.eye(4, dtype=np.float32)]
    step = T_of([0, 0, 0, 1, 0, 0])
    turn = T_of([0, 0, np.pi / 2, 1, 0, 0])
    for i in range(1, n):
        gt.append((gt[-1] @ (turn if i % 2 == 0 else step)).astype(np.float32))
    drift = T_of([0, 0, 0.02, 0.02, 0, 0])
    builder = pg.PoseGraphBuilder(node_capacity=16, edge_capacity=16)
    est = [np.eye(4, dtype=np.float32)]
    for i in range(1, n):
        m = (relative(gt[i - 1], gt[i]) @ drift).astype(np.float32)
        est.append((est[-1] @ m).astype(np.float32))
    for p in est:
        builder.add_node(p)
    for i in range(1, n):
        builder.add_edge(i - 1, i, relative(gt[i - 1], gt[i]) @ drift)
    builder.add_edge(n - 1, 0, relative(gt[n - 1], gt[0]), is_loop=True)
    graph = builder.build()

    cfg = pg.PoseGraphConfig(iterations=10)
    single = pg.optimize(graph, cfg)

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("edges",))
    edge_spec = pg.PoseGraph(
        poses=P(), node_mask=P(),
        edge_i=P("edges"), edge_j=P("edges"), edge_T=P("edges"),
        edge_info=P("edges"), edge_is_loop=P("edges"), edge_mask=P("edges"),
    )

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=(edge_spec,), out_specs=P(), check_vma=False)
    def run(g):
        out = pg.optimize(g, cfg, axis_name="edges")
        return out.poses

    poses_sharded = run(graph)
    np.testing.assert_allclose(
        np.asarray(poses_sharded), np.asarray(single.poses), atol=1e-4
    )


# ---------------------------------------------------------------------------
# Spatial-tile reference sharding (map-too-large mode).
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_register_tile_sharded_matches_single(rng):
    """Tile-sharded mode must reproduce the replicated/single-device result
    (same correspondences; f32 summation-order differences only)."""
    from open3d_slam_jax.parallel import register_tile_sharded
    import dataclasses

    mesh = make_mesh(batch=1, points=8)
    ref_pts = make_surface_cloud(rng, 3000)
    ref = with_normals(ref_pts, capacity=4096)
    T_true = small_transform(0.02, 0.05)
    read_pts = np.asarray(se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts)))
    reading = pc.from_points(read_pts, capacity=4096)
    cfg = dataclasses.replace(
        BASE_CFG, matcher="grid", grid_table_size=1 << 12, grid_bucket_cap=32
    )

    res_tiled = register_tile_sharded(mesh, reading, ref, jnp.eye(4), cfg)
    res_single = icp_mod.register_pair(reading, ref, jnp.eye(4), cfg)

    np.testing.assert_allclose(
        np.asarray(res_tiled.transform), np.asarray(res_single.transform), atol=2e-4
    )
    rot_err, trans_err = pose_error(np.asarray(res_tiled.transform), T_true)
    assert trans_err < 1e-3


def test_tile_partition_reduces_per_device_points(rng):
    """The point of tile sharding: each device's reference slab is a
    fraction of the map (capacity ~N/P + halo), not a replica."""
    from open3d_slam_jax.parallel import partition_tiles

    ref_pts = make_surface_cloud(rng, 8000)
    ref = pc.from_points(ref_pts, capacity=8192)
    reading = pc.from_points(ref_pts[:2000], capacity=2048)
    reading_tiles, reference_tiles, axis, cuts = partition_tiles(
        reading, ref, np.eye(4), n_tiles=8, halo=0.3
    )
    assert reference_tiles.xyz.shape[0] == 8
    # Per-tile capacity clearly below the full map capacity.
    assert reference_tiles.xyz.shape[1] <= 8192 // 2
    # Every reading point owned exactly once.
    assert int(np.asarray(reading_tiles.mask).sum()) == int(np.asarray(reading.mask).sum())
    # Halo: reference tiles may overlap, so total >= N.
    assert int(np.asarray(reference_tiles.mask).sum()) >= int(np.asarray(ref.mask).sum())


@pytest.mark.slow
def test_pose_graph_edge_sharded_pcg_matches_single(rng):
    """Multi-host PCG pose-graph GN: edges sharded, block diagonal + gradient
    psummed once per GN iteration and the off-diagonal scatter psummed per
    matvec — must match the single-device PCG optimization."""
    from jax.sharding import Mesh, PartitionSpec as P

    from open3d_slam_jax.slam import pose_graph as pg
    from tests.test_pose_graph import _loop_graph

    graph, _, _ = _loop_graph(24, edge_cap=32, n_loops=2)
    cfg = pg.PoseGraphConfig(iterations=10, solver="pcg", cg_tol=1e-7, cg_iterations=300)
    single = pg.optimize(graph, cfg)

    mesh = Mesh(np.array(jax.devices()).reshape(8), ("edges",))
    edge_spec = pg.PoseGraph(
        poses=P(), node_mask=P(),
        edge_i=P("edges"), edge_j=P("edges"), edge_T=P("edges"),
        edge_info=P("edges"), edge_is_loop=P("edges"), edge_mask=P("edges"),
    )

    @jax.jit
    @jax.shard_map(mesh=mesh, in_specs=(edge_spec,), out_specs=P(), check_vma=False)
    def run(g):
        return pg.optimize(g, cfg, axis_name="edges").poses

    poses_sharded = run(graph)
    np.testing.assert_allclose(
        np.asarray(poses_sharded), np.asarray(single.poses), atol=1e-4
    )
