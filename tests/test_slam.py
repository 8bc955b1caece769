import pytest
import jax
import jax.numpy as jnp
import numpy as np

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.ops import pointcloud as pc
from open3d_slam_jax.slam import motion_compensation as mc
from open3d_slam_jax.slam import submap as submap_mod
from open3d_slam_jax.slam.transform_buffer import TransformInterpolationBuffer


def T_of(twist):
    return np.asarray(se3.exp_se3(jnp.asarray(twist, jnp.float32)), np.float64)


class TestTransformBuffer:
    def test_push_lookup_exact(self):
        buf = TransformInterpolationBuffer()
        T1, T2 = T_of([0, 0, 0, 1, 0, 0]), T_of([0, 0, 0, 2, 0, 0])
        buf.push(1.0, T1)
        buf.push(2.0, T2)
        np.testing.assert_allclose(buf.lookup(1.0), T1, atol=1e-9)
        np.testing.assert_allclose(buf.lookup(2.0), T2, atol=1e-9)

    def test_interpolation_midpoint(self):
        buf = TransformInterpolationBuffer()
        T1 = np.eye(4)
        T1[:3, 3] = [1, 0, 0]
        c, s = np.cos(0.2), np.sin(0.2)
        T1[:2, :2] = [[c, -s], [s, c]]
        buf.push(0.0, np.eye(4))
        buf.push(1.0, T1)
        mid = buf.lookup(0.5)
        np.testing.assert_allclose(mid[:3, 3], [0.5, 0, 0], atol=1e-9)
        yaw = np.arctan2(mid[1, 0], mid[0, 0])
        np.testing.assert_allclose(yaw, 0.1, atol=1e-6)

    def test_clamping(self):
        buf = TransformInterpolationBuffer()
        buf.push(1.0, T_of([0, 0, 0, 1, 0, 0]))
        buf.push(2.0, T_of([0, 0, 0, 2, 0, 0]))
        np.testing.assert_allclose(buf.lookup(0.0)[:3, 3], [1, 0, 0])
        np.testing.assert_allclose(buf.lookup(5.0)[:3, 3], [2, 0, 0])

    def test_out_of_order_insert(self):
        buf = TransformInterpolationBuffer()
        buf.push(2.0, T_of([0, 0, 0, 2, 0, 0]))
        buf.push(1.0, T_of([0, 0, 0, 1, 0, 0]))
        np.testing.assert_allclose(buf.lookup(1.5)[:3, 3], [1.5, 0, 0], atol=1e-9)

    def test_size_limit(self):
        buf = TransformInterpolationBuffer(size_limit=3)
        for i in range(10):
            buf.push(float(i), T_of([0, 0, 0, i, 0, 0]))
        assert len(buf) == 3
        assert buf.earliest_time == 7.0

    def test_motion_between(self):
        buf = TransformInterpolationBuffer()
        buf.push(0.0, T_of([0, 0, 0, 1, 0, 0]))
        buf.push(1.0, T_of([0, 0, 0, 3, 1, 0]))
        m = buf.motion_between(0.0, 1.0)
        np.testing.assert_allclose(m[:3, 3], [2, 1, 0], atol=1e-9)


class TestMotionCompensation:
    def test_zero_motion_noop(self, rng):
        pts = rng.normal(size=(100, 3)).astype(np.float32)
        b = pc.from_points(pts)
        out = mc.undistort(b, jnp.zeros(6), jnp.linspace(0, 1, 100))
        np.testing.assert_allclose(np.asarray(out.xyz), pts, atol=1e-6)

    def test_end_of_sweep_points_unmoved(self, rng):
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        b = pc.from_points(pts)
        twist = jnp.asarray([0.1, 0.05, -0.02, 0.5, 0.2, 0.1], jnp.float32)
        phases = jnp.ones(50)  # all acquired at sweep end
        out = mc.undistort(b, twist, phases)
        np.testing.assert_allclose(np.asarray(out.xyz), pts, atol=1e-6)

    def test_start_points_get_full_inverse_motion(self, rng):
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        b = pc.from_points(pts)
        twist = jnp.asarray([0, 0, 0, 1.0, 0, 0], jnp.float32)
        phases = jnp.zeros(50)  # all acquired at sweep start
        out = mc.undistort(b, twist, phases)
        np.testing.assert_allclose(np.asarray(out.xyz), pts + np.array([-1, 0, 0]), atol=1e-5)

    def test_undistort_recovers_static_scene(self, rng):
        # Simulate: sensor translates during sweep; each point measured in
        # the sensor frame at its phase. Undistortion must reassemble the
        # static scene as seen from the sweep-end pose.
        scene = rng.uniform(-5, 5, size=(200, 3)).astype(np.float32)
        twist = np.array([0, 0, 0, 0.6, -0.2, 0.1], np.float32)
        phases = rng.uniform(0, 1, size=200).astype(np.float32)
        T_end = np.asarray(se3.exp_se3(jnp.asarray(twist)))
        distorted = []
        for p, s in zip(phases, scene):
            T_at = np.asarray(se3.exp_se3(jnp.asarray(twist * p)))
            distorted.append(np.linalg.inv(T_at) @ np.r_[s, 1.0])
        distorted = np.array(distorted, np.float32)[:, :3]
        b = pc.from_points(distorted)
        out = mc.undistort(b, jnp.asarray(twist), jnp.asarray(phases))
        expected = (np.linalg.inv(T_end) @ np.c_[scene, np.ones(200)].T).T[:, :3]
        np.testing.assert_allclose(np.asarray(out.xyz), expected, atol=1e-4)

    def test_azimuth_phases(self):
        pts = np.array([[1.0, 0, 0], [0, 1.0, 0], [-1.0, 0, 0]], np.float32)
        ph = np.asarray(mc.phases_from_azimuth(jnp.asarray(pts), clockwise=False))
        # -x sits on the wrap-around boundary: 0 and 1 are equivalent.
        np.testing.assert_allclose(ph[:2], [0.5, 0.75], atol=1e-6)
        assert np.isclose(ph[2] % 1.0, 0.0, atol=1e-6) or np.isclose(ph[2], 1.0, atol=1e-6)


class TestSubmap:
    def test_insert_scan_accumulates(self, rng):
        sm = submap_mod.create(4096)
        scan = pc.from_points(rng.uniform(-5, 5, (1000, 3)).astype(np.float32), capacity=1024)
        sm = submap_mod.insert_scan(sm, scan, jnp.eye(4), 0.2, 50.0)
        assert int(jnp.sum(sm.cloud.mask)) > 500
        assert int(sm.num_scans) == 1

    def test_insert_transforms_scan(self, rng):
        sm = submap_mod.create(4096)
        pts = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
        scan = pc.from_points(pts, capacity=128)
        T = jnp.asarray(T_of([0, 0, 0, 10, 0, 0]), jnp.float32)
        sm = submap_mod.insert_scan(sm, scan, T, 0.05, 50.0)
        got = np.asarray(sm.cloud.xyz)[np.asarray(sm.cloud.mask)]
        assert np.all(got[:, 0] > 8.0)

    def test_voxel_merge_bounds_growth(self, rng):
        sm = submap_mod.create(8192)
        for i in range(5):
            scan = pc.from_points(
                rng.uniform(-5, 5, (2000, 3)).astype(np.float32) * 0.99, capacity=2048
            )
            sm = submap_mod.insert_scan(sm, scan, jnp.eye(4), 0.5, 50.0)
        n = int(jnp.sum(sm.cloud.mask))
        # ~20^3/2... the voxel grid bounds the count by occupied voxels.
        assert n < 8192
        assert int(sm.num_scans) == 5

    def test_carve_removes_seen_through_points(self, rng):
        # Map has a point at x=2; new scan (origin sensor) sees a wall at
        # x=5 through that location => carve it. A map point at x=8 is
        # behind the wall => kept.
        sm = submap_mod.create(64)
        stale = np.array([[2.0, 0, 0], [8.0, 0, 0]], np.float32)
        sm = submap_mod.insert_scan(sm, pc.from_points(stale, capacity=4), jnp.eye(4), 0.05, 50.0)
        wall = np.c_[np.full(200, 5.0), rng.uniform(-.2, .2, (200, 2))].astype(np.float32)
        scan = pc.from_points(wall, capacity=256)
        sm2 = submap_mod.carve(sm, scan, jnp.eye(4), angle_tol=0.05, range_margin=0.3)
        kept = np.asarray(sm2.cloud.xyz)[np.asarray(sm2.cloud.mask)]
        assert not np.any(np.isclose(kept[:, 0], 2.0, atol=0.3))
        assert np.any(np.isclose(kept[:, 0], 8.0, atol=0.3))

    def test_transform_submap(self, rng):
        sm = submap_mod.create(128)
        pts = rng.uniform(-1, 1, (50, 3)).astype(np.float32)
        sm = submap_mod.insert_scan(sm, pc.from_points(pts, capacity=64), jnp.eye(4), 0.01, 50.0)
        T = jnp.asarray(T_of([0, 0, 0.3, 1, 2, 3]), jnp.float32)
        sm2 = submap_mod.transform_submap(sm, T)
        before = np.asarray(sm.cloud.xyz)[np.asarray(sm.cloud.mask)]
        after = np.asarray(sm2.cloud.xyz)[np.asarray(sm2.cloud.mask)]
        Tnp = np.asarray(T)
        np.testing.assert_allclose(after, before @ Tnp[:3, :3].T + Tnp[:3, 3], atol=1e-4)


class TestCloudRegistrationFacade:
    @pytest.mark.slow
    def test_all_types_register(self, rng):
        import sys
        sys.path.insert(0, '/root/repo/tests')
        from test_icp import make_surface_cloud, small_transform, pose_error
        from open3d_slam_jax.models.cloud_registration import (
            CloudRegistrationConfig, register_clouds,
        )
        ref_pts = make_surface_cloud(rng, 1200)
        T_true = small_transform(0.02, 0.06)
        read_pts = np.asarray(
            se3.apply_transform(se3.transform_inverse(T_true), jnp.asarray(ref_pts))
        )
        for rt in ("PointToPointIcp", "PointToPlaneIcp", "GeneralizedIcp"):
            cfg = CloudRegistrationConfig(
                registration_type=rt, max_correspondence_dist=0.5, max_iterations=25,
                icp_overrides={"grid_table_size": 1 << 13, "grid_bucket_cap": 48,
                               "trimmed_ratio": 0.9},
            )
            res = register_clouds(
                pc.from_points(read_pts), pc.from_points(ref_pts), None, cfg
            )
            rot_err, trans_err = pose_error(np.asarray(res.transform), T_true)
            assert trans_err < 8e-3, (rt, trans_err)

    def test_unknown_type_raises(self):
        from open3d_slam_jax.models.cloud_registration import (
            CloudRegistrationConfig,
        )
        import pytest
        with pytest.raises(ValueError):
            CloudRegistrationConfig(registration_type="MagicIcp").icp_config()


class TestConstraintBuilders:
    def test_odometry_constraints(self, rng):
        from open3d_slam_jax.slam.constraint_builders import (
            build_odometry_constraints, overlap_fraction,
        )
        from open3d_slam_jax.slam.submap_collection import (
            SubmapCollection, SubmapCollectionConfig,
        )
        coll = SubmapCollection(SubmapCollectionConfig(
            submap_capacity=8192, creation_radius=4.0, activation_radius=3.0,
            min_scans_before_switch=1,
        ))
        world = rng.uniform(-5, 15, (20000, 3)).astype(np.float32)
        for i in range(8):
            pose = np.eye(4); pose[0, 3] = i * 1.5
            local = world - pose[:3, 3]
            near = local[np.linalg.norm(local, axis=1) < 8][:4000]
            coll.insert_scan(pc.from_points(near.astype(np.float32), capacity=4096), pose, pose)
        cons = build_odometry_constraints(coll, refine=False)
        assert len(cons) == len(coll) - 1
        for c in cons:
            # anchors are along +x at multiples of the creation radius
            assert c.T_parent_child[0, 3] > 0

    def test_overlap_fraction(self, rng):
        from open3d_slam_jax.slam.constraint_builders import overlap_fraction
        a = pc.from_points(rng.uniform(0, 2, (500, 3)).astype(np.float32))
        b_same = pc.from_points(rng.uniform(0, 2, (800, 3)).astype(np.float32))
        b_far = pc.from_points((rng.uniform(0, 2, (800, 3)) + 50).astype(np.float32))
        assert overlap_fraction(a, b_same, 0.5) > 0.9
        assert overlap_fraction(a, b_far, 0.5) < 0.05
