"""Tests for the native host runtime (run against the C++ library when it
builds, otherwise exercising the numpy fallback — both paths must agree)."""

import numpy as np
import pytest

from open3d_slam_jax import native


def make_packet(rng, n=500, step=32):
    """Synthetic PointCloud2-style packet: x@0, y@4, z@8 f32, intensity@16."""
    xyz = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    xyz[::50] = np.nan  # some invalid records
    intensity = rng.uniform(0, 255, n).astype(np.float32)
    buf = np.zeros((n, step), np.uint8)
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf[:, 16:20] = intensity[:, None].view(np.uint8).reshape(n, 4)
    return buf.tobytes(), xyz, intensity


def test_native_builds():
    assert native.native_available(), "C++ host library failed to build"


def test_decode_xyz(rng):
    data, xyz, _ = make_packet(rng)
    out, mask = native.decode_xyz(data, 500, 32, 0, 4, 8)
    finite = np.all(np.isfinite(xyz), axis=1)
    assert mask.sum() == finite.sum()
    np.testing.assert_allclose(out, xyz[finite], atol=0)


def test_decode_channel(rng):
    data, xyz, intensity = make_packet(rng)
    _, mask = native.decode_xyz(data, 500, 32, 0, 4, 8)
    vals = native.decode_channel(data, 500, 32, 16, native.FLOAT32, mask)
    finite = np.all(np.isfinite(xyz), axis=1)
    np.testing.assert_allclose(vals, intensity[finite], atol=0)


def test_voxel_downsample_host_matches_oracle(rng):
    pts = rng.uniform(-3, 3, (2000, 3)).astype(np.float32)
    out = native.voxel_downsample_host(pts, 0.5)
    cells = set(map(tuple, np.floor(pts / 0.5).astype(np.int64)))
    assert len(out) == len(cells)
    # Each centroid must lie inside its voxel.
    c = np.floor(out / 0.5).astype(np.int64)
    assert set(map(tuple, c)) == cells


def test_scan_ring_fifo():
    ring = native.ScanRing(capacity=3)
    for i in range(3):
        assert not ring.push(bytes([i] * 4), float(i))
    assert len(ring) == 3
    blob, stamp = ring.pop()
    assert blob == bytes([0] * 4) and stamp == 0.0
    assert len(ring) == 2


def test_scan_ring_drop_oldest():
    ring = native.ScanRing(capacity=2)
    ring.push(b"a", 0.0)
    ring.push(b"b", 1.0)
    assert ring.push(b"c", 2.0)  # drops "a"
    assert ring.dropped == 1
    blob, stamp = ring.pop()
    assert blob == b"b"
    blob, stamp = ring.pop()
    assert blob == b"c"
    assert ring.pop() is None


def test_numpy_fallback_agrees(rng, monkeypatch):
    """Force the fallback and verify identical results."""
    data, xyz, _ = make_packet(rng, n=300)
    out_native, mask_native = native.decode_xyz(data, 300, 32, 0, 4, 8)
    monkeypatch.setattr(native, "_load", lambda: None)
    out_np, mask_np = native.decode_xyz(data, 300, 32, 0, 4, 8)
    np.testing.assert_array_equal(out_native, out_np)
    np.testing.assert_array_equal(mask_native, mask_np)


class TestSensorMsgs:
    def _msg(self, rng, n=200):
        from open3d_slam_jax.io import sensor_msgs as sm

        xyz = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
        t = np.linspace(0, 0.1, n).astype(np.float32)
        step = 16
        buf = np.zeros((n, step), np.uint8)
        buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
        buf[:, 12:16] = t[:, None].view(np.uint8).reshape(n, 4)
        fields = [
            sm.PointField("x", 0, sm.FLOAT32),
            sm.PointField("y", 4, sm.FLOAT32),
            sm.PointField("z", 8, sm.FLOAT32),
            sm.PointField("t", 12, sm.FLOAT32),
        ]
        return sm.PointCloud2Like(buf.tobytes(), n, step, fields), xyz, t

    def test_deserialize(self, rng):
        from open3d_slam_jax.io import sensor_msgs as sm

        msg, xyz, t = self._msg(rng)
        batch = sm.deserialize(msg, capacity=256)
        assert int(batch.count()) == 200
        np.testing.assert_allclose(np.asarray(batch.xyz[:200]), xyz, atol=0)
        np.testing.assert_allclose(np.asarray(batch.extras["times"][:200, 0]), t, atol=0)

    def test_roundtrip(self, rng):
        from open3d_slam_jax.io import sensor_msgs as sm

        msg, xyz, t = self._msg(rng)
        batch = sm.deserialize(msg, capacity=256)
        msg2 = sm.serialize(batch, stamp=1.5)
        batch2 = sm.deserialize(msg2, capacity=256)
        np.testing.assert_allclose(
            np.asarray(batch2.xyz[:200]), np.asarray(batch.xyz[:200]), atol=0
        )
        assert msg2.stamp == 1.5

    def test_missing_xyz_raises(self, rng):
        from open3d_slam_jax.io import sensor_msgs as sm

        msg, _, _ = self._msg(rng)
        bad = sm.PointCloud2Like(msg.data, msg.width, msg.point_step, msg.fields[:2])
        with pytest.raises(ValueError):
            sm.deserialize(bad)


def test_pointcloud2_rgb_roundtrip(rng):
    """Packed PCL rgb float (0x00RRGGBB) decodes to colors [N,3] in [0,1]
    and survives serialize->deserialize (≙ the color cases of the
    reference's RosPointCloud2DeserializerTest)."""
    from open3d_slam_jax.io import sensor_msgs as sm

    n = 64
    xyz = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint32)
    packed = (rgb[:, 0] << 16) | (rgb[:, 1] << 8) | rgb[:, 2]
    step = 16
    buf = np.zeros((n, step), np.uint8)
    buf[:, 0:12] = xyz.view(np.uint8).reshape(n, 12)
    buf[:, 12:16] = packed[:, None].view(np.uint8)
    msg = sm.PointCloud2Like(
        buf.tobytes(), n, step,
        [sm.PointField("x", 0, sm.FLOAT32), sm.PointField("y", 4, sm.FLOAT32),
         sm.PointField("z", 8, sm.FLOAT32), sm.PointField("rgb", 12, sm.FLOAT32)],
    )
    batch = sm.deserialize(msg, capacity=64)
    cols = np.asarray(batch.extras["colors"])[:n]
    np.testing.assert_allclose(cols, rgb.astype(np.float32) / 255.0, atol=1e-6)

    msg2 = sm.serialize(batch)
    batch2 = sm.deserialize(msg2, capacity=64)
    np.testing.assert_allclose(
        np.asarray(batch2.extras["colors"])[:n], cols, atol=1 / 255.0
    )
