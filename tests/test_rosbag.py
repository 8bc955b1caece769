"""Native rosbag v2.0 reader: synthetic bags built record-by-record."""

import bz2
import struct
import pytest

import numpy as np

from open3d_slam_jax.io import rosbag, sensor_msgs


def _hdr(**kv) -> bytes:
    out = b""
    for k, v in kv.items():
        entry = k.encode() + b"=" + v
        out += struct.pack("<I", len(entry)) + entry
    return struct.pack("<I", len(out)) + out


def _rec(header: bytes, data: bytes) -> bytes:
    return header + struct.pack("<I", len(data)) + data


def _conn_record(cid: int, topic: str, dtype: str) -> bytes:
    sub = b""
    for k, v in ((b"topic", topic.encode()), (b"type", dtype.encode()),
                 (b"md5sum", b"x" * 32), (b"message_definition", b"")):
        entry = k + b"=" + v
        sub += struct.pack("<I", len(entry)) + entry
    return _rec(
        _hdr(op=b"\x07", conn=struct.pack("<I", cid), topic=topic.encode()),
        sub,
    )


def _msg_record(cid: int, sec: int, nsec: int, raw: bytes) -> bytes:
    return _rec(
        _hdr(op=b"\x02", conn=struct.pack("<I", cid),
             time=struct.pack("<II", sec, nsec)),
        raw,
    )


def _ros_header(sec=1, nsec=0, frame=b"map") -> bytes:
    return (struct.pack("<I", 0) + struct.pack("<II", sec, nsec)
            + struct.pack("<I", len(frame)) + frame)


def _pointcloud2_raw(pts: np.ndarray, sec=1) -> bytes:
    n = len(pts)
    fields = b""
    for i, name in enumerate((b"x", b"y", b"z")):
        fields += (struct.pack("<I", len(name)) + name
                   + struct.pack("<I", 4 * i) + bytes([sensor_msgs.FLOAT32])
                   + struct.pack("<I", 1))
    data = pts.astype("<f4").tobytes()
    return (_ros_header(sec=sec) + struct.pack("<II", 1, n)
            + struct.pack("<I", 3) + fields
            + b"\x00" + struct.pack("<II", 12, 12 * n)
            + struct.pack("<I", len(data)) + data)


def _odometry_raw(pos, quat_xyzw, sec=1) -> bytes:
    child = b"base"
    return (_ros_header(sec=sec) + struct.pack("<I", len(child)) + child
            + struct.pack("<3d", *pos) + struct.pack("<4d", *quat_xyzw)
            + struct.pack("<36d", *([0.0] * 36))
            + struct.pack("<6d", *([0.0] * 6))
            + struct.pack("<36d", *([0.0] * 36)))


def _imu_raw(quat_xyzw, gyro, accel, sec=1) -> bytes:
    return (_ros_header(sec=sec) + struct.pack("<4d", *quat_xyzw)
            + struct.pack("<9d", *([0.0] * 9)) + struct.pack("<3d", *gyro)
            + struct.pack("<9d", *([0.0] * 9)) + struct.pack("<3d", *accel)
            + struct.pack("<9d", *([0.0] * 9)))


def _write_bag(path, records, compression=None):
    chunk = b"".join(records)
    if compression == "bz2":
        payload = bz2.compress(chunk)
        hdr = _hdr(op=b"\x05", compression=b"bz2",
                   size=struct.pack("<I", len(chunk)))
    else:
        payload = chunk
        hdr = _hdr(op=b"\x05", compression=b"none",
                   size=struct.pack("<I", len(chunk)))
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_rec(hdr, payload))


def _make_bag(path, rng, compression=None, n_clouds=3):
    records = [
        _conn_record(0, "/points", "sensor_msgs/PointCloud2"),
        _conn_record(1, "/odom", "nav_msgs/Odometry"),
        _conn_record(2, "/imu", "sensor_msgs/Imu"),
    ]
    clouds = []
    for i in range(n_clouds):
        pts = rng.uniform(-2, 2, size=(50, 3)).astype(np.float32)
        clouds.append(pts)
        records.append(_msg_record(1, i + 1, 0, _odometry_raw(
            (0.1 * i, 0.0, 0.0), (0, 0, 0, 1), sec=i + 1)))
        records.append(_msg_record(2, i + 1, 100, _imu_raw(
            (0, 0, 0, 1), (0.01, 0, 0), (0, 0, 9.81), sec=i + 1)))
        records.append(_msg_record(0, i + 1, 500, _pointcloud2_raw(pts, sec=i + 1)))
    _write_bag(path, records, compression=compression)
    return clouds


def test_bag_roundtrip_uncompressed(tmp_path, rng):
    path = str(tmp_path / "t.bag")
    clouds = _make_bag(path, rng)
    msgs = list(rosbag.read_bag_decoded(path))
    pc2 = [(t, m) for t, d, s, m in msgs if d == "sensor_msgs/PointCloud2"]
    odom = [m for t, d, s, m in msgs if d == "nav_msgs/Odometry"]
    imu = [m for t, d, s, m in msgs if d == "sensor_msgs/Imu"]
    assert len(pc2) == 3 and len(odom) == 3 and len(imu) == 3
    for (topic, msg), pts in zip(pc2, clouds):
        assert topic == "/points"
        batch = sensor_msgs.deserialize(msg, capacity=64)
        got = np.asarray(batch.xyz)[np.asarray(batch.mask)]
        np.testing.assert_allclose(np.sort(got, 0), np.sort(pts, 0), atol=1e-6)
    np.testing.assert_allclose(odom[2].position, (0.2, 0.0, 0.0))
    np.testing.assert_allclose(imu[0].linear_acceleration, (0, 0, 9.81))
    np.testing.assert_allclose(imu[0].angular_velocity, (0.01, 0, 0))


def test_bag_bz2_chunks(tmp_path, rng):
    path = str(tmp_path / "t2.bag")
    _make_bag(path, rng, compression="bz2")
    msgs = list(rosbag.read_bag(path))
    assert sum(m.datatype == "sensor_msgs/PointCloud2" for m in msgs) == 3
    # Stamps carried through record headers.
    stamps = [m.stamp for m in msgs if m.datatype == "nav_msgs/Odometry"]
    assert stamps == sorted(stamps)


def test_bag_topic_filter_and_bad_magic(tmp_path, rng):
    path = str(tmp_path / "t3.bag")
    _make_bag(path, rng)
    only = list(rosbag.read_bag_decoded(path, topics=["/odom"]))
    assert len(only) == 3 and all(t == "/odom" for t, _, _, _ in only)
    bad = tmp_path / "not.bag"
    bad.write_bytes(b"#NOTABAG\n")
    try:
        list(rosbag.read_bag(str(bad)))
        assert False, "expected ValueError"
    except ValueError as e:
        assert "not a rosbag" in str(e)


# ---------------------------------------------------------------------------
# LZ4 chunks (roslz4 writes the standard LZ4 Frame format).
# ---------------------------------------------------------------------------

def _lz4_frame_store(data: bytes) -> bytes:
    """Minimal valid LZ4 frame: one uncompressed (high-bit) block."""
    out = struct.pack("<I", 0x184D2204) + bytes([0x40, 0x70, 0x00])
    out += struct.pack("<I", 0x80000000 | len(data)) + data
    out += struct.pack("<I", 0)
    return out


def test_lz4_frame_and_block_decode():
    from open3d_slam_jax import native as nat

    # Hand-crafted compressed block: token(lit=4, match=8) + "abcd" +
    # offset 4 -> "abcdabcdabcd", then a literal-only tail "WXYZ".
    blk = bytes([0x44]) + b"abcd" + b"\x04\x00" + bytes([0x40]) + b"WXYZ"
    expect = b"abcdabcdabcd" + b"WXYZ"
    frame = (struct.pack("<I", 0x184D2204) + bytes([0x40, 0x70, 0x00])
             + struct.pack("<I", len(blk)) + blk + struct.pack("<I", 0))
    assert nat.lz4_frame_decompress(frame, len(expect)) == expect
    assert nat._lz4_frame_decode_py(frame, len(expect)) == expect

    # Overlapping match (offset 1, RLE): token(lit=1, match=15) -> 'x'*16.
    blk2 = bytes([0x1B]) + b"x" + b"\x01\x00"
    frame2 = (struct.pack("<I", 0x184D2204) + bytes([0x40, 0x70, 0x00])
              + struct.pack("<I", len(blk2)) + blk2 + struct.pack("<I", 0))
    assert nat.lz4_frame_decompress(frame2, 16) == b"x" * 16
    assert nat._lz4_frame_decode_py(frame2, 16) == b"x" * 16

    # Uncompressed-block frame round trip.
    data = bytes(range(256)) * 7
    assert nat.lz4_frame_decompress(_lz4_frame_store(data), len(data)) == data

    # Malformed input raises.
    with pytest.raises(ValueError):
        nat.lz4_frame_decompress(b"\x00\x01\x02\x03\x04\x05\x06\x07", 8)


def test_bag_lz4_chunks(tmp_path, rng):
    path = str(tmp_path / "t_lz4.bag")
    records = [
        _conn_record(0, "/points", "sensor_msgs/PointCloud2"),
    ]
    pts = rng.uniform(-2, 2, size=(50, 3)).astype(np.float32)
    records.append(_msg_record(0, 1, 500, _pointcloud2_raw(pts, sec=1)))
    chunk = b"".join(records)
    hdr = _hdr(op=b"\x05", compression=b"lz4",
               size=struct.pack("<I", len(chunk)))
    with open(path, "wb") as f:
        f.write(b"#ROSBAG V2.0\n")
        f.write(_rec(hdr, _lz4_frame_store(chunk)))
    msgs = list(rosbag.read_bag(path))
    assert sum(m.datatype == "sensor_msgs/PointCloud2" for m in msgs) == 1
