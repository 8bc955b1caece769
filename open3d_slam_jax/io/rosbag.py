"""Native rosbag v2.0 reader — no ROS dependency.

The reference ingests data through ROS: live subscribers
(``OnlineRangeDataProcessorRos.cpp:100-125``) or deterministic rosbag replay
(``RosbagRangeDataProcessorRos.cpp:247-421``), which SURVEY.md marks as the
primary correctness harness. This module reads the same ``.bag`` files
directly: the bag v2.0 container is a simple documented record format
(op-coded records with key=value headers), and the handful of message types
the pipeline consumes have stable little-endian wire layouts that we decode
by hand — ``sensor_msgs/PointCloud2`` (via :mod:`io.sensor_msgs` and the
native decoder), ``nav_msgs/Odometry``, ``sensor_msgs/Imu``,
``geometry_msgs/PoseStamped``, and ``tf2_msgs/TFMessage``.

Supported chunk compressions: ``none`` and ``bz2`` (stdlib); ``lz4`` bags
raise with a clear message (no lz4 module in this environment).
"""

from __future__ import annotations

import bz2
import dataclasses
import struct
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from open3d_slam_jax.io import sensor_msgs

_MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07


def _parse_header(buf: bytes) -> Dict[bytes, bytes]:
    fields: Dict[bytes, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = struct.unpack_from("<I", buf, off)
        off += 4
        entry = buf[off : off + flen]
        off += flen
        k, _, v = entry.partition(b"=")
        fields[k] = v
    return fields


def _read_record(data: bytes, off: int) -> Tuple[Dict[bytes, bytes], bytes, int]:
    (hlen,) = struct.unpack_from("<I", data, off)
    off += 4
    hdr = _parse_header(data[off : off + hlen])
    off += hlen
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    payload = data[off : off + dlen]
    off += dlen
    return hdr, payload, off


@dataclasses.dataclass(frozen=True)
class Connection:
    conn_id: int
    topic: str
    datatype: str
    md5sum: str


@dataclasses.dataclass(frozen=True)
class BagMessage:
    topic: str
    datatype: str
    stamp: float  # record receive time, seconds
    raw: bytes  # serialized message body


def read_bag(path: str) -> Iterator[BagMessage]:
    """Iterate messages of a rosbag v2.0 file in chunk order."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_MAGIC):
        raise ValueError(f"{path}: not a rosbag v2.0 file")
    off = len(_MAGIC)
    conns: Dict[int, Connection] = {}

    def handle(hdr: Dict[bytes, bytes], payload: bytes):
        op = hdr[b"op"][0]
        if op == _OP_CONNECTION:
            cid = struct.unpack("<I", hdr[b"conn"])[0]
            sub = _parse_header(payload)
            conns[cid] = Connection(
                conn_id=cid,
                topic=(hdr.get(b"topic") or sub.get(b"topic", b"")).decode(),
                datatype=sub.get(b"type", b"").decode(),
                md5sum=sub.get(b"md5sum", b"").decode(),
            )
        elif op == _OP_MSG:
            cid = struct.unpack("<I", hdr[b"conn"])[0]
            sec, nsec = struct.unpack("<II", hdr[b"time"])
            c = conns.get(cid)
            if c is not None:
                yield BagMessage(
                    topic=c.topic,
                    datatype=c.datatype,
                    stamp=sec + nsec * 1e-9,
                    raw=payload,
                )

    while off < len(data):
        hdr, payload, off = _read_record(data, off)
        op = hdr[b"op"][0]
        if op == _OP_CHUNK:
            comp = hdr.get(b"compression", b"none")
            if comp == b"none":
                chunk = payload
            elif comp == b"bz2":
                chunk = bz2.decompress(payload)
            elif comp == b"lz4":
                # roslz4 writes the standard LZ4 Frame; the chunk header's
                # 'size' field is the uncompressed size (bag format 2.0).
                from open3d_slam_jax.native import lz4_frame_decompress

                expected = struct.unpack("<I", hdr[b"size"])[0]
                chunk = lz4_frame_decompress(payload, expected)
            else:
                raise NotImplementedError(
                    f"rosbag chunk compression {comp.decode()!r} unsupported"
                )
            o = 0
            while o < len(chunk):
                ehdr, epayload, o = _read_record(chunk, o)
                yield from handle(ehdr, epayload)
        else:
            # Unchunked writers place connection/message records at top
            # level; index / chunk-info / bag-header records are skipped
            # inside ``handle``-unknown ops.
            if op in (_OP_CONNECTION, _OP_MSG):
                yield from handle(hdr, payload)


class _Cursor:
    def __init__(self, raw: bytes):
        self.b = raw
        self.o = 0

    def u32(self) -> int:
        (v,) = struct.unpack_from("<I", self.b, self.o)
        self.o += 4
        return v

    def f64(self, n: int = 1):
        vals = struct.unpack_from(f"<{n}d", self.b, self.o)
        self.o += 8 * n
        return vals if n > 1 else vals[0]

    def string(self) -> str:
        n = self.u32()
        s = self.b[self.o : self.o + n].decode(errors="replace")
        self.o += n
        return s

    def time(self) -> float:
        sec = self.u32()
        nsec = self.u32()
        return sec + nsec * 1e-9

    def header(self) -> Tuple[float, str]:
        self.u32()  # seq
        t = self.time()
        frame = self.string()
        return t, frame


def decode_pointcloud2(raw: bytes) -> sensor_msgs.PointCloud2Like:
    """sensor_msgs/PointCloud2 wire format -> PointCloud2Like."""
    c = _Cursor(raw)
    stamp, _frame = c.header()
    height = c.u32()
    width = c.u32()
    nfields = c.u32()
    fields: List[sensor_msgs.PointField] = []
    for _ in range(nfields):
        name = c.string()
        offset = c.u32()
        datatype = c.b[c.o]
        c.o += 1
        count = struct.unpack_from("<I", c.b, c.o + 0)[0]
        c.o += 4
        fields.append(sensor_msgs.PointField(name, offset, datatype, count))
    c.o += 1  # is_bigendian
    point_step = c.u32()
    c.u32()  # row_step
    dlen = c.u32()
    data = c.b[c.o : c.o + dlen]
    c.o += dlen
    return sensor_msgs.PointCloud2Like(
        data=data, width=width, point_step=point_step, fields=fields,
        height=height, stamp=stamp,
    )


@dataclasses.dataclass(frozen=True)
class OdometryMsg:
    stamp: float
    frame_id: str
    child_frame_id: str
    position: np.ndarray  # [3]
    quaternion: np.ndarray  # [x, y, z, w]


def decode_odometry(raw: bytes) -> OdometryMsg:
    c = _Cursor(raw)
    stamp, frame = c.header()
    child = c.string()
    px, py, pz = c.f64(3)
    qx, qy, qz, qw = c.f64(4)
    return OdometryMsg(
        stamp=stamp, frame_id=frame, child_frame_id=child,
        position=np.array([px, py, pz]),
        quaternion=np.array([qx, qy, qz, qw]),
    )


@dataclasses.dataclass(frozen=True)
class ImuMsg:
    stamp: float
    quaternion: np.ndarray  # [x, y, z, w]
    angular_velocity: np.ndarray  # [3]
    linear_acceleration: np.ndarray  # [3]


def decode_imu(raw: bytes) -> ImuMsg:
    c = _Cursor(raw)
    stamp, _ = c.header()
    qx, qy, qz, qw = c.f64(4)
    c.f64(9)  # orientation covariance
    wx, wy, wz = c.f64(3)
    c.f64(9)
    ax, ay, az = c.f64(3)
    return ImuMsg(
        stamp=stamp,
        quaternion=np.array([qx, qy, qz, qw]),
        angular_velocity=np.array([wx, wy, wz]),
        linear_acceleration=np.array([ax, ay, az]),
    )


def decode_pose_stamped(raw: bytes) -> OdometryMsg:
    c = _Cursor(raw)
    stamp, frame = c.header()
    px, py, pz = c.f64(3)
    qx, qy, qz, qw = c.f64(4)
    return OdometryMsg(
        stamp=stamp, frame_id=frame, child_frame_id="",
        position=np.array([px, py, pz]),
        quaternion=np.array([qx, qy, qz, qw]),
    )


def decode_tf_message(raw: bytes) -> List[OdometryMsg]:
    c = _Cursor(raw)
    n = c.u32()
    out = []
    for _ in range(n):
        stamp, frame = c.header()
        child = c.string()
        tx, ty, tz = c.f64(3)
        qx, qy, qz, qw = c.f64(4)
        out.append(
            OdometryMsg(
                stamp=stamp, frame_id=frame, child_frame_id=child,
                position=np.array([tx, ty, tz]),
                quaternion=np.array([qx, qy, qz, qw]),
            )
        )
    return out


_DECODERS = {
    "sensor_msgs/PointCloud2": decode_pointcloud2,
    "nav_msgs/Odometry": decode_odometry,
    "sensor_msgs/Imu": decode_imu,
    "geometry_msgs/PoseStamped": decode_pose_stamped,
    "tf2_msgs/TFMessage": decode_tf_message,
}


def read_bag_decoded(
    path: str, topics: Optional[List[str]] = None
) -> Iterator[Tuple[str, str, float, object]]:
    """Iterate (topic, datatype, stamp, decoded message) for supported types."""
    for m in read_bag(path):
        if topics is not None and m.topic not in topics:
            continue
        dec = _DECODERS.get(m.datatype)
        if dec is None:
            continue
        yield m.topic, m.datatype, m.stamp, dec(m.raw)
