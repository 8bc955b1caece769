"""Sensor packet deserialization — the pointmatcher_ros analogue.

The reference bridges ``sensor_msgs/PointCloud2`` to its containers in C++
(``RosPointCloud2Deserializer.cpp``, ``deserialization.cpp``). This module
provides the same bridge for this stack without a ROS dependency: a
:class:`PointCloud2Like` message description (fields/offsets/stride + raw
bytes) decoded through the native host library into a padded
:class:`PointBatch`, extra channels (intensity, ring, per-point time,
normals, rgb) included when present.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from open3d_slam_jax import native
from open3d_slam_jax.ops import pointcloud as pc

# PointField datatype codes (sensor_msgs convention).
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)


@dataclasses.dataclass(frozen=True)
class PointField:
    name: str
    offset: int
    datatype: int  # PointField code
    count: int = 1


@dataclasses.dataclass
class PointCloud2Like:
    """Minimal mirror of sensor_msgs/PointCloud2."""

    data: bytes
    width: int
    point_step: int
    fields: List[PointField]
    height: int = 1
    stamp: float = 0.0

    @property
    def n_points(self) -> int:
        return self.width * self.height

    def field(self, name: str) -> Optional[PointField]:
        for f in self.fields:
            if f.name == name:
                return f
        return None


def deserialize(
    msg: PointCloud2Like,
    capacity: Optional[int] = None,
    extra_channels: Tuple[str, ...] = ("intensity", "t", "time", "ring"),
) -> pc.PointBatch:
    """PointCloud2-like message -> padded PointBatch.

    NaN records are dropped during decoding (≙ the RemoveNaN + ordering
    logic in ``SlamWrapper::addRangeScan``). ``times`` channels are
    normalized to a ``times [N, 1]`` extra; normals (nx/ny/nz fields) are
    assembled when present.
    """
    fx, fy, fz = msg.field("x"), msg.field("y"), msg.field("z")
    if fx is None or fy is None or fz is None:
        raise ValueError("PointCloud2 message lacks x/y/z fields")
    if not (fx.datatype == fy.datatype == fz.datatype):
        raise ValueError("mixed xyz datatypes unsupported")

    xyz, mask = native.decode_xyz(
        msg.data, msg.n_points, msg.point_step,
        fx.offset, fy.offset, fz.offset,
        native.FLOAT32 if fx.datatype == FLOAT32 else native.FLOAT64,
    )

    extras: Dict[str, np.ndarray] = {}
    for name in extra_channels:
        f = msg.field(name)
        if f is None:
            continue
        code = {FLOAT32: native.FLOAT32, FLOAT64: native.FLOAT64,
                UINT8: native.UINT8, UINT16: native.UINT16}.get(f.datatype)
        if code is None:
            continue
        vals = native.decode_channel(
            msg.data, msg.n_points, msg.point_step, f.offset, code, mask
        )
        key = "times" if name in ("t", "time", "timestamp") else name
        extras[key] = vals[:, None]

    if all(msg.field(n) is not None for n in ("normal_x", "normal_y", "normal_z")):
        comps = []
        for n in ("normal_x", "normal_y", "normal_z"):
            f = msg.field(n)
            comps.append(
                native.decode_channel(
                    msg.data, msg.n_points, msg.point_step, f.offset,
                    native.FLOAT32, mask,
                )
            )
        extras["normals"] = np.stack(comps, axis=1)

    # Packed PCL colors: a float32 whose bits are 0x00RRGGBB (or 0xAARRGGBB
    # for "rgba") -> colors [N, 3] in [0, 1] (≙ the color path of the
    # reference's RosPointCloud2Deserializer).
    frgb = msg.field("rgb") or msg.field("rgba")
    if frgb is not None:
        raw = np.frombuffer(msg.data, np.uint8).reshape(msg.n_points, msg.point_step)
        packed = raw[:, frgb.offset: frgb.offset + 4].copy().view(np.uint32)[:, 0]
        packed = packed[np.asarray(mask, bool)]  # same NaN-drop as xyz
        r = ((packed >> 16) & 0xFF).astype(np.float32) / 255.0
        g = ((packed >> 8) & 0xFF).astype(np.float32) / 255.0
        b = (packed & 0xFF).astype(np.float32) / 255.0
        extras["colors"] = np.stack([r, g, b], axis=1)

    return pc.from_points(xyz, capacity=capacity, extras=extras)


def serialize(batch: pc.PointBatch, stamp: float = 0.0) -> PointCloud2Like:
    """PointBatch -> PointCloud2-like message (float32 xyz [+ channels]);
    the publisher-side counterpart (``serialization.cpp``)."""
    m = np.asarray(batch.mask)
    xyz = np.asarray(batch.xyz)[m].astype(np.float32)
    fields = [
        PointField("x", 0, FLOAT32),
        PointField("y", 4, FLOAT32),
        PointField("z", 8, FLOAT32),
    ]
    cols = [xyz]
    off = 12
    for name, vals in batch.extras.items():
        v = np.asarray(vals)[m].astype(np.float32)
        if name == "normals":
            for i, n in enumerate(("normal_x", "normal_y", "normal_z")):
                fields.append(PointField(n, off, FLOAT32))
                off += 4
            cols.append(v)
        elif name == "colors" and v.ndim == 2 and v.shape[1] == 3:
            c = (np.clip(v, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint32)
            packed = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
            fields.append(PointField("rgb", off, FLOAT32))
            off += 4
            cols.append(packed.view(np.float32)[:, None])
        elif v.ndim == 2 and v.shape[1] == 1:
            fields.append(PointField("times" if name == "times" else name, off, FLOAT32))
            off += 4
            cols.append(v)
    payload = np.concatenate(cols, axis=1)
    return PointCloud2Like(
        data=payload.astype(np.float32).tobytes(),
        width=len(xyz),
        point_step=off,
        fields=fields,
        stamp=stamp,
    )
