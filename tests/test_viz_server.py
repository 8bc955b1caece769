"""Live viz publisher (viz_server.VizServer) — the RViz-publisher analogue.

Reference behavior mirrored: SlamWrapperRos publishes assembled map /
trajectory / stats over ROS topics from sidecar threads
(SlamWrapperRos.cpp:275-293); here an embedded HTTP server serves the same
state to any browser/curl.
"""

import json
import struct
import urllib.request
import zlib

import numpy as np

from open3d_slam_jax import viz
from open3d_slam_jax.viz_server import VizServer


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_encode_png_roundtrip():
    rgb = (np.arange(4 * 5 * 3).reshape(4, 5, 3) % 256).astype(np.uint8)
    body = viz.encode_png(rgb)
    assert body.startswith(b"\x89PNG\r\n\x1a\n")
    # IHDR carries the dimensions
    w, h = struct.unpack(">II", body[16:24])
    assert (w, h) == (5, 4)
    # decode the single IDAT back to the filtered scanlines
    idat_at = body.index(b"IDAT")
    (ln,) = struct.unpack(">I", body[idat_at - 4 : idat_at])
    raw = zlib.decompress(body[idat_at + 4 : idat_at + 4 + ln])
    rows = np.frombuffer(raw, np.uint8).reshape(4, 1 + 5 * 3)
    assert (rows[:, 0] == 0).all()  # filter type none
    np.testing.assert_array_equal(rows[:, 1:].reshape(4, 5, 3), rgb)


def test_viz_server_endpoints():
    srv = VizServer(port=0)
    try:
        base = f"http://{srv.host}:{srv.port}"
        # before any publish: dashboard up, map 404s
        assert b"live map" in _get(base + "/")
        try:
            _get(base + "/map.png")
            assert False, "expected 404 before first publish"
        except urllib.error.HTTPError as e:
            assert e.code == 404

        rng = np.random.default_rng(0)
        pts = rng.normal(size=(5000, 3)).astype(np.float32) * [10, 10, 1]
        traj = np.stack([np.linspace(0, 5, 20), np.zeros(20), np.zeros(20)], -1)
        loops = np.stack([traj[:2], traj[-2:]], axis=1)  # [2, 2, 3]
        srv.publish(
            map_points=pts,
            trajectory=traj,
            loop_segments=loops,
            stats={"overlap": 0.93, "iterations": 7, "note": "ok",
                   "ignored": object()},
        )

        png = _get(base + "/map.png")
        assert png.startswith(b"\x89PNG\r\n\x1a\n")
        # render cache: identical bytes on re-fetch
        assert _get(base + "/map.png") == png

        tj = json.loads(_get(base + "/trajectory.json"))
        assert len(tj["positions"]) == 20
        st = json.loads(_get(base + "/stats.json"))
        assert st["overlap"] == 0.93 and st["iterations"] == 7
        assert st["note"] == "ok" and "ignored" not in st

        # a new publish invalidates the render cache
        srv.publish(map_points=pts * 0.5)
        png2 = _get(base + "/map.png")
        assert png2 != png
    finally:
        srv.close()


def test_viz_server_downsamples_large_maps():
    srv = VizServer(port=0, max_render_points=1000)
    try:
        pts = np.random.default_rng(1).normal(size=(10_000, 3)).astype(np.float32)
        srv.publish(map_points=pts)
        assert srv._map_pts.shape[0] <= 1000
    finally:
        srv.close()
