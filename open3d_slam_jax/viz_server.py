"""Live visualization publisher: an embedded HTTP map server.

The reference publishes live state over ROS topics from sidecar worker
threads — assembled map / submaps / dense map clouds, scan2scan and
scan2map odometries, and paths (``SlamWrapperRos.cpp:275-293`` publisher
setup; tf/odom/visualization workers) — which RViz renders remotely.
Headless accelerator hosts have neither ROS nor RViz, so the equivalent
is a dependency-free HTTP sidecar: the SLAM loop pushes its latest state
here (cheap host-side numpy; render happens lazily per HTTP request, off
the hot path), and any browser / curl on the network plays the RViz role.

Endpoints:
  /                 tiny auto-refreshing HTML dashboard
  /map.png          top-down render of the latest map + trajectory
  /trajectory.json  stamped trajectory positions
  /stats.json       latest per-scan stats dict (scan2map time, fitness, ...)

Everything is stdlib (``http.server`` + the hand-rolled PNG writer in
``viz.py``). The server owns no SLAM state: ``publish_*`` copies small
arrays under a lock, mirroring the reference's snapshot-then-publish
pattern (``SlamWrapperRos`` publishes copies taken under the map mutex).
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from open3d_slam_jax import viz

__all__ = ["VizServer"]

_PAGE = b"""<!doctype html>
<html><head><title>open3d_slam_jax</title>
<meta http-equiv="refresh" content="2">
<style>body{background:#111;color:#ddd;font-family:monospace}</style>
</head><body>
<h3>open3d_slam_jax &mdash; live map</h3>
<img src="/map.png" style="max-width:95vw;border:1px solid #444">
<pre id="s"></pre>
<script>fetch('/stats.json').then(r=>r.json()).then(d=>{
  document.getElementById('s').textContent=JSON.stringify(d,null,1);});
</script></body></html>
"""


class VizServer:
    """Threaded HTTP publisher for live SLAM state.

    Usage::

        srv = VizServer(port=8008)
        ...
        stats = pipe.process_scan(pts, t)
        srv.publish(map_points=pipe.assembled_map(),
                    trajectory=traj, stats=stats)
        ...
        srv.close()

    ``port=0`` picks a free port (``srv.port`` reports the bound one).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 max_render_points: int = 400_000):
        self._lock = threading.Lock()
        self._map_pts: Optional[np.ndarray] = None
        self._traj: Optional[np.ndarray] = None
        self._loops: Optional[np.ndarray] = None
        self._stats: dict = {}
        self._png_cache: Optional[bytes] = None  # invalidated on publish
        self._max_render_points = int(max_render_points)

        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # keep the SLAM console clean
                pass

            def do_GET(self):
                if self.path in ("/", "/index.html"):
                    self._send(200, "text/html", _PAGE)
                elif self.path == "/map.png":
                    body = server._render_png()
                    if body is None:
                        self._send(404, "text/plain", b"no map published yet")
                    else:
                        self._send(200, "image/png", body)
                elif self.path == "/trajectory.json":
                    with server._lock:
                        traj = server._traj
                    body = json.dumps(
                        {"positions": [] if traj is None else traj.tolist()}
                    ).encode()
                    self._send(200, "application/json", body)
                elif self.path == "/stats.json":
                    with server._lock:
                        body = json.dumps(server._stats).encode()
                    self._send(200, "application/json", body)
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code: int, ctype: str, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="viz-server", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------------
    def publish(
        self,
        map_points: Optional[np.ndarray] = None,
        trajectory: Optional[np.ndarray] = None,
        loop_segments: Optional[np.ndarray] = None,
        stats: Optional[dict] = None,
    ) -> None:
        """Snapshot the latest state. Cheap: copies arrays, renders nothing.

        ``map_points``: [N,3]; downsampled to ``max_render_points`` by
        stride so a 10 Hz publish cadence stays O(map copy), matching the
        reference's throttled visualization workers.
        """
        with self._lock:
            if map_points is not None:
                pts = np.asarray(map_points, dtype=np.float32)
                if pts.shape[0] > self._max_render_points:
                    step = int(np.ceil(pts.shape[0] / self._max_render_points))
                    pts = pts[::step]
                self._map_pts = pts.copy()
                self._png_cache = None
            if trajectory is not None:
                self._traj = np.asarray(trajectory, dtype=np.float32).copy()
                self._png_cache = None
            if loop_segments is not None:
                self._loops = np.asarray(loop_segments, dtype=np.float32).copy()
                self._png_cache = None
            if stats is not None:
                self._stats = {
                    k: (float(v) if isinstance(v, (int, float, np.floating, np.integer)) else v)
                    for k, v in stats.items()
                    if isinstance(v, (int, float, bool, str, np.floating, np.integer))
                }

    # ------------------------------------------------------------------
    def _render_png(self) -> Optional[bytes]:
        """Render (and cache) the latest snapshot. Runs on the HTTP thread."""
        with self._lock:
            if self._png_cache is not None:
                return self._png_cache
            pts, traj, loops = self._map_pts, self._traj, self._loops
        if pts is None or pts.shape[0] == 0:
            return None
        pairs = None if loops is None else [(a, b) for a, b in loops]
        rgb = viz.render_topdown(pts, trajectory=traj, loop_closures=pairs)
        body = viz.encode_png(np.asarray(rgb))
        with self._lock:
            self._png_cache = body
        return body

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)
