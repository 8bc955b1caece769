"""Visualization sidecar: dependency-free top-down map/trajectory renders.

The reference publishes RViz topics from a sidecar thread
(``SlamWrapperRos.cpp`` visualization workers, ``visualization_utils``,
``IcpMatchesPublisher``). Headless accelerator hosts have no RViz; this module writes
self-contained PNGs (hand-rolled writer over stdlib ``zlib`` — no PIL /
matplotlib) so `run-slam --viz` and the evaluation harness can emit visual
artifacts anywhere.

Renders: orthographic top-down point density colored by mean height
(perceptual 'viridis-like' ramp), optional trajectory polyline + loop
closure segments, correspondence match renders for ICP debugging.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = ["encode_png", "write_png", "render_topdown", "render_matches"]


def encode_png(rgb: np.ndarray) -> bytes:
    """Encode an ``[H, W, 3] uint8`` array as PNG bytes (stdlib only)."""
    h, w, _ = rgb.shape
    raw = b"".join(
        b"\x00" + rgb[y].astype(np.uint8).tobytes() for y in range(h)
    )

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (
            struct.pack(">I", len(body))
            + tag
            + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an ``[H, W, 3] uint8`` array as a PNG (stdlib only)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def _colormap(t: np.ndarray) -> np.ndarray:
    """[N] in [0,1] -> [N,3] uint8, a compact viridis-like ramp."""
    t = np.clip(t, 0.0, 1.0)
    # piecewise-linear through (indigo, teal, green, yellow)
    anchors = np.array(
        [[70, 90, 200], [40, 160, 180], [80, 220, 120], [255, 235, 60]],
        dtype=np.float64,
    )
    pos = np.array([0.0, 1 / 3, 2 / 3, 1.0])
    out = np.empty((t.shape[0], 3))
    for c in range(3):
        out[:, c] = np.interp(t, pos, anchors[:, c])
    return out.astype(np.uint8)


def _draw_line(img: np.ndarray, p0, p1, color) -> None:
    """Bresenham polyline segment on [H, W, 3]."""
    h, w, _ = img.shape
    x0, y0 = int(p0[0]), int(p0[1])
    x1, y1 = int(p1[0]), int(p1[1])
    dx, dy = abs(x1 - x0), -abs(y1 - y0)
    sx = 1 if x0 < x1 else -1
    sy = 1 if y0 < y1 else -1
    err = dx + dy
    while True:
        if 0 <= x0 < w and 0 <= y0 < h:
            img[y0, x0] = color
        if x0 == x1 and y0 == y1:
            break
        e2 = 2 * err
        if e2 >= dy:
            err += dy
            x0 += sx
        if e2 <= dx:
            err += dx
            y0 += sy


def render_topdown(
    points: np.ndarray,
    trajectory: Optional[np.ndarray] = None,
    loop_closures: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None,
    size: int = 1024,
    margin: float = 0.05,
    path: Optional[str] = None,
) -> np.ndarray:
    """Top-down density render of a map cloud, colored by mean height.

    ``points [N, 3]``; ``trajectory [T, 3]`` drawn as a red polyline with a
    white start marker; ``loop_closures`` as cyan segments. Returns the
    ``[size, size, 3]`` image (and writes it when ``path`` is given).
    """
    pts = np.asarray(points, np.float64)
    if pts.size == 0:
        img = np.zeros((size, size, 3), np.uint8)
        if path:
            write_png(path, img)
        return img

    lo = pts[:, :2].min(axis=0)
    hi = pts[:, :2].max(axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    pad = span * margin
    lo = lo - pad
    scale = (size - 1) / (span + 2 * pad)

    ij = np.clip(((pts[:, :2] - lo) * scale), 0, size - 1).astype(np.int64)
    flat = ij[:, 1] * size + ij[:, 0]
    cnt = np.bincount(flat, minlength=size * size).astype(np.float64)
    zsum = np.bincount(flat, weights=pts[:, 2], minlength=size * size)
    occ = cnt > 0
    zmean = np.zeros_like(zsum)
    zmean[occ] = zsum[occ] / cnt[occ]

    img = np.zeros((size * size, 3), np.uint8)
    if occ.any():
        z = zmean[occ]
        zlo, zhi = np.percentile(z, [2, 98])
        t = (z - zlo) / max(zhi - zlo, 1e-9)
        # density shading: sqrt-compressed count brightens busy cells
        d = np.sqrt(cnt[occ]) / np.sqrt(max(cnt.max(), 1.0))
        col = _colormap(t).astype(np.float64) * (0.7 + 0.3 * d)[:, None]
        img[occ] = np.clip(col, 0, 255).astype(np.uint8)
    img = img.reshape(size, size, 3)[::-1].copy()  # y-up

    # 3x3 dilation: sparse voxelized maps land one point per pixel at high
    # render sizes; splatting keeps structure visible without PIL.
    painted = img.any(axis=2)
    acc = img.astype(np.uint16)
    hits = painted.astype(np.uint16)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            sh = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
            shp = np.roll(np.roll(painted, dy, axis=0), dx, axis=1)
            acc += sh.astype(np.uint16)
            hits += shp.astype(np.uint16)
    fill = ~painted & (hits > 0)
    img[fill] = (acc[fill] // np.maximum(hits[fill], 1)[:, None]).astype(np.uint8)

    def to_px(p):
        x = (p[0] - lo[0]) * scale
        y = (p[1] - lo[1]) * scale
        return (x, size - 1 - y)

    if trajectory is not None and len(trajectory) > 0:
        tr = np.asarray(trajectory, np.float64)
        for a, b in zip(tr[:-1], tr[1:]):
            _draw_line(img, to_px(a), to_px(b), (255, 64, 64))
        sx, sy = to_px(tr[0])
        img[max(0, int(sy) - 2) : int(sy) + 3, max(0, int(sx) - 2) : int(sx) + 3] = (
            255,
            255,
            255,
        )
    for a, b in loop_closures or []:
        _draw_line(img, to_px(np.asarray(a)), to_px(np.asarray(b)), (64, 255, 255))

    if path:
        write_png(path, img)
    return img


def render_matches(
    src: np.ndarray,
    tgt: np.ndarray,
    pair_mask: Optional[np.ndarray] = None,
    size: int = 1024,
    path: Optional[str] = None,
) -> np.ndarray:
    """ICP correspondence render (≙ IcpMatchesPublisher): source points
    green, target points blue, match segments grey."""
    src = np.asarray(src, np.float64)
    tgt = np.asarray(tgt, np.float64)
    allp = np.concatenate([src, tgt])
    lo = allp[:, :2].min(axis=0)
    hi = allp[:, :2].max(axis=0)
    span = float(max(hi[0] - lo[0], hi[1] - lo[1], 1e-6))
    pad = 0.05 * span
    lo = lo - pad
    scale = (size - 1) / (span + 2 * pad)
    img = np.zeros((size, size, 3), np.uint8)

    def to_px(p):
        return ((p[:, 0] - lo[0]) * scale, size - 1 - (p[:, 1] - lo[1]) * scale)

    if pair_mask is None:
        pair_mask = np.ones(min(len(src), len(tgt)), bool)
    n = min(len(src), len(tgt), len(pair_mask))
    for i in np.nonzero(pair_mask[:n])[0][:: max(1, n // 2000)]:
        xa, ya = (src[i, 0] - lo[0]) * scale, size - 1 - (src[i, 1] - lo[1]) * scale
        xb, yb = (tgt[i, 0] - lo[0]) * scale, size - 1 - (tgt[i, 1] - lo[1]) * scale
        _draw_line(img, (xa, ya), (xb, yb), (90, 90, 90))
    for pts, color in ((tgt, (80, 120, 255)), (src, (80, 255, 120))):
        xs, ys = to_px(pts)
        xi = np.clip(xs.astype(np.int64), 0, size - 1)
        yi = np.clip(ys.astype(np.int64), 0, size - 1)
        img[yi, xi] = color
    if path:
        write_png(path, img)
    return img
