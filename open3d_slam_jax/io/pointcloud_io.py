"""Host-side point-cloud IO: CSV, ASCII VTK, PLY, PCD.

Counterpart of libpointmatcher's ``IO.cpp`` (CSV/VTK/PLY/PCD loaders with
labeled descriptors, ``IO.cpp:380-930``) — numpy-based, returning plain
``(points, extras)`` numpy arrays that callers pad into PointBatches. Kept
deliberately free of JAX so data loading never touches the device.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import numpy as np

Extras = Dict[str, np.ndarray]


def load_cloud(path: str) -> Tuple[np.ndarray, Extras]:
    """Dispatch by extension (≙ ``DataPoints::load``, ``IO.cpp:380-386``)."""
    p = str(path).lower()
    if p.endswith(".csv"):
        return load_csv(path)
    if p.endswith(".vtk"):
        return load_vtk(path)
    if p.endswith(".ply"):
        return load_ply(path)
    if p.endswith(".pcd"):
        return load_pcd(path)
    raise ValueError(f"unsupported point cloud format: {path}")


def save_cloud(path: str, points: np.ndarray, extras: Optional[Extras] = None) -> None:
    """Dispatch by extension (≙ ``DataPoints::save``, ``IO.cpp:388-404``)."""
    p = str(path).lower()
    if p.endswith(".csv"):
        return save_csv(path, points, extras)
    if p.endswith(".vtk"):
        return save_vtk(path, points, extras)
    if p.endswith(".ply"):
        return save_ply(path, points, extras)
    if p.endswith(".pcd"):
        return save_pcd(path, points, extras)
    raise ValueError(f"unsupported point cloud format: {path}")


def load_csv(path: str) -> Tuple[np.ndarray, Extras]:
    """CSV with an optional header naming columns (x, y, z + descriptors).

    Headerless numeric files (like the reference's ``car_cloud400.csv``) are
    treated as plain x y z rows, matching ``CSVDataPointsLoader``'s
    auto-detection (``IO.cpp``)."""
    with open(path, "r") as f:
        header = f.readline().strip()
    delim = "," if "," in header else None
    names = [h.strip() for h in (header.split(",") if delim else header.split())]

    def _numeric(tok: str) -> bool:
        try:
            float(tok)
            return True
        except ValueError:
            return False

    if names and all(_numeric(n) for n in names):
        data = np.loadtxt(path, delimiter=delim, dtype=np.float32, ndmin=2)
        if data.shape[1] == 2:
            data = np.c_[data, np.zeros((len(data), 1), np.float32)]
        return data[:, :3].astype(np.float32), {}

    data = np.loadtxt(path, skiprows=1, delimiter=delim, dtype=np.float32, ndmin=2)
    cols = {n.lower(): i for i, n in enumerate(names)}
    if not {"x", "y"} <= cols.keys():
        raise ValueError(f"CSV must name x,y(,z) columns, got {names}")
    idx = [cols["x"], cols["y"]]
    if "z" in cols:
        idx.append(cols["z"])
    pts = data[:, idx]
    if pts.shape[1] == 2:
        pts = np.c_[pts, np.zeros((len(pts), 1), np.float32)]
    extras: Extras = {}
    if {"nx", "ny", "nz"} <= cols.keys():
        extras["normals"] = data[:, [cols["nx"], cols["ny"], cols["nz"]]]
    return pts.astype(np.float32), extras


def save_csv(path: str, points: np.ndarray, extras: Optional[Extras] = None) -> None:
    extras = extras or {}
    names = ["x", "y", "z"]
    arrays = [np.asarray(points, np.float32)]
    if "normals" in extras:
        names += ["nx", "ny", "nz"]
        arrays.append(np.asarray(extras["normals"], np.float32))
    data = np.concatenate(arrays, axis=1)
    np.savetxt(path, data, delimiter=",", header=",".join(names), comments="")


_VTK_DTYPES = {
    "float": (">f4", np.float32), "double": (">f8", np.float64),
    "int": (">i4", np.int32), "unsigned_int": (">u4", np.uint32),
    "short": (">i2", np.int16), "unsigned_short": (">u2", np.uint16),
    "char": ("i1", np.int8), "unsigned_char": ("u1", np.uint8),
    "long": (">i8", np.int64), "unsigned_long": (">u8", np.uint64),
}


def load_vtk(path: str) -> Tuple[np.ndarray, Extras]:
    """Legacy VTK, ASCII **or BINARY** (big-endian, per the legacy spec),
    polydata/unstructured points — the reference reads both
    (``IO.cpp:380-930``/``loadVTK``). POINTS plus any NORMALS / SCALARS /
    VECTORS point-data arrays (returned in ``extras`` under their VTK
    names; NORMALS under ``"normals"``)."""
    with open(path, "rb") as f:
        raw = f.read()
    # Header: line 1 version comment, line 2 title, line 3 ASCII|BINARY.
    nl = 0
    lines_end = []
    for _ in range(3):
        nl = raw.index(b"\n", nl) + 1
        lines_end.append(nl)
    fmt = raw[lines_end[1]: lines_end[2]].strip().upper()
    binary = fmt == b"BINARY"
    pos = lines_end[2]

    def read_line(p):
        e = raw.index(b"\n", p)
        return raw[p:e].decode("ascii", errors="replace").strip(), e + 1

    def read_array(p, count, vtk_type):
        """Read ``count`` scalars of ``vtk_type`` starting at ``p``."""
        be, host = _VTK_DTYPES[vtk_type]
        if binary:
            itemsize = np.dtype(be).itemsize
            arr = np.frombuffer(raw, dtype=be, count=count, offset=p).astype(host)
            q = p + count * itemsize
            if q < len(raw) and raw[q: q + 1] == b"\n":
                q += 1
            return arr, q
        # ASCII: take exactly `count` whitespace tokens.
        toks = []
        while len(toks) < count:
            line, p = read_line(p)
            toks.extend(line.split())
        return np.array(toks[:count], dtype=host), p

    pts = None
    extras: Extras = {}
    n_points = 0
    while pos < len(raw):
        line, pos2 = read_line(pos)
        up = line.upper()
        if up.startswith("POINTS"):
            _, cnt, typ = line.split()[:3]
            n_points = int(cnt)
            arr, pos2 = read_array(pos2, n_points * 3, typ.lower())
            pts = arr.reshape(n_points, 3).astype(np.float32)
        elif up.startswith("NORMALS"):
            typ = line.split()[2].lower()
            arr, pos2 = read_array(pos2, n_points * 3, typ)
            extras["normals"] = arr.reshape(n_points, 3).astype(np.float32)
        elif up.startswith("VECTORS"):
            name, typ = line.split()[1], line.split()[2].lower()
            arr, pos2 = read_array(pos2, n_points * 3, typ)
            extras[name] = arr.reshape(n_points, 3).astype(np.float32)
        elif up.startswith("SCALARS"):
            parts = line.split()
            name, typ = parts[1], parts[2].lower()
            ncomp = int(parts[3]) if len(parts) > 3 else 1
            lookup, pos2 = read_line(pos2)  # LOOKUP_TABLE line
            if not lookup.upper().startswith("LOOKUP_TABLE"):
                raise ValueError(f"malformed SCALARS block in {path}")
            arr, pos2 = read_array(pos2, n_points * ncomp, typ)
            extras[name] = arr.reshape(n_points, ncomp).astype(np.float32)
        elif up.startswith(("VERTICES", "POLYGONS", "LINES", "CELLS", "TRIANGLE_STRIPS")):
            # Connectivity blocks: "<KEY> n size" then `size` ints — skip.
            _, _n, size = line.split()[:3]
            _, pos2 = read_array(pos2, int(size), "int")
        elif up.startswith("CELL_TYPES"):
            _, cnt = line.split()[:2]
            _, pos2 = read_array(pos2, int(cnt), "int")
        # POINT_DATA/CELL_DATA/FIELD headers and blank lines: fall through.
        pos = pos2
        if pts is not None and pos >= len(raw):
            break
    if pts is None:
        raise ValueError(f"no POINTS section in {path}")
    return pts, extras


def save_vtk(
    path: str,
    points: np.ndarray,
    extras: Optional[Extras] = None,
    binary: bool = False,
) -> None:
    """Legacy VTK polydata writer, ASCII or BINARY (big-endian) — round-trip
    partner of :func:`load_vtk` (≙ ``IO.cpp``'s ``saveVTK``). Normals go to
    a NORMALS block; other per-point extras to SCALARS blocks."""
    extras = extras or {}
    points = np.asarray(points, np.float32)
    n = len(points)

    def emit(f, arr):
        arr = np.asarray(arr, np.float32)
        if binary:
            f.write(arr.astype(">f4").tobytes())
            f.write(b"\n")
        else:
            np.savetxt(f, arr.reshape(n, -1), fmt="%.8g")

    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nopen3d_slam_jax cloud\n")
        f.write(b"BINARY\n" if binary else b"ASCII\n")
        f.write(b"DATASET POLYDATA\n")
        f.write(f"POINTS {n} float\n".encode())
        emit(f, points)
        if extras:
            f.write(f"POINT_DATA {n}\n".encode())
        if "normals" in extras:
            f.write(b"NORMALS normals float\n")
            emit(f, extras["normals"])
        for name, arr in extras.items():
            if name == "normals":
                continue
            arr = np.asarray(arr, np.float32).reshape(n, -1)
            f.write(f"SCALARS {name} float {arr.shape[1]}\n".encode())
            f.write(b"LOOKUP_TABLE default\n")
            emit(f, arr)


_PLY_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "i2", "ushort": "u2", "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
}


def load_ply(path: str) -> Tuple[np.ndarray, Extras]:
    """PLY (ascii or binary_little_endian), vertex element only."""
    with open(path, "rb") as f:
        header_lines = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header_lines.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header_lines if l.startswith("format"))
        n = 0
        props = []
        in_vertex = False
        for l in header_lines:
            if l.startswith("element"):
                parts = l.split()
                in_vertex = parts[1] == "vertex"
                if in_vertex:
                    n = int(parts[2])
            elif l.startswith("property") and in_vertex:
                _, typ, name = l.split()[:3]
                props.append((name, _PLY_DTYPES[typ]))
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append(f.readline().split())
            arr = np.array(rows, dtype=np.float64)
            rec = {name: arr[:, i] for i, (name, _) in enumerate(props)}
        elif fmt == "binary_little_endian":
            dt = np.dtype([(name, "<" + d) for name, d in props])
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            rec = {name: raw[name].astype(np.float64) for name, _ in props}
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    extras: Extras = {}
    if {"nx", "ny", "nz"} <= rec.keys():
        extras["normals"] = np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=1).astype(np.float32)
    if {"red", "green", "blue"} <= rec.keys():
        extras["colors"] = (
            np.stack([rec["red"], rec["green"], rec["blue"]], axis=1) / 255.0
        ).astype(np.float32)
    return pts, extras


def save_ply(path: str, points: np.ndarray, extras: Optional[Extras] = None) -> None:
    """Binary little-endian PLY with optional normals/colors — the map-save
    format (≙ the reference saving maps/submaps as PCD/PLY,
    ``SlamWrapper.cpp:499-517``)."""
    extras = extras or {}
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if "normals" in extras:
        nm = np.asarray(extras["normals"], np.float32)
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        cols += [nm[:, 0], nm[:, 1], nm[:, 2]]
    if "colors" in extras:
        c = (np.clip(np.asarray(extras["colors"]), 0, 1) * 255).astype(np.uint8)
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        cols += [c[:, 0], c[:, 1], c[:, 2]]
    rec = np.empty(n, dtype=np.dtype(fields))
    for (name, _), col in zip(fields, cols):
        rec[name] = col
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        type_names = {"<f4": "float", "u1": "uchar"}
        for name, dt in fields:
            f.write(f"property {type_names[dt]} {name}\n".encode())
        f.write(b"end_header\n")
        f.write(rec.tobytes())


def load_pcd(path: str) -> Tuple[np.ndarray, Extras]:
    """PCD v0.7, ascii or binary (uncompressed)."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        n = int(header["POINTS"])
        np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "u1", ("U", 4): "<u4", ("I", 4): "<i4"}
        dt = np.dtype([(fld, np_types[(t, s)]) for fld, t, s in zip(fields, types, sizes)])
        if header["DATA"] == "ascii":
            arr = np.loadtxt(f, dtype=np.float64, ndmin=2)
            rec = {fld: arr[:, i] for i, fld in enumerate(fields)}
        elif header["DATA"] == "binary":
            raw = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
            rec = {fld: raw[fld].astype(np.float64) for fld in fields}
        else:
            raise ValueError(f"unsupported PCD data mode {header['DATA']}")
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1).astype(np.float32)
    extras: Extras = {}
    if {"normal_x", "normal_y", "normal_z"} <= rec.keys():
        extras["normals"] = np.stack(
            [rec["normal_x"], rec["normal_y"], rec["normal_z"]], axis=1
        ).astype(np.float32)
    return pts, extras


def save_pcd(path: str, points: np.ndarray, extras: Optional[Extras] = None) -> None:
    """Binary PCD v0.7 (x y z [+ normals])."""
    extras = extras or {}
    points = np.asarray(points, np.float32)
    n = len(points)
    fields = ["x", "y", "z"]
    cols = [points[:, 0], points[:, 1], points[:, 2]]
    if "normals" in extras:
        nm = np.asarray(extras["normals"], np.float32)
        fields += ["normal_x", "normal_y", "normal_z"]
        cols += [nm[:, 0], nm[:, 1], nm[:, 2]]
    dt = np.dtype([(fld, "<f4") for fld in fields])
    rec = np.empty(n, dtype=dt)
    for fld, col in zip(fields, cols):
        rec[fld] = col
    with open(path, "wb") as f:
        f.write(b"# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n")
        f.write(f"FIELDS {' '.join(fields)}\n".encode())
        f.write(f"SIZE {' '.join(['4'] * len(fields))}\n".encode())
        f.write(f"TYPE {' '.join(['F'] * len(fields))}\n".encode())
        f.write(f"COUNT {' '.join(['1'] * len(fields))}\n".encode())
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n".encode())
        f.write(f"POINTS {n}\nDATA binary\n".encode())
        f.write(rec.tobytes())
