"""Point-cloud IO round-trips (≙ libpointmatcher IO.cpp loaders/savers,
IO.cpp:380-930 — CSV/VTK/PLY/PCD, with VTK in BOTH ascii and binary legacy
encodings, which the reference reads)."""

import os

import numpy as np
import pytest

from open3d_slam_jax.io import (
    load_cloud,
    load_pcd,
    load_ply,
    load_vtk,
    save_pcd,
    save_ply,
)
from open3d_slam_jax.io.pointcloud_io import save_vtk

REF_DATA = "/root/reference/libpointmatcher/examples/data"


@pytest.fixture
def cloud(rng):
    pts = rng.uniform(-10, 10, (257, 3)).astype(np.float32)
    normals = rng.normal(size=(257, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    intensity = rng.uniform(0, 1, (257, 1)).astype(np.float32)
    return pts, normals, intensity


@pytest.mark.parametrize("binary", [False, True])
def test_vtk_roundtrip(tmp_path, cloud, binary):
    pts, normals, intensity = cloud
    p = str(tmp_path / "c.vtk")
    save_vtk(p, pts, {"normals": normals, "intensity": intensity}, binary=binary)
    pts2, extras = load_vtk(p)
    np.testing.assert_allclose(pts2, pts, atol=1e-5)
    np.testing.assert_allclose(extras["normals"], normals, atol=1e-5)
    np.testing.assert_allclose(extras["intensity"], intensity, atol=1e-5)


def test_vtk_binary_equals_ascii(tmp_path, cloud):
    """The two encodings of the same cloud must load identically."""
    pts, normals, _ = cloud
    pa, pb = str(tmp_path / "a.vtk"), str(tmp_path / "b.vtk")
    save_vtk(pa, pts, {"normals": normals}, binary=False)
    save_vtk(pb, pts, {"normals": normals}, binary=True)
    a_pts, a_ex = load_vtk(pa)
    b_pts, b_ex = load_vtk(pb)
    np.testing.assert_allclose(a_pts, b_pts, atol=1e-5)
    np.testing.assert_allclose(a_ex["normals"], b_ex["normals"], atol=1e-5)


@pytest.mark.skipif(not os.path.isdir(REF_DATA), reason="reference data not mounted")
def test_vtk_reads_reference_cloud():
    pts, _ = load_vtk(os.path.join(REF_DATA, "cloud.00000.vtk"))
    assert pts.shape[1] == 3 and len(pts) > 1000
    assert np.isfinite(pts).all()


@pytest.mark.skipif(not os.path.isdir(REF_DATA), reason="reference data not mounted")
def test_load_cloud_dispatch():
    pts, _ = load_cloud(os.path.join(REF_DATA, "car_cloud400.csv"))
    assert pts.shape[1] == 3 and len(pts) > 100


def test_ply_roundtrip(tmp_path, cloud):
    pts, normals, _ = cloud
    p = str(tmp_path / "c.ply")
    save_ply(p, pts, {"normals": normals})
    pts2, extras = load_ply(p)
    np.testing.assert_allclose(pts2, pts, atol=1e-6)
    np.testing.assert_allclose(extras["normals"], normals, atol=1e-6)


def test_pcd_roundtrip(tmp_path, cloud):
    pts, normals, _ = cloud
    p = str(tmp_path / "c.pcd")
    save_pcd(p, pts, {"normals": normals})
    pts2, extras = load_pcd(p)
    np.testing.assert_allclose(pts2, pts, atol=1e-6)
    np.testing.assert_allclose(extras["normals"], normals, atol=1e-6)
