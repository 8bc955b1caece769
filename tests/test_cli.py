"""CLI smoke tests (≙ the reference's examples/ executables).

Covers the host entry points that have no other harness: list-modules,
profile-filters (filterProfiler.cpp analogue), compute-overlap.
"""

import json

import numpy as np
import pytest

from open3d_slam_jax import cli


def test_list_modules(capsys):
    assert cli.main(["list-modules"]) == 0
    out = capsys.readouterr().out
    assert "VoxelGridDataPointsFilter" in out
    assert "HiddenPointRemovalDataPointsFilter" in out
    assert "DegeneracyAwareness" in out


def test_profile_filters_default_chain(capsys):
    # filterProfiler.cpp's own chain (random sample -> voxel grid) + normals,
    # on a small synthetic cloud; verifies per-stage rows and point bookkeeping.
    assert cli.main(["profile-filters", "--points", "4000", "--reps", "2"]) == 0
    doc = json.loads(capsys.readouterr().out)
    stages = doc["stages"]
    assert [s["filter"] for s in stages] == [
        "RandomSamplingDataPointsFilter",
        "VoxelGridDataPointsFilter",
        "SurfaceNormalDataPointsFilter",
    ]
    assert stages[0]["points_in"] == 4000
    # prob=0.5 sampling: out is roughly half, and stages chain in->out.
    assert 1000 < stages[0]["points_out"] < 3000
    assert stages[1]["points_in"] == stages[0]["points_out"]
    # normals estimation keeps the count; voxel grid only removes.
    assert stages[2]["points_out"] == stages[2]["points_in"]
    for s in stages:
        assert s["p50_ms"] > 0 and s["compile_ms"] > 0


def test_profile_filters_from_yaml(tmp_path, capsys):
    cfg = tmp_path / "chain.yaml"
    cfg.write_text(
        "readingDataPointsFilters:\n"
        "  - MaxDistDataPointsFilter:\n      maxDist: 5.0\n"
        "  - RandomSamplingDataPointsFilter:\n      prob: 0.25\n"
    )
    assert cli.main([
        "profile-filters", "--points", "2000", "--reps", "1",
        "--config", str(cfg),
    ]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [s["filter"] for s in doc["stages"]] == [
        "MaxDistDataPointsFilter", "RandomSamplingDataPointsFilter",
    ]


def test_register_init_guess_and_save_transformed(tmp_path, capsys):
    # icp.cpp's --initTranslation/--initRotation/isTransfoSaved surface:
    # a rotated+shifted pair that converges from the provided guess; the
    # transformed reading lands on the reference.
    rng = np.random.default_rng(1)
    n = 3000
    ref = np.c_[rng.uniform(-4, 4, (n, 2)), 0.2 * np.sin(rng.uniform(-4, 4, (n, 1)))]
    ang = 0.3
    R = np.array([[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1.0]])
    t = np.array([0.8, -0.5, 0.1])
    reading = (ref - t) @ R  # reading = R^T (ref - t): T_true maps reading->ref
    pr, pd = tmp_path / "ref.ply", tmp_path / "read.ply"
    from open3d_slam_jax.io import load_cloud, save_cloud

    save_cloud(str(pr), ref.astype(np.float32))
    save_cloud(str(pd), reading.astype(np.float32))
    out_T, out_cloud = tmp_path / "T.txt", tmp_path / "moved.pcd"
    rc = cli.main([
        "register", str(pd), str(pr),
        "--max-dist", "2.0",
        "--init-translation", f"{t[0]},{t[1]},{t[2]}",
        "--init-rotation", "1,0,0;0,1,0;0,0,1",
        "--output", str(out_T), "--save-transformed", str(out_cloud),
    ])
    assert rc == 0
    T = np.loadtxt(out_T)
    assert np.allclose(T[:3, :3], R, atol=2e-2)
    assert np.allclose(T[:3, 3], t, atol=2e-2)
    moved, _ = load_cloud(str(out_cloud))
    # transformed reading ≈ reference (same point order by construction)
    assert float(np.abs(moved - ref).max()) < 0.05


def test_register_rejects_bad_rotation(tmp_path, capsys):
    from open3d_slam_jax.io import save_cloud

    p = tmp_path / "c.csv"
    save_cloud(str(p), np.zeros((4, 3), np.float32))
    rc = cli.main(["register", str(p), str(p), "--init-rotation", "1,0;0,1"])
    assert rc == 1


def test_compute_overlap(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    pa, pb = tmp_path / "a.csv", tmp_path / "b.csv"
    np.savetxt(pa, a, delimiter=",", header="x,y,z", comments="")
    np.savetxt(pb, a + 0.001, delimiter=",", header="x,y,z", comments="")
    assert cli.main(["compute-overlap", str(pa), str(pb), "--radius", "0.05"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["overlap_a_in_b"] > 0.99
