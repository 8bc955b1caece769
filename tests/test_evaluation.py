import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from open3d_slam_jax import evaluation
from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models import icp as icp_mod

from tests.test_icp import BASE_CFG, make_surface_cloud


@pytest.mark.slow
def test_evaluate_and_report(rng, tmp_path):
    cases = []
    for i in range(3):
        ref = make_surface_cloud(rng, 900)
        T_gt = np.asarray(se3.exp_se3(jnp.asarray([0.02, 0, 0.01 * i, 0.1, -0.05, 0.02], jnp.float32)))
        reading = (np.linalg.inv(T_gt)[None, :3, :3] @ ref[:, :, None])[:, :, 0] + np.linalg.inv(T_gt)[:3, 3]
        cases.append(evaluation.EvalCase(reading.astype(np.float32), ref, T_gt, np.eye(4), name=f"case{i}"))
    cfg = dataclasses.replace(BASE_CFG, matcher="grid", grid_table_size=1 << 13, grid_bucket_cap=48)
    results, summary = evaluation.evaluate(cases, cfg, reading_capacity=1024, reference_capacity=1024)
    assert summary["cases"] == 3
    assert summary["trans_err_p50_m"] < 5e-3, summary
    assert summary["converged_frac"] == 1.0
    out = tmp_path / "report.csv"
    evaluation.write_report(str(out), results, summary)
    text = out.read_text()
    assert "trans_err_p50_m" in text and "case0" in text


def test_manifest_roundtrip(rng, tmp_path):
    from open3d_slam_jax.io import save_ply

    ref = make_surface_cloud(rng, 500)
    read = ref + np.float32([0.05, 0, 0])
    p_ref, p_read = tmp_path / "ref.ply", tmp_path / "read.ply"
    save_ply(str(p_ref), ref)
    save_ply(str(p_read), read)
    gt = np.eye(4); gt[0, 3] = 0.05
    man = tmp_path / "manifest.csv"
    cols = ["reading", "reference"] + [f"gt_{i}{j}" for i in range(4) for j in range(4)]
    with open(man, "w") as f:
        f.write(",".join(cols) + "\n")
        f.write(",".join([str(p_read), str(p_ref)] + [str(v) for v in gt.flatten()]) + "\n")
    cases = evaluation.load_manifest(str(man))
    assert len(cases) == 1
    np.testing.assert_allclose(cases[0].T_gt, gt)
    assert cases[0].reading.shape == ref.shape


def test_viz_png_roundtrip(tmp_path, rng):
    """PNG writer emits decodable files; map+trajectory renders deterministic."""
    import struct as _struct
    import zlib as _zlib

    from open3d_slam_jax import viz

    pts = rng.uniform(-5, 5, size=(5000, 3)).astype(np.float32)
    pts[:, 2] = 0.2 * pts[:, 0]
    traj = np.stack([np.linspace(-4, 4, 20), np.zeros(20), np.zeros(20)], 1)
    out = str(tmp_path / "map.png")
    img = viz.render_topdown(pts, trajectory=traj, size=256, path=out)
    raw = open(out, "rb").read()
    assert raw.startswith(b"\x89PNG\r\n\x1a\n")
    # parse IHDR
    assert raw[12:16] == b"IHDR"
    w, h = _struct.unpack(">II", raw[16:24])
    assert (w, h) == (256, 256)
    # IDAT decompresses to h * (1 + w*3) filtered bytes
    idat_off = raw.index(b"IDAT") - 4
    (ilen,) = _struct.unpack(">I", raw[idat_off:idat_off + 4])
    body = raw[idat_off + 8 : idat_off + 8 + ilen]
    assert len(_zlib.decompress(body)) == h * (1 + w * 3)
    # trajectory drawn in red along the middle row band
    red = (img[:, :, 0] > 200) & (img[:, :, 1] < 100)
    assert red.sum() > 50
    img2 = viz.render_topdown(pts, trajectory=traj, size=256)
    np.testing.assert_array_equal(img, img2)


def test_viz_render_matches(tmp_path, rng):
    from open3d_slam_jax import viz

    src = rng.uniform(-1, 1, size=(300, 3))
    tgt = src + 0.1
    img = viz.render_matches(src, tgt, size=128, path=str(tmp_path / "m.png"))
    assert img.shape == (128, 128, 3)
    assert (img.sum(axis=2) > 0).sum() > 100


def test_read_report_and_render(tmp_path):
    # Round-trip write_report -> read_report, then the plotting analogue of
    # evaluations/jupyter/PlotSingleResults.ipynb renders a valid PNG.
    results = [
        evaluation.EvalResult(
            name=f"case{i}", trans_err_m=0.001 * (i + 1),
            rot_err_rad=0.0002 * i, iterations=8 + i, converged=i != 3,
            overlap=0.7 + 0.02 * i, wall_s=0.01 * (i + 1),
        )
        for i in range(5)
    ]
    csv_path = tmp_path / "report.csv"
    evaluation.write_report(str(csv_path), results, {"pair_cases": 5})
    rows, summary = evaluation.read_report(str(csv_path))
    assert len(rows) == 5
    assert rows[2]["trans_err_m"] == pytest.approx(0.003)
    assert rows[3]["converged"] is False
    assert summary["pair_cases"] == "5"

    png = tmp_path / "report.png"
    try:
        evaluation.render_report(str(csv_path), str(png))
    except ImportError:
        pytest.skip("matplotlib not installed")
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert png.stat().st_size > 5000


def test_read_report_tolerates_multi_protocol(tmp_path):
    # EVAL_r02.csv-style concatenated protocols: rows that don't match the
    # header land in summary, protocol-1 rows still parse.
    p = tmp_path / "multi.csv"
    p.write_text(
        '"# protocol 1",dev\n'
        "name,trans_err_m,rot_err_rad,iterations,converged,overlap,wall_s\n"
        "a,0.001,0.0001,5,True,0.8,0.5\n"
        "pair_cases,1\n"
        '"# protocol 2"\n'
        "frame,ate_trans_m,ate_rot_rad\n"
        "0,0.01,0.001\n"
    )
    rows, summary = evaluation.read_report(str(p))
    assert len(rows) == 1 and rows[0]["name"] == "a"
    assert summary["pair_cases"] == "1"


def test_protocol_presets_translate():
    """The embedded official protocols translate through the registry:
    Besl92 -> point-to-point trimmed 0.75 brute knn=1; Chen91 ->
    point-to-plane trimmed 0.7 with a surfel-decimated reference chain
    (evaluations/official_solutions/*.yaml semantics)."""
    cfg_b, rchain_b, refchain_b = evaluation.protocol_config("Besl92_pt2point")
    assert cfg_b.minimizer == "point_to_point"
    assert cfg_b.knn == 1
    assert cfg_b.matcher == "brute"  # unbounded KDTree -> exact brute
    assert cfg_b.trimmed_ratio == 0.75
    assert cfg_b.max_iterations == 150
    assert cfg_b.min_diff_rot == 0.001 and cfg_b.min_diff_trans == 0.01
    cfg_c, _, _ = evaluation.protocol_config("Chen91_pt2plane")
    assert cfg_c.minimizer == "point_to_plane"
    assert cfg_c.trimmed_ratio == 0.7
    with pytest.raises(KeyError):
        evaluation.protocol_config("nope")
    # CLI choices stay in sync with the preset table.
    assert set(evaluation.PROTOCOLS) == {"Besl92_pt2point", "Chen91_pt2plane"}


@pytest.mark.slow
def test_evaluate_with_protocol_chains(rng):
    """End-to-end: a Chen91 run over synthetic cases applies the filter
    chains (reference keeps surfel normals; reading randomly sampled) and
    recovers the pose."""
    import jax

    cases = []
    for i in range(2):
        ref = make_surface_cloud(rng, 3000)
        ref = ref * 3.0 + np.array([4.0, 0, 0], np.float32)  # past minDist 1.0
        T_gt = np.asarray(
            se3.exp_se3(jnp.asarray([0.01, 0, 0.01, 0.06, -0.03, 0.02], jnp.float32))
        )
        reading = (np.linalg.inv(T_gt)[None, :3, :3] @ ref[:, :, None])[:, :, 0] \
            + np.linalg.inv(T_gt)[:3, 3]
        cases.append(
            evaluation.EvalCase(
                reading.astype(np.float32), ref.astype(np.float32),
                T_gt, np.eye(4), name=f"c{i}",
            )
        )
    cfg, rchain, refchain = evaluation.protocol_config("Chen91_pt2plane")
    results, summary = evaluation.evaluate(
        cases, cfg, reading_capacity=4096, reference_capacity=4096,
        reading_filters=rchain, reference_filters=refchain,
        device_timing_reps=2,
    )
    assert summary["cases"] == 2
    assert summary["trans_err_p50_m"] < 0.05, summary
    assert "device" in summary and "device_p50_s" in summary
