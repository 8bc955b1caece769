"""``chip_smoke.py`` on the CPU: the device gate refuses to run, and every
phase runs end to end at tiny sizes (its numbers mean nothing here; the
card run at full width is ``python chip_smoke.py`` on the GPU)."""

import dataclasses
import os
import subprocess
import sys

import pytest

import bench
import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        capture_output=True, text=True, timeout=300, env=env, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def _tiny_rt_cfg():
    cfg = bench.pipeline_cfg_64k(smoke=True)
    return dataclasses.replace(
        cfg,
        loop_closure_enabled=False,
        dense_map_capacity=1 << 14,
        odometry=dataclasses.replace(
            cfg.odometry, max_points=2048,
            icp=dataclasses.replace(cfg.odometry.icp, grid_table_size=1 << 11)),
        mapper=dataclasses.replace(
            cfg.mapper, scan_capacity=2048, submap_capacity=1 << 14,
            ref_capacity=8192,
            icp=dataclasses.replace(cfg.mapper.icp, grid_table_size=1 << 12)),
        submaps=dataclasses.replace(cfg.submaps, submap_capacity=1 << 14),
    )


PHASES = {
    "xicp": lambda: cs.phase_xicp(
        0, n_read=4096, map_cap=65536, batch=2, scene_points=40_000, reps=1),
    "realtime": lambda: cs.phase_realtime(
        0, n_pts=2048, n_frames=12, scene_points=20_000, cfg=_tiny_rt_cfg(),
        min_closures=0),
    "pose_graph": lambda: cs.phase_pose_graph(0, n_small=32, n_big=64, e_big=256),
    "mesh": lambda: cs.phase_mesh(
        0, n_read=4096, map_cap=65536, scene_points=40_000,
        n_small=32, n_big=64, e_big=256),
}


@pytest.mark.parametrize("phase", sorted(PHASES))
def test_phase_runs_tiny(phase):
    fields = PHASES[phase]()
    assert fields["checks"] and all(fields["checks"].values())
