"""Restricted-Lua parameter loader tests (≙ LuaLoader.cpp +
lua_parameter_dictionary/test/test_lua.cpp coverage)."""

import glob
import os
import textwrap

import pytest

from open3d_slam_jax.config import slam_config_from_lua
from open3d_slam_jax.config.lua import LuaError, load_lua, loads_lua

REF_PARAM = "/root/reference/open3d_slam_rsl/ros/open3d_slam_ros/param"
SHIPPED = sorted(glob.glob(os.path.join(REF_PARAM, "param_*.lua")))


# ---------------------------------------------------------------------------
# Language-subset semantics.
# ---------------------------------------------------------------------------


def test_tables_and_scalars():
    t = loads_lua(
        textwrap.dedent(
            """
            -- a comment
            A = {
              x = 1, y = -2.5, s = "hi", b = true, nb = false, -- inline
              nested = { deep = { v = 3 } },
            }
            """
        )
    )
    assert t["A"]["x"] == 1 and t["A"]["y"] == -2.5
    assert t["A"]["s"] == "hi" and t["A"]["b"] is True and t["A"]["nb"] is False
    assert t["A"]["nested"]["deep"]["v"] == 3


def test_deepcopy_vs_alias():
    src = """
    BASE = { v = 1 }
    copied = deepcopy(BASE)
    aliased = BASE
    copied.v = 2
    aliased.v = 3
    """
    t = loads_lua(src)
    # Lua reference semantics: alias shares, deepcopy does not.
    assert t["BASE"]["v"] == 3
    assert t["copied"]["v"] == 2


def test_dotted_assignment_and_return():
    src = """
    params = { a = { b = { c = 1 } } }
    params.a.b.c = 42
    return params
    """
    assert loads_lua(src)["a"]["b"]["c"] == 42


def test_function_definitions_skipped():
    src = """
    function deepcopy(orig, copies)
        copies = copies or {}
        if type(orig) == 'table' then
            for k, v in next, orig, nil do end
        end
        return orig
    end
    X = { v = deepcopy({ w = 7 }) }
    """
    assert loads_lua(src)["X"]["v"]["w"] == 7


def test_include(tmp_path):
    (tmp_path / "base.lua").write_text("BASE = { v = 10 }\n")
    main = tmp_path / "main.lua"
    main.write_text('include "base.lua"\nparams = deepcopy(BASE)\nreturn params\n')
    assert load_lua(str(main))["v"] == 10


def test_unknown_construct_raises():
    with pytest.raises(LuaError):
        loads_lua("x = 1 + 2\n")  # arithmetic is outside the subset
    with pytest.raises(LuaError):
        loads_lua("params.a = 1\n")  # assignment into undefined table


# ---------------------------------------------------------------------------
# The reference's shipped parameter files.
# ---------------------------------------------------------------------------


@pytest.mark.skipif(not SHIPPED, reason="reference params not mounted")
@pytest.mark.parametrize("path", SHIPPED, ids=[os.path.basename(p) for p in SHIPPED])
def test_shipped_param_files_load(path):
    tree = load_lua(path)
    # Every production tree carries the full section set.
    for key in ("odometry", "mapper_localizer", "submap", "map_builder",
                "place_recognition", "motion_compensation"):
        assert key in tree, key
    cfg = slam_config_from_lua(path)
    assert cfg.mapper.icp.max_iterations > 0
    assert cfg.submaps.creation_radius > 0


@pytest.mark.skipif(not SHIPPED, reason="reference params not mounted")
def test_robosense_values_carry_over():
    """Spot-check known values from param_robosense_rs16.lua end to end."""
    cfg = slam_config_from_lua(os.path.join(REF_PARAM, "param_robosense_rs16.lua"))
    assert cfg.motion_compensation.enabled is True  # is_undistort_scan = true
    assert cfg.mapper.icp.max_match_dist == pytest.approx(0.8)
    assert cfg.submaps.creation_radius == pytest.approx(20.0)
    assert cfg.odometry.voxel_size == pytest.approx(0.05)
    assert cfg.mapper.scan_voxel_size == pytest.approx(0.08)
    assert cfg.build_dense_map is False

    # A config loaded from lua constructs a working pipeline.
    from open3d_slam_jax.slam.pipeline import SlamPipeline

    pipe = SlamPipeline(cfg)
    assert pipe.cfg.motion_compensation.scan_duration == pytest.approx(0.1)
