"""Guard: the package holds no accelerator-specific code paths of the
machine it was first written for, and every Pallas kernel names its GPU
route and runs compiled outside tests."""

import pathlib
import re

PKG = pathlib.Path(__file__).resolve().parent.parent / "open3d_slam_jax"
_OLD = "t" + "pu"  # spelled apart so this file does not match itself


def test_no_foreign_backend_code():
    banned = [
        f"pallas.{_OLD}", f"pl{_OLD}", f"lib{_OLD}", f'"{_OLD}"', f"'{_OLD}'",
        "O3S_FUSED_" + "INTERPRET", "relay_" + "roundtrip",
    ]
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        src = path.read_text()
        offenders += [(path.name, b) for b in banned if b in src]
        calls = len(re.findall(r"\bpallas_call\(", src))
        routes = len(re.findall(r'backend="(triton|mosaic_gpu)"', src))
        if calls != routes:
            offenders.append((path.name, "pallas_call without a GPU route"))
        if "interpret=True" in src:
            offenders.append((path.name, "interpret mode outside tests"))
    assert not offenders, offenders
