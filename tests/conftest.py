"""Test harness: run everything on a virtual 8-device CPU mesh.

The tests validate numerics and sharding on the CPU: JAX is held to the CPU
backend with ``xla_force_host_platform_device_count=8`` (set here, before
anything imports JAX), so multi-device code paths (shard_map/psum over a
Mesh) execute without GPUs. The hand-written Pallas kernels have no CPU
lowering, so the tests run them in the Pallas interpreter. Speed is
measured on the GPU by ``chip_smoke.py`` and ``bench.py``, never here.
"""

import functools
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    from open3d_slam_jax.kernels import pair_gn_pallas as pgk

    monkeypatch.setattr(
        pgk, "pair_gn_step", functools.partial(pgk.pair_gn_step, interpret=True)
    )
