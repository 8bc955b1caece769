"""Device-mesh utilities.

The distributed backbone the reference lacks entirely (its only IPC is ROS
pub/sub + in-process queues, SURVEY 2.6): a named ``jax.sharding.Mesh`` with
two workload axes —

- ``"batch"``: data parallelism over registration problems (hypotheses,
  submap pairs, sessions) — the moral replacement of the reference's
  OpenMP-over-problems;
- ``"points"``: sharding of the point dimension of a single large problem,
  with 6x6 J^T J / J^T r blocks psum-reduced across devices (the TP/SP
  analogue).

The GPUs of one host are joined all to all (NVLink), so the mesh shape
follows the algorithm alone. Multi-host: initialize ``jax.distributed``
before calling, then the same mesh spans hosts.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    batch: Optional[int] = None,
    points: Optional[int] = None,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a ("batch", "points") mesh over the available devices.

    Defaults: all devices on the batch axis. Total device count must equal
    batch * points.
    """
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if batch is None and points is None:
        batch, points = n, 1
    elif batch is None:
        batch = n // points
    elif points is None:
        points = n // batch
    if batch * points != n:
        raise ValueError(f"mesh {batch}x{points} != {n} devices")
    arr = np.asarray(devices).reshape(batch, points)
    return Mesh(arr, axis_names=("batch", "points"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (problem) axis over "batch"."""
    return NamedSharding(mesh, P("batch"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
