"""open3d_slam_jax — a JAX scan-registration and
pose-trajectory-optimization engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
leggedrobotics/open3d_slam_private (libpointmatcher X-ICP + open3d_slam):

- ``geometry``: SE(3)/SO(3) math (exp/log, axis-angle, quaternions).
- ``ops``: batched point-cloud ops (filters, normals, KNN, grid hash).
- ``kernels``: hand-written Pallas kernels (GPU, Triton route).
- ``models``: registration engines (batched ICP / GICP, X-ICP
  localizability-aware solving, minimizers, checkers).
- ``slam``: odometry, mapper, submaps, loop closure, pose-graph GN.
- ``parallel``: mesh / shard_map scaling (point-sharded registration,
  multi-host pose-graph reduction).
- ``config``: typed config schemas + name->op registry (YAML-compatible
  with the reference's module vocabulary).
- ``io``: point-cloud and trajectory IO.

Everything on the compute path is fixed-shape, masked, jit/vmap-first.
"""

import jax as _jax

# Geometry code is numerics-sensitive: on the GPU an f32 matmul at default
# precision runs in TF32 (~3 decimal digits), which perturbs SE(3) point
# transforms enough to flip voxel-boundary cells and bias registrations.
# All matmuls in this library run at full f32 precision ("highest"); the
# hot paths (grid matching, linearization) are elementwise math and
# unaffected.
_jax.config.update("jax_default_matmul_precision", "highest")

from open3d_slam_jax.version import __version__

__all__ = ["__version__"]
