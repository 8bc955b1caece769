"""PointBatch — the fixed-shape, masked point-cloud container.

Fixed-shape analogue of libpointmatcher's ``DataPoints`` (labeled Eigen
matrices, ``PointMatcher.h:222-405``): instead of a dynamic 4xN homogeneous
feature matrix plus named descriptor rows, a ``PointBatch`` is a pytree of
padded ``[..., N, d]`` arrays with a validity ``mask``. All ops preserve the
static shape; "removing" points means clearing their mask bit, and compaction
(when a smaller capacity is wanted) is an explicit masked top-k move.

Named descriptor channels (normals, colors, times, eigenvalues, ...) live in
``extras`` keyed by name, mirroring ``getDescriptorViewByName``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import jax
import jax.numpy as jnp

# Large finite coordinate for padded slots: keeps padded points out of every
# radius/voxel/KNN query without introducing NaN/inf into reductions.
PAD_COORD = 1.0e9


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Padded point cloud(s): ``xyz [..., N, 3]``, ``mask [..., N]`` bool.

    ``extras`` maps channel name -> ``[..., N, d]`` array. Normals are stored
    under ``"normals"`` to match the reference's descriptor name.

    ``index_grid`` (optional): the organized-cloud 2-D index grid
    (≙ ``DataPoints::indexGrid``, ``PointMatcher.h:222-405``): an
    ``[..., H, W]`` int32 array of linear indices into the point axis, -1
    for empty cells. Validity of a cell = ``mask[index_grid[h, w]]`` (like
    the reference, where removed points leave dangling grid cells that the
    organized consumers skip). Masking preserves the grid; :func:`compact`
    remaps it.
    """

    xyz: jax.Array
    mask: jax.Array
    extras: Dict[str, jax.Array] = dataclasses.field(default_factory=dict)
    index_grid: Optional[jax.Array] = None

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    @property
    def is_organized(self) -> bool:
        """≙ ``DataPoints::isOrganized()``."""
        return self.index_grid is not None

    @property
    def batch_shape(self):
        return self.xyz.shape[:-2]

    def count(self) -> jax.Array:
        """Number of valid points, ``[...]`` int32."""
        return jnp.sum(self.mask.astype(jnp.int32), axis=-1)

    @property
    def normals(self) -> Optional[jax.Array]:
        return self.extras.get("normals")

    def with_extras(self, **channels: jax.Array) -> "PointBatch":
        extras = dict(self.extras)
        extras.update(channels)
        return dataclasses.replace(self, extras=extras)

    def without_extra(self, name: str) -> "PointBatch":
        extras = {k: v for k, v in self.extras.items() if k != name}
        return dataclasses.replace(self, extras=extras)

    def with_mask(self, mask: jax.Array) -> "PointBatch":
        """Intersect validity with ``mask`` (does not touch xyz)."""
        return dataclasses.replace(self, mask=self.mask & mask)

    def padded_xyz(self) -> jax.Array:
        """xyz with padded slots pushed to PAD_COORD (far from any query)."""
        return jnp.where(self.mask[..., None], self.xyz, PAD_COORD)

    def transformed(self, T: jax.Array) -> "PointBatch":
        """Apply ``[..., 4, 4]`` rigid transform; rotates ``normals`` too —
        the analogue of ``RigidTransformation::compute`` which transforms
        features and rotates the normals descriptor
        (``TransformationsImpl.cpp``)."""
        from open3d_slam_jax.geometry import se3

        xyz = se3.apply_transform(T, self.xyz)
        extras = dict(self.extras)
        if "normals" in extras:
            extras["normals"] = se3.apply_rotation(T, extras["normals"])
        return dataclasses.replace(self, xyz=xyz, extras=extras)


def from_points(
    points,
    capacity: Optional[int] = None,
    extras: Optional[Dict[str, jax.Array]] = None,
    dtype=jnp.float32,
) -> PointBatch:
    """Build a single (unbatched) PointBatch from an ``[n, 3]`` array,
    padding (or truncating) to ``capacity``."""
    points = jnp.asarray(points, dtype=dtype)
    n = points.shape[0]
    if capacity is None:
        capacity = n
    extras = dict(extras or {})
    if n >= capacity:
        xyz = points[:capacity]
        mask = jnp.ones((capacity,), dtype=bool)
        extras = {k: jnp.asarray(v, dtype=dtype)[:capacity] for k, v in extras.items()}
    else:
        pad = capacity - n
        xyz = jnp.concatenate([points, jnp.full((pad, 3), PAD_COORD, dtype=dtype)], axis=0)
        mask = jnp.concatenate([jnp.ones((n,), bool), jnp.zeros((pad,), bool)], axis=0)
        extras = {
            k: jnp.concatenate(
                [jnp.asarray(v, dtype=dtype), jnp.zeros((pad,) + jnp.asarray(v).shape[1:], dtype=dtype)],
                axis=0,
            )
            for k, v in extras.items()
        }
    return PointBatch(xyz=xyz, mask=mask, extras=extras)


def from_organized(
    points,
    extras: Optional[Dict[str, jax.Array]] = None,
    dtype=jnp.float32,
) -> PointBatch:
    """Build an ORGANIZED PointBatch from an ``[H, W, 3]`` range image
    (≙ constructing a ``DataPoints`` with an ``indexGrid``). Non-finite
    pixels become invalid points; the grid keeps their cells at -1."""
    img = jnp.asarray(points, dtype=dtype)
    h, w = img.shape[0], img.shape[1]
    flat = img.reshape(h * w, 3)
    finite = jnp.all(jnp.isfinite(flat), axis=-1)
    xyz = jnp.where(finite[:, None], flat, PAD_COORD)
    idx = jnp.arange(h * w, dtype=jnp.int32)
    grid = jnp.where(finite, idx, -1).reshape(h, w)
    flat_extras = {
        k: jnp.asarray(v, dtype=dtype).reshape(h * w, -1)
        for k, v in (extras or {}).items()
    }
    return PointBatch(xyz=xyz, mask=finite, extras=flat_extras, index_grid=grid)


def organized_view(batch: PointBatch):
    """``(xyz_image [H, W, 3], valid [H, W])`` of an organized batch —
    the consumer-side of the index grid (what
    ``OrganizedCloudSurfaceNormal`` walks in the reference). Cells that are
    empty or whose point was mask-removed are invalid."""
    if batch.index_grid is None:
        raise ValueError("organized_view: batch carries no index_grid")
    g = batch.index_grid
    safe = jnp.maximum(g, 0)
    xyz = batch.xyz[safe]
    valid = (g >= 0) & batch.mask[safe]
    return jnp.where(valid[..., None], xyz, PAD_COORD), valid


def stack(batches) -> PointBatch:
    """Stack same-capacity PointBatches along a new leading batch axis."""
    return jax.tree.map(lambda *xs: jnp.stack(xs, axis=0), *batches)


def compact(batch: PointBatch, capacity: int) -> PointBatch:
    """Move valid points to the front and resize to ``capacity``.

    The replacement for dynamic-shape point removal: after heavy mask-based
    filtering, compaction reclaims padding so downstream fixed-cost ops run on
    a smaller static N. Stable order (valid points keep relative order).
    """
    n = batch.capacity
    # Stable partition: sort key = (invalid, original index).
    key = jnp.where(batch.mask, 0, 1) * (n + 1) + jnp.arange(n)
    order = jnp.argsort(key, axis=-1)
    xyz = jnp.take_along_axis(batch.xyz, order[..., :capacity, None], axis=-2)
    mask = jnp.take_along_axis(batch.mask, order[..., :capacity], axis=-1)
    extras = {
        k: jnp.take_along_axis(v, order[..., :capacity, None], axis=-2)
        for k, v in batch.extras.items()
    }
    xyz = jnp.where(mask[..., None], xyz, PAD_COORD)
    index_grid = None
    if batch.index_grid is not None and batch.xyz.ndim == 2:
        # Remap the organized grid through the permutation: cells whose
        # point was moved keep pointing at it; cells whose point fell off
        # the new capacity (or was invalid) go empty (-1).
        inv = jnp.full((n,), -1, jnp.int32)
        inv = inv.at[order[:capacity]].set(
            jnp.where(mask, jnp.arange(capacity, dtype=jnp.int32), -1)
        )
        g = batch.index_grid
        index_grid = jnp.where(g >= 0, inv[jnp.maximum(g, 0)], -1)
    return PointBatch(xyz=xyz, mask=mask, extras=extras, index_grid=index_grid)


# ---------------------------------------------------------------------------
# Masked reductions shared across the stack.
# ---------------------------------------------------------------------------


def masked_mean(values: jax.Array, mask: jax.Array, axis=-1, keepdims=False) -> jax.Array:
    """Mean over mask==True; zero where the mask is empty."""
    m = mask.astype(values.dtype)
    s = jnp.sum(values * m, axis=axis, keepdims=keepdims)
    c = jnp.sum(m, axis=axis, keepdims=keepdims)
    return s / jnp.maximum(c, 1.0)


def masked_centroid(batch: PointBatch) -> jax.Array:
    """``[..., 3]`` centroid of valid points (the reference's mean-centering
    input, ``ICP.cpp:881-891``)."""
    return masked_mean(batch.xyz, batch.mask[..., None], axis=-2)


def masked_quantile(values: jax.Array, mask: jax.Array, q, axis: int = -1) -> jax.Array:
    """Reference-compatible quantile over the masked entries.

    Matches ``Matches::getDistsQuantile`` (``Matches.cpp``): the result is the
    element at (floor-)index ``count * q`` of the ascending valid values (an
    ``nth_element`` pick, not an interpolated quantile); ``q == 1`` returns the
    max. Invalid slots are ignored.
    """
    big = jnp.asarray(jnp.finfo(values.dtype).max, dtype=values.dtype)
    vals = jnp.where(mask, values, big)
    svals = jnp.sort(vals, axis=axis)
    count = jnp.sum(mask.astype(jnp.int32), axis=axis)
    n = values.shape[axis]
    idx = jnp.minimum((count.astype(jnp.float32) * q).astype(jnp.int32), jnp.maximum(count - 1, 0))
    idx = jnp.clip(idx, 0, n - 1)
    picked = jnp.take_along_axis(svals, jnp.expand_dims(idx, axis), axis=axis)
    return jnp.squeeze(picked, axis=axis)
