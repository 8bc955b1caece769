"""Batched RANSAC rigid alignment on feature correspondences.

Batched device replacement for Open3D's
``RegistrationRANSACBasedOnFeatureMatching`` (used by the reference at
``PlaceRecognition.cpp:81-85``): instead of a sequential hypothesize-verify
loop, ALL hypotheses are drawn, solved (3-point weighted Kabsch) and scored
in one vmapped pass — the degenerate/weak hypotheses simply lose the argmax.

Flow:
  correspondences (feature KNN, see ops.fpfh.match_features)
  -> H random minimal samples (3 correspondences each)
  -> vmapped Kabsch -> [H, 4, 4]
  -> inlier count under ``inlier_dist`` on all correspondences
  -> best hypothesis (+ optional polish on its inliers).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from open3d_slam_jax.geometry import se3
from open3d_slam_jax.models.minimizers import point_to_point_transform


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    num_hypotheses: int = 512
    inlier_dist: float = 0.5
    min_inliers: int = 10
    # Mutual-best filtering and edge-length similarity check (Open3D's
    # correspondence checkers) are applied in score space.
    edge_similarity: float = 0.9


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RansacResult:
    transform: jax.Array  # [4, 4]
    inliers: jax.Array  # int32
    fitness: jax.Array  # inliers / valid correspondences
    ok: jax.Array  # bool


@functools.partial(jax.jit, static_argnames=("cfg",))
def ransac_align(
    src_xyz: jax.Array,  # [C, 3] correspondence source points
    tgt_xyz: jax.Array,  # [C, 3] matched target points
    corr_mask: jax.Array,  # [C]
    key: jax.Array,
    cfg: RansacConfig = RansacConfig(),
) -> RansacResult:
    """Estimate the rigid transform src -> tgt from putative correspondences."""
    C = src_xyz.shape[0]
    dtype = src_xyz.dtype
    n_valid = jnp.maximum(jnp.sum(corr_mask.astype(jnp.int32)), 1)

    # Draw [H, 3] indices FROM THE VALID correspondences (categorical over
    # the mask) — uniform over capacity would mostly hit padded slots.
    logits = jnp.where(corr_mask, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        key, logits[None, :], shape=(cfg.num_hypotheses, 3)
    )
    s = src_xyz[idx]  # [H, 3, 3]
    t = tgt_xyz[idx]
    w = corr_mask[idx].astype(dtype)  # [H, 3]

    # Edge-length similarity gate (scale consistency of the minimal sample).
    def edges(x):
        return jnp.stack(
            [
                jnp.linalg.norm(x[:, 0] - x[:, 1], axis=-1),
                jnp.linalg.norm(x[:, 1] - x[:, 2], axis=-1),
                jnp.linalg.norm(x[:, 0] - x[:, 2], axis=-1),
            ],
            axis=-1,
        )
    es, et = edges(s), edges(t)
    ratio = jnp.minimum(es, et) / jnp.maximum(jnp.maximum(es, et), 1e-9)
    sample_ok = jnp.all(ratio > cfg.edge_similarity, axis=-1) & (jnp.sum(w, -1) >= 3)

    Ts = jax.vmap(point_to_point_transform)(s, t, w)  # [H, 4, 4]

    # Score all hypotheses against all correspondences.
    moved = jnp.einsum("hij,cj->hci", Ts[:, :3, :3], src_xyz) + Ts[:, None, :3, 3]
    d2 = jnp.sum((moved - tgt_xyz[None]) ** 2, axis=-1)  # [H, C]
    inl = (d2 <= cfg.inlier_dist**2) & corr_mask[None, :]
    counts = jnp.sum(inl.astype(jnp.int32), axis=-1)
    counts = jnp.where(sample_ok, counts, -1)

    best = jnp.argmax(counts)
    best_T = Ts[best]
    best_inl = inl[best]
    best_count = counts[best]

    # Polish: weighted Kabsch on the winning inlier set.
    polish_T = point_to_point_transform(src_xyz, tgt_xyz, best_inl.astype(dtype))
    ok = best_count >= cfg.min_inliers
    T_out = jnp.where(ok, polish_T, jnp.eye(4, dtype=dtype))
    return RansacResult(
        transform=T_out,
        inliers=best_count,
        fitness=best_count.astype(dtype) / n_valid.astype(dtype),
        ok=ok,
    )
