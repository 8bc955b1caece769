"""Pallas kernel (Triton route): fused pair-cached GN linearisation.

One streaming pass over the cached correspondences of a pair-cached ICP
round (``models/icp.py round_body``): transform the reading points by the
current pose, compute pair distances, apply the round-frozen TrimmedDist
threshold, and reduce the point-to-plane normal equations — A's upper
triangle (21), b (6) and the convergence statistics — without writing any
per-pair intermediate to device memory.

Layout: pairs flattened to ``[P]`` (``P = N * K``) structure-of-arrays
columns, padded to a multiple of the block. Each Triton block reduces
``block`` pairs into its own row of a ``[n_blocks, 32]`` partial-sum table;
XLA sums the table. Blocks carry nothing between each other, so they run
in any order on any SM.

Reference semantics: PointToPlane.cpp normal equations on TrimmedDist
weights (the sums of ``minimizers.point_to_plane_normal_equations_bc``;
block-local f32 accumulation, so agreement is to f32 summation order).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

_N_A = 21  # upper triangle of the 6x6
_N_B = 6
_SLOT_SUMW = 27
_SLOT_SUMWR2 = 28
_SLOT_NOK = 29  # pairs passing validity + radius (overlap numerator)
_N_SLOTS = 32  # partial-sum row width (power of two for Triton)
_N_COLS = 10  # qx qy qz nx ny nz valid rx ry rz


def _kernel(p_ref, qx, qy, qz, nx, ny, nz, vv, rx, ry, rz, out_ref):
    t = [p_ref[i] for i in range(14)]
    x, y, z = rx[...], ry[...], rz[...]
    sx = t[0] * x + t[1] * y + t[2] * z + t[3]
    sy = t[4] * x + t[5] * y + t[6] * z + t[7]
    sz = t[8] * x + t[9] * y + t[10] * z + t[11]
    tau, max_d2 = t[12], t[13]

    nxv, nyv, nzv = nx[...], ny[...], nz[...]
    dx = sx - qx[...]
    dy = sy - qy[...]
    dz = sz - qz[...]
    d2 = dx * dx + dy * dy + dz * dz
    ok = (vv[...] > 0.0) & (d2 <= max_d2)
    w = jnp.where(ok & (d2 <= tau), 1.0, 0.0)

    r = dx * nxv + dy * nyv + dz * nzv
    # J = [s x n ; n]
    cols = (
        sy * nzv - sz * nyv,
        sz * nxv - sx * nzv,
        sx * nyv - sy * nxv,
        nxv, nyv, nzv,
    )
    vals = []
    for a in range(6):
        wa = w * cols[a]
        for b in range(a, 6):
            vals.append(jnp.sum(wa * cols[b]))
    for a in range(6):
        vals.append(-jnp.sum(w * cols[a] * r))
    vals.append(jnp.sum(w))
    vals.append(jnp.sum(w * r * r))
    vals.append(jnp.sum(ok.astype(jnp.float32)))
    slot = jax.lax.broadcasted_iota(jnp.int32, (_N_SLOTS,), 0)
    row = jnp.zeros((_N_SLOTS,), jnp.float32)
    for s, v in enumerate(vals):
        row = jnp.where(slot == s, v, row)
    out_ref[...] = row


def prepare_pairs(reading_xyz, pair_xyz, pair_normals, pair_valid, block=2048):
    """Once-per-round prep: ``[N, K, *]`` pairs + ``[N, 3]`` reading ->
    ten ``[P_pad]`` f32 columns (the reading repeated per pair slot)."""
    n, k, _ = pair_xyz.shape
    p = n * k
    pad = (-p) % block
    rd = jnp.broadcast_to(reading_xyz[:, None, :], (n, k, 3)).reshape(p, 3)
    q = pair_xyz.reshape(p, 3)
    nm = pair_normals.reshape(p, 3)
    v = pair_valid.reshape(p).astype(jnp.float32)
    cols = [q[:, 0], q[:, 1], q[:, 2], nm[:, 0], nm[:, 1], nm[:, 2], v,
            rd[:, 0], rd[:, 1], rd[:, 2]]
    return tuple(jnp.pad(c.astype(jnp.float32), (0, pad)) for c in cols)


@functools.partial(jax.jit, static_argnames=("block", "num_warps", "interpret"))
def pair_gn_step(soa, T, trim_limit, max_d2, block: int = 2048,
                 num_warps: int = 4, interpret: bool = False):
    """One fused GN linearisation over prepared pairs.

    Returns ``(A [6,6], b [6], sum_w, sum_wr2, n_radius_ok)`` with weights
    ``valid & d2 <= max_d2 & d2 <= trim_limit``. ``interpret`` runs the
    Pallas interpreter (the CPU tests set it); on the GPU the kernel is
    compiled through Triton."""
    p_pad = soa[0].shape[0]
    if p_pad % block:
        raise ValueError(f"pair count {p_pad} is not a multiple of block {block}")
    n_blocks = p_pad // block
    params = jnp.zeros((16,), jnp.float32)
    params = params.at[:12].set(T[:3, :].reshape(-1).astype(jnp.float32))
    params = params.at[12].set(jnp.asarray(trim_limit, jnp.float32))
    params = params.at[13].set(jnp.asarray(max_d2, jnp.float32))

    col_spec = pl.BlockSpec((block,), lambda i: (i,))
    out = pl.pallas_call(
        _kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec((16,), lambda i: (0,))] + [col_spec] * _N_COLS,
        out_specs=pl.BlockSpec((_N_SLOTS,), lambda i: (i,)),
        out_shape=jax.ShapeDtypeStruct((n_blocks * _N_SLOTS,), jnp.float32),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=num_warps, num_stages=1),
        interpret=interpret,
        name="pair_gn",
    )(params, *soa)

    flat = jnp.sum(out.reshape(n_blocks, _N_SLOTS), axis=0)
    iu = [(a, b) for a in range(6) for b in range(a, 6)]
    A = jnp.zeros((6, 6), jnp.float32)
    for s, (a, b) in enumerate(iu):
        A = A.at[a, b].set(flat[s]).at[b, a].set(flat[s])
    b_vec = flat[_N_A:_N_A + _N_B]
    return A, b_vec, flat[_SLOT_SUMW], flat[_SLOT_SUMWR2], flat[_SLOT_NOK]


def pair_gn_fused(reading_xyz, pair_xyz, pair_normals, pair_valid, T,
                  trim_limit, max_d2, block: int = 2048):
    """One-shot convenience wrapper: prep + one step (checks / ad-hoc use)."""
    soa = prepare_pairs(reading_xyz, pair_xyz, pair_normals, pair_valid, block=block)
    return pair_gn_step(soa, T, trim_limit, max_d2, block=block)
