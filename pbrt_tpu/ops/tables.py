"""Small-table reads (shared by builder, lights, sampling).

Three regimes by table size: a fused where-chain for tiny tables (a
Cornell box: 14 rows), a one-hot matmul at HIGHEST precision for small
ones, and a real gather for large ones.  The thresholds were chosen on
the previous accelerator; whether the GPU needs anything but the gather
is an open measurement (PERF.md).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

WHERE_CHAIN_MAX_ROWS = 48
ONE_HOT_MAX_ROWS = 1024


def select_rows(cols, idx):
    """Row-select ``cols[idx]`` ([T, C], [N] -> [N, C]).

    Tiny tables: fused where-chain (exact, no padded matmul).
    Small tables: one-hot x matmul (HIGHEST precision — f32-accurate).
    Large tables: real gather (the BVH regime, where prim ids are
    already sorted/coherent).
    """
    t = cols.shape[0]
    if t <= WHERE_CHAIN_MAX_ROWS:
        out = jnp.broadcast_to(cols[0][None, :], (idx.shape[0], cols.shape[1]))
        for k in range(1, t):
            out = jnp.where((idx == k)[:, None], cols[k][None, :], out)
        return out
    if t <= ONE_HOT_MAX_ROWS and cols.dtype == jnp.float32:
        oh = (
            idx[:, None] == jnp.arange(t, dtype=idx.dtype)[None, :]
        ).astype(cols.dtype)
        return jax.lax.dot(oh, cols, precision=jax.lax.Precision.HIGHEST)
    return cols[idx]


def select_values(vals, idx):
    """1-D variant: ``vals[idx]`` ([T], [N] -> [N]) via where-chain /
    one-hot, same thresholds as :func:`select_rows`."""
    t = vals.shape[0]
    if t <= WHERE_CHAIN_MAX_ROWS:
        out = jnp.broadcast_to(vals[0], idx.shape)
        for k in range(1, t):
            out = jnp.where(idx == k, vals[k], out)
        return out
    if t <= ONE_HOT_MAX_ROWS and vals.dtype == jnp.float32:
        oh = (
            idx[:, None] == jnp.arange(t, dtype=idx.dtype)[None, :]
        ).astype(vals.dtype)
        return jax.lax.dot(oh, vals[:, None],
                           precision=jax.lax.Precision.HIGHEST)[:, 0]
    return vals[idx]
