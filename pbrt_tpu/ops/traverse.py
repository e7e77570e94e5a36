"""Skip-link BVH traversal: the plain XLA walk and the GPU kernel.

The tree comes from ``accel.bvh.build_bvh``: nodes in depth-first order,
node ``i``'s first child is ``i + 1`` and its *skip link* is the first
node after its subtree.  A walk needs no stack: descend on a box hit,
follow the skip link on a miss or after a leaf.  Each ray carries only
(node, best_t, best_prim, b0, b1) and finishes on its own, or at its
first hit for an any-hit (shadow) query.

Two implementations of the same walk, chosen by platform name:

* :func:`walk_xla` — one ``lax.while_loop`` over the whole wavefront.
  It is the CPU path and the reference the kernel is tested against.
* :func:`walk_gpu` — a Pallas kernel through Triton: one launch, lanes
  are threads, the node and triangle tables stay in device memory and
  are read through L2 by per-lane gathers.  Each block of rays loops
  until its own slowest lane is done, so one slow ray holds back only
  its block, not the wavefront.

Lanes whose ``t_max <= RAY_EPS`` cannot hit anything (every hit needs
``RAY_EPS < t < best_t``), so the kernel parks them before the first
step; padded lanes use the same rule.

Tables (:class:`BVHTables`):
  box  [M, 8] f32  min xyz, max xyz, 2 pad (one 32-byte row per node)
  link [M, 4] i32  skip, first, count (0 = interior), pad
  tris [T, 9] f32  p0 p1 p2 per triangle, in leaf order
  n_nodes [1] i32  the walk ends at node >= n_nodes (padded shard trees)

Results are (t, prim, b0, b1): ``prim`` is the leaf-order slot, -1 on a
miss, where ``t`` stays ``t_max``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu.ops.intersect import RAY_EPS

#: rays per Triton program, one warp per 32 lanes.  On an H100 32 beat 64
#: and 128 at 50k and 1M triangles (PERF.md): a smaller block waits less
#: on its slowest lane.
GPU_BLOCK = 32


class BVHTables(NamedTuple):
    box: jax.Array
    link: jax.Array
    tris: jax.Array
    n_nodes: jax.Array


def pack_nodes(mins, maxs, skips, firsts, counts):
    """Node arrays from ``build_bvh`` -> numpy (box [M, 8], link [M, 4])."""
    m = len(mins)
    box = np.zeros((m, 8), np.float32)
    box[:, 0:3] = mins
    box[:, 3:6] = maxs
    link = np.zeros((m, 4), np.int32)
    link[:, 0] = skips
    link[:, 1] = firsts
    link[:, 2] = counts
    return box, link


def pack_tables(mins, maxs, skips, firsts, counts, p0, p1, p2):
    """Host arrays from ``build_bvh`` (triangles already in leaf order)
    -> numpy :class:`BVHTables`."""
    tris = np.concatenate(
        [np.asarray(p0), np.asarray(p1), np.asarray(p2)], axis=-1
    ).astype(np.float32)
    return BVHTables(*pack_nodes(mins, maxs, skips, firsts, counts), tris,
                     np.asarray([len(mins)], np.int32))


def _safe_inv(v):
    sign = jnp.where(v < 0.0, -1.0, 1.0)
    return jnp.clip(sign / jnp.maximum(jnp.abs(v), 1e-20), -1e30, 1e30)


def _slab(bmin, bmax, o, inv):
    """Ray/box slab test per axis lists -> (t_near, t_far)."""
    t0 = [(bmin[c] - o[c]) * inv[c] for c in range(3)]
    t1 = [(bmax[c] - o[c]) * inv[c] for c in range(3)]
    t_near = jnp.maximum(
        jnp.maximum(jnp.minimum(t0[0], t1[0]), jnp.minimum(t0[1], t1[1])),
        jnp.minimum(t0[2], t1[2]),
    )
    t_far = jnp.minimum(
        jnp.minimum(jnp.maximum(t0[0], t1[0]), jnp.maximum(t0[1], t1[1])),
        jnp.maximum(t0[2], t1[2]),
    )
    return t_near, t_far


def _moller(o, d, a, b, c):
    """Moller-Trumbore on per-axis lists -> (ok, t, b0, b1); ``ok`` omits
    the ``t < best_t`` test."""
    e1 = [b[k] - a[k] for k in range(3)]
    e2 = [c[k] - a[k] for k in range(3)]
    pv = [
        d[1] * e2[2] - d[2] * e2[1],
        d[2] * e2[0] - d[0] * e2[2],
        d[0] * e2[1] - d[1] * e2[0],
    ]
    det = e1[0] * pv[0] + e1[1] * pv[1] + e1[2] * pv[2]
    inv_det = jnp.where(
        jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0
    )
    tv = [o[k] - a[k] for k in range(3)]
    b0 = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv_det
    qv = [
        tv[1] * e1[2] - tv[2] * e1[1],
        tv[2] * e1[0] - tv[0] * e1[2],
        tv[0] * e1[1] - tv[1] * e1[0],
    ]
    b1 = (d[0] * qv[0] + d[1] * qv[1] + d[2] * qv[2]) * inv_det
    tt = (e2[0] * qv[0] + e2[1] * qv[1] + e2[2] * qv[2]) * inv_det
    ok = (
        (jnp.abs(det) > 1e-12)
        & (b0 >= 0.0)
        & (b1 >= 0.0)
        & (b0 + b1 <= 1.0)
        & (tt > RAY_EPS)
    )
    return ok, tt, b0, b1


def _step(load_box, load_link, load_tri, load_id, o, d, inv, st, *,
          n_nodes, leaf_size, any_hit):
    """One node visit for every lane: the body shared by both walks.

    ``load_*(index, column, mask)`` read one table column at per-lane
    indices; ``load_id`` is None without a tie-break id table.
    """
    node, bt, bp, bg, b0c, b1c = st
    active = node < n_nodes
    ni = jnp.where(active, node, 0)
    bmin = [load_box(ni, c, active) for c in range(3)]
    bmax = [load_box(ni, 3 + c, active) for c in range(3)]
    t_near, t_far = _slab(bmin, bmax, o, inv)
    box_hit = active & (t_near <= t_far) & (t_far > RAY_EPS) & (t_near < bt)
    skip = load_link(ni, 0, active)
    first = load_link(ni, 1, box_hit)
    count = load_link(ni, 2, box_hit)
    is_leaf = count > 0
    for k in range(leaf_size):
        valid = box_hit & is_leaf & (k < count)
        pid = jnp.where(valid, first + k, 0)
        a = [load_tri(pid, c, valid) for c in range(3)]
        b = [load_tri(pid, 3 + c, valid) for c in range(3)]
        c_ = [load_tri(pid, 6 + c, valid) for c in range(3)]
        ok, tt, b0, b1 = _moller(o, d, a, b, c_)
        if load_id is None:
            better = tt < bt
        else:
            g = load_id(pid, valid)
            better = (tt < bt) | ((tt == bt) & (g < bg))
            bg = jnp.where(valid & ok & better, g, bg)
        hit = valid & ok & better
        bp = jnp.where(hit, pid, bp)
        b0c = jnp.where(hit, b0, b0c)
        b1c = jnp.where(hit, b1, b1c)
        bt = jnp.where(hit, tt, bt)
    nxt = jnp.where(box_hit & ~is_leaf, ni + 1, skip)
    nxt = jnp.where(active, nxt, n_nodes)
    if any_hit:
        nxt = jnp.where(bp >= 0, n_nodes, nxt)
    return nxt, bt, bp, bg, b0c, b1c


_NO_ID = 2**30


def walk_xla(tables: BVHTables, o, d, t_max, *, any_hit: bool,
             leaf_size: int, tie_ids=None):
    """The plain walk: one ``lax.while_loop`` over the whole wavefront.

    ``tie_ids`` [T] i32 breaks exact-``t`` ties toward the lower id (the
    geometry-sharded path needs shard-count-invariant winners); without
    it the first triangle found keeps the tie.
    """
    n = o.shape[0]
    nn = tables.n_nodes[0]
    oc = [o[:, c] for c in range(3)]
    dc = [d[:, c] for c in range(3)]
    inv = [_safe_inv(v) for v in dc]
    n_tri = tables.tris.shape[0]

    def load_box(i, c, mask):
        return tables.box[i, c]

    def load_link(i, c, mask):
        return tables.link[i, c]

    def load_tri(i, c, mask):
        return tables.tris[jnp.minimum(i, n_tri - 1), c]

    load_id = None
    if tie_ids is not None:
        def load_id(i, mask):
            return tie_ids[jnp.minimum(i, n_tri - 1)]

    def body(st):
        return _step(load_box, load_link, load_tri, load_id, oc, dc, inv,
                     st, n_nodes=nn, leaf_size=leaf_size, any_hit=any_hit)

    init = (
        jnp.zeros((n,), jnp.int32),
        jnp.broadcast_to(t_max, (n,)).astype(o.dtype),
        jnp.full((n,), -1, jnp.int32),
        jnp.full((n,), _NO_ID, jnp.int32),
        jnp.zeros((n,), o.dtype),
        jnp.zeros((n,), o.dtype),
    )
    _, bt, bp, _, b0, b1 = jax.lax.while_loop(
        lambda st: jnp.any(st[0] < nn), body, init
    )
    return bt, bp, b0, b1


def _gpu_kernel(*refs, leaf_size, any_hit, has_ids):
    from jax.experimental.pallas import triton as plgpu

    if has_ids:
        box, link, tris, ids, nn_ref, *rays, t_out, p_out, b0_out, b1_out = refs
    else:
        box, link, tris, nn_ref, *rays, t_out, p_out, b0_out, b1_out = refs
        ids = None
    ox, oy, oz, dx, dy, dz, tmax = (r[...] for r in rays)
    nn = nn_ref[0]
    o = [ox, oy, oz]
    d = [dx, dy, dz]
    inv = [_safe_inv(v) for v in d]

    def gather(ref, width):
        def load(i, c, mask):
            return plgpu.load(ref.at[i * width + c], mask=mask, other=0)
        return load

    load_id = None
    if has_ids:
        def load_id(i, mask):
            return plgpu.load(ids.at[i], mask=mask, other=_NO_ID)

    def body(st):
        return _step(gather(box, 8), gather(link, 4), gather(tris, 9),
                     load_id, o, d, inv, st, n_nodes=nn,
                     leaf_size=leaf_size, any_hit=any_hit)

    def cond(st):
        return jnp.max((st[0] < nn).astype(jnp.int32)) > 0

    b = tmax.shape[0]
    init = (
        # lanes that cannot hit anything (dead or padded) start parked
        jnp.where(tmax > RAY_EPS, 0, nn).astype(jnp.int32),
        tmax,
        jnp.full((b,), -1, jnp.int32),
        jnp.full((b,), _NO_ID, jnp.int32),
        jnp.zeros((b,), tmax.dtype),
        jnp.zeros((b,), tmax.dtype),
    )
    _, bt, bp, _, b0, b1 = jax.lax.while_loop(cond, body, init)
    t_out[...] = bt
    p_out[...] = bp
    b0_out[...] = b0
    b1_out[...] = b1


@partial(jax.jit, static_argnames=("any_hit", "leaf_size", "block",
                                   "interpret"))
def walk_gpu(tables: BVHTables, o, d, t_max, *, any_hit: bool,
             leaf_size: int, tie_ids=None, block: int = GPU_BLOCK,
             interpret: bool = False):
    """The walk as one Pallas-Triton launch (``interpret=True`` runs the
    same kernel on the CPU for tests).  Same contract as
    :func:`walk_xla`."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = o.shape[0]
    n_pad = -(-n // block) * block
    tmax = jnp.broadcast_to(t_max, (n,)).astype(jnp.float32)
    cols = [o[:, c] for c in range(3)] + [d[:, c] for c in range(3)]
    cols = [c.astype(jnp.float32) for c in cols] + [tmax]
    if n_pad != n:
        # padded lanes get t_max = 0: parked before the first step
        cols = [jnp.pad(c, (0, n_pad - n)) for c in cols]
    has_ids = tie_ids is not None
    flat = [tables.box.reshape(-1), tables.link.reshape(-1),
            tables.tris.reshape(-1)]
    if has_ids:
        flat.append(tie_ids.astype(jnp.int32))
    flat.append(tables.n_nodes.astype(jnp.int32))

    def whole(x):
        return pl.BlockSpec(x.shape, lambda i: (0,))

    lane = pl.BlockSpec((block,), lambda i: (i,))
    out_shape = [
        jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        jax.ShapeDtypeStruct((n_pad,), jnp.int32),
        jax.ShapeDtypeStruct((n_pad,), jnp.float32),
        jax.ShapeDtypeStruct((n_pad,), jnp.float32),
    ]
    t, prim, b0, b1 = pl.pallas_call(
        partial(_gpu_kernel, leaf_size=leaf_size, any_hit=any_hit,
                has_ids=has_ids),
        out_shape=out_shape,
        grid=(n_pad // block,),
        in_specs=[whole(x) for x in flat] + [lane] * 7,
        out_specs=[lane] * 4,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=max(1, block // 32), num_stages=1
        ),
        interpret=interpret,
        name="bvh_walk_anyhit" if any_hit else "bvh_walk_closest",
    )(*flat, *cols)
    return t[:n], prim[:n], b0[:n], b1[:n]


def traverse(platform: str, tables: BVHTables, o, d, t_max, *,
             any_hit: bool, leaf_size: int, tie_ids=None):
    """The walk for ``platform`` ("gpu" or "cpu"); any other raises.

    Rays carry no gradient through traversal: hit distances are a
    function of geometry the integrators never differentiate.
    """
    o, d, t_max = (jax.lax.stop_gradient(x) for x in (o, d, t_max))
    if platform == "gpu":
        return walk_gpu(tables, o, d, t_max, any_hit=any_hit,
                        leaf_size=leaf_size, tie_ids=tie_ids)
    if platform == "cpu":
        return walk_xla(tables, o, d, t_max, any_hit=any_hit,
                        leaf_size=leaf_size, tie_ids=tie_ids)
    raise ValueError(f"no BVH traversal for platform {platform!r}")
