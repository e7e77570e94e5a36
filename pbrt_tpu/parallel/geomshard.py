"""Geometry-sharded rendering: triangles distributed across the mesh.

BASELINE config 5: scenes too big (or too compute-heavy) to replicate are
sharded over a **tp** mesh axis — each device holds a contiguous slice of
the triangle tables.  A 2D (dp, tp) mesh then gives:

  * rays sharded over dp, replicated over tp;
  * triangles sharded over tp, replicated over dp;
  * closest-hit = local sweep over the device's slice, then a ``pmin``
    all-reduce of hit distance over tp and masked-``psum`` broadcast of
    the winning primitive's attributes (p0/p1/p2/uv/n/mat/light).

This is the all-reduce formulation of "ray re-routing": every collective
is a dense XLA reduction across the devices (no per-ray routing tables),
which scales compute perfectly at the cost of O(rays) reduction bandwidth
per bounce — but rays stay replicated over tp.

The **ring formulation** (:func:`ring_closest_hit`,
:func:`make_ring_path_fn`) shards the rays over tp as well: each device
owns rays/tp lanes, and the ray packet (origins, directions, running
best-hit record) rotates around a device ring via ``ppermute``, visiting
every geometry slice exactly once.  Same images (identical lexicographic
(t, gid) tie-breaks), tp x fewer lanes per device, and neighbor-only
point-to-point traffic instead of all-reduces — the SURVEY §2.2 "ring
collective" pattern (the ray-tracing analogue of ring attention).

Determinism: ties in the pmin are broken toward the lowest primitive id,
so results are invariant to the shard count.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.ops.intersect import RAY_EPS

INF_T = 1e8


def shard_triangle_arrays(tri_data, tri_mat, tri_light, n_shards: int,
                          bvh: bool = False):
    """Pad + split triangle SoA into [n_shards, T/n_shards, ...] arrays.

    ``bvh=True`` additionally builds a **per-shard BVH** (native binned
    SAH, accel/bvh.py) and reorders each shard's triangles into its BVH's
    leaf order, adding the traversal tables of ``ops/traverse.py``
    stacked over the shard dim — ``bvh_box [S, M, 8]``, ``bvh_link
    [S, M, 4]``, ``bvh_tris [S, T/S, 9]`` — and node counts ``nn [S]``:
    the production formulation for BASELINE config 5 (1M-triangle scenes
    sharded over tp), replacing the O(rays x tris) brute sweep.
    """
    t = tri_data.count
    per = -(-t // n_shards)
    total = per * n_shards

    if tri_data.n0 is None:
        # densify missing shading normals with geometric normals
        from pbrt_tpu.shapes import concat_triangle_data

        tri_data = concat_triangle_data([tri_data])

    def pad(a, fill=0.0):
        a = np.asarray(a)
        if len(a) < total:
            padding = np.full((total - len(a),) + a.shape[1:], fill, dtype=a.dtype)
            a = np.concatenate([a, padding])
        return a.reshape(n_shards, per, *a.shape[1:])

    out = {
        "p0": pad(tri_data.p0.astype(float_t)),
        "p1": pad(tri_data.p1.astype(float_t)),
        "p2": pad(tri_data.p2.astype(float_t)),
        "uv0": pad(tri_data.uv0.astype(float_t)),
        "uv1": pad(tri_data.uv1.astype(float_t)),
        "uv2": pad(tri_data.uv2.astype(float_t)),
        "n0": pad(tri_data.n0.astype(float_t)),
        "n1": pad(tri_data.n1.astype(float_t)),
        "n2": pad(tri_data.n2.astype(float_t)),
        "mat": pad(np.asarray(tri_mat, dtype=np.int32), fill=-1),
        "light": pad(np.asarray(tri_light, dtype=np.int32), fill=-1),
        "valid": pad(np.ones(t, dtype=bool), fill=False),
        "gid": pad(np.arange(t, dtype=np.int32), fill=2**30),
    }
    if not bvh:
        return out

    from pbrt_tpu.accel.bvh import build_bvh
    from pbrt_tpu.ops.traverse import pack_nodes

    packs = []
    for s in range(n_shards):
        v = int(out["valid"][s].sum())
        if v == 0:
            # one empty node; nn = 0 ends the walk before it starts
            packs.append((pack_nodes(
                np.zeros((1, 3)), np.full((1, 3), -1.0), [1], [0], [0]
            ), 0))
            continue
        mins, maxs, skips, firsts, counts, perm = build_bvh(
            out["p0"][s][:v], out["p1"][s][:v], out["p2"][s][:v], _SHARD_LEAF
        )
        order = np.concatenate([perm, np.arange(v, per)])
        for k in out:
            out[k][s] = out[k][s][order]
        packs.append(
            (pack_nodes(mins, maxs, skips, firsts, counts), len(mins))
        )

    m_pad = max(8, max(len(box) for (box, _), _ in packs))

    def stack_nodes(col):
        rows = [p[col] for p, _ in packs]
        res = np.zeros((n_shards, m_pad, rows[0].shape[1]), rows[0].dtype)
        for s, r in enumerate(rows):
            res[s, : len(r)] = r
        return res

    out["bvh_box"] = stack_nodes(0)
    out["bvh_link"] = stack_nodes(1)
    out["bvh_tris"] = np.concatenate(
        [out["p0"], out["p1"], out["p2"]], axis=-1
    ).astype(np.float32)
    out["nn"] = np.asarray([nn for _, nn in packs], dtype=np.int32)
    return out


# leaf size used by the per-shard BVHs (static: unrolls the leaf tests)
_SHARD_LEAF = 4


def _local_bvh_hit(shard, o, d, t_max, platform=None):
    """Skip-link BVH closest hit over this device's slice
    (``ops/traverse.py``: the GPU kernel or the XLA walk).

    Lexicographic (t, gid) tie-break inside the walk, so the winner is
    invariant to which shard (and hence which traversal order) tests a
    triangle — required for shard-count-invariant images.
    Returns (t [N], local_idx [N], b0, b1) like :func:`local_closest_hit`.
    """
    from pbrt_tpu.ops.traverse import BVHTables, traverse

    tables = BVHTables(
        shard["bvh_box"], shard["bvh_link"], shard["bvh_tris"], shard["nn"]
    )
    return traverse(
        platform or jax.default_backend(), tables, o, d, t_max,
        any_hit=False, leaf_size=_SHARD_LEAF, tie_ids=shard["gid"],
    )


def local_closest_hit(shard, o, d, t_max, chunk=256, platform=None):
    """Closest hit of rays [N] against this device's triangle slice.

    Returns (t [N], local_idx [N], b0, b1); t = t_max when missed.
    Shards built with ``bvh=True`` walk their own BVH (GPU kernel or XLA
    walk, by ``platform``); otherwise a brute sweep (the reference
    formulation).
    """
    if "bvh_box" in shard:
        return _local_bvh_hit(shard, o, d, t_max, platform)
    p0s, p1s, p2s = shard["p0"], shard["p1"], shard["p2"]
    t_total = p0s.shape[0]
    chunk = min(chunk, t_total)
    n_chunks = -(-t_total // chunk)
    pad = n_chunks * chunk - t_total

    def pad_c(a):
        if pad:
            a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
        return a.reshape(n_chunks, chunk, *a.shape[1:])

    p0c, p1c, p2c = pad_c(p0s), pad_c(p1s), pad_c(p2s)
    validc = pad_c(shard["valid"].astype(jnp.int32)) > 0

    def body(carry, xs):
        bt, bi, b0c, b1c = carry
        (p0, p1, p2, valid), ci = xs
        e1 = p1 - p0
        e2 = p2 - p0
        pvec = jnp.cross(d[:, None, :], e2[None])
        det = jnp.sum(e1[None] * pvec, axis=-1)
        inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
        tvec = o[:, None, :] - p0[None]
        b0 = jnp.sum(tvec * pvec, axis=-1) * inv_det
        qvec = jnp.cross(tvec, e1[None])
        b1 = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
        tt = jnp.sum(e2[None] * qvec, axis=-1) * inv_det
        ok = (
            (jnp.abs(det) > 1e-12)
            & (b0 >= 0)
            & (b1 >= 0)
            & (b0 + b1 <= 1)
            & (tt > RAY_EPS)
            & (tt < bt[:, None])
            & valid[None]
        )
        tt = jnp.where(ok, tt, jnp.inf)
        best = jnp.argmin(tt, axis=-1)
        rows = jnp.arange(tt.shape[0])
        t_best = tt[rows, best]
        better = t_best < bt
        bt = jnp.where(better, t_best, bt)
        bi = jnp.where(better, ci * chunk + best, bi)
        b0c = jnp.where(better, b0[rows, best], b0c)
        b1c = jnp.where(better, b1[rows, best], b1c)
        return (bt, bi, b0c, b1c), None

    n = o.shape[0]
    init = (
        jnp.broadcast_to(t_max, (n,)).astype(o.dtype),
        jnp.full((n,), -1, dtype=jnp.int32),
        jnp.zeros((n,), o.dtype),
        jnp.zeros((n,), o.dtype),
    )
    (bt, bi, b0c, b1c), _ = jax.lax.scan(
        body, init, ((p0c, p1c, p2c, validc), jnp.arange(n_chunks, dtype=jnp.int32))
    )
    return bt, bi, b0c, b1c


def allreduce_closest(shard, t_local, idx_local, b0, b1, axis="tp"):
    """Combine per-shard closest hits into the global closest + attributes.

    Tie-break: minimum (t, global_id) lexicographically via pmin on a
    fused key, making the result shard-count invariant.
    """
    safe = jnp.maximum(idx_local, 0)
    gid = jnp.where(idx_local >= 0, shard["gid"][safe], jnp.int32(2**30))
    t_global = jax.lax.pmin(t_local, axis)
    # winner: my t equals the global min AND my gid is the min among ties
    is_tie = t_local <= t_global + 0.0
    gid_key = jnp.where(is_tie, gid, jnp.int32(2**30))
    gid_min = jax.lax.pmin(gid_key, axis)
    winner = is_tie & (gid == gid_min) & (idx_local >= 0)
    hit = gid_min < 2**30

    def bcast(x, fill=0.0):
        return jax.lax.psum(jnp.where(winner[..., None] if x.ndim > 1 else winner, x, fill), axis)

    out = {
        "t": t_global,
        "hit": hit,
        "prim": jax.lax.psum(jnp.where(winner, gid, 0), axis),
        "b0": jax.lax.psum(jnp.where(winner, b0, 0.0), axis),
        "b1": jax.lax.psum(jnp.where(winner, b1, 0.0), axis),
        "p0": bcast(shard["p0"][safe]),
        "p1": bcast(shard["p1"][safe]),
        "p2": bcast(shard["p2"][safe]),
        "uv0": bcast(shard["uv0"][safe]),
        "uv1": bcast(shard["uv1"][safe]),
        "uv2": bcast(shard["uv2"][safe]),
        "n0": bcast(shard["n0"][safe]),
        "n1": bcast(shard["n1"][safe]),
        "n2": bcast(shard["n2"][safe]),
        "mat": jax.lax.psum(jnp.where(winner, shard["mat"][safe], 0), axis)
        + jnp.where(gid_min < 2**30, 0, -1),
        "light": jax.lax.psum(jnp.where(winner, shard["light"][safe], 0), axis)
        + jnp.where(gid_min < 2**30, 0, -1),
    }
    return out


def sharded_occluded(shard, o, d, t_max, axis="tp", platform=None):
    t_local, idx, _, _ = local_closest_hit(shard, o, d, t_max,
                                           platform=platform)
    any_local = idx >= 0
    return jax.lax.psum(any_local.astype(jnp.int32), axis) > 0


def interaction_from_reduced(hit, o, d):
    """Reduced hit record -> SoA interaction (like compute_interaction but
    from the broadcast winner attributes; no further gathers needed)."""
    t = hit["t"]
    p = o + d * t[..., None]
    b0 = hit["b0"]
    b1 = hit["b1"]
    b2 = 1.0 - b0 - b1
    ng = jnp.cross(hit["p1"] - hit["p0"], hit["p2"] - hit["p0"])
    ng = ng / jnp.maximum(jnp.linalg.norm(ng, axis=-1, keepdims=True), 1e-12)
    ns = b2[..., None] * hit["n0"] + b0[..., None] * hit["n1"] + b1[..., None] * hit["n2"]
    nsn = jnp.linalg.norm(ns, axis=-1, keepdims=True)
    ns = jnp.where(nsn > 1e-9, ns / jnp.maximum(nsn, 1e-12), ng)
    ng = jnp.where(jnp.sum(ng * ns, axis=-1, keepdims=True) < 0, -ng, ng)
    uv = (
        b2[..., None] * hit["uv0"]
        + b0[..., None] * hit["uv1"]
        + b1[..., None] * hit["uv2"]
    )
    miss = ~hit["hit"]
    return {
        "p": p,
        "ng": jnp.where(miss[..., None], 0.0, ng),
        "ns": jnp.where(miss[..., None], 0.0, ns),
        "uv": uv,
        "mat": jnp.where(miss, -1, hit["mat"]),
        "light": jnp.where(miss, -1, hit["light"]),
        "med_in": jnp.full(t.shape, -1, jnp.int32),
        "med_out": jnp.full(t.shape, -1, jnp.int32),
        "wo": -d,
    }


# ---------------------------------------------------------------------------
# Ring (all_to_all) formulation: rays sharded over tp as well
# ---------------------------------------------------------------------------

_REC_VEC = ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2")


def ring_closest_hit(shard, o, d, t_max, tp_size: int, axis="tp",
                     platform=None):
    """Closest hit with rays AND triangles both sharded over ``axis``.

    Each of ``tp_size`` steps intersects the packet currently resident on
    this device against the local triangle slice, folds the result into the
    packet's best-hit record (lexicographic (t, gid) — identical tie-break
    to :func:`allreduce_closest`, so images match bit for bit), then
    rotates the packet one hop around the ring.  After tp steps every
    packet is back home having visited all geometry.

    Returns the same hit-record dict as :func:`allreduce_closest`.
    """
    n = o.shape[0]
    dt = o.dtype
    tmax = jnp.broadcast_to(t_max, (n,)).astype(dt)
    packet = {
        "o": o,
        "d": d,
        "tmax": tmax,
        "t": tmax,
        "gid": jnp.full((n,), 2**30, jnp.int32),
        "b0": jnp.zeros((n,), dt),
        "b1": jnp.zeros((n,), dt),
        "mat": jnp.full((n,), -1, jnp.int32),
        "light": jnp.full((n,), -1, jnp.int32),
    }
    for k in _REC_VEC:
        packet[k] = jnp.zeros((n,) + shard[k].shape[1:], dt)

    perm = [(i, (i + 1) % tp_size) for i in range(tp_size)]

    for _ in range(tp_size):
        t_l, idx_l, b0, b1 = local_closest_hit(
            shard, packet["o"], packet["d"], packet["tmax"],
            platform=platform,
        )
        safe = jnp.maximum(idx_l, 0)
        gid_l = jnp.where(idx_l >= 0, shard["gid"][safe], jnp.int32(2**30))
        better = (idx_l >= 0) & (
            (t_l < packet["t"]) | ((t_l == packet["t"]) & (gid_l < packet["gid"]))
        )
        packet["t"] = jnp.where(better, t_l, packet["t"])
        packet["gid"] = jnp.where(better, gid_l, packet["gid"])
        packet["b0"] = jnp.where(better, b0, packet["b0"])
        packet["b1"] = jnp.where(better, b1, packet["b1"])
        for k in _REC_VEC:
            packet[k] = jnp.where(better[..., None], shard[k][safe], packet[k])
        for k in ("mat", "light"):
            packet[k] = jnp.where(better, shard[k][safe], packet[k])
        packet = {k: jax.lax.ppermute(v, axis, perm) for k, v in packet.items()}

    found = packet["gid"] < 2**30
    return {
        "t": packet["t"],
        "hit": found,
        "prim": jnp.where(found, packet["gid"], 0),
        "b0": packet["b0"],
        "b1": packet["b1"],
        **{k: packet[k] for k in _REC_VEC},
        "mat": packet["mat"],
        "light": packet["light"],
    }


# ---------------------------------------------------------------------------
# Geometry-sharded wavefront path tracing (demonstrator + scaling harness)
# ---------------------------------------------------------------------------


def _shard_specs(tp_axis, bvh, P):
    """PartitionSpec dict matching shard_triangle_arrays' key set."""
    spec = {k: P(tp_axis, None) for k in (
        "p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2"
    )}
    spec.update({k: P(tp_axis) for k in ("mat", "light", "valid", "gid")})
    if bvh:
        spec.update({k: P(tp_axis, None) for k in (
            "bvh_box", "bvh_link", "bvh_tris"
        )})
        spec["nn"] = P(tp_axis)
    return spec


def make_sharded_path_fn(mesh, camera, sampler, film, kd_table, env_l,
                         max_depth=3, dp_axis="dp", tp_axis="tp",
                         formulation="allreduce", bvh=False):
    """Builds a jitted SPMD render step over a (dp, tp) mesh.

    Inputs at call time: (state, shard_tables_local?, pixels, sidx) — the
    triangle shard arrives via shard_map in_specs P('tp', ...), pixels via
    P('dp', ...) (allreduce) or P(('dp','tp'), ...) (ring).  Matte shading
    with a per-material kd table and a constant environment light; NEE
    omitted (env provides direct light) — this is the scaling harness for
    BASELINE config 5, not the full feature integrator.

    formulation:
      * "allreduce" — rays replicated over tp; winner reduced by pmin/psum;
      * "ring"      — rays sharded over tp too; packets rotate the ring
        (see :func:`ring_closest_hit`).  Same images, tp x more lanes.
    """
    from jax.sharding import PartitionSpec as P

    from pbrt_tpu.core.geometry import coordinate_system, vface_forward
    from pbrt_tpu.core.sampling import cosine_sample_hemisphere

    kd_table = jnp.asarray(kd_table)
    env_l = jnp.asarray(env_l)
    platform = mesh.devices.flat[0].platform

    def local_step(state, shard, pixel_xy, sidx):
        n = pixel_xy.shape[0]
        u_film = sampler.get2(pixel_xy, sidx, 0)
        p_film = pixel_xy.astype(float_t) + u_film
        o, d, w = camera.generate_rays(p_film, sampler.get2(pixel_xy, sidx, 2))
        L = jnp.zeros((n, 3), dtype=float_t)
        beta = jnp.ones((n, 3), dtype=float_t)
        alive = jnp.ones((n,), dtype=bool)
        for bounce in range(max_depth):
            if formulation == "ring":
                hit = ring_closest_hit(
                    shard, o, d, jnp.full((n,), INF_T, dtype=float_t),
                    mesh.shape[tp_axis], tp_axis, platform,
                )
            else:
                t_l, idx_l, b0, b1 = local_closest_hit(
                    shard, o, d, jnp.full((n,), INF_T, dtype=float_t),
                    platform=platform,
                )
                hit = allreduce_closest(shard, t_l, idx_l, b0, b1, tp_axis)
            esc = alive & ~hit["hit"]
            L = L + jnp.where(esc[..., None], beta * env_l, 0.0)
            alive = alive & hit["hit"]
            si = interaction_from_reduced(hit, o, d)
            if bounce == max_depth - 1:
                break
            ns = vface_forward(si["ns"], si["wo"])
            ss, ts = coordinate_system(ns)
            kd = kd_table[jnp.clip(si["mat"], 0, kd_table.shape[0] - 1)]
            u2 = sampler.get2(pixel_xy, sidx, 5 + 3 * bounce)
            wi_local = cosine_sample_hemisphere(u2)
            wi = (
                wi_local[..., 0:1] * ss
                + wi_local[..., 1:2] * ts
                + wi_local[..., 2:3] * ns
            )
            beta = jnp.where(alive[..., None], beta * kd, beta)
            o = si["p"] + ns * 1e-3
            d = wi
        L = jnp.where(jnp.isfinite(L), L, 0.0) * w[..., None]
        zero = {k: jnp.zeros_like(v) for k, v in state.items()}
        partial = film.add_samples(zero, p_film, L)
        partial = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, (dp_axis, tp_axis)), partial
        )
        if formulation != "ring":
            # tp replicas each traced the same rays: avoid double counting
            tp_size = mesh.shape[tp_axis]
            partial = jax.tree_util.tree_map(lambda x: x / tp_size, partial)
        return jax.tree_util.tree_map(jnp.add, state, partial)

    shard_spec = _shard_specs(tp_axis, bvh, P)
    ray_axes = (dp_axis, tp_axis) if formulation == "ring" else dp_axis
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), shard_spec, P(ray_axes, None), P(ray_axes)),
        out_specs=P(),
        check_vma=False,
    )
    return jax.jit(fn)


def make_sharded_grad_fn(mesh, camera, sampler, film, target,
                         max_depth=3, dp_axis="dp", tp_axis="tp", bvh=False,
                         remat=True):
    """Jitted loss+gradient step with geometry sharded over tp: the
    path-replay inverse-rendering formulation of BASELINE config 5.

    Differentiable parameters theta = {"kd": [M,3], "env_l": [3]}; the
    forward wavefront is the same matte harness as
    :func:`make_sharded_path_fn` (allreduce formulation) with each bounce
    wrapped in ``jax.checkpoint`` — reverse mode *replays* the bounce
    (re-intersecting with its deterministic samples) instead of storing
    wavefront state, and the resulting parameter gradients are psum'd over
    (dp, tp).  Returns ``fn(theta, shard, pixels, sidx) -> (loss, grads)``.
    """
    from jax.sharding import PartitionSpec as P

    from pbrt_tpu.core.geometry import coordinate_system, vface_forward
    from pbrt_tpu.core.sampling import cosine_sample_hemisphere

    target = jnp.asarray(target)
    platform = mesh.devices.flat[0].platform

    def radiance(theta, shard, pixel_xy, sidx):
        n = pixel_xy.shape[0]
        u_film = sampler.get2(pixel_xy, sidx, 0)
        p_film = pixel_xy.astype(float_t) + u_film
        o, d, w = camera.generate_rays(p_film, sampler.get2(pixel_xy, sidx, 2))
        carry = (
            jnp.zeros((n, 3), dtype=float_t),
            jnp.ones((n, 3), dtype=float_t),
            jnp.ones((n,), dtype=bool),
            o,
            d,
        )

        def bounce_body(bounce, carry):
            L, beta, alive, o, d = carry
            t_l, idx_l, b0, b1 = local_closest_hit(
                shard, o, d, jnp.where(alive, INF_T, 0.0).astype(float_t),
                platform=platform,
            )
            hit = allreduce_closest(shard, t_l, idx_l, b0, b1, tp_axis)
            esc = alive & ~hit["hit"]
            L = L + jnp.where(esc[..., None], beta * theta["env_l"], 0.0)
            alive = alive & hit["hit"]
            si = interaction_from_reduced(hit, o, d)
            if bounce == max_depth - 1:
                return L, beta, alive, o, d
            ns = vface_forward(si["ns"], si["wo"])
            ss, ts = coordinate_system(ns)
            kd = theta["kd"][jnp.clip(si["mat"], 0, theta["kd"].shape[0] - 1)]
            u2 = sampler.get2(pixel_xy, sidx, 5 + 3 * bounce)
            wi_local = cosine_sample_hemisphere(u2)
            wi = (
                wi_local[..., 0:1] * ss
                + wi_local[..., 1:2] * ts
                + wi_local[..., 2:3] * ns
            )
            beta = jnp.where(alive[..., None], beta * kd, beta)
            return L, beta, alive, si["p"] + ns * 1e-3, wi

        for bounce in range(max_depth):
            body = lambda c, b=bounce: bounce_body(b, c)
            if remat:
                body = jax.checkpoint(body)
            carry = body(carry)
        L = carry[0]
        return jnp.where(jnp.isfinite(L), L, 0.0) * w[..., None], p_film

    def local_loss(theta, shard, pixel_xy, sidx):
        L, p_film = radiance(theta, shard, pixel_xy, sidx)
        pix = jnp.clip(
            p_film.astype(jnp.int32),
            0,
            jnp.asarray(target.shape[:2][::-1], jnp.int32) - 1,
        )
        want = target[pix[..., 1], pix[..., 0]]
        # tp replicas trace identical rays: average, don't double count
        per_lane = jnp.sum((L - want) ** 2, axis=-1) / mesh.shape[tp_axis]
        return jnp.sum(per_lane)

    def local_step(theta, shard, pixel_xy, sidx):
        # each device differentiates its own lanes' share of the loss (the
        # collectives inside carry no theta dependence); the all-reduce of
        # loss and gradients over (dp, tp) completes the training step
        loss, grads = jax.value_and_grad(local_loss)(theta, shard, pixel_xy, sidx)
        total = jax.lax.psum(loss, (dp_axis, tp_axis))
        grads = jax.tree_util.tree_map(
            lambda g: jax.lax.psum(g, (dp_axis, tp_axis)), grads
        )
        return total, grads

    shard_spec = _shard_specs(tp_axis, bvh, P)
    fn = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), shard_spec, P(dp_axis, None), P(dp_axis)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return jax.jit(fn)
