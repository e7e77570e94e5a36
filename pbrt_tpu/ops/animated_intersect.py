"""Keyframed-triangle intersection for motion blur.

The reference parses shutter times and keeps the 2-slot animated
``TransformSet`` (api.rs:157-198) but never renders; pbrt-v3 interpolates
the transform at each ray's time and transforms the ray.  The device
formulation avoids per-lane matrix work entirely: the host bakes K
world-space vertex keyframes per animated shape (decompose + slerp,
core/animated.py — K adapts to the rotation angle so the per-segment
linear chord stays within tolerance of the slerp arc), and the wavefront
blends vertex positions with per-lane piecewise-linear hat weights
``w_k(t) = max(0, 1 - |t (K-1) - k|)`` — every inner-loop op is a dense
[N]-vector fma, no gathers, no matrix inversions.

Time is a pure function of (pixel, sample index, dimension 4), so motion
blur keeps the determinism contract (CLAUDE.md): renders are bit-stable
across batch sizes and mesh shapes.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.ops.intersect import KIND_NONE, KIND_TRI, RAY_EPS

# device matrix products run at full f32 (no TF32 on the GPU)
HIGHEST = jax.lax.Precision.HIGHEST


def time_weights(time_norm, n_keys: int):
    """[N] normalized times in [0,1] -> [N, K] hat-function weights."""
    x = jnp.clip(time_norm, 0.0, 1.0) * (n_keys - 1)
    k = jnp.arange(n_keys, dtype=time_norm.dtype)[None, :]
    return jnp.maximum(0.0, 1.0 - jnp.abs(x[:, None] - k))


class AnimatedTriIntersector:
    """Brute-force sweep over K-keyframed triangles with per-lane time.

    ``key_tris``: K TriangleData with identical topology (same count/order);
    key k holds world-space vertices at shutter time k/(K-1).
    Same hit contract as the static intersectors, plus the ``time`` kwarg
    ([N] in [0,1]; None = shutter open).
    """

    # past this count the sweep culls through a shutter-union BVH
    BVH_MIN_TRIS = 64

    def __init__(self, key_tris):
        self.n_keys = len(key_tris)
        self.n_tri = key_tris[0].count
        self.n_sph = 0
        # [T, K, 9] per-prim per-key vertex scalars
        cols = np.stack(
            [
                np.concatenate(
                    [kt.p0.astype(float_t), kt.p1.astype(float_t),
                     kt.p2.astype(float_t)], axis=1,
                )
                for kt in key_tris
            ],
            axis=1,
        )
        self._bvh = None
        if self.n_tri >= self.BVH_MIN_TRIS:
            # BVH over SHUTTER-EXPANDED bounds: each prim's box is the
            # union of its box at every keyframe (pbrt AnimatedTransform
            # MotionBounds), so any time-t position stays inside; the
            # leaf test blends vertices at the lane's time as usual
            from pbrt_tpu.accel.bvh import build_bvh

            v = cols.reshape(self.n_tri, self.n_keys, 3, 3)
            bb_min = v.min(axis=(1, 2))
            bb_max = v.max(axis=(1, 2))
            mins, maxs, skips, firsts, counts, perm = build_bvh(
                bb_min, bb_max, bb_max, leaf_size=4
            )
            cols = cols[perm]
            self._bvh = {
                "min": jnp.asarray(mins),
                "max": jnp.asarray(maxs),
                "skip": jnp.asarray(skips),
                "first": jnp.asarray(firsts),
                "count": jnp.asarray(counts),
                "perm": jnp.asarray(perm.astype(np.int32)),
                "m": len(mins),
            }
        self.cols = jnp.asarray(cols)

    def _weights(self, time, n, dt):
        if time is None:
            time = jnp.zeros((n,), dtype=dt)
        return time_weights(jnp.broadcast_to(time, (n,)).astype(dt), self.n_keys)

    def intersect(self, o, d, t_max, time=None):
        n = o.shape[0]
        dt = o.dtype
        w = self._weights(time, n, dt)  # [N, K]
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

        def blend(cols_k, j):
            # cols_k: [K, 9]; per-lane blended scalar column j -> [N]
            acc = w[:, 0] * cols_k[0, j]
            for k in range(1, self.n_keys):
                acc = acc + w[:, k] * cols_k[k, j]
            return acc

        def body(carry, cols_k):
            bt, bp, b0a, b1a, k = carry
            p0x, p0y, p0z = blend(cols_k, 0), blend(cols_k, 1), blend(cols_k, 2)
            p1x, p1y, p1z = blend(cols_k, 3), blend(cols_k, 4), blend(cols_k, 5)
            p2x, p2y, p2z = blend(cols_k, 6), blend(cols_k, 7), blend(cols_k, 8)
            e1x, e1y, e1z = p1x - p0x, p1y - p0y, p1z - p0z
            e2x, e2y, e2z = p2x - p0x, p2y - p0y, p2z - p0z
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = jnp.where(
                jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0
            )
            tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
            b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            b1 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = (
                (jnp.abs(det) > 1e-12)
                & (b0 >= 0.0)
                & (b1 >= 0.0)
                & (b0 + b1 <= 1.0)
                & (tt > RAY_EPS)
                & (tt < bt)
            )
            bt = jnp.where(ok, tt, bt)
            bp = jnp.where(ok, k, bp)
            b0a = jnp.where(ok, b0, b0a)
            b1a = jnp.where(ok, b1, b1a)
            return (bt, bp, b0a, b1a, k + 1), None

        if self._bvh is not None:
            bt, bp, b0a, b1a = self._bvh_walk(
                o, d, jnp.broadcast_to(t_max, (n,)).astype(dt), w
            )
            got = bp >= 0
            prim = jnp.where(got, self._bvh["perm"][jnp.maximum(bp, 0)], 0)
            return {
                "t": bt,
                "hit": got,
                "kind": jnp.where(got, KIND_TRI, KIND_NONE),
                "prim": prim,
                "b0": b0a,
                "b1": b1a,
            }
        init = (
            jnp.broadcast_to(t_max, (n,)).astype(dt),
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), dt),
            jnp.zeros((n,), dt),
            jnp.int32(0),
        )
        (bt, bp, b0a, b1a, _), _ = jax.lax.scan(body, init, self.cols)
        got = bp >= 0
        return {
            "t": bt,
            "hit": got,
            "kind": jnp.where(got, KIND_TRI, KIND_NONE),
            "prim": jnp.maximum(bp, 0),
            "b0": b0a,
            "b1": b1a,
        }

    def _bvh_walk(self, o, d, t_max, w, leaf_size=4):
        """Skip-link walk over shutter-union bounds; leaf tests blend the
        triangle's keyframed vertices with the lane's hat weights."""
        bvh = self._bvh
        m = bvh["m"]
        n = o.shape[0]
        ox, oy, oz = o[..., 0], o[..., 1], o[..., 2]
        dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]

        def safe_inv(v):
            sign = jnp.where(v < 0.0, -1.0, 1.0)
            return jnp.clip(sign / jnp.maximum(jnp.abs(v), 1e-20), -1e30, 1e30)

        inv = safe_inv(d)

        def blend_prim(pid):
            """One gather of the prim's [K, 9] keys, blended -> [N, 9]."""
            ck = self.cols[pid]  # [N, K, 9]
            return jnp.einsum("nk,nkj->nj", w, ck, precision=HIGHEST)

        def cond(st):
            return jnp.any(st[0] < m)

        def body(st):
            node, bt, bp, b0c, b1c = st
            active = node < m
            ni = jnp.minimum(node, m - 1)
            t0 = (bvh["min"][ni] - o) * inv
            t1 = (bvh["max"][ni] - o) * inv
            tn = jnp.max(jnp.minimum(t0, t1), axis=-1)
            tf = jnp.min(jnp.maximum(t0, t1), axis=-1)
            box_hit = active & (tn <= tf) & (tf > RAY_EPS) & (tn < bt)
            cnt = bvh["count"][ni]
            is_leaf = cnt > 0
            fst = bvh["first"][ni]
            for k in range(leaf_size):
                pid = jnp.minimum(fst + k, self.n_tri - 1)
                ok0 = box_hit & is_leaf & (k < cnt)
                v = blend_prim(pid)
                p0x, p0y, p0z = v[:, 0], v[:, 1], v[:, 2]
                e1x, e1y, e1z = v[:, 3] - p0x, v[:, 4] - p0y, v[:, 5] - p0z
                e2x, e2y, e2z = v[:, 6] - p0x, v[:, 7] - p0y, v[:, 8] - p0z
                pvx = dy * e2z - dz * e2y
                pvy = dz * e2x - dx * e2z
                pvz = dx * e2y - dy * e2x
                det = e1x * pvx + e1y * pvy + e1z * pvz
                inv_det = jnp.where(
                    jnp.abs(det) > 1e-12,
                    1.0 / jnp.where(det == 0.0, 1.0, det), 0.0,
                )
                tvx, tvy, tvz = ox - p0x, oy - p0y, oz - p0z
                b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
                qvx = tvy * e1z - tvz * e1y
                qvy = tvz * e1x - tvx * e1z
                qvz = tvx * e1y - tvy * e1x
                b1 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
                tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
                ok = (
                    ok0
                    & (jnp.abs(det) > 1e-12)
                    & (b0 >= 0.0)
                    & (b1 >= 0.0)
                    & (b0 + b1 <= 1.0)
                    & (tt > RAY_EPS)
                    & (tt < bt)
                )
                bp = jnp.where(ok, pid, bp)
                b0c = jnp.where(ok, b0, b0c)
                b1c = jnp.where(ok, b1, b1c)
                bt = jnp.where(ok, tt, bt)
            descend = box_hit & ~is_leaf
            nxt = jnp.where(descend, ni + 1, bvh["skip"][ni])
            nxt = jnp.where(active, nxt, m)
            return nxt, bt, bp, b0c, b1c

        init = (
            jnp.zeros((n,), jnp.int32),
            t_max,
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), o.dtype),
            jnp.zeros((n,), o.dtype),
        )
        _, bt, bp, b0c, b1c = jax.lax.while_loop(cond, body, init)
        return bt, bp, b0c, b1c

    def occluded(self, o, d, t_max, time=None):
        return self.intersect(o, d, t_max, time)["hit"]


class AnimatedIntersector:
    """Animated triangles + static analytic spheres, merged hit records."""

    def __init__(self, key_tris, sph_data):
        from pbrt_tpu.ops.intersect import KIND_SPHERE
        from pbrt_tpu.ops.intersect_soa import SoABruteForceIntersector

        self._kind_sphere = KIND_SPHERE
        self.tris = AnimatedTriIntersector(key_tris) if key_tris[0].count else None
        self.n_tri = key_tris[0].count
        self.n_sph = sph_data.count if sph_data is not None else 0
        self._sph = (
            SoABruteForceIntersector(None, sph_data) if self.n_sph else None
        )

    def intersect(self, o, d, t_max, time=None):
        n = o.shape[0]
        if self.tris is not None:
            out = self.tris.intersect(o, d, t_max, time)
        else:
            out = {
                "t": jnp.broadcast_to(t_max, (n,)).astype(o.dtype),
                "hit": jnp.zeros((n,), bool),
                "kind": jnp.full((n,), KIND_NONE, jnp.int32),
                "prim": jnp.zeros((n,), jnp.int32),
                "b0": jnp.zeros((n,), o.dtype),
                "b1": jnp.zeros((n,), o.dtype),
            }
        if self._sph is not None:
            sph = self._sph.intersect(o, d, out["t"])
            closer = sph["hit"] & (sph["t"] < out["t"])
            out = {
                "t": jnp.where(closer, sph["t"], out["t"]),
                "hit": out["hit"] | closer,
                "kind": jnp.where(closer, self._kind_sphere, out["kind"]),
                "prim": jnp.where(closer, sph["prim"], out["prim"]),
                "b0": jnp.where(closer, 0.0, out["b0"]),
                "b1": jnp.where(closer, 0.0, out["b1"]),
            }
        return out

    def occluded(self, o, d, t_max, time=None):
        occ = jnp.zeros(o.shape[:-1], bool)
        if self.tris is not None:
            occ = self.tris.occluded(o, d, t_max, time)
        if self._sph is not None:
            occ = occ | self._sph.occluded(o, d, t_max)
        return occ
