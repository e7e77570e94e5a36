"""Component-SoA intersection sweep — flat-vector brute force.

The [N, K, 3] formulation in ops/intersect.py puts the 3-vector on the
minor axis.  Here every operand is a flat [N] vector and the primitive
loop is a ``lax.scan`` over *stacked per-primitive scalars* — each
iteration is ~60 dense elementwise ops.  Ideal for small-to-medium primitive counts; the BVH
covers large ones.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.ops.intersect import KIND_NONE, KIND_SPHERE, KIND_TRI, RAY_EPS


def _split3(v):
    return v[..., 0], v[..., 1], v[..., 2]


# Below this primitive count the sweep is unrolled into one fused kernel
# with primitive scalars baked in as compile-time constants — a lax.scan
# would bounce the [N] carry through HBM once per primitive.
UNROLL_MAX = 96


class SoABruteForceIntersector:
    """Drop-in replacement for BruteForceIntersector (same hit contract)."""

    def __init__(self, tri_data, sph_data):
        self.n_tri = tri_data.count if tri_data is not None else 0
        self.n_sph = sph_data.count if sph_data is not None else 0
        self.unroll = (self.n_tri + self.n_sph) <= UNROLL_MAX
        if self.unroll:
            if self.n_tri:
                self.tri_host = (
                    np.asarray(tri_data.p0, dtype=np.float64),
                    np.asarray(tri_data.p1, dtype=np.float64),
                    np.asarray(tri_data.p2, dtype=np.float64),
                )
            if self.n_sph:
                self.sph_host = (
                    np.asarray(sph_data.w2o, dtype=np.float64),
                    np.asarray(sph_data.radius, dtype=np.float64),
                    np.asarray(sph_data.z_min, dtype=np.float64),
                    np.asarray(sph_data.z_max, dtype=np.float64),
                    np.asarray(sph_data.phi_max, dtype=np.float64),
                )
        if self.n_tri:
            # stacked per-triangle scalars [T, 9]
            self.tri_cols = jnp.asarray(
                np.concatenate(
                    [
                        tri_data.p0.astype(float_t),
                        tri_data.p1.astype(float_t),
                        tri_data.p2.astype(float_t),
                    ],
                    axis=1,
                )
            )
        if self.n_sph:
            w2o = np.asarray(sph_data.w2o, dtype=float_t).reshape(self.n_sph, 16)
            cols = np.concatenate(
                [
                    w2o[:, :12],  # rotation+translation rows
                    sph_data.radius[:, None].astype(float_t),
                    sph_data.z_min[:, None].astype(float_t),
                    sph_data.z_max[:, None].astype(float_t),
                    sph_data.phi_max[:, None].astype(float_t),
                ],
                axis=1,
            )
            self.sph_cols = jnp.asarray(cols)

    def _tri_sweep(self, o, d, best, any_hit=False):
        ox, oy, oz = _split3(o)
        dx, dy, dz = _split3(d)

        def body(carry, cols):
            bt, bp, b0a, b1a, k = carry
            p0x, p0y, p0z, p1x, p1y, p1z, p2x, p2y, p2z = (cols[i] for i in range(9))
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

        n = o.shape[0]
        init = (
            best,
            jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,), o.dtype),
            jnp.zeros((n,), o.dtype),
            jnp.int32(0),
        )
        (bt, bp, b0a, b1a, _), _ = jax.lax.scan(body, init, self.tri_cols)
        return bt, bp, b0a, b1a

    def _sph_sweep(self, o, d, best):
        ox, oy, oz = _split3(o)
        dx, dy, dz = _split3(d)

        def body(carry, cols):
            bt, bp, k = carry
            m = [cols[i] for i in range(12)]
            radius, zmin, zmax, phimax = cols[12], cols[13], cols[14], cols[15]
            # object-space ray
            oox = m[0] * ox + m[1] * oy + m[2] * oz + m[3]
            ooy = m[4] * ox + m[5] * oy + m[6] * oz + m[7]
            ooz = m[8] * ox + m[9] * oy + m[10] * oz + m[11]
            odx = m[0] * dx + m[1] * dy + m[2] * dz
            ody = m[4] * dx + m[5] * dy + m[6] * dz
            odz = m[8] * dx + m[9] * dy + m[10] * dz
            a = odx * odx + ody * ody + odz * odz
            b = 2.0 * (oox * odx + ooy * ody + ooz * odz)
            c = oox * oox + ooy * ooy + ooz * ooz - radius * radius
            disc = b * b - 4 * a * c
            has = disc >= 0.0
            sq = jnp.sqrt(jnp.maximum(disc, 0.0))
            q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
            t0 = q / jnp.where(a == 0, 1.0, a)
            t1 = c / jnp.where(q == 0, 1.0, q)
            t_near = jnp.minimum(t0, t1)
            t_far = jnp.maximum(t0, t1)

            def clip_ok(t):
                pz = ooz + odz * t
                z_ok = (pz >= zmin - 1e-6) & (pz <= zmax + 1e-6)
                px = oox + odx * t
                py = ooy + ody * t
                phi = jnp.arctan2(py, px)
                phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
                return z_ok & (phi <= phimax + 1e-6)

            near_ok = has & (t_near > RAY_EPS) & (t_near < bt) & clip_ok(t_near)
            far_ok = has & (t_far > RAY_EPS) & (t_far < bt) & clip_ok(t_far)
            tt = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, jnp.inf))
            ok = tt < bt
            bt = jnp.where(ok, tt, bt)
            bp = jnp.where(ok, k, bp)
            return (bt, bp, k + 1), None

        n = o.shape[0]
        init = (best, jnp.full((n,), -1, jnp.int32), jnp.int32(0))
        (bt, bp, _), _ = jax.lax.scan(body, init, self.sph_cols)
        return bt, bp

    def _tri_sweep_unrolled_anyhit(self, o, d, tmax):
        """Shadow-ray sweep: no best-hit bookkeeping (prim/b0/b1/t selects
        drop out), just a running occlusion mask — ~30% fewer elementwise ops per
        triangle than the closest-hit sweep."""
        ox, oy, oz = _split3(o)
        dx, dy, dz = _split3(d)
        n = o.shape[0]
        hit = jnp.zeros((n,), bool)
        p0s, p1s, p2s = self.tri_host
        for k in range(self.n_tri):
            p0 = p0s[k]
            e1 = p1s[k] - p0
            e2 = p2s[k] - p0
            pvx = dy * e2[2] - dz * e2[1]
            pvy = dz * e2[0] - dx * e2[2]
            pvz = dx * e2[1] - dy * e2[0]
            det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
            inv_det = jnp.where(
                jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0
            )
            tvx, tvy, tvz = ox - p0[0], oy - p0[1], oz - p0[2]
            b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1[2] - tvz * e1[1]
            qvy = tvz * e1[0] - tvx * e1[2]
            qvz = tvx * e1[1] - tvy * e1[0]
            b1 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det
            hit = hit | (
                (jnp.abs(det) > 1e-12)
                & (b0 >= 0.0)
                & (b1 >= 0.0)
                & (b0 + b1 <= 1.0)
                & (tt > RAY_EPS)
                & (tt < tmax)
            )
        return hit

    def _tri_sweep_unrolled(self, o, d, best):
        """Python-unrolled sweep: triangle coords are trace constants, the
        whole loop fuses into one kernel."""
        ox, oy, oz = _split3(o)
        dx, dy, dz = _split3(d)
        n = o.shape[0]
        bt = best
        bp = jnp.full((n,), -1, jnp.int32)
        b0a = jnp.zeros((n,), o.dtype)
        b1a = jnp.zeros((n,), o.dtype)
        p0s, p1s, p2s = self.tri_host
        for k in range(self.n_tri):
            p0 = p0s[k]
            e1 = p1s[k] - p0
            e2 = p2s[k] - p0
            pvx = dy * e2[2] - dz * e2[1]
            pvy = dz * e2[0] - dx * e2[2]
            pvz = dx * e2[1] - dy * e2[0]
            det = e1[0] * pvx + e1[1] * pvy + e1[2] * pvz
            inv_det = jnp.where(
                jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0.0, 1.0, det), 0.0
            )
            tvx, tvy, tvz = ox - p0[0], oy - p0[1], oz - p0[2]
            b0 = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1[2] - tvz * e1[1]
            qvy = tvz * e1[0] - tvx * e1[2]
            qvz = tvx * e1[1] - tvy * e1[0]
            b1 = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            tt = (e2[0] * qvx + e2[1] * qvy + e2[2] * qvz) * inv_det
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
        return bt, bp, b0a, b1a

    def _sph_candidates_unrolled(self, k, o, d):
        """Per-sphere candidate hits (t_near, t_far, clip masks) with the
        structure of the k-th sphere specialized at trace time:

        - translate-only transforms skip the 3x3 rotation entirely (the
          dominant case: ``Translate`` + ``Shape "sphere"``), and the
          direction is untouched so ``a = dot(d, d)`` is sphere-independent;
        - full spheres (phi_max = 2pi, z range covering the whole sphere)
          skip the arctan2/z clip tests, the most expensive ops in the sweep.
        """
        ox, oy, oz = _split3(o)
        dx, dy, dz = _split3(d)
        w2os, radii, zmins, zmaxs, phimaxs = self.sph_host
        m = w2os[k]
        radius = float(radii[k])
        zmin, zmax, phimax = float(zmins[k]), float(zmaxs[k]), float(phimaxs[k])
        translate_only = bool(
            np.allclose(m[:3, :3], np.eye(3), atol=1e-12)
        )
        full = (
            phimax >= 2 * np.pi - 1e-5
            and zmin <= -radius * (1 - 1e-6)
            and zmax >= radius * (1 - 1e-6)
        )
        if translate_only:
            oox, ooy, ooz = ox + m[0, 3], oy + m[1, 3], oz + m[2, 3]
            odx, ody, odz = dx, dy, dz
        else:
            oox = m[0, 0] * ox + m[0, 1] * oy + m[0, 2] * oz + m[0, 3]
            ooy = m[1, 0] * ox + m[1, 1] * oy + m[1, 2] * oz + m[1, 3]
            ooz = m[2, 0] * ox + m[2, 1] * oy + m[2, 2] * oz + m[2, 3]
            odx = m[0, 0] * dx + m[0, 1] * dy + m[0, 2] * dz
            ody = m[1, 0] * dx + m[1, 1] * dy + m[1, 2] * dz
            odz = m[2, 0] * dx + m[2, 1] * dy + m[2, 2] * dz
        a = odx * odx + ody * ody + odz * odz
        b = 2.0 * (oox * odx + ooy * ody + ooz * odz)
        c = oox * oox + ooy * ooy + ooz * ooz - radius * radius
        disc = b * b - 4 * a * c
        has = disc >= 0.0
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
        t0 = q / jnp.where(a == 0, 1.0, a)
        t1 = c / jnp.where(q == 0, 1.0, q)
        t_near = jnp.minimum(t0, t1)
        t_far = jnp.maximum(t0, t1)

        if full:
            clip_near = clip_far = True
        else:
            def clip_ok(t):
                pz = ooz + odz * t
                z_ok = (pz >= zmin - 1e-6) & (pz <= zmax + 1e-6)
                px = oox + odx * t
                py = ooy + ody * t
                phi = jnp.arctan2(py, px)
                phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
                return z_ok & (phi <= phimax + 1e-6)

            clip_near = clip_ok(t_near)
            clip_far = clip_ok(t_far)
        return has, t_near, t_far, clip_near, clip_far

    def _sph_sweep_unrolled(self, o, d, best):
        n = o.shape[0]
        bt = best
        bp = jnp.full((n,), -1, jnp.int32)
        for k in range(self.n_sph):
            has, t_near, t_far, clip_near, clip_far = (
                self._sph_candidates_unrolled(k, o, d)
            )
            near_ok = has & (t_near > RAY_EPS) & (t_near < bt) & clip_near
            far_ok = has & (t_far > RAY_EPS) & (t_far < bt) & clip_far
            tt = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, jnp.inf))
            ok = tt < bt
            bt = jnp.where(ok, tt, bt)
            bp = jnp.where(ok, k, bp)
        return bt, bp

    def _sph_sweep_unrolled_anyhit(self, o, d, tmax):
        hit = jnp.zeros((o.shape[0],), bool)
        for k in range(self.n_sph):
            has, t_near, t_far, clip_near, clip_far = (
                self._sph_candidates_unrolled(k, o, d)
            )
            near_ok = (t_near > RAY_EPS) & (t_near < tmax) & clip_near
            far_ok = (t_far > RAY_EPS) & (t_far < tmax) & clip_far
            hit = hit | (has & (near_ok | far_ok))
        return hit

    def intersect(self, o, d, t_max):
        n = o.shape[0]
        best_t = jnp.broadcast_to(t_max, (n,)).astype(o.dtype)
        best_kind = jnp.full((n,), KIND_NONE, jnp.int32)
        best_prim = jnp.zeros((n,), jnp.int32)
        best_b0 = jnp.zeros((n,), o.dtype)
        best_b1 = jnp.zeros((n,), o.dtype)
        if self.unroll:
            if self.n_tri:
                t, p, b0, b1 = self._tri_sweep_unrolled(o, d, best_t)
                got = p >= 0
                best_t = jnp.where(got, t, best_t)
                best_kind = jnp.where(got, KIND_TRI, best_kind)
                best_prim = jnp.where(got, p, best_prim)
                best_b0 = jnp.where(got, b0, best_b0)
                best_b1 = jnp.where(got, b1, best_b1)
            if self.n_sph:
                t, p = self._sph_sweep_unrolled(o, d, best_t)
                got = p >= 0
                best_t = jnp.where(got, t, best_t)
                best_kind = jnp.where(got, KIND_SPHERE, best_kind)
                best_prim = jnp.where(got, p, best_prim)
            return {
                "t": best_t,
                "hit": best_kind != KIND_NONE,
                "kind": best_kind,
                "prim": best_prim,
                "b0": best_b0,
                "b1": best_b1,
            }
        if self.n_tri:
            t, p, b0, b1 = self._tri_sweep(o, d, best_t)
            got = p >= 0
            best_t = jnp.where(got, t, best_t)
            best_kind = jnp.where(got, KIND_TRI, best_kind)
            best_prim = jnp.where(got, p, best_prim)
            best_b0 = jnp.where(got, b0, best_b0)
            best_b1 = jnp.where(got, b1, best_b1)
        if self.n_sph:
            t, p = self._sph_sweep(o, d, best_t)
            got = p >= 0
            best_t = jnp.where(got, t, best_t)
            best_kind = jnp.where(got, KIND_SPHERE, best_kind)
            best_prim = jnp.where(got, p, best_prim)
        return {
            "t": best_t,
            "hit": best_kind != KIND_NONE,
            "kind": best_kind,
            "prim": best_prim,
            "b0": best_b0,
            "b1": best_b1,
        }

    def occluded(self, o, d, t_max):
        if self.unroll:
            n = o.shape[0]
            tmax = jnp.broadcast_to(t_max, (n,)).astype(o.dtype)
            hit = jnp.zeros((n,), bool)
            if self.n_tri:
                hit = hit | self._tri_sweep_unrolled_anyhit(o, d, tmax)
            if self.n_sph:
                hit = hit | self._sph_sweep_unrolled_anyhit(o, d, tmax)
            return hit
        return self.intersect(o, d, t_max)["hit"]
