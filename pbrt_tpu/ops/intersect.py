"""Ray-scene intersection (device).

Two primitive kinds: triangles (Moller-Trumbore, branchless) and analytic
spheres (object-space quadratic with z/phi clipping, mirroring the
reference's ``quadratic`` lib.rs:181-203 and pbrt-v3 §3.2).

This module provides the *brute-force* path: primitives are swept in
fixed-size chunks with ``lax.scan`` keeping a running closest hit, so
memory is O(N x CHUNK) regardless of scene size.  The BVH path
(``pbrt_tpu.accel``) shares the same hit-record contract and replaces the
sweep for large scenes.

Hit record (SoA dict, all [N]):
  t, hit (bool), kind (0 tri / 1 sphere), prim (index), b0/b1 (tri barys)
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t

# device matrix products run at full f32 (no TF32 on the GPU)
HIGHEST = jax.lax.Precision.HIGHEST

TRI_CHUNK = 256
SPH_CHUNK = 64

KIND_NONE = -1
KIND_TRI = 0
KIND_SPHERE = 1

RAY_EPS = 1e-4


def _pad_to(x, n, axis=0):
    pad = n - x.shape[axis]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, mode="edge")


def _chunked(arrs, chunk):
    """Stack host arrays into [C, chunk, ...] with edge padding + valid mask."""
    n = arrs[0].shape[0]
    c = max(1, -(-n // chunk))
    total = c * chunk
    out = [np.reshape(_pad_to(np.asarray(a), total), (c, chunk) + a.shape[1:]) for a in arrs]
    valid = np.arange(total).reshape(c, chunk) < n
    return out, valid


def tri_intersect_chunk(o, d, t_max, p0, p1, p2, valid):
    """[N] rays x [K] tris -> per-ray closest in this chunk.

    Returns (t [N], idx_in_chunk [N], b0, b1) with t=inf when missed.
    """
    e1 = p1 - p0  # [K,3]
    e2 = p2 - p0
    # pvec: [N,K,3]
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = jnp.sum(e1[None] * pvec, axis=-1)  # [N,K]
    inv_det = jnp.where(jnp.abs(det) > 1e-12, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = o[:, None, :] - p0[None]  # [N,K,3]
    b0 = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    b1 = jnp.sum(d[:, None, :] * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None] * qvec, axis=-1) * inv_det
    hit = (
        (jnp.abs(det) > 1e-12)
        & (b0 >= 0.0)
        & (b1 >= 0.0)
        & (b0 + b1 <= 1.0)
        & (t > RAY_EPS)
        & (t < t_max[:, None])
        & valid[None, :]
    )
    t = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t, axis=-1)
    n_idx = jnp.arange(t.shape[0])
    return t[n_idx, best], best, b0[n_idx, best], b1[n_idx, best]


def sphere_intersect_chunk(o, d, t_max, w2o, radius, z_min, z_max, phi_max, valid):
    """[N] rays x [K] spheres -> per-ray closest in chunk.

    Spheres intersect in object space (nonuniform scales stay exact).
    """
    # object-space rays: [N,K,3]
    rot = w2o[:, :3, :3]  # [K,3,3]
    trans = w2o[:, :3, 3]  # [K,3]
    oo = jnp.einsum("kij,nj->nki", rot, o, precision=HIGHEST) + trans[None]
    od = jnp.einsum("kij,nj->nki", rot, d, precision=HIGHEST)
    a = jnp.sum(od * od, axis=-1)
    b = 2.0 * jnp.sum(oo * od, axis=-1)
    c = jnp.sum(oo * oo, axis=-1) - (radius * radius)[None]
    disc = b * b - 4 * a * c
    has = disc >= 0.0
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    q = jnp.where(b < 0, -0.5 * (b - sq), -0.5 * (b + sq))
    t0 = q / jnp.where(a == 0, 1.0, a)
    t1 = c / jnp.where(q == 0, 1.0, q)
    t_near = jnp.minimum(t0, t1)
    t_far = jnp.maximum(t0, t1)

    def clip_ok(t):
        p = oo + od * t[..., None]
        z_ok = (p[..., 2] >= z_min[None] - 1e-6) & (p[..., 2] <= z_max[None] + 1e-6)
        phi = jnp.arctan2(p[..., 1], p[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
        return z_ok & (phi <= phi_max[None] + 1e-6)

    near_ok = has & (t_near > RAY_EPS) & (t_near < t_max[:, None]) & clip_ok(t_near)
    far_ok = has & (t_far > RAY_EPS) & (t_far < t_max[:, None]) & clip_ok(t_far)
    t = jnp.where(near_ok, t_near, jnp.where(far_ok, t_far, jnp.inf))
    t = jnp.where(valid[None, :], t, jnp.inf)
    best = jnp.argmin(t, axis=-1)
    n_idx = jnp.arange(t.shape[0])
    return t[n_idx, best], best


def _fit_chunk(n, max_chunk):
    """Smallest power-of-two chunk covering n, capped at max_chunk —
    avoids padding a 22-triangle scene to 256 lanes of dead work."""
    c = 8
    while c < n and c < max_chunk:
        c <<= 1
    return c


class BruteForceIntersector:
    """Holds chunked device tables; __call__ is jit-traceable."""

    def __init__(self, tri_data, sph_data):
        self.n_tri = tri_data.count if tri_data is not None else 0
        self.n_sph = sph_data.count if sph_data is not None else 0
        self.tri_chunk = _fit_chunk(self.n_tri, TRI_CHUNK)
        self.sph_chunk = _fit_chunk(self.n_sph, SPH_CHUNK)
        if self.n_tri:
            (c_arrs, valid) = _chunked(
                [tri_data.p0, tri_data.p1, tri_data.p2], self.tri_chunk
            )
            self.tri_chunks = tuple(jnp.asarray(a.astype(float_t)) for a in c_arrs)
            self.tri_valid = jnp.asarray(valid)
        if self.n_sph:
            (c_arrs, valid) = _chunked(
                [
                    sph_data.w2o.astype(float_t),
                    sph_data.radius,
                    sph_data.z_min,
                    sph_data.z_max,
                    sph_data.phi_max,
                ],
                self.sph_chunk,
            )
            self.sph_chunks = tuple(jnp.asarray(np.asarray(a, dtype=float_t)) for a in c_arrs)
            self.sph_valid = jnp.asarray(valid)

    def intersect(self, o, d, t_max):
        n = o.shape[0]
        best_t = jnp.broadcast_to(t_max, (n,)).astype(o.dtype)
        best_kind = jnp.full((n,), KIND_NONE, dtype=jnp.int32)
        best_prim = jnp.zeros((n,), dtype=jnp.int32)
        best_b0 = jnp.zeros((n,), dtype=o.dtype)
        best_b1 = jnp.zeros((n,), dtype=o.dtype)

        if self.n_tri:
            def tri_body(carry, chunk):
                bt, bk, bp, b0c, b1c = carry
                (p0, p1, p2, valid), ci = chunk
                t, idx, b0, b1 = tri_intersect_chunk(o, d, bt, p0, p1, p2, valid)
                better = t < bt
                bt = jnp.where(better, t, bt)
                bk = jnp.where(better, KIND_TRI, bk)
                bp = jnp.where(better, ci * self.tri_chunk + idx, bp)
                b0c = jnp.where(better, b0, b0c)
                b1c = jnp.where(better, b1, b1c)
                return (bt, bk, bp, b0c, b1c), None

            chunks = (
                (self.tri_chunks[0], self.tri_chunks[1], self.tri_chunks[2], self.tri_valid),
                jnp.arange(self.tri_chunks[0].shape[0], dtype=jnp.int32),
            )
            (best_t, best_kind, best_prim, best_b0, best_b1), _ = jax.lax.scan(
                tri_body, (best_t, best_kind, best_prim, best_b0, best_b1), chunks
            )

        if self.n_sph:
            def sph_body(carry, chunk):
                bt, bk, bp, b0c, b1c = carry
                (w2o, radius, zmin, zmax, phimax, valid), ci = chunk
                t, idx = sphere_intersect_chunk(
                    o, d, bt, w2o, radius, zmin, zmax, phimax, valid
                )
                better = t < bt
                bt = jnp.where(better, t, bt)
                bk = jnp.where(better, KIND_SPHERE, bk)
                bp = jnp.where(better, ci * self.sph_chunk + idx, bp)
                return (bt, bk, bp, b0c, b1c), None

            chunks = (
                (*self.sph_chunks, self.sph_valid),
                jnp.arange(self.sph_chunks[0].shape[0], dtype=jnp.int32),
            )
            (best_t, best_kind, best_prim, best_b0, best_b1), _ = jax.lax.scan(
                sph_body, (best_t, best_kind, best_prim, best_b0, best_b1), chunks
            )

        hit = best_kind != KIND_NONE
        return {
            "t": best_t,
            "hit": hit,
            "kind": best_kind,
            "prim": best_prim,
            "b0": best_b0,
            "b1": best_b1,
        }

    def occluded(self, o, d, t_max):
        """Any-hit within (eps, t_max)."""
        rec = self.intersect(o, d, t_max)
        return rec["hit"]
