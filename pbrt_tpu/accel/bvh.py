"""BVH accelerator: host build, stackless device traversal.

Build (host): binned SAH on the largest centroid axis (native C++ in
``native/pbrt_native.cpp``, with a Python fallback of the same tree
class).  Leaves hold up to ``LEAF_SIZE`` triangles; nodes are emitted in
depth-first order with **skip links** (node i's skip = first node after
its subtree).

Traversal (device, ``ops/traverse.py``): the skip-link layout makes the
walk stackless — each lane carries one node cursor and its best hit.
Front-to-back ordering is not per-ray (skip links fix child order), but
t_max shrinks as hits are found, so far boxes are culled.

Spheres stay on the chunked brute-force path (scenes have few analytic
spheres); the BVH covers triangles, where the primitive counts live.

Replaces the reference's never-built "bvh" accelerator default
(api.rs:237).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.ops.intersect import KIND_NONE, KIND_SPHERE, KIND_TRI, RAY_EPS
from pbrt_tpu.ops.intersect_soa import SoABruteForceIntersector
from pbrt_tpu.ops.traverse import BVHTables, pack_tables, traverse

LEAF_SIZE = 4


def build_bvh(p0, p1, p2, leaf_size=LEAF_SIZE, use_native=True):
    """BVH build; returns (node arrays, prim permutation).

    node arrays: mins [M,3], maxs [M,3], skip [M], first [M], count [M]
    (count==0 for interior nodes); perm [T] maps BVH prim slots to
    original triangle indices.

    Prefers the native binned-SAH builder (native/pbrt_native.cpp) and
    falls back to the Python median-split build.
    """
    if use_native:
        from pbrt_tpu.native import bvh_build_native

        out = bvh_build_native(np.asarray(p0), np.asarray(p1), np.asarray(p2), leaf_size)
        if out is not None:
            return out
    t = len(p0)
    bb_min = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    bb_max = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    centroid = (0.5 * (bb_min + bb_max)).astype(np.float32)

    perm = np.arange(t, dtype=np.int64)
    mins, maxs, skips, firsts, counts = [], [], [], [], []
    N_BINS = 16

    def _sah_split(pr):
        """Binned SAH on the largest centroid axis (pbrt-v3 §4.3.2);
        returns the number of prims in the left child, or None for a
        degenerate spread (caller median-splits).  Mirrors the native
        builder (native/pbrt_native.cpp) so the Python fallback produces
        the same tree CLASS — r3 verdict: the old median split gave
        CPU/test users a structurally worse tree than production."""
        cen = centroid[pr]
        c_lo = cen.min(axis=0)
        c_hi = cen.max(axis=0)
        axis = int(np.argmax(c_hi - c_lo))
        ext = c_hi[axis] - c_lo[axis]
        if ext <= 1e-12:
            return None, axis
        bins = np.minimum(
            ((cen[:, axis] - c_lo[axis]) / ext * N_BINS).astype(np.int64),
            N_BINS - 1,
        )
        lo_b = bb_min[pr]
        hi_b = bb_max[pr]
        binned_min = np.full((N_BINS, 3), np.inf, np.float32)
        binned_max = np.full((N_BINS, 3), -np.inf, np.float32)
        np.minimum.at(binned_min, bins, lo_b)
        np.maximum.at(binned_max, bins, hi_b)
        cnt = np.bincount(bins, minlength=N_BINS)

        def areas(mn, mx):
            e = np.maximum(mx - mn, 0.0)
            return e[:, 0] * e[:, 1] + e[:, 1] * e[:, 2] + e[:, 0] * e[:, 2]

        lmin = np.minimum.accumulate(binned_min, axis=0)
        lmax = np.maximum.accumulate(binned_max, axis=0)
        rmin = np.minimum.accumulate(binned_min[::-1], axis=0)[::-1]
        rmax = np.maximum.accumulate(binned_max[::-1], axis=0)[::-1]
        lcnt = np.cumsum(cnt)
        rcnt = lcnt[-1] - lcnt
        # split after bin k (k = 0..N_BINS-2)
        cost = (
            areas(lmin, lmax)[:-1] * lcnt[:-1]
            + areas(rmin, rmax)[1:] * rcnt[:-1]
        )
        valid = (lcnt[:-1] > 0) & (rcnt[:-1] > 0)
        if not valid.any():
            return None, axis
        cost = np.where(valid, cost, np.inf)
        k = int(np.argmin(cost))
        order = np.argsort(bins, kind="stable")
        n_left = int(lcnt[k])
        return (order, n_left), axis

    def build_rec(lo, hi):
        idx = len(mins)
        pr = perm[lo:hi]
        mins.append(bb_min[pr].min(axis=0))
        maxs.append(bb_max[pr].max(axis=0))
        skips.append(0)
        if hi - lo <= leaf_size:
            firsts.append(lo)
            counts.append(hi - lo)
        else:
            firsts.append(0)
            counts.append(0)
            split, axis = _sah_split(pr)
            if split is not None:
                order, mid = split
            else:
                mid = (hi - lo) // 2
                order = np.argpartition(centroid[pr][:, axis], mid)
            perm[lo:hi] = pr[order]
            build_rec(lo, lo + mid)
            build_rec(lo + mid, hi)
        skips[idx] = len(mins)  # first node after this subtree
        return

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * int(np.log2(max(t, 2)) + 2) * 64 + 10000))
    try:
        if t > 0:
            build_rec(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    return (
        np.asarray(mins, dtype=np.float32),
        np.asarray(maxs, dtype=np.float32),
        np.asarray(skips, dtype=np.int32),
        np.asarray(firsts, dtype=np.int32),
        np.asarray(counts, dtype=np.int32),
        perm,
    )


class BVHIntersector:
    """Skip-link BVH for triangles + brute-force spheres.

    Traversal is chosen by platform (``ops/traverse.py``): the Triton
    kernel on "gpu", the XLA while_loop walk on "cpu".  With ``sort=True``
    the GPU path first co-sorts the rays by direction octant and origin
    Morton code so that neighbouring lanes walk similar paths.
    """

    def __init__(self, tri_data, sph_data, leaf_size=LEAF_SIZE,
                 platform=None):
        self.platform = platform or jax.default_backend()
        if self.platform not in ("gpu", "cpu"):
            raise ValueError(
                f"no BVH traversal for platform {self.platform!r}"
            )
        self.n_tri = tri_data.count if tri_data is not None else 0
        self.n_sph = sph_data.count if sph_data is not None else 0
        self._sph_brute = None
        if self.n_sph:
            self._sph_brute = SoABruteForceIntersector(None, sph_data)
        if self.n_tri:
            mins, maxs, skips, firsts, counts, perm = build_bvh(
                tri_data.p0, tri_data.p1, tri_data.p2, leaf_size
            )
            self.n_nodes = len(mins)
            self.leaf_size = leaf_size
            self.tables = BVHTables(*(jnp.asarray(a) for a in pack_tables(
                mins, maxs, skips, firsts, counts,
                tri_data.p0[perm].astype(float_t),
                tri_data.p1[perm].astype(float_t),
                tri_data.p2[perm].astype(float_t),
            )))
            self.perm = jnp.asarray(perm.astype(np.int32))
            # scene bounds for Morton-coded ray sorting
            self._scene_min = jnp.asarray(mins[0])
            self._scene_extent = jnp.asarray(
                np.maximum(maxs[0] - mins[0], 1e-6)
            )

    # -- ray ordering --------------------------------------------------------

    @staticmethod
    def _part1by2(v):
        """Spread 10 bits to every 3rd bit (Morton encoding helper)."""
        v = v & jnp.uint32(0x3FF)
        v = (v | (v << 16)) & jnp.uint32(0x030000FF)
        v = (v | (v << 8)) & jnp.uint32(0x0300F00F)
        v = (v | (v << 4)) & jnp.uint32(0x030C30C3)
        v = (v | (v << 2)) & jnp.uint32(0x09249249)
        return v

    def _sort_keys(self, o, d, t_max=None):
        """Dead bit (top), origin Morton, direction octant, direction Morton.

        Direction bits matter as much as origin bits: camera and
        point-light shadow wavefronts share ONE origin, so an origin-only
        key would leave neighbouring lanes with widely divergent rays.

        Lanes whose ``t_max`` is already spent (terminated wavefront lanes,
        failed shadow candidates) sort to the end, so bounce compaction
        falls out of the sort instead of a gather/scatter pass.
        """
        import os as _os

        # Key bit budget (31 bits: origin Morton | octant | direction
        # Morton).  The 5/4 bits-per-axis default suits shared-origin
        # wavefronts; PBRT_TPU_KEY_OBITS re-balances it.
        obits = int(_os.environ.get("PBRT_TPU_KEY_OBITS", "5"))
        dbits = min(4, (28 - 3 * obits) // 3)
        octant = (
            (d[..., 0] < 0).astype(jnp.uint32) * 4
            + (d[..., 1] < 0).astype(jnp.uint32) * 2
            + (d[..., 2] < 0).astype(jnp.uint32)
        )
        # direction Morton: dbits/axis of |d| (octant already holds signs)
        ad = jnp.abs(d)
        qd = jnp.clip(ad / jnp.maximum(
            jnp.max(ad, axis=-1, keepdims=True), 1e-12
        ), 0.0, 0.999999)
        qdi = (qd * float(1 << dbits)).astype(jnp.uint32)
        dir_m = (
            self._part1by2(qdi[..., 0])
            | (self._part1by2(qdi[..., 1]) << 1)
            | (self._part1by2(qdi[..., 2]) << 2)
        ) & jnp.uint32((1 << (3 * dbits)) - 1)
        q = jnp.clip(
            (o - self._scene_min) / self._scene_extent, 0.0, 0.999999
        )
        qi = (q * float(1 << obits)).astype(jnp.uint32)
        morton = (
            self._part1by2(qi[..., 0])
            | (self._part1by2(qi[..., 1]) << 1)
            | (self._part1by2(qi[..., 2]) << 2)
        ) & jnp.uint32((1 << (3 * obits)) - 1)
        # origin-major: coincident-origin wavefronts (camera, point-light
        # shadows) have equal high bits and fall through to direction bits
        key = (morton << (3 + 3 * dbits)) | (octant << (3 * dbits)) | dir_m
        if t_max is not None:
            import os

            # PBRT_TPU_NO_DEADBIT=1 disables the dead-lane packing
            if os.environ.get("PBRT_TPU_NO_DEADBIT", "0") in ("", "0"):
                dead = (t_max <= RAY_EPS).astype(jnp.uint32)
                key = key | (dead << 31)
        return key

    def _traverse(self, o, d, t_max, any_hit, sort):
        """(t, slot, b0, b1) for every lane, in lane order."""
        def walk(o, d, t_max):
            return traverse(self.platform, self.tables, o, d, t_max,
                            any_hit=any_hit, leaf_size=self.leaf_size)

        if not (sort and self.platform == "gpu"):
            return walk(o, d, t_max)
        # one co-sort carries the ray columns into traversal order; one
        # packed row scatter returns the results to lane order
        n = o.shape[0]
        srt = jax.lax.sort(
            (self._sort_keys(o, d, t_max), jnp.arange(n, dtype=jnp.int32),
             o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], t_max),
            num_keys=1,
        )
        t, prim, b0, b1 = walk(
            jnp.stack(srt[2:5], -1), jnp.stack(srt[5:8], -1), srt[8]
        )
        bits = jax.lax.bitcast_convert_type
        packed = jnp.stack(
            [bits(t, jnp.int32), prim, bits(b0, jnp.int32),
             bits(b1, jnp.int32)], axis=-1,
        )
        out = jnp.zeros_like(packed).at[srt[1]].set(
            packed, unique_indices=True
        )
        f32 = jnp.float32
        return (bits(out[:, 0], f32), out[:, 1], bits(out[:, 2], f32),
                bits(out[:, 3], f32))

    # integrators may pass sort=False for wavefronts that are already
    # coherent in lane order (camera bounces: lanes are pixel-major)
    supports_sort_hint = True

    def sort_keys(self, o, d, t_max=None):
        """Public traversal-order keys (dead bit | origin Morton | octant |
        direction Morton) for integrators that keep their wavefront carry
        permanently sorted (PathIntegrator sorted-carry mode)."""
        return self._sort_keys(o, d, t_max)

    def intersect(self, o, d, t_max, sort=True):
        n = o.shape[0]
        best_t = jnp.broadcast_to(t_max, (n,)).astype(o.dtype)
        best_kind = jnp.full((n,), KIND_NONE, dtype=jnp.int32)
        best_prim = jnp.zeros((n,), dtype=jnp.int32)
        best_b0 = jnp.zeros((n,), dtype=o.dtype)
        best_b1 = jnp.zeros((n,), dtype=o.dtype)

        if self.n_tri:
            t, prim, b0, b1 = self._traverse(o, d, best_t, False, sort)
            got = prim >= 0
            best_t = jnp.where(got, t, best_t)
            best_kind = jnp.where(got, KIND_TRI, best_kind)
            best_prim = jnp.where(got, self.perm[jnp.maximum(prim, 0)], best_prim)
            best_b0 = jnp.where(got, b0, best_b0)
            best_b1 = jnp.where(got, b1, best_b1)

        if self.n_sph:
            sph = self._sph_brute.intersect(o, d, best_t)
            closer = sph["hit"] & (sph["t"] < best_t)
            best_t = jnp.where(closer, sph["t"], best_t)
            best_kind = jnp.where(closer, KIND_SPHERE, best_kind)
            best_prim = jnp.where(closer, sph["prim"], best_prim)

        hit = best_kind != KIND_NONE
        return {
            "t": best_t,
            "hit": hit,
            "kind": best_kind,
            "prim": best_prim,
            "b0": best_b0,
            "b1": best_b1,
        }

    def occluded(self, o, d, t_max, sort=True):
        n = o.shape[0]
        t_max = jnp.broadcast_to(t_max, (n,)).astype(o.dtype)
        found = jnp.zeros((n,), dtype=bool)
        if self.n_tri:
            _, prim, _, _ = self._traverse(o, d, t_max, True, sort)
            found = prim >= 0
        if self.n_sph:
            found = found | self._sph_brute.occluded(o, d, t_max)
        return found
