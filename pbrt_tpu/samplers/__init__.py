"""Samplers: deterministic, stateless sample generators.

The reference reserves the names halton/sobol/random/stratified/
02sequence/maxmindist (defaults api.rs:226-249) but implements none of them
(the Sobol tables sit unused, SURVEY.md §2.1).  Here every sampler is a
pure function ``get(pixel, sample_index, dim) -> [N] floats`` — no mutable
per-pixel state like pbrt's Sampler objects, because a wavefront draws the
d-th dimension for a million lanes at once, and determinism across
shardings requires values to depend only on (pixel, sample, dim).

Dimension allocation is static per integrator (camera gets dims 0-4, then 2
or 3 dims per bounce), mirroring pbrt's Get1D/Get2D call discipline.
"""

from __future__ import annotations

import logging

import numpy as np

import jax.numpy as jnp

from pbrt_tpu.core.lowdiscrepancy import (
    owen_scramble_u32,
    radical_inverse,
    scrambled_radical_inverse,
    sobol_matrices,
    sobol_sample_u32,
    u32_to_unit_float,
)
from pbrt_tpu.core.rng import hash_combine, hash_u32, pcg3d, u32_to_float

log = logging.getLogger("pbrt_tpu")


def _pixel_code(pixel_xy):
    """Mix pixel (x, y) into one uint32 key."""
    x = pixel_xy[..., 0].astype(jnp.uint32)
    y = pixel_xy[..., 1].astype(jnp.uint32)
    return hash_u32(x * jnp.uint32(0x9E3779B1) ^ (y + jnp.uint32(0x85EBCA77)))


class Sampler:
    samples_per_pixel: int = 16
    # static promise that every sample_index passed to get/get2 is < bound
    # (set via bounded(); lets Halton truncate its digit chains)
    index_bound: int | None = None

    def __init__(self, samples_per_pixel: int, seed: int = 0):
        self.samples_per_pixel = int(samples_per_pixel)
        self.seed = int(seed)

    def bounded(self, index_bound: int):
        """Shallow view of this sampler whose callers promise
        ``sample_index < index_bound`` — values are unchanged, only
        statically-dead digit work is elided."""
        import copy

        s = copy.copy(self)
        s.index_bound = int(index_bound)
        return s

    def get(self, pixel_xy, sample_index, dim: int):
        raise NotImplementedError

    def get2(self, pixel_xy, sample_index, dim: int):
        return jnp.stack(
            [self.get(pixel_xy, sample_index, dim), self.get(pixel_xy, sample_index, dim + 1)],
            axis=-1,
        )


class RandomSampler(Sampler):
    """Counter-based uniform randoms (pcg3d hash of pixel/sample/dim)."""

    def get(self, pixel_xy, sample_index, dim: int):
        pc = _pixel_code(pixel_xy)
        a, b, c = pcg3d(
            pc ^ jnp.uint32(self.seed),
            jnp.asarray(sample_index, jnp.uint32),
            jnp.uint32(dim),
        )
        return u32_to_float(a)


class StratifiedSampler(Sampler):
    """Jittered stratification per dimension.

    The first two dims (film x/y) use an sqrt-spp grid; later dims use
    1D strata with a per-(pixel,dim) random shuffle via hashing — the
    wavefront analogue of pbrt's in-pixel stratified arrays.
    """

    def __init__(self, xsamples=4, ysamples=4, jitter=True, seed: int = 0):
        super().__init__(xsamples * ysamples, seed)
        self.nx, self.ny = int(xsamples), int(ysamples)
        self.jitter = bool(jitter)

    def _jitter_u(self, pixel_xy, sample_index, dim):
        if not self.jitter:
            return 0.5
        pc = _pixel_code(pixel_xy)
        a, _, _ = pcg3d(
            pc ^ jnp.uint32(self.seed),
            jnp.asarray(sample_index, jnp.uint32),
            jnp.uint32(dim),
        )
        return u32_to_float(a)

    def _permuted_index(self, pixel_xy, sample_index, dim):
        """Per-(pixel, dim) random bijection of sample indices so strata in
        different dimensions are decorrelated (Kensler-style cycle-walking
        would be exact; hashing + modular multiply is adequate here)."""
        n = self.samples_per_pixel
        pc = _pixel_code(pixel_xy)
        h = hash_combine(pc, jnp.uint32(dim + 0x51), jnp.uint32(self.seed))
        idx = jnp.asarray(sample_index, jnp.uint32)
        # odd multiplier + offset modulo n is a bijection when n is a power
        # of two; otherwise fall back to offset-only rotation
        if n & (n - 1) == 0 and n > 0:
            mult = (h | jnp.uint32(1)) & jnp.uint32(n - 1) | jnp.uint32(1)
            return (idx * mult + (h >> 8)) % jnp.uint32(n)
        return (idx + h) % jnp.uint32(max(n, 1))

    def get(self, pixel_xy, sample_index, dim: int):
        n = self.samples_per_pixel
        u = self._jitter_u(pixel_xy, sample_index, dim)
        if dim == 0 or dim == 1:
            # 2D grid strata over (dim0, dim1)
            s = jnp.asarray(sample_index, jnp.uint32)
            sx = (s % self.nx).astype(jnp.float32)
            sy = ((s // self.nx) % self.ny).astype(jnp.float32)
            if dim == 0:
                return jnp.minimum((sx + u) / self.nx, 0.99999994)
            return jnp.minimum((sy + u) / self.ny, 0.99999994)
        s = self._permuted_index(pixel_xy, sample_index, dim).astype(jnp.float32)
        return jnp.minimum((s + u) / n, 0.99999994)


class HaltonSampler(Sampler):
    """Randomized-QMC Halton: dimension d uses the d-th prime base with a
    per-(pixel, dim) Cranley-Patterson rotation.

    Divergence from pbrt-v3 (documented): pbrt enumerates one global Halton
    sequence and computes which global indices land in each pixel; on device we
    instead give every pixel the full sequence with an independent random
    rotation — the same convergence order, but the index math is a pure
    per-lane function with no CRT solve.

    Past ``QMC_DIM_LIMIT`` dimensions the sampler falls back to counter
    hashes — pbrt's samplers likewise revert to uniform randoms beyond
    their array dimensions (§7.2.3), and at depth the high-prime radical
    inverses cost ~20x a hash for no stratification benefit.
    """

    QMC_DIM_LIMIT = 20

    def get(self, pixel_xy, sample_index, dim: int):
        if dim >= self.QMC_DIM_LIMIT:
            pc = _pixel_code(pixel_xy)
            a, _, _ = pcg3d(
                pc ^ jnp.uint32(self.seed),
                jnp.asarray(sample_index, jnp.uint32),
                jnp.uint32(dim),
            )
            return u32_to_float(a)
        d = dim % 1024
        pc = _pixel_code(pixel_xy)
        rot_bits = hash_combine(pc, jnp.uint32(d), jnp.uint32(self.seed))
        rot = u32_to_float(rot_bits)
        return scrambled_radical_inverse(
            d, jnp.asarray(sample_index, jnp.uint32), rot, self.index_bound
        )


class SobolSampler(Sampler):
    """Owen-scrambled Sobol'; per-pixel scramble seed, generated matrices."""

    def __init__(self, samples_per_pixel: int, seed: int = 0):
        super().__init__(samples_per_pixel, seed)
        self._v = jnp.asarray(sobol_matrices())

    def get(self, pixel_xy, sample_index, dim: int):
        d = dim % self._v.shape[0]
        idx = jnp.asarray(sample_index, jnp.uint32)
        pc = _pixel_code(pixel_xy)
        # Owen-scramble the index itself (decorrelates pixels) then the output
        index_seed = hash_combine(pc, jnp.uint32(self.seed))
        scrambled_idx = owen_scramble_u32(idx, index_seed)
        # note: scrambling the index this way permutes sample order per pixel;
        # to preserve sequence prefix property we instead scramble output only
        bits = sobol_sample_u32(idx, self._v[d])
        out_seed = hash_combine(pc, jnp.uint32(d + 1), jnp.uint32(self.seed))
        bits = owen_scramble_u32(bits, out_seed)
        del scrambled_idx
        return u32_to_unit_float(bits)


class ZeroTwoSequenceSampler(SobolSampler):
    """(0,2)-sequence: Sobol dims (0,1) reused per 2D pair with per-pair
    scrambles (pbrt-v3 §7.5); on device this is Sobol with pair-folded dims."""

    def get(self, pixel_xy, sample_index, dim: int):
        pair_dim = dim % 2
        pair_id = dim // 2
        idx = jnp.asarray(sample_index, jnp.uint32)
        pc = _pixel_code(pixel_xy)
        bits = sobol_sample_u32(idx, self._v[pair_dim])
        out_seed = hash_combine(pc, jnp.uint32(pair_id * 2 + pair_dim + 7), jnp.uint32(self.seed))
        bits = owen_scramble_u32(bits, out_seed)
        return u32_to_unit_float(bits)


class MaxMinDistSampler(ZeroTwoSequenceSampler):
    """pbrt's maxmindist generator matrices are specially chosen (0,2)
    variants; Owen-scrambled (0,2) has equal or better blue-noise-ish
    distribution, so this aliases ZeroTwoSequence on device."""


def make_sampler(name: str, params, seed: int = 0) -> Sampler:
    """Factory per pbrt-v3 MakeSampler names."""
    spp = params.find_one_int("pixelsamples", 16)
    if name == "random":
        return RandomSampler(spp, seed)
    if name == "stratified":
        xs = params.find_one_int("xsamples", 4)
        ys = params.find_one_int("ysamples", 4)
        jitter = params.find_one_bool("jitter", True)
        return StratifiedSampler(xs, ys, jitter, seed)
    if name == "halton":
        return HaltonSampler(spp, seed)
    if name in ("sobol", "lowdiscrepancy"):
        return SobolSampler(spp, seed)
    if name == "02sequence":
        return ZeroTwoSequenceSampler(spp, seed)
    if name == "maxmindist":
        return MaxMinDistSampler(spp, seed)
    log.warning("Sampler '%s' unknown; using halton.", name)
    return HaltonSampler(spp, seed)
