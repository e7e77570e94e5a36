"""PCG32 pseudo-random number generation (O'Neill 2014), host and device.

Two layers:

* :class:`Rng` — a stateful host-side generator operating on numpy uint64,
  bit-exact with the reference implementation
  (/root/reference/src/core/rng.rs:44-94).  The reference's golden output
  vectors (rng.rs:126-176, copied there from pbrt-v3 C++) are our parity
  anchor; ``tests/test_rng.py`` asserts them.

* Device functions — PCG32 re-expressed as *stateless* uint32-pair arithmetic
  in ``jax.numpy`` so megabatches of lanes can each run their own sequence
  in 32-bit lanes.  64-bit state is a ``(hi, lo)`` pair of uint32 with
  explicit carries, so no kernel needs native u64.  All device sampling in
  the renderer is a pure function of (sequence id, offset) — never of device
  id — which is what makes renders bit-stable across shardings
  (SURVEY.md §5 determinism note).

Also provides counter-based hashes (pcg3d, hash_u32) used by samplers for
decorrelation/scrambling.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import ONE_MINUS_EPSILON

PCG32_DEFAULT_STATE = np.uint64(0x853C49E6748FEA9B)
PCG32_DEFAULT_STREAM = np.uint64(0xDA3E39CB94B95BDB)
PCG32_MULT = np.uint64(0x5851F42D4C957F2D)

_U64 = np.uint64
_U32 = np.uint32
# All host arithmetic wraps mod 2^64 like the reference's wrapping_mul/add.
_ERR = np.seterr  # silence overflow warnings locally in _step


class Rng:
    """Stateful PCG32 generator, bit-exact with rng.rs:44-94."""

    def __init__(self, sequence_index: int | None = None):
        self.state = PCG32_DEFAULT_STATE
        self.inc = PCG32_DEFAULT_STREAM
        if sequence_index is not None:
            self.set_sequence(sequence_index)

    def set_sequence(self, sequence_index: int) -> None:
        """Reset state for stream ``sequence_index`` (rng.rs:53-59)."""
        old = np.seterr(over="ignore")
        try:
            self.state = _U64(0)
            self.inc = _U64(((int(sequence_index) << 1) | 1) & 0xFFFFFFFFFFFFFFFF)
            self.uniform_u32()
            self.state = _U64(self.state + PCG32_DEFAULT_STATE)
            self.uniform_u32()
        finally:
            np.seterr(**old)

    def uniform_u32(self) -> int:
        """Next u32, uniform over [0, 2^32) (rng.rs:62-76)."""
        old = np.seterr(over="ignore")
        try:
            oldstate = self.state
            self.state = _U64(oldstate * PCG32_MULT + self.inc)
            xorshifted = _U32(((oldstate >> _U64(18)) ^ oldstate) >> _U64(27))
            rot = int(oldstate >> _U64(59))
            return int((int(xorshifted) >> rot) | (int(xorshifted) << ((32 - rot) & 31)) & 0xFFFFFFFF) & 0xFFFFFFFF
        finally:
            np.seterr(**old)

    def uniform_u32_threshold(self, b: int) -> int:
        """Debiased bounded sample over [0, b) (rng.rs:79-87)."""
        threshold = ((~b + 1) & 0xFFFFFFFF) % b
        while True:
            r = self.uniform_u32()
            if r >= threshold:
                return r % b

    def uniform_float(self) -> float:
        """Uniform float in [0, 1) (rng.rs:89-93)."""
        return min(ONE_MINUS_EPSILON, float(np.float32(self.uniform_u32() * np.float32(2.3283064365386963e-10))))

    def __sub__(self, other: "Rng") -> int:
        """Distance between two generator states (rng.rs:96-118)."""
        assert self.inc == other.inc
        old = np.seterr(over="ignore")
        try:
            cur_mult = int(PCG32_MULT)
            cur_plus = int(self.inc)
            cur_state = int(other.state)
            the_bit = 1
            distance = 0
            mask = 0xFFFFFFFFFFFFFFFF
            target = int(self.state)
            while target != cur_state:
                if (target & the_bit) != (cur_state & the_bit):
                    cur_state = (cur_state * cur_mult + cur_plus) & mask
                    distance |= the_bit
                assert (target & the_bit) == (cur_state & the_bit)
                the_bit = (the_bit << 1) & mask
                cur_plus = (cur_plus * (cur_mult + 1)) & mask
                cur_mult = (cur_mult * cur_mult) & mask
            return distance
        finally:
            np.seterr(**old)


# ---------------------------------------------------------------------------
# Device PCG32: uint64 emulated as (hi, lo) uint32 pairs
# ---------------------------------------------------------------------------

_MULT_HI = jnp.uint32(0x5851F42D)
_MULT_LO = jnp.uint32(0x4C957F2D)
_STATE_HI = jnp.uint32(0x853C49E6)
_STATE_LO = jnp.uint32(0x748FEA9B)


def _umul32_wide(a, b):
    """32x32 -> 64 multiply as (hi, lo) uint32, via 16-bit limbs."""
    a = a.astype(jnp.uint32)
    b = b.astype(jnp.uint32)
    mask = jnp.uint32(0xFFFF)
    a0, a1 = a & mask, a >> 16
    b0, b1 = b & mask, b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 16) + (p01 & mask) + (p10 & mask)
    lo = (p00 & mask) | (mid << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def _add64(a_hi, a_lo, b_hi, b_lo):
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(jnp.uint32)
    hi = a_hi + b_hi + carry
    return hi, lo


def _mul64(a_hi, a_lo, b_hi, b_lo):
    hi, lo = _umul32_wide(a_lo, b_lo)
    hi = hi + a_hi * b_lo + a_lo * b_hi
    return hi, lo


def pcg32_step(state_hi, state_lo, inc_hi, inc_lo):
    """One PCG32 step on uint32-pair state.

    Returns ``(new_hi, new_lo, output_u32)``; semantics of rng.rs:62-76.
    """
    old_hi, old_lo = state_hi, state_lo
    nh, nl = _mul64(old_hi, old_lo, _MULT_HI, _MULT_LO)
    nh, nl = _add64(nh, nl, inc_hi, inc_lo)
    # x = oldstate >> 18 (64-bit)
    x_lo = (old_lo >> 18) | (old_hi << 14)
    x_hi = old_hi >> 18
    # x ^= oldstate
    x_lo = x_lo ^ old_lo
    x_hi = x_hi ^ old_hi
    # xorshifted = u32(x >> 27)
    xorshifted = (x_lo >> 27) | (x_hi << 5)
    rot = old_hi >> 27  # == oldstate >> 59
    out = (xorshifted >> rot) | (xorshifted << ((jnp.uint32(32) - rot) & 31))
    return nh, nl, out


def pcg32_init(seq_hi, seq_lo):
    """Vectorized ``set_sequence`` (rng.rs:53-59) on uint32 pairs.

    Returns ``(state_hi, state_lo, inc_hi, inc_lo)`` ready for
    :func:`pcg32_step`.
    """
    seq_hi = jnp.asarray(seq_hi, jnp.uint32)
    seq_lo = jnp.asarray(seq_lo, jnp.uint32)
    inc_hi = (seq_hi << 1) | (seq_lo >> 31)
    inc_lo = (seq_lo << 1) | jnp.uint32(1)
    zero = jnp.zeros_like(inc_lo)
    sh, sl, _ = pcg32_step(zero, zero, inc_hi, inc_lo)
    sh, sl = _add64(sh, sl, jnp.broadcast_to(_STATE_HI, sh.shape), jnp.broadcast_to(_STATE_LO, sl.shape))
    sh, sl, _ = pcg32_step(sh, sl, inc_hi, inc_lo)
    return sh, sl, inc_hi, inc_lo


def u32_to_float(bits):
    """Map uint32 -> [0, 1) float like rng.rs:89-93."""
    f = bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)
    return jnp.minimum(jnp.float32(ONE_MINUS_EPSILON), f)


# ---------------------------------------------------------------------------
# Counter-based hashes for stateless per-lane decorrelation
# ---------------------------------------------------------------------------


def hash_u32(x):
    """Finalizer-style integer hash (lowbias32 by W. Hash prospector)."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def hash_combine(*xs):
    """Hash an arbitrary number of uint32 keys into one uint32."""
    h = jnp.uint32(0x9E3779B9)
    for x in xs:
        h = hash_u32(h ^ jnp.asarray(x, jnp.uint32) + jnp.uint32(0x9E3779B9) + (h << 6) + (h >> 2))
    return h


def pcg3d(x, y, z):
    """pcg3d hash (Jarzynski & Olano 2020): 3 u32 in, 3 u32 out."""
    v0 = jnp.asarray(x, jnp.uint32)
    v1 = jnp.asarray(y, jnp.uint32)
    v2 = jnp.asarray(z, jnp.uint32)
    m = jnp.uint32(1664525)
    a = jnp.uint32(1013904223)
    v0 = v0 * m + a
    v1 = v1 * m + a
    v2 = v2 * m + a
    v0 += v1 * v2
    v1 += v2 * v0
    v2 += v0 * v1
    v0 ^= v0 >> 16
    v1 ^= v1 >> 16
    v2 ^= v2 >> 16
    v0 += v1 * v2
    v1 += v2 * v0
    v2 += v0 * v1
    return v0, v1, v2
