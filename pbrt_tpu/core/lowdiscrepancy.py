"""Low-discrepancy sequence machinery (pbrt-v3 ch. 7).

Everything here is a *pure function of (index, dimension, seed)* — never of
device id — which is the determinism contract that makes renders bit-stable
across shardings (SURVEY.md §5).

Pieces:

* prime table + radical inverse in arbitrary bases (device, fori_loop with
  a static digit bound per base);
* base-2 Sobol' with direction matrices and Owen scrambling via the
  Laine-Karras hash — the device-friendly workhorse;
* a Sobol' direction-number **generator**: the reference embeds pbrt's
  60k-line constant table (src/core/sobolmatrices.rs, from Joe & Kuo data
  we neither have nor copy).  Instead we *derive* direction numbers: find
  primitive polynomials over GF(2) by exhaustive primitivity testing and
  draw the free odd initial values m_i from seeded PCG32.  Any such choice
  yields a valid digital (t,s)-sequence (Sobol' 1967; Bratley & Fox 1988);
  table quality differs from Joe-Kuo but correctness and convergence order
  do not.  Generated once and cached to ``pbrt_tpu/data/sobol_v32.npy``.
"""

from __future__ import annotations

import math
import os
from pathlib import Path

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu.core.rng import Rng

# ---------------------------------------------------------------------------
# Primes (host-generated; pbrt ships a 1000-entry table)
# ---------------------------------------------------------------------------


def _sieve(n: int) -> np.ndarray:
    is_p = np.ones(n, dtype=bool)
    is_p[:2] = False
    for i in range(2, int(n**0.5) + 1):
        if is_p[i]:
            is_p[i * i :: i] = False
    return np.nonzero(is_p)[0]


PRIMES = _sieve(8200)[:1024].astype(np.int64)  # >= 1024 prime bases


def _max_digits(base: int) -> int:
    """Digits needed to exhaust a 32-bit index in ``base``."""
    return int(math.ceil(32.0 / math.log2(base))) + 1


def radical_inverse(base_index: int, n, index_bound: int | None = None):
    """Radical inverse of uint32 ``n`` in the ``base_index``-th prime base.

    Device function; the digit loop bound is static per base.
    """
    base = int(PRIMES[base_index])
    n = jnp.asarray(n, jnp.uint32)
    if base == 2:
        # bit reversal
        v = n
        v = ((v >> 16) | (v << 16)).astype(jnp.uint32)
        v = ((v & jnp.uint32(0x00FF00FF)) << 8) | ((v & jnp.uint32(0xFF00FF00)) >> 8)
        v = ((v & jnp.uint32(0x0F0F0F0F)) << 4) | ((v & jnp.uint32(0xF0F0F0F0)) >> 4)
        v = ((v & jnp.uint32(0x33333333)) << 2) | ((v & jnp.uint32(0xCCCCCCCC)) >> 2)
        v = ((v & jnp.uint32(0x55555555)) << 1) | ((v & jnp.uint32(0xAAAAAAAA)) >> 1)
        return v.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10)

    inv_base = np.float32(1.0 / base)
    digits = _max_digits(base)
    if index_bound is not None and index_bound >= 1:
        # n < index_bound needs only ceil(log_base(bound)) digits — the
        # higher digits are zero, so the value is IDENTICAL.  A render
        # wave's sample indices are bounded by spp, cutting the base-3..19
        # digit chains from ~20 to 2-6 each (~5x sampler cost).
        k, p = 1, base
        while p < index_bound and k < digits:
            p *= base
            k += 1
        digits = k

    # accumulate digit_k * base^-(k+1) in float — an integer digit-reversal
    # accumulator overflows uint32 after ~20 base-3 digits.
    # On device the digit loop is UNROLLED (static count) so it fuses into the
    # surrounding kernel; a lax.fori_loop would bounce the [N] carry through
    # HBM once per digit.  On CPU unrolling only bloats XLA compile time, so
    # keep the rolled loop there (identical arithmetic, identical results).
    if jax.default_backend() == "cpu":
        def body(i, carry):
            val, scale, rem = carry
            digit = (rem % base).astype(jnp.float32)
            scale = scale * inv_base
            val = val + digit * scale
            rem = rem // base
            return val, scale, rem

        val, _, _ = jax.lax.fori_loop(
            0, digits,
            body,
            (jnp.zeros(n.shape, jnp.float32), jnp.float32(1.0), n),
        )
        return jnp.minimum(val, jnp.float32(0.99999994))
    val = jnp.zeros(n.shape, dtype=jnp.float32)
    scale = 1.0
    rem = n
    for _ in range(digits):
        digit = (rem % base).astype(jnp.float32)
        scale = scale * float(inv_base)
        val = val + digit * scale
        rem = rem // base
    return jnp.minimum(val, jnp.float32(0.99999994))


def scrambled_radical_inverse(base_index: int, n, rotation, index_bound=None):
    """Cranley-Patterson rotated radical inverse; rotation in [0,1)."""
    u = radical_inverse(base_index, n, index_bound)
    u = u + rotation
    return jnp.where(u >= 1.0, u - 1.0, u)


# ---------------------------------------------------------------------------
# Sobol' direction-number generation (host, cached)
# ---------------------------------------------------------------------------

_DATA_DIR = Path(__file__).resolve().parent.parent / "data"
N_SOBOL_DIMENSIONS = 1024
SOBOL_BITS = 32


def _primitive_polynomials(count: int):
    """First ``count`` primitive polynomials over GF(2), ordered by degree.

    A degree-d polynomial (bitmask with implicit leading 1) is primitive iff
    it is irreducible and x has multiplicative order 2^d - 1 in GF(2)[x]/(p).
    """

    def polymul_mod(a, b, p, d):
        # multiply field elements a*b mod p where p has degree d
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> d & 1:
                a ^= p | (1 << d)
        return r

    def prime_factors(n):
        fs = set()
        f = 2
        while f * f <= n:
            while n % f == 0:
                fs.add(f)
                n //= f
            f += 1
        if n > 1:
            fs.add(n)
        return fs

    def x_pow(e, p, d):
        # compute x^e in GF(2^d) with modulus p (square-and-multiply)
        result = 1
        base = 2  # 'x'
        while e:
            if e & 1:
                result = polymul_mod(result, base, p, d)
            base = polymul_mod(base, base, p, d)
            e >>= 1
        return result

    out = []
    degree = 1
    while len(out) < count:
        order = (1 << degree) - 1
        factors = prime_factors(order) if order > 1 else set()
        for low in range(1 << degree):
            if not (low & 1):
                continue  # constant term must be 1
            p = low  # implicit leading term x^degree
            # primitivity: x^order == 1 and x^(order/q) != 1 for primes q
            if degree == 1:
                # both x+1 (p=1... low bits) handled: order=1, trivially ok
                ok = True
            else:
                if x_pow(order, p, degree) != 1:
                    continue
                ok = all(x_pow(order // q, p, degree) != 1 for q in factors)
            if ok:
                out.append((degree, p))
                if len(out) == count:
                    break
        degree += 1
    return out


def _generate_sobol_matrices(n_dims: int = N_SOBOL_DIMENSIONS) -> np.ndarray:
    """[n_dims, 32] uint32 direction vectors v_{j,i} (MSB-aligned)."""
    v = np.zeros((n_dims, SOBOL_BITS), dtype=np.uint64)
    # dimension 0: van der Corput — v_i = 2^(31-i)
    for i in range(SOBOL_BITS):
        v[0, i] = 1 << (31 - i)
    polys = _primitive_polynomials(n_dims - 1)
    rng = Rng(0x5B01)  # deterministic free-parameter draws
    for j, (d, low_bits) in enumerate(polys, start=1):
        # initial odd m_i < 2^i
        m = [0] * (SOBOL_BITS + 1)
        for i in range(1, d + 1):
            m[i] = 2 * rng.uniform_u32_threshold(max(1, 1 << (i - 1))) + 1
        # coefficients a_1..a_{d-1} from low_bits (a_d term folds via 2^d m_{i-d})
        a = [(low_bits >> (d - 1 - k)) & 1 for k in range(d - 1)]
        for i in range(d + 1, SOBOL_BITS + 1):
            val = m[i - d] ^ ((1 << d) * m[i - d])
            for k in range(1, d):
                if a[k - 1]:
                    val ^= (1 << k) * m[i - k]
            m[i] = val
        for i in range(1, SOBOL_BITS + 1):
            v[j, i - 1] = m[i] << (32 - i)
    return v.astype(np.uint32)


_SOBOL_V = None


def sobol_matrices() -> np.ndarray:
    """Direction vectors [1024, 32] uint32, cached on disk."""
    global _SOBOL_V
    if _SOBOL_V is not None:
        return _SOBOL_V
    path = _DATA_DIR / "sobol_v32.npy"
    if path.exists():
        _SOBOL_V = np.load(path)
    else:
        _SOBOL_V = _generate_sobol_matrices()
        _DATA_DIR.mkdir(parents=True, exist_ok=True)
        np.save(path, _SOBOL_V)
    return _SOBOL_V


def sobol_sample_u32(index, dim_matrix):
    """Sobol' sample bits: XOR of direction vectors where index bit set.

    index: [N] uint32 device array; dim_matrix: [32] uint32 (device).
    """
    index = jnp.asarray(index, jnp.uint32)
    if jax.default_backend() == "cpu":
        def body(i, acc):
            bit = (index >> i) & jnp.uint32(1)
            return acc ^ jnp.where(bit.astype(bool), dim_matrix[i], jnp.uint32(0))

        return jax.lax.fori_loop(0, SOBOL_BITS, body, jnp.zeros_like(index))
    # Device: unrolled (32 static steps) so the XOR chain fuses into one kernel
    acc = jnp.zeros(index.shape, dtype=jnp.uint32)
    for i in range(SOBOL_BITS):
        bit = (index >> i) & jnp.uint32(1)
        acc = acc ^ jnp.where(bit.astype(bool), dim_matrix[i], jnp.uint32(0))
    return acc


def owen_scramble_u32(x, seed):
    """Laine-Karras-style Owen scrambling of reversed-bit Sobol values.

    x: uint32 sample bits (MSB-aligned); seed: uint32 per-lane/dimension.
    Reference: Laine & Karras 2011, "Stratified sampling for stochastic
    transparency"; Burley 2020 practical hash version.
    """
    x = jnp.asarray(x, jnp.uint32)

    def reverse_bits(v):
        v = ((v >> 16) | (v << 16)).astype(jnp.uint32)
        v = ((v & jnp.uint32(0x00FF00FF)) << 8) | ((v & jnp.uint32(0xFF00FF00)) >> 8)
        v = ((v & jnp.uint32(0x0F0F0F0F)) << 4) | ((v & jnp.uint32(0xF0F0F0F0)) >> 4)
        v = ((v & jnp.uint32(0x33333333)) << 2) | ((v & jnp.uint32(0xCCCCCCCC)) >> 2)
        v = ((v & jnp.uint32(0x55555555)) << 1) | ((v & jnp.uint32(0xAAAAAAAA)) >> 1)
        return v

    v = reverse_bits(x)
    v = v + seed
    v = v ^ (v * jnp.uint32(0x6C50B47C))
    v = v ^ (v * jnp.uint32(0xB82F1E52))
    v = v ^ (v * jnp.uint32(0xC7AFE638))
    v = v ^ (v * jnp.uint32(0x8D22F6E6))
    return reverse_bits(v)


def u32_to_unit_float(bits):
    return jnp.minimum(
        bits.astype(jnp.float32) * jnp.float32(2.3283064365386963e-10),
        jnp.float32(0.99999994),
    )
