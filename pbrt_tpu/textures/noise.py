"""Procedural noise textures (pbrt-v3 §10.6): fbm, wrinkled, windy, marble,
dots.

Noise is hash-based gradient (Perlin-style) noise — instead of the classic
256-entry permutation table we derive lattice gradients from a counter hash
(pcg3d), which vectorizes cleanly and needs no table gathers.
The gradient selection and smootherstep weights match pbrt-v3's Grad/
NoiseWeight so the statistical character is the same.
"""

from __future__ import annotations

import jax.numpy as jnp

from pbrt_tpu.core.rng import pcg3d


def _grad(ix, iy, iz, dx, dy, dz):
    h, _, _ = pcg3d(ix.astype(jnp.uint32), iy.astype(jnp.uint32), iz.astype(jnp.uint32))
    h = h & 15
    u = jnp.where(h < 8, dx, dy)
    v = jnp.where(h < 4, dy, jnp.where((h == 12) | (h == 14), dx, dz))
    u = jnp.where(h & 1, -u, u)
    v = jnp.where(h & 2, -v, v)
    return u + v


def _noise_weight(t):
    t3 = t * t * t
    t4 = t3 * t
    return 6.0 * t4 * t - 15.0 * t4 + 10.0 * t3


def noise3(p):
    """Gradient noise at [..., 3] points; output roughly in [-1, 1]."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    ix = jnp.floor(x)
    iy = jnp.floor(y)
    iz = jnp.floor(z)
    dx, dy, dz = x - ix, y - iy, z - iz
    ixi = ix.astype(jnp.int32)
    iyi = iy.astype(jnp.int32)
    izi = iz.astype(jnp.int32)

    def g(ox, oy, oz):
        return _grad(ixi + ox, iyi + oy, izi + oz, dx - ox, dy - oy, dz - oz)

    w000 = g(0, 0, 0)
    w100 = g(1, 0, 0)
    w010 = g(0, 1, 0)
    w110 = g(1, 1, 0)
    w001 = g(0, 0, 1)
    w101 = g(1, 0, 1)
    w011 = g(0, 1, 1)
    w111 = g(1, 1, 1)
    wx = _noise_weight(dx)
    wy = _noise_weight(dy)
    wz = _noise_weight(dz)
    x00 = w000 + wx * (w100 - w000)
    x10 = w010 + wx * (w110 - w010)
    x01 = w001 + wx * (w101 - w001)
    x11 = w011 + wx * (w111 - w011)
    y0 = x00 + wy * (x10 - x00)
    y1 = x01 + wy * (x11 - x01)
    return y0 + wz * (y1 - y0)


def fbm(p, omega=0.5, max_octaves=8, octaves=None):
    """Fractional Brownian motion: sum of noise octaves (pbrt-v3 FBm)."""
    n = int(octaves if octaves is not None else max_octaves)
    total = jnp.zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(n):
        total = total + o * noise3(p * lam)
        lam *= 1.99
        o *= omega
    return total


def turbulence(p, omega=0.5, max_octaves=8, octaves=None):
    n = int(octaves if octaves is not None else max_octaves)
    total = jnp.zeros(p.shape[:-1])
    lam, o = 1.0, 1.0
    for _ in range(n):
        total = total + o * jnp.abs(noise3(p * lam))
        lam *= 1.99
        o *= omega
    return total


class FBmTexture:
    def __init__(self, mapping3d, octaves=8, roughness=0.5):
        self.mapping = mapping3d
        self.octaves = int(octaves)
        self.roughness = float(roughness)

    def eval(self, si):
        p = self.mapping.map(si)
        return fbm(p, self.roughness, octaves=self.octaves)


class WrinkledTexture:
    def __init__(self, mapping3d, octaves=8, roughness=0.5):
        self.mapping = mapping3d
        self.octaves = int(octaves)
        self.roughness = float(roughness)

    def eval(self, si):
        p = self.mapping.map(si)
        return turbulence(p, self.roughness, octaves=self.octaves)


class WindyTexture:
    """windy waves: fbm(0.1p) * |fbm(p)| (pbrt-v3 §10.6.5)."""

    def __init__(self, mapping3d):
        self.mapping = mapping3d

    def eval(self, si):
        p = self.mapping.map(si)
        wind_strength = fbm(0.1 * p, 0.5, octaves=3)
        wave_height = fbm(p, 0.5, octaves=6)
        return jnp.abs(wind_strength) * wave_height


class MarbleTexture:
    """Marble via sine-perturbed turbulence mapped through a spline palette."""

    _C = jnp.array(
        [
            [0.58, 0.58, 0.6],
            [0.58, 0.58, 0.6],
            [0.58, 0.58, 0.6],
            [0.5, 0.5, 0.5],
            [0.6, 0.59, 0.58],
            [0.58, 0.58, 0.6],
            [0.58, 0.58, 0.6],
            [0.2, 0.2, 0.33],
            [0.58, 0.58, 0.6],
        ]
    )

    def __init__(self, mapping3d, octaves=8, roughness=0.5, scale=1.0, variation=0.2):
        self.mapping = mapping3d
        self.octaves = int(octaves)
        self.roughness = float(roughness)
        self.scale = float(scale)
        self.variation = float(variation)

    def eval(self, si):
        p = self.mapping.map(si) * self.scale
        marble = self.variation * fbm(p, self.roughness, octaves=self.octaves)
        t = 0.5 + 0.5 * jnp.sin(self.scale * p[..., 1] + marble)
        # cubic-ish spline through the palette
        nc = self._C.shape[0]
        f = jnp.clip(t, 0.0, 1.0) * (nc - 3)
        i = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, nc - 4)
        u = (f - i)[..., None]
        c0 = self._C[i]
        c1 = self._C[i + 1]
        c2 = self._C[i + 2]
        c3 = self._C[i + 3]
        s0 = (1 - u) * c1 + u * c2
        s1 = (1 - u) * ((1 - u) * c0 + u * c1) + u * ((1 - u) * c1 + u * c2)
        s2 = (1 - u) * ((1 - u) * c1 + u * c2) + u * ((1 - u) * c2 + u * c3)
        return 1.5 * ((1 - u) * s1 + u * s2) * 0.5 + 0.25 * s0 * 0.0


class DotsTexture:
    """Polka dots: inside-tex where a hashed per-cell dot covers (s,t)."""

    def __init__(self, mapping, inside_tex, outside_tex):
        self.mapping = mapping
        self.inside = inside_tex
        self.outside = outside_tex

    def eval(self, si):
        from pbrt_tpu.core.rng import hash_u32, u32_to_float

        s, t = self.mapping.map(si)
        s_cell = jnp.floor(s + 0.5).astype(jnp.int32)
        t_cell = jnp.floor(t + 0.5).astype(jnp.int32)
        key = (s_cell.astype(jnp.uint32) * jnp.uint32(9973)) ^ t_cell.astype(jnp.uint32)
        has_dot = u32_to_float(hash_u32(key)) < 0.5
        cs = s_cell + (u32_to_float(hash_u32(key + jnp.uint32(1))) - 0.5) * 0.5
        ct = t_cell + (u32_to_float(hash_u32(key + jnp.uint32(2))) - 0.5) * 0.5
        radius = 0.35
        ds, dt = s - cs, t - ct
        inside = has_dot & (ds * ds + dt * dt < radius * radius)
        vi = self.inside.eval(si)
        vo = self.outside.eval(si)
        if vi.ndim > inside.ndim:
            inside = inside[..., None]
        return jnp.where(inside, vi, vo)
