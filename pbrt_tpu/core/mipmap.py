"""MIPMap: image pyramid with device-side filtered lookup.

Completes the reference's stub (/root/reference/src/core/mipmap.rs:54-67):
``ImageWrap`` repeat/black/clamp modes (mipmap.rs:22-30), a power-of-two
pyramid built on host, trilinear device lookup, and the 128-entry EWA
weight LUT with alpha=2 (mipmap.rs:43-52) for anisotropic filtering.

Device design: the pyramid is packed into a single flat device array plus
per-level (offset, w, h) tables, so one gather kernel serves every level —
no Python-level branching inside jit.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import float_t

WRAP_REPEAT = 0
WRAP_BLACK = 1
WRAP_CLAMP = 2

WRAP_NAMES = {"repeat": WRAP_REPEAT, "black": WRAP_BLACK, "clamp": WRAP_CLAMP}

EWA_LUT_SIZE = 128
# alpha=2 Gaussian LUT (mipmap.rs:43-52)
_EWA_ALPHA = 2.0
EWA_WEIGHT_LUT = np.exp(
    -_EWA_ALPHA * (np.arange(EWA_LUT_SIZE, dtype=np.float64) / (EWA_LUT_SIZE - 1))
) - np.exp(-_EWA_ALPHA)
EWA_WEIGHT_LUT = EWA_WEIGHT_LUT.astype(float_t)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _resample_pow2(img: np.ndarray) -> np.ndarray:
    """Resize [H,W,C] to power-of-two dims with a separable tent filter."""
    h, w, c = img.shape
    nw, nh = _next_pow2(w), _next_pow2(h)
    if (nw, nh) == (w, h):
        return img

    def resample_axis(a, new_n, axis):
        old_n = a.shape[axis]
        if old_n == new_n:
            return a
        # Linear interpolation at sample centers
        x = (np.arange(new_n) + 0.5) * old_n / new_n - 0.5
        x0 = np.clip(np.floor(x).astype(int), 0, old_n - 1)
        x1 = np.clip(x0 + 1, 0, old_n - 1)
        t = np.clip(x - x0, 0.0, 1.0)
        a0 = np.take(a, x0, axis=axis)
        a1 = np.take(a, x1, axis=axis)
        shape = [1] * a.ndim
        shape[axis] = new_n
        t = t.reshape(shape)
        return (1 - t) * a0 + t * a1

    img = resample_axis(img, nh, 0)
    img = resample_axis(img, nw, 1)
    return img


class MIPMap:
    """Image pyramid; channels = 1 (float tex) or 3 (spectrum tex)."""

    def __init__(self, image: np.ndarray, wrap: int = WRAP_REPEAT,
                 do_trilinear: bool = True, max_anisotropy: float = 8.0):
        img = np.asarray(image, dtype=np.float64)
        if img.ndim == 2:
            img = img[..., None]
        img = _resample_pow2(img)
        self.wrap = wrap
        self.do_trilinear = do_trilinear
        self.max_anisotropy = max_anisotropy
        self.channels = img.shape[-1]

        levels = [img]
        while levels[-1].shape[0] > 1 or levels[-1].shape[1] > 1:
            prev = levels[-1]
            h, w = prev.shape[:2]
            nh, nw = max(1, h // 2), max(1, w // 2)
            ds = prev[: nh * 2, : nw * 2].reshape(nh, 2, nw, 2, -1).mean(axis=(1, 3))
            levels.append(ds)
        self.n_levels = len(levels)
        self.sizes = [(l.shape[1], l.shape[0]) for l in levels]  # (w, h)

        # Flat-packed pyramid for single-gather device lookup
        offsets = []
        off = 0
        flat = []
        for l in levels:
            offsets.append(off)
            flat.append(l.reshape(-1, self.channels))
            off += l.shape[0] * l.shape[1]
        self._flat = jnp.asarray(np.concatenate(flat, axis=0).astype(float_t))
        self._offsets = jnp.asarray(np.array(offsets, dtype=np.int32))
        self._widths = jnp.asarray(np.array([s[0] for s in self.sizes], dtype=np.int32))
        self._heights = jnp.asarray(np.array([s[1] for s in self.sizes], dtype=np.int32))

    # -- device lookup -----------------------------------------------------
    # All lookups accept ``flat``: an override of the packed pyramid array
    # (same shape as self._flat).  Passing a differentiable array here makes
    # texel values gradient targets (inverse rendering of textures).

    def _wrap_coords(self, i, n):
        if self.wrap == WRAP_REPEAT:
            return jnp.mod(i, n), jnp.ones_like(i, dtype=bool)
        if self.wrap == WRAP_CLAMP:
            return jnp.clip(i, 0, n - 1), jnp.ones_like(i, dtype=bool)
        valid = (i >= 0) & (i < n)
        return jnp.clip(i, 0, n - 1), valid

    def _texel(self, level, s_idx, t_idx, flat=None):
        """Gather texels at integer coords for per-lane levels [N]."""
        w = self._widths[level]
        h = self._heights[level]
        off = self._offsets[level]
        si, s_ok = self._wrap_coords(s_idx, w)
        ti, t_ok = self._wrap_coords(t_idx, h)
        idx = off + ti * w + si
        src = self._flat if flat is None else flat
        tex = src[idx]
        ok = (s_ok & t_ok)[..., None]
        return jnp.where(ok, tex, 0.0)

    def _bilerp(self, level, s, t, flat=None):
        """Bilinear lookup at continuous (s,t) in [0,1] for level [N]."""
        w = self._widths[level].astype(float_t)
        h = self._heights[level].astype(float_t)
        fs = s * w - 0.5
        ft = t * h - 0.5
        s0 = jnp.floor(fs).astype(jnp.int32)
        t0 = jnp.floor(ft).astype(jnp.int32)
        ds = (fs - s0)[..., None]
        dt = (ft - t0)[..., None]
        return (
            (1 - ds) * (1 - dt) * self._texel(level, s0, t0, flat)
            + (1 - ds) * dt * self._texel(level, s0, t0 + 1, flat)
            + ds * (1 - dt) * self._texel(level, s0 + 1, t0, flat)
            + ds * dt * self._texel(level, s0 + 1, t0 + 1, flat)
        )

    def lookup(self, s, t, width=None, flat=None):
        """Trilinear filtered lookup; ``width`` is the filter footprint in
        [0,1] texture space per lane (None -> finest level)."""
        s = jnp.asarray(s)
        t = jnp.asarray(t)
        if width is None:
            lvl = jnp.zeros(s.shape, dtype=jnp.int32)
            out = self._bilerp(lvl, s, t, flat)
        else:
            width = jnp.maximum(jnp.asarray(width), 1e-8)
            level = self.n_levels - 1 + jnp.log2(width)
            level = jnp.clip(level, 0.0, self.n_levels - 1 - 1e-4)
            l0 = jnp.floor(level).astype(jnp.int32)
            dl = (level - l0)[..., None]
            out = (1 - dl) * self._bilerp(l0, s, t, flat) + dl * self._bilerp(
                jnp.minimum(l0 + 1, self.n_levels - 1), s, t, flat
            )
        if self.channels == 1:
            return out[..., 0]
        return out

    def lookup_aniso(self, s, t, duvdx, duvdy, flat=None, taps=4):
        """Anisotropic lookup: EWA-LUT-weighted taps along the major axis.

        The footprint ellipse axes are the uv-space differentials
        (duvdx/duvdy [N,2]); the level is chosen from the MINOR axis
        (clamped by ``max_anisotropy``, mipmap.rs:38-40 fields) and
        ``taps`` trilinear samples are distributed along the MAJOR axis
        weighted by the alpha=2 Gaussian ``EWA_WEIGHT_LUT``
        (/root/reference/src/core/mipmap.rs:43-52).  Fixed tap count keeps
        the kernel branch-free and jit-static — the device formulation of
        pbrt's variable-texel EWA loop.
        """
        s = jnp.asarray(s)
        t = jnp.asarray(t)
        lx = jnp.linalg.norm(duvdx, axis=-1)
        ly = jnp.linalg.norm(duvdy, axis=-1)
        major_is_x = lx >= ly
        major = jnp.where(major_is_x[..., None], duvdx, duvdy)
        major_len = jnp.maximum(lx, ly)
        minor_len = jnp.minimum(lx, ly)
        minor_len = jnp.maximum(minor_len, major_len / self.max_anisotropy)
        width = jnp.maximum(minor_len, 1e-8)
        level = jnp.clip(
            self.n_levels - 1 + jnp.log2(width), 0.0, self.n_levels - 1 - 1e-4
        )
        l0 = jnp.floor(level).astype(jnp.int32)
        dl = (level - l0)[..., None]
        l1 = jnp.minimum(l0 + 1, self.n_levels - 1)

        acc = 0.0
        wsum = 0.0
        for i in range(taps):
            f = (i + 0.5) / taps - 0.5  # static offsets in [-0.5, 0.5)
            r2 = min((2.0 * f) ** 2, 1.0)
            w = float(EWA_WEIGHT_LUT[int(r2 * (EWA_LUT_SIZE - 1))])
            ss = s + major[..., 0] * f
            tt = t + major[..., 1] * f
            val = (1 - dl) * self._bilerp(l0, ss, tt, flat) + dl * self._bilerp(
                l1, ss, tt, flat
            )
            acc = acc + w * val
            wsum = wsum + w
        out = acc / wsum
        if self.channels == 1:
            return out[..., 0]
        return out
