"""Monte-Carlo sampling utilities and distributions (pbrt-v3 ch. 13).

The reference's sampling.rs is an empty ``Distribution2D`` stub
(sampling.rs:17-19); here both Distribution1D and Distribution2D are real,
stored as prefix-sum CDF device arrays sampled with
``jnp.searchsorted`` — a vectorized binary search, the natural device mapping
of pbrt's per-call ``FindInterval``.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import INV_2PI, INV_4PI, PI, PI_OVER_2, PI_OVER_4, float_t


# ---------------------------------------------------------------------------
# Fast trig for warps
# ---------------------------------------------------------------------------

# Cephes sinf/cosf quarter-wave kernels (|r| <= pi/4, abs err ~1e-7)
_S3, _S5, _S7 = -1.6666654611e-1, 8.3321608736e-3, -1.9515295891e-4
_C4, _C6, _C8 = 4.166664568298827e-2, -1.388731625493765e-3, 2.443315711809948e-5


def fast_sincos(t):
    """(sin t, cos t) for |t| <= ~pi via quadrant folding + quarter-wave
    polynomials.

    ``jnp.sin``/``jnp.cos`` lower to full-range libm expansions;
    Monte-Carlo warps only need f32 distribution accuracy, so the ~15-op
    polynomial is enough on the hot path."""
    q = jnp.round(t * (2.0 / PI))
    r = t - q * (PI / 2)
    z = r * r
    sin_r = r * (1.0 + z * (_S3 + z * (_S5 + z * _S7)))
    cos_r = 1.0 + z * (-0.5 + z * (_C4 + z * (_C6 + z * _C8)))
    qi = q.astype(jnp.int32) & 3  # two's-complement & maps -1 -> 3, -2 -> 2
    swap = (qi & 1) == 1
    s = jnp.where(swap, cos_r, sin_r)
    c = jnp.where(swap, sin_r, cos_r)
    s = jnp.where((qi == 2) | (qi == 3), -s, s)
    c = jnp.where((qi == 1) | (qi == 2), -c, c)
    return s, c


def sincos_2pi(u):
    """(sin 2*pi*u, cos 2*pi*u) for u in [0, 1) (periodic fold to [-pi, pi])."""
    t = (u - jnp.round(u)) * (2.0 * PI)
    return fast_sincos(t)


# ---------------------------------------------------------------------------
# Warps (batched; u is [..., 2] or [...])
# ---------------------------------------------------------------------------


def uniform_sample_hemisphere(u):
    z = u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    s, c = sincos_2pi(u[..., 1])
    return jnp.stack([r * c, r * s, z], axis=-1)


def uniform_hemisphere_pdf():
    return INV_2PI


def uniform_sample_sphere(u):
    z = 1.0 - 2.0 * u[..., 0]
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    s, c = sincos_2pi(u[..., 1])
    return jnp.stack([r * c, r * s, z], axis=-1)


def uniform_sphere_pdf():
    return INV_4PI


def concentric_sample_disk(u):
    """Shirley-Chiu concentric disk warp, branchless (pbrt-v3 §13.6.2)."""
    ox = 2.0 * u[..., 0] - 1.0
    oy = 2.0 * u[..., 1] - 1.0
    zero = (ox == 0.0) & (oy == 0.0)
    use_x = jnp.abs(ox) > jnp.abs(oy)
    r = jnp.where(use_x, ox, oy)
    theta = jnp.where(
        use_x,
        PI_OVER_4 * (oy / jnp.where(ox == 0.0, 1.0, ox)),
        PI_OVER_2 - PI_OVER_4 * (ox / jnp.where(oy == 0.0, 1.0, oy)),
    )
    sth, cth = fast_sincos(theta)  # theta in [-pi/4, 3pi/4]
    x = r * cth
    y = r * sth
    return jnp.where(zero[..., None], 0.0, jnp.stack([x, y], axis=-1))


def cosine_sample_hemisphere(u):
    d = concentric_sample_disk(u)
    z = jnp.sqrt(jnp.maximum(0.0, 1.0 - d[..., 0] ** 2 - d[..., 1] ** 2))
    return jnp.stack([d[..., 0], d[..., 1], z], axis=-1)


def cosine_hemisphere_pdf(cos_theta):
    return cos_theta / PI


def uniform_sample_cone(u, cos_theta_max):
    cos_theta = (1.0 - u[..., 0]) + u[..., 0] * cos_theta_max
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    s, c = sincos_2pi(u[..., 1])
    return jnp.stack([c * sin_theta, s * sin_theta, cos_theta], axis=-1)


def uniform_cone_pdf(cos_theta_max):
    return 1.0 / (2 * PI * jnp.maximum(1.0 - cos_theta_max, 1e-9))


def uniform_sample_triangle(u):
    su0 = jnp.sqrt(u[..., 0])
    return jnp.stack([1.0 - su0, u[..., 1] * su0], axis=-1)


def power_heuristic(nf, f_pdf, ng, g_pdf):
    """Beta=2 power heuristic for MIS (pbrt-v3 §13.10.1)."""
    f = nf * f_pdf
    g = ng * g_pdf
    denom = f * f + g * g
    return jnp.where(denom > 0.0, f * f / jnp.where(denom == 0.0, 1.0, denom), 0.0)


# ---------------------------------------------------------------------------
# Distributions (CDF tables, device binary search)
# ---------------------------------------------------------------------------


class Distribution1D:
    """Piecewise-constant 1D distribution over [0, 1]."""

    def __init__(self, func):
        f = np.maximum(np.asarray(func, dtype=np.float64), 0.0)
        n = len(f)
        cdf = np.concatenate([[0.0], np.cumsum(f)])
        total = cdf[-1]
        if total == 0.0:
            cdf = np.linspace(0.0, 1.0, n + 1)
            total = 1.0 / n  # uniform fallback, func_int = avg
            f = np.full(n, 1.0 / n)
            self.func_int = 1.0 / n
        else:
            cdf = cdf / total
            self.func_int = total / n
        self.n = n
        self.func_np = f.astype(float_t)
        self.cdf_np = cdf.astype(float_t)
        self.func = jnp.asarray(self.func_np)
        self.cdf = jnp.asarray(self.cdf_np)

    def sample_continuous(self, u):
        """Returns (x in [0,1], pdf, offset)."""
        if self.n <= 48:
            # Tiny table (area-light triangle lists, light pickers):
            # comparison-count + where-chains fuse into the surrounding
            # elementwise kernel instead of searchsorted + 3 gathers.
            offset = jnp.zeros(u.shape, jnp.int32)
            for k in range(1, self.n):
                offset = offset + (u >= float(self.cdf_np[k])).astype(jnp.int32)
            from pbrt_tpu.ops.tables import select_values

            c0 = select_values(self.cdf[:-1], offset)
            c1 = select_values(self.cdf[1:], offset)
            pdf = select_values(self.func, offset) / jnp.maximum(
                self.func_int, 1e-20
            )
        else:
            offset = jnp.clip(
                jnp.searchsorted(self.cdf, u, side="right") - 1, 0, self.n - 1
            )
            c0 = self.cdf[offset]
            c1 = self.cdf[offset + 1]
            pdf = self.func[offset] / jnp.maximum(self.func_int, 1e-20)
        du = jnp.where(c1 > c0, (u - c0) / jnp.where(c1 == c0, 1.0, c1 - c0), 0.0)
        x = (offset.astype(float_t) + du) / self.n
        return x, pdf, offset

    def pdf_at(self, x):
        offset = jnp.clip((x * self.n).astype(jnp.int32), 0, self.n - 1)
        if self.n <= 48:
            from pbrt_tpu.ops.tables import select_values

            return select_values(self.func, offset) / jnp.maximum(
                self.func_int, 1e-20
            )
        return self.func[offset] / jnp.maximum(self.func_int, 1e-20)


class Distribution2D:
    """2D distribution: marginal over rows, conditional over columns
    (completes the reference's empty struct, sampling.rs:17-19)."""

    def __init__(self, func2d):
        f = np.maximum(np.asarray(func2d, dtype=np.float64), 0.0)  # [H, W]
        h, w = f.shape
        self.h, self.w = h, w
        row_int = f.sum(axis=1) / w
        # conditional CDFs per row
        cond_cdf = np.concatenate(
            [np.zeros((h, 1)), np.cumsum(f, axis=1)], axis=1
        )
        row_tot = cond_cdf[:, -1:].copy()
        safe_tot = np.where(row_tot == 0.0, 1.0, row_tot)
        cond_cdf = cond_cdf / safe_tot
        uniform_rows = (row_tot[:, 0] == 0.0)
        if uniform_rows.any():
            cond_cdf[uniform_rows] = np.linspace(0.0, 1.0, w + 1)
        # marginal over rows
        marg = row_int
        marg_cdf = np.concatenate([[0.0], np.cumsum(marg)])
        tot = marg_cdf[-1]
        if tot == 0.0:
            marg_cdf = np.linspace(0.0, 1.0, h + 1)
            marg = np.full(h, 1.0 / h)
            tot = 1.0
            self.func_int = 1e-20
        else:
            marg_cdf = marg_cdf / tot
            self.func_int = tot / h
        self.func = jnp.asarray(f.astype(float_t))
        self.row_int = jnp.asarray(np.maximum(row_int, 0.0).astype(float_t))
        self.cond_cdf = jnp.asarray(cond_cdf.astype(float_t))
        self.marg_cdf = jnp.asarray(marg_cdf.astype(float_t))
        self.marg_func = jnp.asarray(marg.astype(float_t))

    def sample_continuous(self, u):
        """u: [...,2] -> ((u,v) in [0,1]^2, pdf)."""
        u0 = u[..., 0]
        u1 = u[..., 1]
        row = jnp.clip(
            jnp.searchsorted(self.marg_cdf, u1, side="right") - 1, 0, self.h - 1
        )
        mc0 = self.marg_cdf[row]
        mc1 = self.marg_cdf[row + 1]
        dv = jnp.where(mc1 > mc0, (u1 - mc0) / jnp.where(mc1 == mc0, 1.0, mc1 - mc0), 0.0)
        pdf_v = self.marg_func[row] / jnp.maximum(self.func_int, 1e-20)
        v = (row.astype(float_t) + dv) / self.h

        # per-lane bisection into this lane's row CDF: O(log W) gathers of
        # [N] values each — never materializes an [N, W] matrix.
        import jax

        n_steps = max(1, int(np.ceil(np.log2(self.w + 1))) + 1)

        def bisect_body(_, lohi):
            lo, hi = lohi
            mid = (lo + hi) // 2
            below = self.cond_cdf[row, mid] <= u0
            lo = jnp.where(below, mid, lo)
            hi = jnp.where(below, hi, mid)
            return lo, hi

        lo0 = jnp.zeros_like(row)
        hi0 = jnp.full_like(row, self.w)
        col, _ = jax.lax.fori_loop(0, n_steps, bisect_body, (lo0, hi0))
        col = jnp.clip(col, 0, self.w - 1)
        cc0 = self.cond_cdf[row, col]
        cc1 = self.cond_cdf[row, col + 1]
        du = jnp.where(cc1 > cc0, (u0 - cc0) / jnp.where(cc1 == cc0, 1.0, cc1 - cc0), 0.0)
        row_integral = jnp.maximum(self.row_int[row], 1e-20)
        pdf_u = self.func[row, col] / row_integral
        uu = (col.astype(float_t) + du) / self.w
        return jnp.stack([uu, v], axis=-1), pdf_u * pdf_v

    def pdf_at(self, uv):
        col = jnp.clip((uv[..., 0] * self.w).astype(jnp.int32), 0, self.w - 1)
        row = jnp.clip((uv[..., 1] * self.h).astype(jnp.int32), 0, self.h - 1)
        return self.func[row, col] / jnp.maximum(self.func_int, 1e-20)
