"""Hair BSDF (Chiang et al. 2016), the model behind pbrt-v3's ``hair`` material.

The reference names no materials at all (wathiede/pbrt has no Material types,
SURVEY.md §0); pbrt-v3 — whose capability surface the reference commits to —
implements this in src/materials/hair.{h,cpp}.  The model is a near-perfect
fit for wide devices: every term (longitudinal Gaussian-on-sphere Mp, azimuthal
trimmed-logistic Np, attenuation Ap) is closed-form elementwise math over the
wavefront — no tables, no recursion, no divergence.

Frame convention: local x = curve tangent (``si["tang"]``, see
integrators' ``shading_frame``), z = face-forwarded radial normal.  pbrt
derives the azimuthal offset ``h`` from the curve intersection's v
coordinate; our curves are tessellated tubes (shapes/curve.py), so ``h``
follows exactly from the hit geometry instead: a ray hitting a circular
cross-section at signed impact parameter h·r sees the radial normal tilted
by gamma_o = asin(h) from the reversed ray, hence

    h = -wo.y / sqrt(wo.y^2 + wo.z^2)

(the sign matches pbrt's Phi(p) = 2 p gamma_t - 2 gamma_o + p pi convention:
the specular R lobe then peaks exactly at the mirror direction about the
tube normal — verified in tests/test_hair.py).

All formulas follow pbrt-v3 hair.cpp; lobe count pMax = 3.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import PI

P_MAX = 3
SQRT_PI_OVER_8 = 0.626657069

# CIE Y weights used by pbrt's RGBSpectrum::y() (spectrum.cpp)
_Y_WEIGHT = np.array([0.212671, 0.715160, 0.072169])


# -- small numerics (pbrt-v3 hair.cpp helpers) ------------------------------


def _i0(x):
    """Modified Bessel I0 by 10-term power series (pbrt-v3 I0)."""
    x2 = x * x
    val = jnp.ones_like(x)
    term = jnp.ones_like(x)
    # term_{i} = x^{2i} / (4^i (i!)^2); ratio term_{i}/term_{i-1} = x2/(4 i^2)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    small = jnp.log(_i0(jnp.minimum(x, 12.0)))
    big = x + 0.5 * (-jnp.log(2.0 * PI) + jnp.log(1.0 / jnp.maximum(x, 12.0)) + 1.0 / (8.0 * jnp.maximum(x, 12.0)))
    return jnp.where(x > 12.0, big, small)


def _mp(cos_i, cos_o, sin_i, sin_o, v):
    """Longitudinal scattering Mp (pbrt-v3 hair.cpp Mp)."""
    v = jnp.maximum(v, 1e-7)
    a = cos_i * cos_o / v
    b = sin_i * sin_o / v
    # log-space form, stable for small v
    mp_log = jnp.exp(_log_i0(a) - b - 1.0 / v + 0.6931 + jnp.log(1.0 / (2.0 * v)))
    # direct form for v > .1 (evaluate with clamped v so the unselected
    # lanes cannot overflow to inf/inf = nan)
    vs = jnp.maximum(v, 0.1)
    a_s = cos_i * cos_o / vs
    b_s = sin_i * sin_o / vs
    mp_dir = jnp.exp(-b_s) * _i0(a_s) / (jnp.sinh(1.0 / vs) * 2.0 * vs)
    return jnp.where(v <= 0.1, mp_log, mp_dir)


def _logistic(x, s):
    x = jnp.abs(x)
    e = jnp.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    return 1.0 / (1.0 + jnp.exp(-x / s))


def _trimmed_logistic(x, s, a, b):
    return _logistic(x, s) / (_logistic_cdf(b, s) - _logistic_cdf(a, s))


def _sample_trimmed_logistic(u, s, a, b):
    k = _logistic_cdf(b, s) - _logistic_cdf(a, s)
    denom = jnp.maximum(u * k + _logistic_cdf(a, s), 1e-9)
    x = -s * jnp.log(jnp.maximum(1.0 / denom - 1.0, 1e-9))
    return jnp.clip(x, a, b)


def _phi_fn(p, gamma_o, gamma_t):
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * PI


def _np_term(phi, p, s, gamma_o, gamma_t):
    dphi = phi - _phi_fn(p, gamma_o, gamma_t)
    dphi = jnp.mod(dphi + PI, 2.0 * PI) - PI  # wrap to [-pi, pi]
    return _trimmed_logistic(dphi, s, -PI, PI)


def _compact_1by1(x):
    """Drop odd bits of a uint32 Morton code (pbrt-v3 Compact1By1)."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def demux_float(u):
    """One uniform float -> two (pbrt-v3 DemuxFloat), Morton deinterleave."""
    v = (jnp.clip(u, 0.0, 0.99999994) * 4294967296.0).astype(jnp.uint32)
    ux = _compact_1by1(v).astype(u.dtype) * (1.0 / 65536.0)
    uy = _compact_1by1(v >> 1).astype(u.dtype) * (1.0 / 65536.0)
    return ux, uy


# -- shared per-lane geometry/attenuation ------------------------------------


def _fresnel_dielectric(cos_i, eta):
    from pbrt_tpu.materials.bsdf import fresnel_dielectric

    return fresnel_dielectric(cos_i, jnp.ones_like(eta), eta)


def _safe_sqrt(x):
    return jnp.sqrt(jnp.maximum(x, 0.0))


def _common(params, wo):
    """Quantities depending on (material params, wo) only."""
    beta_m = params["beta_m"]
    beta_n = params["beta_n"]
    eta = params["eta"]
    sigma_a = params["sigma_a"]

    v0 = (0.726 * beta_m + 0.812 * beta_m**2 + 3.7 * beta_m**20) ** 2
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]  # v[3] = v[2] (pbrt pMax=3)
    s = SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n**2 + 5.372 * beta_n**22)

    # scale tilts: sin/cos of 2^k * alpha
    alpha_rad = params["hair_alpha"] * (PI / 180.0)
    sin2k = [jnp.sin(alpha_rad)]
    cos2k = [_safe_sqrt(1.0 - sin2k[0] ** 2)]
    for _ in range(2):
        sin2k.append(2.0 * cos2k[-1] * sin2k[-1])
        cos2k.append(cos2k[-1] ** 2 - sin2k[-1] ** 2)

    sin_theta_o = wo[..., 0]
    cos_theta_o = _safe_sqrt(1.0 - sin_theta_o**2)
    phi_o = jnp.arctan2(wo[..., 2], wo[..., 1])

    perp = _safe_sqrt(wo[..., 1] ** 2 + wo[..., 2] ** 2)
    h = jnp.clip(-wo[..., 1] / jnp.maximum(perp, 1e-7), -1.0, 1.0)
    gamma_o = jnp.arcsin(h)

    # refracted path through the fiber
    sin_theta_t = sin_theta_o / eta
    cos_theta_t = _safe_sqrt(1.0 - sin_theta_t**2)
    etap = _safe_sqrt(eta**2 - sin_theta_o**2) / jnp.maximum(cos_theta_o, 1e-7)
    sin_gamma_t = jnp.clip(h / jnp.maximum(etap, 1e-7), -1.0, 1.0)
    cos_gamma_t = _safe_sqrt(1.0 - sin_gamma_t**2)
    gamma_t = jnp.arcsin(sin_gamma_t)

    # single-pass transmittance
    tr = jnp.exp(-sigma_a * (2.0 * cos_gamma_t / jnp.maximum(cos_theta_t, 1e-7))[..., None])

    # attenuation per lobe: Ap (pbrt-v3 hair.cpp Ap)
    cos_gamma_o = _safe_sqrt(1.0 - h * h)
    f = _fresnel_dielectric(cos_theta_o * cos_gamma_o, eta)[..., None]
    ap0 = jnp.broadcast_to(f, tr.shape)
    ap1 = (1.0 - f) ** 2 * tr
    ap2 = ap1 * tr * f
    ap3 = ap2 * f * tr / jnp.maximum(1.0 - tr * f, 1e-5)
    ap = [ap0, ap1, ap2, ap3]

    return {
        "v": v,
        "s": s,
        "sin2k": sin2k,
        "cos2k": cos2k,
        "sin_theta_o": sin_theta_o,
        "cos_theta_o": cos_theta_o,
        "phi_o": phi_o,
        "gamma_o": gamma_o,
        "gamma_t": gamma_t,
        "ap": ap,
    }


def _tilted_theta_o(c, p):
    """Apply the cuticle-scale tilt to theta_o for lobe p (pbrt-v3 f())."""
    so, co = c["sin_theta_o"], c["cos_theta_o"]
    s2k, c2k = c["sin2k"], c["cos2k"]
    if p == 0:
        sin_op = so * c2k[1] - co * s2k[1]
        cos_op = co * c2k[1] + so * s2k[1]
    elif p == 1:
        sin_op = so * c2k[0] + co * s2k[0]
        cos_op = co * c2k[0] - so * s2k[0]
    elif p == 2:
        sin_op = so * c2k[2] + co * s2k[2]
        cos_op = co * c2k[2] - so * s2k[2]
    else:
        return so, co
    return sin_op, jnp.abs(cos_op)


def _ap_pdf(c):
    """Lobe selection probabilities from luminance of Ap."""
    w = jnp.asarray(_Y_WEIGHT, dtype=c["ap"][0].dtype)
    ys = [jnp.sum(a * w, axis=-1) for a in c["ap"]]
    total = jnp.maximum(sum(ys), 1e-9)
    return [y / total for y in ys]


# -- public: f / pdf / sample ------------------------------------------------


def hair_f(params, wo, wi):
    """f(wo, wi) [N,3]; includes pbrt's 1/|cos theta_i| factor."""
    c = _common(params, wo)
    sin_theta_i = wi[..., 0]
    cos_theta_i = _safe_sqrt(1.0 - sin_theta_i**2)
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - c["phi_o"]

    fsum = jnp.zeros_like(params["sigma_a"])
    for p in range(P_MAX):
        sin_op, cos_op = _tilted_theta_o(c, p)
        mp = _mp(cos_theta_i, cos_op, sin_theta_i, sin_op, c["v"][p])
        np_t = _np_term(phi, p, c["s"], c["gamma_o"], c["gamma_t"])
        fsum = fsum + (mp * np_t)[..., None] * c["ap"][p]
    mp_last = _mp(cos_theta_i, c["cos_theta_o"], sin_theta_i, c["sin_theta_o"], c["v"][P_MAX])
    fsum = fsum + (mp_last / (2.0 * PI))[..., None] * c["ap"][P_MAX]
    abs_cos_wi = jnp.abs(wi[..., 2])
    return fsum / jnp.maximum(abs_cos_wi, 1e-7)[..., None]


def hair_pdf(params, wo, wi):
    c = _common(params, wo)
    sin_theta_i = wi[..., 0]
    cos_theta_i = _safe_sqrt(1.0 - sin_theta_i**2)
    phi_i = jnp.arctan2(wi[..., 2], wi[..., 1])
    phi = phi_i - c["phi_o"]
    apdf = _ap_pdf(c)

    pdf = jnp.zeros(wo.shape[:-1], dtype=wo.dtype)
    for p in range(P_MAX):
        sin_op, cos_op = _tilted_theta_o(c, p)
        mp = _mp(cos_theta_i, cos_op, sin_theta_i, sin_op, c["v"][p])
        np_t = _np_term(phi, p, c["s"], c["gamma_o"], c["gamma_t"])
        pdf = pdf + mp * apdf[p] * np_t
    mp_last = _mp(cos_theta_i, c["cos_theta_o"], sin_theta_i, c["sin_theta_o"], c["v"][P_MAX])
    pdf = pdf + mp_last * apdf[P_MAX] / (2.0 * PI)
    return pdf


def hair_sample_wi(params, wo, u_lobe, u2):
    """Sample wi for hair lanes (pbrt-v3 HairBSDF::Sample_f direction part).

    u_lobe is demuxed into (lobe-select, azimuth) samples; u2 drives the
    longitudinal sample — mirroring pbrt's DemuxFloat(u2[0])/DemuxFloat(u2[1])
    split so four effectively-independent dimensions reach the four decisions.
    Returns wi [N,3]; f/pdf follow from hair_f/hair_pdf (as in pbrt, which
    recomputes the full sums for the returned f and pdf).
    """
    c = _common(params, wo)
    u_p, u_np = demux_float(u_lobe)
    apdf = _ap_pdf(c)

    # lobe selection p in {0,1,2,3}
    c0 = apdf[0]
    c1 = c0 + apdf[1]
    c2 = c1 + apdf[2]
    p_idx = (
        (u_p >= c0).astype(jnp.int32)
        + (u_p >= c1).astype(jnp.int32)
        + (u_p >= c2).astype(jnp.int32)
    )

    def select(vals):
        out = vals[0]
        for k in range(1, 4):
            out = jnp.where(p_idx == k, vals[k], out)
        return out

    sin_ops, cos_ops = zip(*[_tilted_theta_o(c, p) for p in range(4)])
    sin_op = select(list(sin_ops))
    cos_op = select(list(cos_ops))
    v_p = select(c["v"])

    # longitudinal: sample Mp
    u10 = jnp.maximum(u2[..., 0], 1e-5)
    cos_theta = 1.0 + v_p * jnp.log(u10 + (1.0 - u10) * jnp.exp(-2.0 / jnp.maximum(v_p, 1e-7)))
    sin_theta = _safe_sqrt(1.0 - cos_theta**2)
    cos_phi_l = jnp.cos(2.0 * PI * u2[..., 1])
    sin_theta_i = -cos_theta * sin_op + sin_theta * cos_phi_l * cos_op
    cos_theta_i = _safe_sqrt(1.0 - sin_theta_i**2)

    # azimuthal: sample Np (trimmed logistic around Phi(p)), uniform for p=3
    dphi_lobe = (
        _phi_fn(p_idx.astype(wo.dtype), c["gamma_o"], c["gamma_t"])
        + _sample_trimmed_logistic(u_np, c["s"], -PI, PI)
    )
    dphi = jnp.where(p_idx == P_MAX, 2.0 * PI * u_np, dphi_lobe)

    phi_i = c["phi_o"] + dphi
    wi = jnp.stack(
        [sin_theta_i, cos_theta_i * jnp.cos(phi_i), cos_theta_i * jnp.sin(phi_i)],
        axis=-1,
    )
    return wi


# -- pigment helpers (pbrt-v3 hair.cpp) --------------------------------------

EUMELANIN_SIGMA_A = np.array([0.419, 0.697, 1.37])
PHEOMELANIN_SIGMA_A = np.array([0.187, 0.4, 1.05])


def sigma_a_from_concentration(ce: float, cp: float) -> np.ndarray:
    return ce * EUMELANIN_SIGMA_A + cp * PHEOMELANIN_SIGMA_A


def sigma_a_from_reflectance(c, beta_n):
    """Invert the multiple-scattering albedo fit (pbrt-v3 hair.cpp)."""
    denom = (
        5.969
        - 0.215 * beta_n
        + 2.532 * beta_n**2
        - 10.73 * beta_n**3
        + 5.574 * beta_n**4
        + 0.245 * beta_n**5
    )
    ln = jnp.log(jnp.maximum(c, 1e-4)) if hasattr(c, "dtype") else np.log(np.maximum(c, 1e-4))
    return (ln / denom) ** 2
