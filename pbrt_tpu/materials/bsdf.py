"""BSDF evaluation/sampling, branchless over a wavefront.

pbrt-v3 dispatches ``Box<dyn BxDF>`` per intersection; here every lane
carries a material-type id plus SoA parameter arrays (kd, ks, roughness,
eta, ...) and the lobe formulas are evaluated with mask-select — the
Device replacement for virtual dispatch (SURVEY.md §2.2 "EP analogue").

Local shading frame: z = shading normal; wo/wi in local coordinates.
Conventions follow pbrt-v3 ch. 8: f is radiance-carrying BRDF value,
sample returns (wi, f, pdf, is_specular); for specular lobes f already
includes the 1/|cos| so weight = f * |cos| / pdf works uniformly.
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import INV_PI, PI
from pbrt_tpu.core.sampling import cosine_sample_hemisphere, sincos_2pi

# Material type ids (table order matters: keep in sync with materials/__init__)
MATTE = 0
MIRROR = 1
GLASS = 2
PLASTIC = 3
METAL = 4
SUBSTRATE = 5
UBER = 6
TRANSLUCENT = 7
DISNEY = 8
HAIR = 9
FOURIER = 10
NONE = 15  # pure emitter

ONE_MINUS_EPS = 0.99999994


def cos_theta(w):
    return w[..., 2]


def abs_cos_theta(w):
    return jnp.abs(w[..., 2])


def same_hemisphere(a, b):
    return a[..., 2] * b[..., 2] > 0


def reflect(wo, n):
    return -wo + 2.0 * jnp.sum(wo * n, axis=-1, keepdims=True) * n


def refract(wi, n, eta_ratio):
    """Returns (wt, total_internal_reflection mask). eta_ratio = eta_i/eta_t."""
    cos_i = jnp.sum(wi * n, axis=-1)
    sin2_i = jnp.maximum(0.0, 1.0 - cos_i * cos_i)
    sin2_t = eta_ratio * eta_ratio * sin2_i
    tir = sin2_t >= 1.0
    cos_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin2_t))
    wt = eta_ratio[..., None] * (-wi) + (eta_ratio * cos_i - cos_t)[..., None] * n
    return wt, tir


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Scalar dielectric Fresnel with automatic side handling."""
    cos_i = jnp.clip(cos_i, -1.0, 1.0)
    entering = cos_i > 0.0
    ei = jnp.where(entering, eta_i, eta_t)
    et = jnp.where(entering, eta_t, eta_i)
    ci = jnp.abs(cos_i)
    sin_t = ei / et * jnp.sqrt(jnp.maximum(0.0, 1.0 - ci * ci))
    tir = sin_t >= 1.0
    ct = jnp.sqrt(jnp.maximum(0.0, 1.0 - sin_t * sin_t))
    r_par = (et * ci - ei * ct) / jnp.maximum(et * ci + ei * ct, 1e-8)
    r_perp = (ei * ci - et * ct) / jnp.maximum(ei * ci + et * ct, 1e-8)
    f = 0.5 * (r_par * r_par + r_perp * r_perp)
    return jnp.where(tir, 1.0, f)


def fresnel_conductor(cos_i, eta, k):
    """RGB conductor Fresnel (pbrt-v3 §8.2.1); eta/k are [...,3]."""
    ci = jnp.clip(jnp.abs(cos_i), 0.0, 1.0)[..., None]
    ci2 = ci * ci
    si2 = 1.0 - ci2
    eta2 = eta * eta
    k2 = k * k
    t0 = eta2 - k2 - si2
    a2b2 = jnp.sqrt(jnp.maximum(t0 * t0 + 4.0 * eta2 * k2, 0.0))
    t1 = a2b2 + ci2
    a = jnp.sqrt(jnp.maximum(0.5 * (a2b2 + t0), 0.0))
    t2 = 2.0 * a * ci
    rs = (t1 - t2) / jnp.maximum(t1 + t2, 1e-8)
    t3 = ci2 * a2b2 + si2 * si2
    t4 = t2 * si2
    rp = rs * (t3 - t4) / jnp.maximum(t3 + t4, 1e-8)
    return 0.5 * (rp + rs)


def fresnel_schlick_rgb(cos_i, r0):
    c = jnp.clip(1.0 - jnp.abs(cos_i), 0.0, 1.0)[..., None]
    return r0 + (1.0 - r0) * (c**5)


def roughness_to_alpha(roughness):
    """pbrt-v3 TrowbridgeReitz::RoughnessToAlpha."""
    r = jnp.maximum(roughness, 1e-3)
    x = jnp.log(r)
    return 1.62142 + 0.819955 * x + 0.1734 * x * x + 0.0171201 * x**3 + 0.000640711 * x**4


# -- GGX / Trowbridge-Reitz (isotropic) -------------------------------------


def ggx_d(wh, alpha):
    c2 = wh[..., 2] * wh[..., 2]
    a2 = alpha * alpha
    denom = c2 * (a2 - 1.0) + 1.0
    return a2 / jnp.maximum(PI * denom * denom, 1e-12)


def ggx_lambda(w, alpha):
    c = jnp.abs(w[..., 2])
    s2 = jnp.maximum(0.0, 1.0 - c * c)
    tan2 = s2 / jnp.maximum(c * c, 1e-12)
    return 0.5 * (-1.0 + jnp.sqrt(1.0 + alpha * alpha * tan2))


def ggx_g(wo, wi, alpha):
    return 1.0 / (1.0 + ggx_lambda(wo, alpha) + ggx_lambda(wi, alpha))


def ggx_g1(w, alpha):
    return 1.0 / (1.0 + ggx_lambda(w, alpha))


def ggx_sample_wh(u, alpha):
    """Sample the GGX distribution D (not VNDF) like pbrt-v3 TR::Sample_wh."""
    c2 = (1.0 - u[..., 0]) / jnp.maximum(1.0 + (alpha * alpha - 1.0) * u[..., 0], 1e-12)
    cos_t = jnp.sqrt(jnp.maximum(c2, 0.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - c2, 0.0))
    sp, cp = sincos_2pi(u[..., 1])
    return jnp.stack([sin_t * cp, sin_t * sp, cos_t], axis=-1)


def ggx_pdf_wh(wh, alpha):
    return ggx_d(wh, alpha) * jnp.abs(wh[..., 2])


# ---------------------------------------------------------------------------
# Per-lane BSDF parameter bundle
# ---------------------------------------------------------------------------
#
# params = {
#   "type": [N] int32,
#   "kd":   [N,3], "ks": [N,3], "kr": [N,3], "kt": [N,3],
#   "roughness": [N] (alpha, already remapped),
#   "eta": [N], "metal_eta": [N,3], "metal_k": [N,3],
#   "sigma": [N] (Oren-Nayar degrees),
# }


def oren_nayar_ab(sigma_deg):
    s = sigma_deg * (PI / 180.0)
    s2 = s * s
    a = 1.0 - s2 / (2.0 * (s2 + 0.33))
    b = 0.45 * s2 / (s2 + 0.09)
    return a, b


def _diffuse_f(params, wo, wi):
    """Lambert or Oren-Nayar (sigma>0) diffuse term [N,3]."""
    kd = params["kd"]
    sigma = params["sigma"]
    a, b = oren_nayar_ab(sigma)
    # Oren-Nayar per pbrt-v3 §8.4.1
    sin_theta_i = jnp.sqrt(jnp.maximum(0.0, 1.0 - wi[..., 2] ** 2))
    sin_theta_o = jnp.sqrt(jnp.maximum(0.0, 1.0 - wo[..., 2] ** 2))
    # cos(phi_i - phi_o)
    denom_i = jnp.maximum(sin_theta_i, 1e-7)
    denom_o = jnp.maximum(sin_theta_o, 1e-7)
    cos_dphi = (wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]) / (denom_i * denom_o)
    max_cos = jnp.where(
        (sin_theta_i > 1e-4) & (sin_theta_o > 1e-4), jnp.maximum(0.0, cos_dphi), 0.0
    )
    abs_ci = jnp.abs(wi[..., 2])
    abs_co = jnp.abs(wo[..., 2])
    sin_alpha = jnp.where(abs_ci > abs_co, sin_theta_o, sin_theta_i)
    tan_beta = jnp.where(
        abs_ci > abs_co,
        sin_theta_i / jnp.maximum(abs_ci, 1e-7),
        sin_theta_o / jnp.maximum(abs_co, 1e-7),
    )
    on = a + b * max_cos * sin_alpha * tan_beta
    return kd * (INV_PI * on)[..., None]


def _microfacet_reflection_f(wo, wi, alpha, fresnel_fn, scale):
    """Torrance-Sparrow: D G F / (4 cos_o cos_i); returns [N,3]."""
    co = jnp.abs(wo[..., 2])
    ci = jnp.abs(wi[..., 2])
    wh = wi + wo
    wh_len = jnp.linalg.norm(wh, axis=-1, keepdims=True)
    ok = (co > 1e-7) & (ci > 1e-7) & (wh_len[..., 0] > 1e-12) & same_hemisphere(wo, wi)
    wh_n = wh / jnp.maximum(wh_len, 1e-12)
    f = fresnel_fn(jnp.sum(wi * wh_n, axis=-1))
    val = scale * f * (ggx_d(wh_n, alpha) * ggx_g(wo, wi, alpha) / jnp.maximum(4 * co * ci, 1e-7))[..., None]
    return jnp.where(ok[..., None], val, 0.0)


def _microfacet_pdf(wo, wi, alpha):
    wh = wi + wo
    wh_len = jnp.linalg.norm(wh, axis=-1, keepdims=True)
    wh_n = wh / jnp.maximum(wh_len, 1e-12)
    pdf = ggx_pdf_wh(wh_n, alpha) / jnp.maximum(
        4.0 * jnp.abs(jnp.sum(wo * wh_n, axis=-1)), 1e-7
    )
    return jnp.where(same_hemisphere(wo, wi), pdf, 0.0)


def _substrate_f(params, wo, wi):
    """Ashikhmin-Shirley FresnelBlend (pbrt-v3 §8.5)."""
    rd = params["kd"]
    rs = params["ks"]
    alpha = params["roughness"]
    co = jnp.abs(wo[..., 2])
    ci = jnp.abs(wi[..., 2])
    pow5 = lambda v: (v * v) * (v * v) * v
    diffuse = (
        (28.0 / (23.0 * PI))
        * rd
        * (1.0 - rs)
        * (1.0 - pow5(1.0 - 0.5 * ci))[..., None]
        * (1.0 - pow5(1.0 - 0.5 * co))[..., None]
    )
    wh = wi + wo
    wh_len = jnp.linalg.norm(wh, axis=-1, keepdims=True)
    wh_n = wh / jnp.maximum(wh_len, 1e-12)
    d = ggx_d(wh_n, alpha)
    cos_wi_wh = jnp.sum(wi * wh_n, axis=-1)
    schlick = fresnel_schlick_rgb(cos_wi_wh, rs)
    spec = (
        d
        / jnp.maximum(4.0 * jnp.abs(cos_wi_wh) * jnp.maximum(ci, co), 1e-7)
    )[..., None] * schlick
    ok = (wh_len[..., 0] > 1e-12) & same_hemisphere(wo, wi)
    return jnp.where(ok[..., None], diffuse + spec, 0.0)


# ---------------------------------------------------------------------------
# Public batched interface
# ---------------------------------------------------------------------------


def _microfacet_transmission_f(params, wo, wi):
    """Rough dielectric transmission (pbrt-v3 §8.4.4, radiance transport).

    Used for GLASS with roughness above the smooth threshold.
    """
    alpha = params["roughness"]
    eta = params["eta"]
    co = wo[..., 2]
    ci = wi[..., 2]
    same = same_hemisphere(wo, wi)
    # eta ratio for the transmission half-vector; true side from geometry
    outside = params.get("outside", co > 0)
    eta_p = jnp.where(outside, eta, 1.0 / eta)
    wh = wo + wi * eta_p[..., None]
    wh_len = jnp.linalg.norm(wh, axis=-1, keepdims=True)
    wh_n = wh / jnp.maximum(wh_len, 1e-12)
    wh_n = wh_n * jnp.sign(wh_n[..., 2:3])  # orient to +z
    f_d = fresnel_dielectric(jnp.sum(wo * wh_n, axis=-1), jnp.ones_like(eta), eta)
    sqrt_denom = jnp.sum(wo * wh_n, axis=-1) + eta_p * jnp.sum(wi * wh_n, axis=-1)
    factor = 1.0 / jnp.maximum(eta_p, 1e-6)
    d_term = ggx_d(wh_n, alpha)
    g_term = ggx_g(wo, wi, alpha)
    val = (
        (1.0 - f_d)
        * d_term
        * g_term
        * jnp.abs(
            jnp.sum(wi * wh_n, axis=-1)
            * jnp.sum(wo * wh_n, axis=-1)
            * factor
            * factor
            / jnp.maximum(
                jnp.abs(ci) * jnp.abs(co) * sqrt_denom * sqrt_denom, 1e-9
            )
        )
    )
    ok = (~same) & (jnp.abs(co) > 1e-6) & (jnp.abs(ci) > 1e-6) & (wh_len[..., 0] > 1e-9)
    return jnp.where(ok[..., None], params["kt"] * val[..., None], 0.0)


ROUGH_GLASS_MIN_ALPHA = 5e-3


def _active_types(params):
    """Static set of material-type ids present in the scene (None = all).

    Lobes for absent types are skipped entirely — this prunes both the
    compiled graph and the per-lane arithmetic."""
    return params.get("_active")


def _bsdf_eval_one(params, wo, wi):
    """f(wo, wi) [N,3] for one lobe set (specular contributes 0)."""
    mtype = params["type"]
    alpha = params["roughness"]
    eta = params["eta"]
    f = jnp.zeros_like(params["kd"])
    active = _active_types(params)

    def has(*types):
        return active is None or any(t in active for t in types)

    hemi = same_hemisphere(wo, wi)[..., None]
    if has(MATTE, PLASTIC, UBER):
        diffuse = _diffuse_f(params, wo, wi)
    if has(PLASTIC, UBER):
        refl_dielectric = _microfacet_reflection_f(
            wo, wi, alpha,
            lambda ci: fresnel_dielectric(ci, jnp.ones_like(eta), eta)[..., None],
            params["ks"],
        )
    if has(MATTE):
        f = jnp.where((mtype == MATTE)[..., None], jnp.where(hemi, diffuse, 0.0), f)
    if has(PLASTIC):
        f = jnp.where(
            (mtype == PLASTIC)[..., None],
            jnp.where(hemi, diffuse + refl_dielectric, 0.0),
            f,
        )
    if has(UBER):
        f = jnp.where(
            (mtype == UBER)[..., None],
            jnp.where(hemi, diffuse + refl_dielectric, 0.0),
            f,
        )
    if has(METAL):
        refl_conductor = _microfacet_reflection_f(
            wo, wi, alpha,
            lambda ci: fresnel_conductor(ci, params["metal_eta"], params["metal_k"]),
            jnp.ones_like(params["ks"]),
        )
        f = jnp.where((mtype == METAL)[..., None], refl_conductor, f)
    if has(SUBSTRATE):
        substrate = _substrate_f(params, wo, wi)
        f = jnp.where((mtype == SUBSTRATE)[..., None], substrate, f)
    if has(TRANSLUCENT):
        translucent_f = jnp.where(hemi, params["kd"], params["kt"]) * INV_PI
        f = jnp.where((mtype == TRANSLUCENT)[..., None], translucent_f, f)
    if has(GLASS):
        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        rg_refl = _microfacet_reflection_f(
            wo, wi, alpha,
            lambda ci: fresnel_dielectric(ci, jnp.ones_like(eta), eta)[..., None],
            params["kr"],
        )
        rg_trans = _microfacet_transmission_f(params, wo, wi)
        f = jnp.where(rough_glass[..., None], rg_refl + rg_trans, f)
    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu.materials.hair import hair_f

        f = jnp.where((mtype == HAIR)[..., None], hair_f(params, wo, wi), f)
    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu.materials.fourier import fourier_f

        for tbl in params["fourier"]:
            f = jnp.where(tbl["mask"][..., None], fourier_f(tbl, wo, wi), f)
    return f


def _bsdf_pdf_one(params, wo, wi):
    """Solid-angle pdf of _bsdf_sample_one for non-specular lanes."""
    mtype = params["type"]
    alpha = params["roughness"]
    active = _active_types(params)

    def has(*types):
        return active is None or any(t in active for t in types)

    cos_pdf = jnp.where(same_hemisphere(wo, wi), jnp.abs(wi[..., 2]) * INV_PI, 0.0)
    pdf = jnp.zeros(wo.shape[:-1], dtype=wo.dtype)
    if has(PLASTIC, UBER, SUBSTRATE, METAL, GLASS):
        mf_pdf = _microfacet_pdf(wo, wi, alpha)
    if has(MATTE):
        pdf = jnp.where(mtype == MATTE, cos_pdf, pdf)
    if has(PLASTIC, UBER, SUBSTRATE):
        pdf = jnp.where(
            (mtype == PLASTIC) | (mtype == UBER) | (mtype == SUBSTRATE),
            0.5 * (cos_pdf + mf_pdf),
            pdf,
        )
    if has(METAL):
        pdf = jnp.where(mtype == METAL, mf_pdf, pdf)
    if has(TRANSLUCENT):
        pdf = jnp.where(mtype == TRANSLUCENT, 0.5 * jnp.abs(wi[..., 2]) * INV_PI, pdf)
    if has(GLASS):
        # rough dielectric: half of each lobe's pdf
        eta = params["eta"]
        outside_p = params.get("outside", wo[..., 2] > 0)
        eta_p = jnp.where(outside_p, eta, 1.0 / eta)
        wh_t = wo + wi * eta_p[..., None]
        wh_t_len = jnp.linalg.norm(wh_t, axis=-1, keepdims=True)
        wh_tn = wh_t / jnp.maximum(wh_t_len, 1e-12)
        wh_tn = wh_tn * jnp.sign(wh_tn[..., 2:3])
        sqrt_denom = jnp.sum(wo * wh_tn, axis=-1) + eta_p * jnp.sum(wi * wh_tn, axis=-1)
        dwh_dwi = jnp.abs(
            (eta_p * eta_p * jnp.sum(wi * wh_tn, axis=-1))
            / jnp.maximum(sqrt_denom * sqrt_denom, 1e-9)
        )
        trans_pdf = jnp.where(
            (~same_hemisphere(wo, wi)) & (wh_t_len[..., 0] > 1e-9),
            ggx_pdf_wh(wh_tn, alpha) * dwh_dwi,
            0.0,
        )
        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        pdf = jnp.where(rough_glass, 0.5 * (mf_pdf + trans_pdf), pdf)
    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu.materials.hair import hair_pdf

        pdf = jnp.where(mtype == HAIR, hair_pdf(params, wo, wi), pdf)
    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu.materials.fourier import fourier_pdf_tbl

        for tbl in params["fourier"]:
            pdf = jnp.where(
                tbl["mask"] & (mtype == FOURIER), fourier_pdf_tbl(tbl, wo, wi), pdf
            )
    return pdf


def _bsdf_sample_one(params, wo, u_lobe, u2):
    """Sample an outgoing direction from one lobe set.

    Returns (wi [N,3], f [N,3], pdf [N], specular [N] bool).
    For specular lanes f includes 1/|cos| and pdf = 1.
    """
    mtype = params["type"]
    alpha = params["roughness"]
    eta = params["eta"]
    active = _active_types(params)

    def has(*types):
        return active is None or any(t in active for t in types)

    n_local = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=wo.dtype), wo.shape
    )
    sign_o = jnp.sign(jnp.where(wo[..., 2] == 0.0, 1.0, wo[..., 2]))

    # candidate 1: cosine-hemisphere (diffuse), flipped to wo's side
    wi_diff = cosine_sample_hemisphere(u2)
    wi_diff = wi_diff * jnp.stack(
        [jnp.ones_like(sign_o), jnp.ones_like(sign_o), sign_o], axis=-1
    )
    wi = wi_diff

    if has(PLASTIC, UBER, SUBSTRATE, METAL, GLASS):
        # candidate 2: microfacet half-vector reflection
        wh = ggx_sample_wh(u2, alpha)
        wh = wh * sign_o[..., None]  # same side as wo
        wi_mf = reflect(wo, wh)
        use_mf = (
            ((mtype == PLASTIC) | (mtype == UBER) | (mtype == SUBSTRATE))
            & (u_lobe >= 0.5)
        ) | (mtype == METAL)
        wi = jnp.where(use_mf[..., None], wi_mf, wi)

    # candidate 3: perfect mirror
    wi_mirror = jnp.stack([-wo[..., 0], -wo[..., 1], wo[..., 2]], axis=-1)
    if has(MIRROR):
        wi = jnp.where((mtype == MIRROR)[..., None], wi_mirror, wi)

    rough_glass = jnp.zeros(wo.shape[:-1], dtype=bool)
    if has(GLASS):
        # candidate 4: glass — choose reflect vs refract by Fresnel.
        # The shading frame is face-forwarded (wo.z > 0 always), so the
        # true medium side comes from params["outside"]; without it the
        # exit transmission would reuse the entry eta scaling.
        outside = params.get("outside", wo[..., 2] > 0)
        cos_signed = jnp.where(outside, jnp.abs(wo[..., 2]), -jnp.abs(wo[..., 2]))
        f_diel = fresnel_dielectric(cos_signed, jnp.ones_like(eta), eta)
        n_oriented = n_local * sign_o[..., None]
        eta_ratio = jnp.where(outside, 1.0 / eta, eta)
        wt, tir = refract(wo, n_oriented, eta_ratio)
        wt_norm = wt / jnp.maximum(jnp.linalg.norm(wt, axis=-1, keepdims=True), 1e-12)
        choose_reflect = (u_lobe < f_diel) | tir
        wi_glass = jnp.where(choose_reflect[..., None], wi_mirror, wt_norm)

        # candidate 5: rough glass — GGX half-vector, reflect/refract about it
        refl_about_wh = reflect(wo, wh)
        wt_wh, tir_wh = refract(
            wo, wh * jnp.sign(jnp.sum(wo * wh, axis=-1, keepdims=True)), eta_ratio
        )
        wt_wh = wt_wh / jnp.maximum(
            jnp.linalg.norm(wt_wh, axis=-1, keepdims=True), 1e-12
        )
        rough_reflect = (u_lobe < 0.5) | tir_wh
        wi_rough_glass = jnp.where(rough_reflect[..., None], refl_about_wh, wt_wh)

        rough_glass = (mtype == GLASS) & (alpha > ROUGH_GLASS_MIN_ALPHA)
        wi = jnp.where((mtype == GLASS)[..., None], wi_glass, wi)
        wi = jnp.where(rough_glass[..., None], wi_rough_glass, wi)

    if has(TRANSLUCENT):
        # translucent: flip to other side with prob .5
        flip = (mtype == TRANSLUCENT) & (u_lobe >= 0.5)
        wi = jnp.where(
            flip[..., None],
            wi_diff * jnp.asarray([1.0, 1.0, -1.0], dtype=wo.dtype),
            wi,
        )

    if has(HAIR) and "sigma_a" in params:
        from pbrt_tpu.materials.hair import hair_sample_wi

        wi_hair = hair_sample_wi(params, wo, u_lobe, u2)
        wi = jnp.where((mtype == HAIR)[..., None], wi_hair, wi)

    if has(FOURIER) and "fourier" in params:
        from pbrt_tpu.materials.fourier import fourier_sample_wi_tbl

        for tbl in params["fourier"]:
            wi_fr = fourier_sample_wi_tbl(tbl, wo, u_lobe, u2)
            wi = jnp.where(
                (tbl["mask"] & (mtype == FOURIER))[..., None], wi_fr, wi
            )

    specular = (mtype == MIRROR) | ((mtype == GLASS) & ~rough_glass)

    # non-specular f/pdf by evaluation
    f_ns = _bsdf_eval_one(params, wo, wi)
    pdf_ns = _bsdf_pdf_one(params, wo, wi)

    f = f_ns
    pdf = pdf_ns
    if has(MIRROR, GLASS):
        abs_ci = jnp.maximum(jnp.abs(wi[..., 2]), 1e-7)
        # mirror: FresnelNoOp (pbrt MirrorMaterial) -> f = kr/|cos|, pdf = 1
        f_spec = params["kr"] / abs_ci[..., None]
        if has(GLASS):
            # reflect w.p. F (weight kr); refract w.p. 1-F with the
            # radiance-transport (eta_i/eta_t)^2 scale (pbrt-v3
            # SpecularTransmission::Sample_f); branch pdf folds into f.
            glass_refl_f = (
                params["kr"]
                * (f_diel / jnp.maximum(f_diel, 1e-7))[..., None]
                / abs_ci[..., None]
            )
            scale_t = eta_ratio * eta_ratio
            glass_trans_f = params["kt"] * scale_t[..., None] / abs_ci[..., None]
            f_glass = jnp.where(choose_reflect[..., None], glass_refl_f, glass_trans_f)
            f_spec = jnp.where((mtype == GLASS)[..., None], f_glass, f_spec)
        f = jnp.where(specular[..., None], f_spec, f)
        pdf = jnp.where(specular, 1.0, pdf)
    return wi, f, pdf, specular


# ---------------------------------------------------------------------------
# Mix-aware public interface (pbrt-v3 MixMaterial semantics)
# ---------------------------------------------------------------------------
#
# When the scene contains ``Material "mix"`` entries, eval_material_params
# produces TWO complete lobe-parameter sets: the outer dict (child 1, and
# every non-mix material) plus params["mix_b"] (child 2), with
# params["mix_amt"] [N,3] = per-channel blend (1.0 on non-mix lanes) and
# params["mix_pa"] [N] = luminance selection probability.  f and pdf blend
# linearly (f = amt f1 + (1-amt) f2); sampling picks a child by mix_pa with
# the lobe sample rescaled.  Scenes without mix compile to the _one path
# untouched.
#
# NESTED mix materials recurse naturally: params["mix_b"] may itself carry
# a "mix_b" (a mix child), and the wrappers below call each other (not the
# _one internals) on it — the one-sample estimator nests unbiasedly, and
# the static recursion depth equals the scene's mix nesting depth.


def _mix_b(params):
    pb = params.get("mix_b")
    if pb is not None and "outside" in params:
        pb = {**pb, "outside": params["outside"]}
    return pb


def bsdf_eval(params, wo, wi):
    """f(wo, wi) [N,3] for non-specular lobes (specular contributes 0)."""
    f = _bsdf_eval_one(params, wo, wi)
    pb = _mix_b(params)
    if pb is not None:
        amt = params["mix_amt"]
        f = amt * f + (1.0 - amt) * bsdf_eval(pb, wo, wi)
    return f


def bsdf_pdf(params, wo, wi):
    """Solid-angle pdf of bsdf_sample for non-specular lanes."""
    pdf = _bsdf_pdf_one(params, wo, wi)
    pb = _mix_b(params)
    if pb is not None:
        pa = params["mix_pa"]
        pdf = pa * pdf + (1.0 - pa) * bsdf_pdf(pb, wo, wi)
    return pdf


def bsdf_sample(params, wo, u_lobe, u2):
    """Sample an outgoing direction.

    Returns (wi [N,3], f [N,3], pdf [N], specular [N] bool).
    For specular lanes f includes 1/|cos| and the child-selection weight;
    pdf = 1.
    """
    pb = _mix_b(params)
    if pb is None:
        return _bsdf_sample_one(params, wo, u_lobe, u2)
    pa = params["mix_pa"]
    choose_a = u_lobe < pa
    u_a = jnp.clip(u_lobe / jnp.maximum(pa, 1e-6), 0.0, ONE_MINUS_EPS)
    u_b = jnp.clip((u_lobe - pa) / jnp.maximum(1.0 - pa, 1e-6), 0.0, ONE_MINUS_EPS)
    wi_a, f_a, _pdf_a, spec_a = _bsdf_sample_one(params, wo, u_a, u2)
    wi_b, f_b, _pdf_b, spec_b = bsdf_sample(pb, wo, u_b, u2)
    wi = jnp.where(choose_a[..., None], wi_a, wi_b)
    spec = jnp.where(choose_a, spec_a, spec_b)
    f = bsdf_eval(params, wo, wi)
    pdf = bsdf_pdf(params, wo, wi)
    # a sampled specular child lobe keeps its own delta f, scaled by the
    # blend amount over the selection probability (unbiased estimator)
    amt = params["mix_amt"]
    f_spec = jnp.where(
        choose_a[..., None],
        amt * f_a / jnp.maximum(pa, 1e-6)[..., None],
        (1.0 - amt) * f_b / jnp.maximum(1.0 - pa, 1e-6)[..., None],
    )
    f = jnp.where(spec[..., None], f_spec, f)
    pdf = jnp.where(spec, 1.0, pdf)
    return wi, f, pdf, spec
