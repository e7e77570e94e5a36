"""Lights (pbrt-v3 ch. 12), batched over wavefronts.

The reference stubs every light except the infinite light's parameter
parsing (lights/infinite.rs:80-94, ends in ``todo!()``).  Here all of
point/spot/distant/goniometric/projection/infinite/diffuse-area are real.

Contract (all device, SoA):
  sample_li(p, u2)      -> (wi, Li, pdf, dist): one NEE sample toward the light
  pdf_li(p, wi)         -> solid-angle pdf of sample_li for MIS
  le_escaped(d)         -> radiance for rays leaving the scene (infinite only)

Delta lights report pdf=1 and is_delta=True (skip MIS weighting, pbrt-v3
§14.3).  Area lights are bound to primitive ranges by the scene builder.
"""

from __future__ import annotations

import logging

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import INV_2PI, INV_PI, PI, float_t
from pbrt_tpu.core.sampling import (
    Distribution1D,
    Distribution2D,
    uniform_cone_pdf,
    uniform_sample_cone,
    uniform_sample_sphere,
    uniform_sample_triangle,
)
from pbrt_tpu.core.transform import Transform, apply_normal, apply_point, apply_vector

log = logging.getLogger("pbrt_tpu")

BIG_DIST = 1e7


def _to_dev(t: Transform):
    return jnp.asarray(t.m.astype(float_t)), jnp.asarray(t.m_inv.astype(float_t))


class Light:
    is_delta = False
    is_infinite = False

    def power(self) -> np.ndarray:
        return np.zeros(3)

    def le_escaped(self, d):
        return jnp.zeros(d.shape[:-1] + (3,), dtype=d.dtype)

    def pdf_li(self, p, wi):
        return jnp.zeros(p.shape[:-1], dtype=p.dtype)


class PointLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, intensity):
        self.p = np.asarray(light_to_world.apply_p(np.zeros(3)), dtype=float_t)
        self.intensity = np.asarray(intensity, dtype=float_t)
        self._pd = jnp.asarray(self.p)
        self._id = jnp.asarray(self.intensity)

    def power(self):
        return 4 * PI * self.intensity

    def sample_li(self, p, u2):
        to_l = self._pd - p
        d2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(d2)
        wi = to_l / jnp.maximum(dist[..., None], 1e-12)
        li = self._id / jnp.maximum(d2, 1e-12)[..., None]
        return wi, li, jnp.ones_like(dist), dist


class SpotLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, intensity, cone_angle_deg, cone_delta_deg):
        self.l2w = light_to_world
        self.p = np.asarray(light_to_world.apply_p(np.zeros(3)), dtype=float_t)
        self.intensity = np.asarray(intensity, dtype=float_t)
        self.cos_total = float(np.cos(np.deg2rad(cone_angle_deg)))
        self.cos_falloff = float(np.cos(np.deg2rad(cone_angle_deg - cone_delta_deg)))
        self._pd = jnp.asarray(self.p)
        self._id = jnp.asarray(self.intensity)
        _, self._w2l = _to_dev(light_to_world)

    def power(self):
        return self.intensity * 2 * PI * (1 - 0.5 * (self.cos_falloff + self.cos_total))

    def _falloff(self, w_world):
        wl = apply_vector(self._w2l, -w_world)  # direction from light in light space
        wl = wl / jnp.maximum(jnp.linalg.norm(wl, axis=-1, keepdims=True), 1e-12)
        ct = wl[..., 2]
        d = (ct - self.cos_total) / max(self.cos_falloff - self.cos_total, 1e-8)
        d = jnp.clip(d, 0.0, 1.0)
        return jnp.where(
            ct < self.cos_total, 0.0, jnp.where(ct > self.cos_falloff, 1.0, (d * d) * (d * d))
        )

    def sample_li(self, p, u2):
        to_l = self._pd - p
        d2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(d2)
        wi = to_l / jnp.maximum(dist[..., None], 1e-12)
        li = self._id * (self._falloff(wi) / jnp.maximum(d2, 1e-12))[..., None]
        return wi, li, jnp.ones_like(dist), dist


class DistantLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, radiance, from_p, to_p):
        w = np.asarray(from_p, dtype=np.float64) - np.asarray(to_p, dtype=np.float64)
        w = light_to_world.apply_v(w)
        self.w_light = (w / np.linalg.norm(w)).astype(float_t)  # toward the light
        self.radiance = np.asarray(radiance, dtype=float_t)
        self._wd = jnp.asarray(self.w_light)
        self._ld = jnp.asarray(self.radiance)

    def power(self):
        return self.radiance * PI  # x worldRadius^2, scene-dependent; relative ok

    def sample_li(self, p, u2):
        n = p.shape[0]
        wi = jnp.broadcast_to(self._wd, (n, 3))
        li = jnp.broadcast_to(self._ld, (n, 3))
        dist = jnp.full((n,), BIG_DIST, dtype=p.dtype)
        return wi, li, jnp.ones((n,), dtype=p.dtype), dist


class GonioPhotometricLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, intensity, mapname: str):
        from pbrt_tpu.core.mipmap import MIPMap

        self.p = np.asarray(light_to_world.apply_p(np.zeros(3)), dtype=float_t)
        raw = np.asarray(intensity, dtype=float_t)  # raw RGB tint
        self.intensity = _promote_emission(raw)
        self._pd = jnp.asarray(self.p)
        self._id = jnp.asarray(self.intensity)
        _, self._w2l = _to_dev(light_to_world)
        self.mipmap = None
        if mapname:
            try:
                from pbrt_tpu.core.imageio import read_image

                img, _ = read_image(mapname)
                # promote (tint x map) once; eval then multiplies by 1
                self.mipmap = MIPMap(_promote_emission(np.asarray(img) * raw))
                self._id = jnp.ones((3,), dtype=self._id.dtype)
            except (OSError, ValueError) as e:
                log.error("goniometric: cannot read '%s': %s", mapname, e)

    def power(self):
        return 4 * PI * self.intensity

    def _scale(self, w_world):
        if self.mipmap is None:
            return 1.0
        wl = apply_vector(self._w2l, -w_world)
        wl = wl / jnp.maximum(jnp.linalg.norm(wl, axis=-1, keepdims=True), 1e-12)
        theta = jnp.arccos(jnp.clip(wl[..., 2], -1, 1))
        phi = jnp.arctan2(wl[..., 1], wl[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * PI, phi)
        vals = self.mipmap.lookup(phi * INV_2PI, theta * INV_PI)
        return vals.mean(axis=-1) if vals.ndim > 1 else vals

    def sample_li(self, p, u2):
        to_l = self._pd - p
        d2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(d2)
        wi = to_l / jnp.maximum(dist[..., None], 1e-12)
        li = self._id * (self._scale(wi) / jnp.maximum(d2, 1e-12))[..., None]
        return wi, li, jnp.ones_like(dist), dist


class ProjectionLight(Light):
    is_delta = True

    def __init__(self, light_to_world: Transform, intensity, mapname: str, fov_deg=45.0):
        from pbrt_tpu.core.mipmap import MIPMap

        self.p = np.asarray(light_to_world.apply_p(np.zeros(3)), dtype=float_t)
        raw = np.asarray(intensity, dtype=float_t)  # raw RGB tint
        self.intensity = _promote_emission(raw)
        self._pd = jnp.asarray(self.p)
        self._id = jnp.asarray(self.intensity)
        _, self._w2l = _to_dev(light_to_world)
        self.mipmap = None
        aspect = 1.0
        if mapname:
            try:
                from pbrt_tpu.core.imageio import read_image

                img, (w, h) = read_image(mapname)
                # promote (tint x map) once; eval then multiplies by 1
                self.mipmap = MIPMap(_promote_emission(np.asarray(img) * raw))
                self._id = jnp.ones((3,), dtype=self._id.dtype)
                aspect = w / h
            except (OSError, ValueError) as e:
                log.error("projection: cannot read '%s': %s", mapname, e)
        if aspect > 1:
            self.screen = (-aspect, aspect, -1.0, 1.0)
        else:
            self.screen = (-1.0, 1.0, -1 / aspect, 1 / aspect)
        self.proj = Transform.perspective(fov_deg, 1e-2, 1000.0)
        self._projm = jnp.asarray(self.proj.m.astype(float_t))
        self.cos_total = float(
            np.cos(np.arctan(np.tan(np.deg2rad(fov_deg) / 2) * np.hypot(1, aspect)))
        )

    def power(self):
        return 2 * PI * (1 - self.cos_total) * self.intensity

    def _projection(self, w_world):
        wl = apply_vector(self._w2l, -w_world)
        behind = wl[..., 2] < 1e-3
        ps = apply_point(self._projm, wl)
        x0, x1, y0, y1 = self.screen
        inside = (
            (ps[..., 0] >= x0) & (ps[..., 0] <= x1) & (ps[..., 1] >= y0) & (ps[..., 1] <= y1)
        ) & ~behind
        if self.mipmap is None:
            return inside.astype(w_world.dtype)
        s = (ps[..., 0] - x0) / (x1 - x0)
        t = (ps[..., 1] - y0) / (y1 - y0)
        vals = self.mipmap.lookup(jnp.clip(s, 0, 1), jnp.clip(t, 0, 1))
        scale = vals.mean(axis=-1) if vals.ndim > 1 else vals
        return jnp.where(inside, scale, 0.0)

    def sample_li(self, p, u2):
        to_l = self._pd - p
        d2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(d2)
        wi = to_l / jnp.maximum(dist[..., None], 1e-12)
        li = self._id * (self._projection(wi) / jnp.maximum(d2, 1e-12))[..., None]
        return wi, li, jnp.ones_like(dist), dist


class InfiniteAreaLight(Light):
    """Environment light: constant tint x optional lat-long map.

    Completes lights/infinite.rs (construction todo!() at :66): importance
    sampling via a Distribution2D over luminance x sin(theta)
    (pbrt-v3 §12.6, §14.2.4).
    """

    is_infinite = True

    def __init__(self, light_to_world: Transform, l_rgb, mapname: str = "", n_samples=1):
        from pbrt_tpu.core.mipmap import MIPMap

        self.l2w = light_to_world
        self._l2wm, self._w2lm = (
            jnp.asarray(light_to_world.m.astype(float_t)),
            jnp.asarray(light_to_world.m_inv.astype(float_t)),
        )
        raw = np.asarray(l_rgb, dtype=float_t)  # raw RGB tint
        self.l_rgb = _promote_emission(raw)
        self._ld = jnp.asarray(self.l_rgb)
        self.mipmap = None
        self.distribution = None
        if mapname:
            try:
                from pbrt_tpu.core.imageio import read_image

                img, (w, h) = read_image(mapname)
                # promote (tint x map) once, illuminant basis
                img = _promote_emission(
                    np.asarray(img, dtype=np.float64) * raw[None, None]
                ).astype(np.float64)
                self.mipmap = MIPMap(img.astype(float_t))
                lum = 0.212671 * img[..., 0] + 0.715160 * img[..., 1] + 0.072169 * img[..., 2]
                sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)
                self.distribution = Distribution2D(lum * sin_theta[:, None])
            except (OSError, ValueError) as e:
                log.error("infinite light: cannot read '%s': %s", mapname, e)

    def power(self):
        if self.mipmap is None:
            return PI * self.l_rgb
        return PI * np.asarray(self.mipmap._flat).mean(axis=0)

    def _le_dir(self, d_world, l_override=None):
        """Radiance along world direction d (leaving the scene)."""
        if self.mipmap is None:
            ld = self._ld if l_override is None else l_override
            return jnp.broadcast_to(ld, d_world.shape[:-1] + (3,))
        w = apply_vector(self._w2lm, d_world)
        w = w / jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
        theta = jnp.arccos(jnp.clip(w[..., 2], -1, 1))
        phi = jnp.arctan2(w[..., 1], w[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * PI, phi)
        return self.mipmap.lookup(phi * INV_2PI, theta * INV_PI)

    def le_escaped(self, d, l_override=None):
        return self._le_dir(d, l_override)

    def sample_li(self, p, u2, l_override=None):
        n = p.shape[0]
        if self.distribution is None:
            d_l = uniform_sample_sphere(u2)
            wi = apply_vector(self._l2wm, d_l)
            ld = self._ld if l_override is None else l_override
            li = jnp.broadcast_to(ld, (n, 3))
            pdf = jnp.full((n,), 1.0 / (4 * PI), dtype=p.dtype)
        else:
            uv, map_pdf = self.distribution.sample_continuous(u2)
            theta = uv[..., 1] * PI
            phi = uv[..., 0] * 2 * PI
            st, ct = jnp.sin(theta), jnp.cos(theta)
            d_l = jnp.stack([st * jnp.cos(phi), st * jnp.sin(phi), ct], axis=-1)
            wi = apply_vector(self._l2wm, d_l)
            li = self.mipmap.lookup(uv[..., 0], uv[..., 1])
            pdf = jnp.where(
                st > 1e-7, map_pdf / (2 * PI * PI * jnp.maximum(st, 1e-7)), 0.0
            )
        dist = jnp.full((n,), BIG_DIST, dtype=p.dtype)
        return wi, li, pdf, dist

    def pdf_li(self, p, wi):
        if self.distribution is None:
            return jnp.full(p.shape[:-1], 1.0 / (4 * PI), dtype=p.dtype)
        w = apply_vector(self._w2lm, wi)
        w = w / jnp.maximum(jnp.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
        theta = jnp.arccos(jnp.clip(w[..., 2], -1, 1))
        phi = jnp.arctan2(w[..., 1], w[..., 0])
        phi = jnp.where(phi < 0, phi + 2 * PI, phi)
        st = jnp.sin(theta)
        uv = jnp.stack([phi * INV_2PI, theta * INV_PI], axis=-1)
        return jnp.where(
            st > 1e-7,
            self.distribution.pdf_at(uv) / (2 * PI * PI * jnp.maximum(st, 1e-7)),
            0.0,
        )


class DiffuseAreaLight(Light):
    """Emissive geometry: triangles (tessellated or meshes) and spheres.

    The scene builder hands us the emitting primitives' world-space data;
    NEE samples area-uniformly via a Distribution1D over triangle areas.
    """

    def __init__(self, l_emit, two_sided, tri_p0, tri_p1, tri_p2, sph_centers=None,
                 sph_radii=None):
        self.l_emit = np.asarray(l_emit, dtype=float_t)
        self._ld = jnp.asarray(self.l_emit)
        self.two_sided = bool(two_sided)
        self.tri_p0 = jnp.asarray(tri_p0.astype(float_t)) if tri_p0 is not None and len(tri_p0) else None
        if self.tri_p0 is not None:
            self.tri_p1 = jnp.asarray(tri_p1.astype(float_t))
            self.tri_p2 = jnp.asarray(tri_p2.astype(float_t))
            cr = np.cross(tri_p1 - tri_p0, tri_p2 - tri_p0)
            areas = 0.5 * np.linalg.norm(cr, axis=-1)
            self.total_area = float(areas.sum())
            self.area_dist = Distribution1D(areas)
            n = cr / np.maximum(np.linalg.norm(cr, axis=-1, keepdims=True), 1e-12)
            self.tri_n = jnp.asarray(n.astype(float_t))
            # packed [T, 12] p0|p1|p2|n table for the one-row
            # select in sample_li (gathers from tiny tables serialize)
            self._tri_cols = jnp.asarray(
                np.concatenate([tri_p0, tri_p1, tri_p2, n], axis=1).astype(float_t)
            )
        else:
            self.total_area = 1.0
        self.sph_centers = (
            jnp.asarray(np.asarray(sph_centers, dtype=float_t))
            if sph_centers is not None and len(sph_centers)
            else None
        )
        if self.sph_centers is not None:
            self.sph_radii = jnp.asarray(np.asarray(sph_radii, dtype=float_t))
            sa = 4 * np.pi * np.asarray(sph_radii) ** 2
            self.total_area += float(sa.sum())

    def power(self):
        return self.l_emit * self.total_area * PI * (2.0 if self.two_sided else 1.0)

    def l_emitted(self, n_hit, w_out, l_override=None):
        """Radiance leaving a point with normal n_hit toward w_out."""
        ld = self._ld if l_override is None else l_override
        facing = jnp.sum(n_hit * w_out, axis=-1) > 0
        ok = facing | self.two_sided
        return jnp.where(ok[..., None], ld, 0.0)

    def sample_li(self, p, u2, l_override=None):
        # triangles only for now (sphere emitters converted by builder)
        x, pdf_tri, tri_idx = self.area_dist.sample_continuous(u2[..., 0])
        # reuse the fractional part of x as one fresh uniform for the triangle
        frac = jnp.clip(x * self.area_dist.n - tri_idx, 0.0, 0.999999)
        b = uniform_sample_triangle(jnp.stack([frac, u2[..., 1]], axis=-1))
        from pbrt_tpu.ops.tables import select_rows

        rows = select_rows(self._tri_cols, tri_idx)
        p0, p1, p2, n_l = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9], rows[:, 9:12]
        p_l = p0 + b[..., 0:1] * (p1 - p0) + b[..., 1:2] * (p2 - p0)
        to_l = p_l - p
        d2 = jnp.sum(to_l * to_l, axis=-1)
        dist = jnp.sqrt(d2)
        wi = to_l / jnp.maximum(dist[..., None], 1e-12)
        cos_l = jnp.sum(n_l * (-wi), axis=-1)
        cos_term = jnp.abs(cos_l) if self.two_sided else jnp.maximum(cos_l, 0.0)
        # area pdf -> solid angle
        pdf = d2 / jnp.maximum(cos_term * self.total_area, 1e-9)
        ld = self._ld if l_override is None else l_override
        li = jnp.where((cos_term > 1e-7)[..., None], ld, 0.0)
        pdf = jnp.where(cos_term > 1e-7, pdf, 0.0)
        return wi, li, pdf, dist * (1.0 - 1e-3)

    def pdf_li_at_hit(self, p_ref, p_hit, n_hit, wi):
        """Solid-angle pdf that sample_li would have produced p_hit."""
        to_l = p_hit - p_ref
        d2 = jnp.sum(to_l * to_l, axis=-1)
        cos_l = jnp.abs(jnp.sum(n_hit * (-wi), axis=-1))
        return d2 / jnp.maximum(cos_l * self.total_area, 1e-9)


# ---------------------------------------------------------------------------
# Factory (api.rs:334-351 make_light, completed)
# ---------------------------------------------------------------------------


def _promote_emission(rgb):
    """Promote an RGB emission product via the illuminant Smits basis
    (no-op outside a spectral pass)."""
    from pbrt_tpu.core.spectrum import promote_rgb

    return promote_rgb(rgb, illuminant=True)


def make_light(record) -> Light | None:
    """LightRecord (core/api.py) -> Light instance."""
    name, params, l2w = record.name, record.params, record.light_to_world
    one = np.ones(3, dtype=float_t)
    zero3 = np.zeros(3, dtype=float_t)
    if name in ("infinite", "exinfinite"):
        l_rgb = params.find_one_spectrum_raw("L", one)
        scale = params.find_one_spectrum_raw("scale", one)
        mapname = params.find_one_filename("mapname", "")
        params.find_one_int("samples", params.find_one_int("nsamples", 1))
        # raw RGB tint: the light promotes (tint x map) once, illuminant basis
        return InfiniteAreaLight(l2w, l_rgb * scale, mapname)
    if name == "point":
        i = _promote_emission(
            params.find_one_spectrum_raw("I", one)
            * params.find_one_spectrum_raw("scale", one)
        )
        from_p = params.find_one_point3f("from", zero3)
        return PointLight(l2w * Transform.translate(from_p), i)
    if name == "spot":
        i = _promote_emission(
            params.find_one_spectrum_raw("I", one)
            * params.find_one_spectrum_raw("scale", one)
        )
        cone = params.find_one_float("coneangle", 30.0)
        delta = params.find_one_float("conedeltaangle", 5.0)
        from_p = params.find_one_point3f("from", zero3)
        to_p = params.find_one_point3f("to", np.array([0, 0, 1], dtype=float_t))
        from pbrt_tpu.core.transform import Transform as T

        dir_ = to_p - from_p
        nrm = np.linalg.norm(dir_)
        if nrm > 1e-9:
            z = dir_ / nrm
            x = np.cross(np.array([0.0, 1.0, 0.001]), z)
            x /= np.linalg.norm(x)
            y = np.cross(z, x)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = x, y, z, from_p
            l2w = l2w * T(m)
        else:
            l2w = l2w * T.translate(from_p)
        return SpotLight(l2w, i, cone, delta)
    if name == "distant":
        l_rgb = _promote_emission(
            params.find_one_spectrum_raw("L", one)
            * params.find_one_spectrum_raw("scale", one)
        )
        from_p = params.find_one_point3f("from", zero3)
        to_p = params.find_one_point3f("to", np.array([0, 0, 1], dtype=float_t))
        return DistantLight(l2w, l_rgb, from_p, to_p)
    if name == "goniometric":
        i = params.find_one_spectrum_raw("I", one) * params.find_one_spectrum_raw("scale", one)
        return GonioPhotometricLight(l2w, i, params.find_one_filename("mapname", ""))
    if name == "projection":
        i = params.find_one_spectrum_raw("I", one) * params.find_one_spectrum_raw("scale", one)
        fov = params.find_one_float("fov", 45.0)
        return ProjectionLight(l2w, i, params.find_one_filename("mapname", ""), fov)
    log.warning("Light '%s' unknown.", name)
    params.report_unused()
    return None
