"""Cameras: batched ray generation (pbrt-v3 ch. 6).

Raster->camera transforms are built on host (projective math mirrors
pbrt-v3 §6.2); ``generate_rays`` maps a wavefront of film samples to world
rays inside jit.  Perspective (with thin-lens depth of field),
orthographic, and environment cameras; realistic-lens is approximated by
perspective + DoF (documented gap).
"""

from __future__ import annotations

import logging

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import PI, float_t
from pbrt_tpu.core.sampling import concentric_sample_disk
from pbrt_tpu.core.transform import Transform, apply_point, apply_vector

# device matrix products run at full f32 (no TF32 on the GPU)
HIGHEST = jax.lax.Precision.HIGHEST

log = logging.getLogger("pbrt_tpu")


def _screen_window(frame_aspect, screen_window_param=None):
    if screen_window_param is not None:
        return screen_window_param
    if frame_aspect > 1.0:
        return (-frame_aspect, frame_aspect, -1.0, 1.0)
    return (-1.0, 1.0, -1.0 / frame_aspect, 1.0 / frame_aspect)


class ProjectiveCamera:
    def __init__(self, camera_to_world: Transform, camera_to_screen: Transform,
                 resolution, screen_window, lens_radius=0.0, focal_distance=1e6,
                 shutter_open=0.0, shutter_close=1.0):
        self.camera_to_world = camera_to_world
        self.lens_radius = float(lens_radius)
        self.focal_distance = float(focal_distance)
        self.shutter_open = float(shutter_open)
        self.shutter_close = float(shutter_close)
        x0, x1, y0, y1 = screen_window
        res_x, res_y = resolution
        screen_to_raster = (
            Transform.scale(res_x, res_y, 1.0)
            * Transform.scale(1.0 / (x1 - x0), 1.0 / (y0 - y1), 1.0)
            * Transform.translate([-x0, -y1, 0.0])
        )
        raster_to_screen = screen_to_raster.inverse()
        self.raster_to_camera = camera_to_screen.inverse() * raster_to_screen
        self._r2c = jnp.asarray(self.raster_to_camera.m.astype(float_t))
        self._c2w = jnp.asarray(self.camera_to_world.m.astype(float_t))
        self._w2c = jnp.asarray(self.camera_to_world.m_inv.astype(float_t))
        self._c2r = jnp.asarray(self.raster_to_camera.m_inv.astype(float_t))
        self.resolution = (int(res_x), int(res_y))
        # importance normalization: film area on the camera-space z=1 plane
        # (pbrt-v3 PerspectiveCamera constructor, cameras/perspective.cpp)
        pmin = self.raster_to_camera.apply_p(np.zeros(3))
        pmax = self.raster_to_camera.apply_p(np.array([res_x, res_y, 0.0]))
        if abs(pmin[2]) > 1e-9 and abs(pmax[2]) > 1e-9:
            pmin = pmin / pmin[2]
            pmax = pmax / pmax[2]
            self.film_area = float(abs((pmax[0] - pmin[0]) * (pmax[1] - pmin[1])))
        else:
            self.film_area = 1.0
        self.cam_pos_world = np.asarray(
            self.camera_to_world.apply_p(np.zeros(3)), dtype=float_t
        )
        self._anim_c2w = None  # [K,4,4] keyframes when the camera moves

    def set_animation(self, key_transforms):
        """Camera motion blur: keyframed camera-to-world matrices across
        the shutter (decompose+slerp on host, per-lane hat-weight blending
        on device — core/animated.py)."""
        import numpy as _np

        self._anim_c2w = jnp.asarray(
            _np.stack([t.m for t in key_transforms]).astype(float_t)
        )

    def _apply_c2w(self, o, d, u_time):
        """Camera-space (o, d) -> world, per-lane animated when keyed."""
        if self._anim_c2w is None or u_time is None:
            o_w = apply_point(self._c2w, o)
            d_w = apply_vector(self._c2w, d)
        else:
            from pbrt_tpu.ops.animated_intersect import time_weights

            k = self._anim_c2w.shape[0]
            w = time_weights(
                jnp.broadcast_to(u_time, o.shape[:-1]).astype(o.dtype), k
            )
            m = jnp.einsum("nk,kij->nij", w, self._anim_c2w.astype(o.dtype),
                           precision=HIGHEST)
            o_w = jnp.einsum("nij,nj->ni", m[:, :3, :3], o,
                             precision=HIGHEST) + m[:, :3, 3]
            d_w = jnp.einsum("nij,nj->ni", m[:, :3, :3], d,
                             precision=HIGHEST)
        return o_w, d_w / jnp.linalg.norm(d_w, axis=-1, keepdims=True)


class PerspectiveCamera(ProjectiveCamera):
    def __init__(self, camera_to_world, fov_deg, resolution, screen_window=None,
                 lens_radius=0.0, focal_distance=1e6, **kw):
        aspect = resolution[0] / resolution[1]
        sw = _screen_window(aspect, screen_window)
        super().__init__(
            camera_to_world,
            Transform.perspective(fov_deg, 1e-2, 1000.0),
            resolution,
            sw,
            lens_radius,
            focal_distance,
            **kw,
        )

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        """p_film: [N,2] raster samples -> (origin [N,3], dir [N,3], weight [N])."""
        n = p_film.shape[0]
        p_raster = jnp.concatenate(
            [p_film, jnp.zeros((n, 1), dtype=p_film.dtype)], axis=-1
        )
        p_camera = apply_point(self._r2c, p_raster)
        d = p_camera / jnp.linalg.norm(p_camera, axis=-1, keepdims=True)
        o = jnp.zeros_like(d)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * concentric_sample_disk(u_lens)
            ft = self.focal_distance / d[..., 2:3]
            p_focus = d * ft
            o = jnp.concatenate([p_lens, jnp.zeros((n, 1), dtype=d.dtype)], axis=-1)
            d = p_focus - o
            d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o_w, d_w = self._apply_c2w(o, d, u_time)
        return o_w, d_w, jnp.ones(n, dtype=float_t)

    # -- camera importance (pbrt-v3 We/Pdf_We, cameras/perspective.cpp) -----
    # pinhole only (lens_radius == 0); used by BDPT's light-tracing (t=1)
    # strategies and their MIS densities.

    @property
    def supports_light_tracing(self):
        return self.lens_radius == 0.0

    def pdf_we_dir(self, d_world):
        """Directional density of generate_rays: 1/(A cos^3 theta) inside
        the frustum, 0 outside (pbrt Pdf_We)."""
        d_cam = apply_vector(self._w2c, d_world)
        d_cam = d_cam / jnp.maximum(
            jnp.linalg.norm(d_cam, axis=-1, keepdims=True), 1e-12
        )
        cos_t = d_cam[..., 2]
        ok = cos_t > 1e-6
        p_focus = d_cam / jnp.maximum(cos_t, 1e-6)[..., None]
        p_raster = apply_point(self._c2r, p_focus)
        rx, ry = self.resolution
        ok = (
            ok
            & (p_raster[..., 0] >= 0.0) & (p_raster[..., 0] < rx)
            & (p_raster[..., 1] >= 0.0) & (p_raster[..., 1] < ry)
        )
        pdf = 1.0 / jnp.maximum(self.film_area * cos_t**3, 1e-12)
        return jnp.where(ok, pdf, 0.0)

    def project(self, p_world):
        """World point -> (raster [N,2], valid, cos theta, dist) relative to
        the pinhole (pbrt We raster computation)."""
        pc = apply_point(self._w2c, p_world)
        dist = jnp.maximum(jnp.linalg.norm(pc, axis=-1), 1e-12)
        cos_t = pc[..., 2] / dist
        ok = cos_t > 1e-6
        p_focus = pc / jnp.maximum(pc[..., 2], 1e-9)[..., None]
        p_raster = apply_point(self._c2r, p_focus)
        rx, ry = self.resolution
        ok = (
            ok
            & (p_raster[..., 0] >= 0.0) & (p_raster[..., 0] < rx)
            & (p_raster[..., 1] >= 0.0) & (p_raster[..., 1] < ry)
        )
        return p_raster[..., :2], ok, cos_t, dist


class OrthographicCamera(ProjectiveCamera):
    def __init__(self, camera_to_world, resolution, screen_window=None,
                 lens_radius=0.0, focal_distance=1e6, **kw):
        aspect = resolution[0] / resolution[1]
        sw = _screen_window(aspect, screen_window)
        super().__init__(
            camera_to_world,
            Transform.orthographic(0.0, 1.0),
            resolution,
            sw,
            lens_radius,
            focal_distance,
            **kw,
        )

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        n = p_film.shape[0]
        p_raster = jnp.concatenate(
            [p_film, jnp.zeros((n, 1), dtype=p_film.dtype)], axis=-1
        )
        o = apply_point(self._r2c, p_raster)
        d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0], dtype=float_t), o.shape)
        if self.lens_radius > 0.0 and u_lens is not None:
            p_lens = self.lens_radius * concentric_sample_disk(u_lens)
            ft = self.focal_distance
            p_focus = o + d * ft
            o = o.at[..., 0:2].add(p_lens)
            d = p_focus - o
            d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        o_w, d_w = self._apply_c2w(o, d, u_time)
        return o_w, d_w, jnp.ones(n, dtype=float_t)


class EnvironmentCamera:
    def __init__(self, camera_to_world: Transform, resolution,
                 shutter_open=0.0, shutter_close=1.0):
        self.camera_to_world = camera_to_world
        self.resolution = resolution
        self.shutter_open = float(shutter_open)
        self.shutter_close = float(shutter_close)
        self._c2w = jnp.asarray(camera_to_world.m.astype(float_t))

    def generate_rays(self, p_film, u_lens=None, u_time=None):
        res_x, res_y = self.resolution
        theta = PI * p_film[..., 1] / res_y
        phi = 2 * PI * p_film[..., 0] / res_x
        st, ct = jnp.sin(theta), jnp.cos(theta)
        d = jnp.stack([st * jnp.cos(phi), ct, -st * jnp.sin(phi)], axis=-1)
        o = jnp.zeros_like(d)
        o_w = apply_point(self._c2w, o)
        d_w = apply_vector(self._c2w, d)
        return o_w, d_w, jnp.ones(p_film.shape[0], dtype=float_t)


def make_camera(name: str, params, camera_to_world: Transform, film) -> object:
    """Factory per pbrt-v3 MakeCamera; film supplies resolution/aspect."""
    res = film.full_resolution
    shutter_open = params.find_one_float("shutteropen", 0.0)
    shutter_close = params.find_one_float("shutterclose", 1.0)
    lens_radius = params.find_one_float("lensradius", 0.0)
    focal = params.find_one_float("focaldistance", 1e6)
    frame = params.find_one_float(
        "frameaspectratio", res[0] / res[1]
    )
    sw_list = params.find_float("screenwindow")
    sw = None
    if sw_list is not None and len(sw_list) == 4:
        sw = (float(sw_list[0]), float(sw_list[1]), float(sw_list[2]), float(sw_list[3]))
    common = dict(shutter_open=shutter_open, shutter_close=shutter_close)
    if name == "perspective":
        fov = params.find_one_float("fov", 90.0)
        half = params.find_one_float("halffov", -1.0)
        if half > 0:
            fov = 2 * half
        return PerspectiveCamera(
            camera_to_world, fov, res, sw, lens_radius, focal, **common
        )
    if name == "orthographic":
        return OrthographicCamera(camera_to_world, res, sw, lens_radius, focal, **common)
    if name == "environment":
        return EnvironmentCamera(camera_to_world, res, **common)
    if name == "realistic":
        from pbrt_tpu.cameras.realistic import (
            BUILTIN_LENSES,
            RealisticCamera,
            load_lens_file,
        )

        raw = params.find_one_string("lensfile", "")
        lensfile = raw if raw in BUILTIN_LENSES else params.find_one_filename("lensfile", "")
        ap_mm = params.find_one_float("aperturediameter", 1.0)
        focusd = params.find_one_float("focusdistance", 10.0)
        simple = params.find_one_bool("simpleweighting", True)
        try:
            elements = load_lens_file(lensfile)
            return RealisticCamera(
                camera_to_world,
                elements,
                film,
                focus_distance=focusd,
                aperture_diameter_m=ap_mm * 1e-3,
                simple_weighting=simple,
                **common,
            )
        except (OSError, ValueError) as err:
            log.error("realistic camera: %s; falling back to perspective", err)
            return PerspectiveCamera(
                camera_to_world, 45.0, res, sw, lens_radius, focal, **common
            )
    log.warning("Camera '%s' unknown; using perspective.", name)
    return PerspectiveCamera(camera_to_world, 90.0, res, sw, lens_radius, focal, **common)
