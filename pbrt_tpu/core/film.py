"""Film: the device-resident sensor model.

Reference semantics (/root/reference/src/core/film.rs): crop-window ->
cropped pixel bounds via ceil (film.rs:90-101), half-pixel+filter-radius
sample bounds (film.rs:166-175), physical extent from diagonal
(film.rs:218-227), precomputed 16x16 filter table (film.rs:113-123), and
write-time normalization order: xyz->rgb, /filter_weight_sum, + splat*scale,
*scale (film.rs:340-383).

The device design replaces the FilmTile/mutex machinery (film.rs:264-326): samples
are splatted by **scatter-add** directly into a ``[H, W]`` device tensor —
``x.at[idx].add(...)`` with ``mode='drop'`` gives free bounds clipping; a
sharded render keeps one partial film per device and merges with ``psum``
(SURVEY.md §2.2).  ``tile_bounds`` reproduces the reference's tile-clip
math for pixel-domain sharding.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.core import spectrum as spec
from pbrt_tpu.core.filters import FILTER_TABLE_WIDTH, Filter
from pbrt_tpu.core.geometry import Bounds2f, Bounds2i

# device matrix products run at full f32 (no TF32 on the GPU)
HIGHEST = jax.lax.Precision.HIGHEST


class Film:
    def __init__(
        self,
        resolution,
        crop_window=((0.0, 0.0), (1.0, 1.0)),
        filter: Filter = None,
        diagonal_mm: float = 35.0,
        filename: str = "pbrt.png",
        scale: float = 1.0,
        max_sample_luminance: float = float("inf"),
    ):
        from pbrt_tpu.core.filters import BoxFilter

        self.full_resolution = (int(resolution[0]), int(resolution[1]))
        self.crop_window = Bounds2f.from_points(crop_window[0], crop_window[1])
        self.filter = filter or BoxFilter((0.5, 0.5))
        self.diagonal_m = float(diagonal_mm) * 0.001
        self.filename = filename
        self.scale = float(scale)
        self.max_sample_luminance = float(max_sample_luminance)
        fx, fy = self.full_resolution
        # ceil-based crop (film.rs:92-101)
        self.cropped_pixel_bounds = Bounds2i(
            (
                math.ceil(fx * self.crop_window.p_min[0]),
                math.ceil(fy * self.crop_window.p_min[1]),
            ),
            (
                math.ceil(fx * self.crop_window.p_max[0]),
                math.ceil(fy * self.crop_window.p_max[1]),
            ),
        )
        self.filter_table = jnp.asarray(self.filter.table(FILTER_TABLE_WIDTH))

    # -- bounds math (film.rs:166-227) --------------------------------------

    def get_sample_bounds(self) -> Bounds2i:
        rx, ry = self.filter.radius
        b = self.cropped_pixel_bounds
        return Bounds2i(
            (
                math.floor(b.p_min[0] + 0.5 - rx),
                math.floor(b.p_min[1] + 0.5 - ry),
            ),
            (
                math.ceil(b.p_max[0] - 0.5 + rx),
                math.ceil(b.p_max[1] - 0.5 + ry),
            ),
        )

    def get_physical_extent(self) -> Bounds2f:
        aspect = self.full_resolution[1] / self.full_resolution[0]
        x = math.sqrt(self.diagonal_m**2 / (1 + aspect**2))
        y = aspect * x
        return Bounds2f((-x / 2, -y / 2), (x / 2, y / 2))

    def tile_bounds(self, sample_bounds: Bounds2i) -> Bounds2i:
        """Pixel bounds affected by samples in ``sample_bounds``, clipped to
        the crop (film.rs:264-281) — used for pixel-domain sharding."""
        rx, ry = self.filter.radius
        p0 = (
            math.ceil(sample_bounds.p_min[0] - 0.5 - rx),
            math.ceil(sample_bounds.p_min[1] - 0.5 - ry),
        )
        p1 = (
            math.floor(sample_bounds.p_max[0] - 0.5 + rx) + 1,
            math.floor(sample_bounds.p_max[1] - 0.5 + ry) + 1,
        )
        return Bounds2i.from_points(p0, p1).intersect(self.cropped_pixel_bounds)

    # -- device state --------------------------------------------------------

    def initial_state(self) -> Dict[str, jnp.ndarray]:
        w, h = self.cropped_pixel_bounds.diagonal()
        return {
            "xyz": jnp.zeros((h, w, 3), dtype=float_t),
            "weight": jnp.zeros((h, w), dtype=float_t),
            "splat_xyz": jnp.zeros((h, w, 3), dtype=float_t),
        }

    def _filter_support(self):
        # half-open support (-r, r]: floor(2r)+1 candidate pixels per axis
        rx, ry = self.filter.radius
        return (int(math.floor(2 * rx)) + 1, int(math.floor(2 * ry)) + 1)

    def add_samples(self, state, p_film, L_rgb, mask=None, sample_weight=1.0):
        """Accumulate filtered samples (device).

        p_film: [N,2] continuous sample positions (absolute raster coords);
        L_rgb: [N,3]; mask: [N] valid lanes.  Implements the pbrt
        discrete-continuous convention: the filter window around p-0.5,
        weights from the precomputed table (film.rs:34,113-123).
        """
        rx, ry = self.filter.radius
        inv_rx, inv_ry = 1.0 / rx, 1.0 / ry
        bx, by = self.cropped_pixel_bounds.p_min
        fw, fh = self._filter_support()
        if mask is None:
            mask = jnp.ones(p_film.shape[0], dtype=bool)

        # clamp samples to max luminance (film.rs max_sample_luminance)
        if np.isfinite(self.max_sample_luminance):
            y = (
                0.212671 * L_rgb[..., 0]
                + 0.715160 * L_rgb[..., 1]
                + 0.072169 * L_rgb[..., 2]
            )
            s = jnp.where(
                y > self.max_sample_luminance, self.max_sample_luminance / jnp.maximum(y, 1e-20), 1.0
            )
            L_rgb = L_rgb * s[..., None]

        # convert to XYZ once per sample (merge does this per pixel in the
        # reference, film.rs:320 — same result by linearity)
        m = jnp.asarray(np.asarray(spec.RGB_TO_XYZ, dtype=float_t))
        xyz = jnp.matmul(L_rgb, m.T, precision=HIGHEST)

        # half-open support (-r, r] per axis: a sample at an exact pixel
        # boundary belongs to the pixel it floors into — consistent with the
        # dense (scatter-free) accumulation path, and never drops samples
        # with jitter exactly 0 (Halton's first sample).
        px = p_film[..., 0] - 0.5
        py = p_film[..., 1] - 0.5
        x0 = (jnp.floor(px - rx) + 1).astype(jnp.int32)
        y0 = (jnp.floor(py - ry) + 1).astype(jnp.int32)
        x1 = jnp.floor(px + rx).astype(jnp.int32)
        y1 = jnp.floor(py + ry).astype(jnp.int32)

        film_xyz = state["xyz"]
        film_w = state["weight"]
        tbl = self.filter_table
        for j in range(fh):
            for i in range(fw):
                pxl_x = x0 + i
                pxl_y = y0 + j
                dx = jnp.abs((pxl_x.astype(float_t) - px) * inv_rx * FILTER_TABLE_WIDTH)
                dy = jnp.abs((pxl_y.astype(float_t) - py) * inv_ry * FILTER_TABLE_WIDTH)
                in_support = (pxl_x <= x1) & (pxl_y <= y1)
                ix = jnp.minimum(dx.astype(jnp.int32), FILTER_TABLE_WIDTH - 1)
                iy = jnp.minimum(dy.astype(jnp.int32), FILTER_TABLE_WIDTH - 1)
                fweight = tbl[iy, ix] * sample_weight
                ok = mask & in_support
                # local (cropped) coordinates; OOB lanes dropped by scatter
                ly = pxl_y - by
                lx = pxl_x - bx
                ly = jnp.where(ok, ly, -1)
                lx = jnp.where(ok, lx, -1)
                w = jnp.where(ok, fweight, 0.0)
                film_xyz = film_xyz.at[ly, lx].add(
                    xyz * w[..., None], mode="drop"
                )
                film_w = film_w.at[ly, lx].add(w, mode="drop")
        return {"xyz": film_xyz, "weight": film_w, "splat_xyz": state["splat_xyz"]}

    def add_splats(self, state, p_film, L_rgb, mask=None):
        """Unfiltered splat accumulation (film.rs add_splat, completed)."""
        if mask is None:
            mask = jnp.ones(p_film.shape[0], dtype=bool)
        m = jnp.asarray(np.asarray(spec.RGB_TO_XYZ, dtype=float_t))
        xyz = jnp.matmul(L_rgb, m.T, precision=HIGHEST)
        bx, by = self.cropped_pixel_bounds.p_min
        lx = jnp.floor(p_film[..., 0]).astype(jnp.int32) - bx
        ly = jnp.floor(p_film[..., 1]).astype(jnp.int32) - by
        lx = jnp.where(mask, lx, -1)
        ly = jnp.where(mask, ly, -1)
        splat = state["splat_xyz"].at[ly, lx].add(
            jnp.where(mask[..., None], xyz, 0.0), mode="drop"
        )
        return {"xyz": state["xyz"], "weight": state["weight"], "splat_xyz": splat}

    def set_image(self, state, rgb_image):
        """Directly set pixel values (film.rs:329-331, completed)."""
        m = jnp.asarray(np.asarray(spec.RGB_TO_XYZ, dtype=float_t))
        xyz = jnp.matmul(jnp.asarray(rgb_image), m.T, precision=HIGHEST)
        return {
            "xyz": xyz,
            "weight": jnp.ones_like(state["weight"]),
            "splat_xyz": jnp.zeros_like(state["splat_xyz"]),
        }

    def clear(self, state):
        return self.initial_state()

    # -- output --------------------------------------------------------------

    def to_rgb(self, state, splat_scale: float = 1.0):
        """Final [H,W,3] RGB per the write_image order (film.rs:340-372)."""
        minv = jnp.asarray(np.asarray(spec.XYZ_TO_RGB, dtype=float_t))
        rgb = jnp.matmul(state["xyz"], minv.T, precision=HIGHEST)
        w = state["weight"]
        inv_w = jnp.where(w != 0.0, 1.0 / jnp.where(w == 0.0, 1.0, w), 1.0)
        rgb = jnp.where(
            (w != 0.0)[..., None], jnp.maximum(rgb * inv_w[..., None], 0.0), rgb
        )
        splat_rgb = jnp.matmul(state["splat_xyz"], minv.T, precision=HIGHEST)
        rgb = rgb + splat_scale * splat_rgb
        return rgb * self.scale

    def get_pixel_xyz(self, state, p):
        """XYZ sums at absolute pixel p (film.rs:404-410 doctest helper)."""
        bx, by = self.cropped_pixel_bounds.p_min
        return np.asarray(state["xyz"])[p[1] - by, p[0] - bx]

    def write_image(self, state, splat_scale: float = 1.0, filename=None) -> None:
        from pbrt_tpu.core.imageio import write_image as io_write

        rgb = np.asarray(self.to_rgb(state, splat_scale))
        io_write(
            filename or self.filename,
            rgb,
            self.cropped_pixel_bounds,
            self.full_resolution,
        )
