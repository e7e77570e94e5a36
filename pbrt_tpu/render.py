"""Top-level render orchestration: the ``world_end -> Render`` step.

The reference stops exactly here (api.rs:432-473 stubbed); this module is
the device realization: build device tables, jit one wavefront step (camera
ray gen -> path trace -> filtered film scatter-add), then sweep
(sample index x pixel chunk) with a single compiled program.
"""

from __future__ import annotations

import logging
import time

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import Options, float_t
from pbrt_tpu.integrators import make_integrator
from pbrt_tpu.scene.builder import build_scene

log = logging.getLogger("pbrt_tpu")


class Renderer:
    """Holds the compiled scene + jitted step; reusable across spp."""

    def __init__(self, desc, options: Options | None = None, seed: int = 0):
        self.options = options or Options()
        self.compiled = build_scene(desc, self.options, seed)
        self.integrator = make_integrator(self.compiled)
        # config hygiene after the last factory consumes its params
        # (reference pattern api.rs:347,962)
        self.compiled.integrator_params.report_unused()
        self.film = self.compiled.film
        self.sampler = self.compiled.sampler
        self.camera = self.compiled.camera
        self._step = jax.jit(self._step_impl, static_argnames=("index_bound",))
        self.rays_traced = 0

    def _step_impl(self, state, pixel_xy, sample_index, lane_mask,
                   splat_scale=1.0, index_bound=None):
        sampler = self.sampler
        if index_bound:
            sampler = sampler.bounded(index_bound)
        u_film = sampler.get2(pixel_xy, sample_index, 0)
        p_film = pixel_xy.astype(float_t) + u_film
        u_lens = sampler.get2(pixel_xy, sample_index, 2)
        u_time = (
            sampler.get(pixel_xy, sample_index, 4)
            if getattr(self.camera, "_anim_c2w", None) is not None
            else None
        )
        o, d, w = self.camera.generate_rays(p_film, u_lens, u_time)
        if getattr(self.integrator, "provides_splats", False):
            # integrators with light-tracing strategies (BDPT t=1) emit
            # film splats at pixels other than the lane's own
            L, splats = self.integrator.li_splat(
                sampler, pixel_xy, sample_index, o, d
            )
        else:
            L = self.integrator.li(sampler, pixel_xy, sample_index, o, d)
            splats = []
        L = jnp.where(jnp.isfinite(L), L, 0.0) * w[..., None]
        state = self.film.add_samples(state, p_film, L, mask=lane_mask)
        for ps, Ls, ms in splats:
            Ls = jnp.where(jnp.isfinite(Ls), Ls, 0.0) * splat_scale
            state = self.film.add_splats(state, ps, Ls, mask=ms & lane_mask)
        return state

    def _frame_dense(self, state, n_pix, n_chunks, pix_per_chunk, spp):
        """Whole frame (chunk loop + film combine) in ONE device dispatch.

        Lane -> (pixel, sample) is derived on device from the chunk counter
        (the film rectangle is row-major), so the host uploads nothing at
        all — with the remote-accelerator dispatch path, per-chunk operand
        transfers and per-op dispatch latency were ~60% of frame
        wall-clock.  All shape parameters are static.
        """
        b = self.film.cropped_pixel_bounds
        w = b.width
        h = b.height
        x0, y0 = b.p_min
        flat = {
            "fx": jnp.zeros((n_chunks * pix_per_chunk, 3), dtype=float_t),
            "fw": jnp.zeros((n_chunks * pix_per_chunk,), dtype=float_t),
        }

        def chunk(ci, flat):
            pix_start = ci * pix_per_chunk
            idx = pix_start + jnp.arange(pix_per_chunk, dtype=jnp.int32)
            pix_ok = idx < n_pix
            idxc = jnp.minimum(idx, n_pix - 1)
            pixel_xy = jnp.stack(
                [x0 + idxc % w, y0 + idxc // w], axis=-1
            )  # [P, 2]
            pixel_xy = jnp.repeat(pixel_xy, spp, axis=0)  # [P*spp, 2]
            sample_index = jnp.tile(
                jnp.arange(spp, dtype=jnp.uint32), pix_per_chunk
            )
            lane_mask = jnp.repeat(pix_ok, spp)
            return self._step_impl_dense(
                flat, pixel_xy, sample_index, lane_mask, pix_start, spp
            )

        if n_chunks == 1:
            flat = chunk(0, flat)
        else:
            flat = jax.lax.fori_loop(0, n_chunks, chunk, flat)
        return {
            "xyz": state["xyz"] + flat["fx"][: h * w].reshape(h, w, 3),
            "weight": state["weight"] + flat["fw"][: h * w].reshape(h, w),
            "splat_xyz": state["splat_xyz"],
        }

    def _step_impl_dense(self, flat, pixel_xy, sample_index, lane_mask,
                         pix_start, spp):
        """Scatter-free film accumulation for box filters with radius <= 0.5.

        Lanes arrive pixel-major with ``spp`` consecutive samples per pixel
        covering a contiguous row-major range of the (padded) flat film
        starting at index ``pix_start`` — so accumulation is a reshape-sum
        plus one dynamic-slice add, with no scatter.  Whether the GPU still
        needs it beside the scatter path is ROADMAP 1f.  ``flat`` = {"fx": [P,3], "fw": [P]} padded flat film.
        """
        import numpy as _np

        from pbrt_tpu.core import spectrum as spec

        sampler = self.sampler.bounded(spp)
        u_film = sampler.get2(pixel_xy, sample_index, 0)
        p_film = pixel_xy.astype(float_t) + u_film
        u_lens = sampler.get2(pixel_xy, sample_index, 2)
        u_time = (
            sampler.get(pixel_xy, sample_index, 4)
            if getattr(self.camera, "_anim_c2w", None) is not None
            else None
        )
        o, d, w = self.camera.generate_rays(p_film, u_lens, u_time)
        L = self.integrator.li(sampler, pixel_xy, sample_index, o, d)
        L = jnp.where(jnp.isfinite(L), L, 0.0) * w[..., None]
        L = jnp.where(lane_mask[..., None], L, 0.0)
        m = jnp.asarray(_np.asarray(spec.RGB_TO_XYZ, dtype=float_t))
        xyz = jnp.matmul(L, m.T, precision=jax.lax.Precision.HIGHEST)
        n_pix_chunk = pixel_xy.shape[0] // spp
        pix_xyz = xyz.reshape(n_pix_chunk, spp, 3).sum(axis=1)
        pix_w = lane_mask.astype(float_t).reshape(n_pix_chunk, spp).sum(axis=1)
        cur = jax.lax.dynamic_slice(flat["fx"], (pix_start, 0), (n_pix_chunk, 3))
        fx = jax.lax.dynamic_update_slice(flat["fx"], cur + pix_xyz, (pix_start, 0))
        cur_w = jax.lax.dynamic_slice(flat["fw"], (pix_start,), (n_pix_chunk,))
        fw = jax.lax.dynamic_update_slice(flat["fw"], cur_w + pix_w, (pix_start,))
        return {"fx": fx, "fw": fw}

    def _count_queries(self, n_samples: int):
        """Exact intersector-query accounting: integrators that expose
        ``queries_per_sample()`` (the unrolled-loop structural counts)
        feed the ``render/{closest,shadow}_queries`` counters — the
        bench's audit-proof Mray/s numerator."""
        qps = getattr(self.integrator, "queries_per_sample", None)
        if qps is None:
            return
        from pbrt_tpu.utils import stats

        closest, shadow = qps()
        stats.count("render/closest_queries", n_samples * closest)
        stats.count("render/shadow_queries", n_samples * shadow)

    def render(self, spp: int | None = None, state=None, progress: bool = True):
        """Sweep all (pixel, sample) pairs as wavefront lanes.

        Samples are folded into the lane axis (lane = pixel * spp + s) so a
        whole frame is a handful of device dispatches — important both for
        utilization and because host->device dispatch latency dominates
        small renders.
        """
        film = self.film
        sample_bounds = film.get_sample_bounds()
        pixels = sample_bounds.offsets().astype(np.int32)  # [P,2]
        n_pix = len(pixels)
        explicit_spp = spp  # caller-specified budget only, None otherwise
        spp = spp if spp is not None else self.sampler.samples_per_pixel
        if self.options.quick_render:
            spp = max(1, spp // 4)
        # lanes = (pixel, sample) pairs
        n_lanes = n_pix * spp
        batch = min(self.options.ray_batch, max(1, n_lanes))
        batch = max(spp, (batch // spp) * spp)  # chunks align to whole pixels
        n_chunks = -(-n_lanes // batch)

        if getattr(self.integrator, "custom_render", False):
            # custom-budget integrators (MLT mutationsperpixel, SPPM
            # numiterations) own their sample counts — the sampler's
            # pixelsamples must NOT override them (r5 bug: the resolved
            # spp silently replaced mutationsperpixel, making the scene
            # parameter dead).  Only an EXPLICIT spp argument overrides.
            return self.integrator.render(
                self, spp=explicit_spp, progress=progress
            )

        # --- checkpoint / resume (SURVEY §5: preemption recovery) --------
        ckpt_path = None
        resume_cursor = 0
        if self.options.checkpoint_dir:
            from pathlib import Path

            from pbrt_tpu.utils.checkpoint import load_checkpoint

            ckpt_path = Path(self.options.checkpoint_dir) / "film.ckpt.npz"
            meta_want = {
                "res": list(self.film.full_resolution),
                "spp": int(spp),
                "n_chunks": int(n_chunks),
            }
            loaded = load_checkpoint(ckpt_path)
            if loaded is not None and state is None:
                ck_state, cursor, meta = loaded
                if meta == meta_want and 0 < cursor <= n_chunks:
                    state = ck_state
                    resume_cursor = cursor
                    log.info("Resuming from %s at chunk %d/%d",
                             ckpt_path, cursor, n_chunks)
                else:
                    log.warning("Checkpoint %s does not match this render "
                                "(have %s, want %s); ignoring", ckpt_path,
                                meta, meta_want)
        if state is None:
            state = film.initial_state()
        t0 = time.time()

        # dense (scatter-free) path: box filter confined to its own pixel,
        # chunks aligned to whole pixels.  Checkpointed renders take the
        # host-chunked path so the sweep cursor is a real host boundary.
        rx, ry = film.filter.radius
        b = film.cropped_pixel_bounds
        dense = (
            rx <= 0.5
            and ry <= 0.5
            and sample_bounds.p_min == b.p_min
            and sample_bounds.p_max == b.p_max
            and batch % spp == 0
            # splatting integrators scatter to arbitrary pixels
            and not getattr(self.integrator, "provides_splats", False)
            and ckpt_path is None
        )
        if dense:
            if not hasattr(self, "_frame_dense_jit"):
                self._frame_dense_jit = jax.jit(
                    self._frame_dense,
                    static_argnames=("n_pix", "n_chunks", "pix_per_chunk", "spp"),
                    donate_argnums=(0,),
                )
            pix_per_chunk = batch // spp
            if progress:
                log.info(
                    "rendering %d chunk(s) x %d lanes in one dispatch",
                    n_chunks, batch,
                )
            state = self._frame_dense_jit(
                state,
                n_pix=n_pix,
                n_chunks=n_chunks,
                pix_per_chunk=pix_per_chunk,
                spp=spp,
            )
            jax.block_until_ready(state["weight"])
            self.rays_traced += n_pix * spp
            from pbrt_tpu.utils import stats

            stats.count("render/chunks", n_chunks)
            stats.count("render/camera_samples", n_pix * spp)
            self._count_queries(n_pix * spp)
            return state

        # general (scatter) path: host-built lane arrays per chunk
        lane_pixels = np.repeat(pixels, spp, axis=0)
        lane_sidx = np.tile(np.arange(spp, dtype=np.uint32), n_pix)
        pad = n_chunks * batch - n_lanes
        if pad:
            lane_pixels = np.concatenate(
                [lane_pixels, np.repeat(lane_pixels[-1:], pad, axis=0)]
            )
            lane_sidx = np.concatenate(
                [lane_sidx, np.zeros(pad, dtype=np.uint32)]
            )
        mask = np.arange(n_chunks * batch) < n_lanes
        chunks = lane_pixels.reshape(n_chunks, batch, 2)
        sidx_chunks = lane_sidx.reshape(n_chunks, batch)
        masks = mask.reshape(n_chunks, batch)
        splat_scale = jnp.asarray(1.0 / spp, dtype=float_t)
        from pbrt_tpu.utils import stats

        for ci in range(resume_cursor, n_chunks):
            state = self._step(
                state,
                jnp.asarray(chunks[ci]),
                jnp.asarray(sidx_chunks[ci]),
                jnp.asarray(masks[ci]),
                splat_scale,
                index_bound=spp,
            )
            stats.count("render/chunks")
            if ckpt_path is not None and (
                (ci + 1) % max(1, self.options.checkpoint_every) == 0
                or ci == n_chunks - 1
            ):
                from pbrt_tpu.utils.checkpoint import save_checkpoint

                jax.block_until_ready(state["weight"])
                save_checkpoint(ckpt_path, state, ci + 1, meta_want)
            if progress and (ci == 0 or ci == n_chunks - 1 or (ci + 1) % 8 == 0):
                jax.block_until_ready(state["weight"])
                log.info(
                    "chunk %d/%d (%.2fs elapsed)", ci + 1, n_chunks, time.time() - t0
                )
        jax.block_until_ready(state["weight"])
        self.rays_traced += n_pix * spp
        stats.count("render/camera_samples", n_pix * spp)
        self._count_queries(n_pix * spp)
        return state


def render_scene(desc, options: Options | None = None, seed: int = 0,
                 write: bool = True):
    """Parse-result -> image on disk; returns dict with film state + image."""
    opt = options or Options()
    if opt.sampled_spectrum:
        from pbrt_tpu.core import spectrum as S

        if S.get_spectral_bins() is None:  # not already inside a pass
            return render_scene_spectral(desc, opt, seed, write)
    r = Renderer(desc, options, seed)
    t0 = time.time()
    state = r.render()
    dt = time.time() - t0
    from pbrt_tpu.utils import stats

    stats.count("render/rays_traced", r.rays_traced)
    stats.timed_add("render/wall_seconds", dt)
    img = np.asarray(r.film.to_rgb(state))
    log.info(
        "Rendered %dx%d @ %d spp in %.2fs",
        r.film.full_resolution[0],
        r.film.full_resolution[1],
        r.sampler.samples_per_pixel,
        dt,
    )
    if write and r.film.filename:
        r.film.write_image(state)
        log.info("Wrote %s", r.film.filename)
    return {
        "image": img,
        "state": state,
        "film": r.film,
        "renderer": r,
        "seconds": dt,
    }


def render_scene_spectral(desc, options: Options | None = None, seed: int = 0,
                          write: bool = True):
    """Full spectral (sampled-spectrum) transport.

    The reference reserves this as the compile-time ``sampled-spectrum``
    feature (Cargo.toml:26-28, spectrum.rs:151-193, SampledSpectrum all
    ``todo!``).  Spectral transport has no wavelength coupling (no
    fluorescence/dispersion in the pbrt-v3 feature set), so the 60-bin
    render decomposes exactly into independent per-bin renders; each pass
    re-binds three wavelength bins to the RGB pipeline's three channels
    (every host entry point for RGB data promotes via the Smits basis while
    the pass is active), and the per-bin radiances integrate against the
    CIE fits into XYZ.  ``options.n_spectral_bins`` controls the stride
    (15 default = 5 passes; 60 = the full grid)."""
    from pbrt_tpu.core import spectrum as S

    opt = options or Options()
    n_bins = int(opt.n_spectral_bins)
    k = S.N_SPECTRAL_SAMPLES
    if n_bins % 3 or k % n_bins:
        raise ValueError(
            f"n_spectral_bins={n_bins} must be a multiple of 3 dividing {k}"
        )
    stride = k // n_bins
    chosen = np.arange(n_bins) * stride + stride // 2
    t0 = time.time()
    xyz = None
    film = None
    try:
        for p in range(n_bins // 3):
            bins = chosen[3 * p : 3 * p + 3]
            S.set_spectral_bins(bins)
            out = render_scene(desc, opt, seed, write=False)
            film = out["film"]
            img = np.asarray(out["image"], dtype=np.float64)  # 3 bin radiances
            cmf = np.stack(
                [S._CIE_X[bins], S._CIE_Y[bins], S._CIE_Z[bins]]
            )  # [3 xyz, 3 bins]
            contrib = np.einsum("hwb,cb->hwc", img, cmf)
            xyz = contrib if xyz is None else xyz + contrib
            log.info("spectral pass %d/%d (bins %s)", p + 1, n_bins // 3, bins)
    finally:
        S.set_spectral_bins(None)
    xyz = xyz * (stride / S._CIE_Y_INTEGRAL)
    img = np.asarray(S.xyz_to_rgb(xyz.astype(float_t)))
    dt = time.time() - t0
    log.info("Spectral render (%d bins, %d passes) in %.2fs", n_bins,
             n_bins // 3, dt)
    if write and film is not None and film.filename:
        from pbrt_tpu.core.imageio import write_image as io_write

        io_write(film.filename, img.astype(float_t), film.cropped_pixel_bounds,
                 film.full_resolution)
        log.info("Wrote %s", film.filename)
    return {"image": img.astype(float_t), "film": film, "seconds": dt,
            "xyz": xyz}
