"""Stochastic progressive photon mapping (pbrt-v3 ch. 16.2), wavefront form.

Per iteration:
  1. camera pass  — trace camera paths; specular chains continue, the first
     diffuse vertex becomes a *visible point* (position, normal, beta, kd);
     escaped/emissive contributions accumulate directly;
  2. photon pass  — emit photons from lights (area emitters + point lights),
     trace bounces, deposit at diffuse hits;
  3. gather       — photons are binned into a uniform grid by cell id,
     SORTED by cell key (one device sort); each visible point scans the
     27 neighboring cells' photon runs with a fixed per-cell cap K and
     accumulates flux within its radius;
  4. SPPM statistics — per-pixel radius shrink with alpha = 2/3.

Device design notes: the photon map is never a pointer structure — it is a
sorted array + searchsorted ranges, and the gather loop is a static 27 x K
unroll of pure vector ops.  The per-cell photon cap is the one documented
approximation (log()'d when exceeded); raise ``max_per_cell`` to tighten.
"""

from __future__ import annotations

import logging

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import PI, float_t
from pbrt_tpu.core.geometry import shading_frame, coordinate_system, vface_forward
from pbrt_tpu.core.sampling import cosine_sample_hemisphere, uniform_sample_sphere
from pbrt_tpu.integrators.path import INF_T, SHADOW_EPS, PathIntegrator, _to_local, _to_world
from pbrt_tpu.materials import eval_material_params
from pbrt_tpu.materials import bsdf as B
from pbrt_tpu.scene.builder import compute_interaction

log = logging.getLogger("pbrt_tpu")


class SPPMIntegrator(PathIntegrator):
    """Custom-loop integrator: drives its own iterations over the film."""

    custom_render = True

    def __init__(self, compiled, max_depth=5, n_iterations=16,
                 photons_per_iteration=-1, initial_radius=1.0,
                 max_per_cell=8):
        super().__init__(compiled, max_depth)
        self.n_iterations = int(n_iterations)
        self.photons_per_iter = int(photons_per_iteration)
        self.initial_radius = float(initial_radius)
        self.max_per_cell = int(max_per_cell)
        # pure-Lambertian scenes take the exact kd/pi gather shortcut;
        # anything glossy/hair/etc. evaluates the real BSDF per photon
        def _entry_types(e):
            if e.mix_children is not None:
                return [c.type_id for c in e.mix_children]
            return [e.type_id]

        self._gather_full_bsdf = any(
            t != B.MATTE
            for e in compiled.materials
            for t in _entry_types(e)
        )

    # -- camera pass -------------------------------------------------------

    def _camera_pass(self, sampler, pixel_xy, sidx, o, d, theta=None):
        """Follow specular chains to the first diffuse vertex.

        Returns (vp dict, L_direct [N,3]).
        """
        c = self.c
        n = o.shape[0]
        dt = o.dtype
        L = jnp.zeros((n, 3), dtype=dt)
        beta = jnp.ones((n, 3), dtype=dt)
        alive = jnp.ones((n,), dtype=bool)
        found = jnp.zeros((n,), dtype=bool)
        # per-lane shutter time (motion blur): the camera ray's dim-4 sample
        time = sampler.get(pixel_xy, sidx, 4) if self._animated else None
        vp_p = jnp.zeros((n, 3), dtype=dt)
        vp_ns = jnp.zeros((n, 3), dtype=dt)
        vp_beta = jnp.zeros((n, 3), dtype=dt)
        vp_kd = jnp.zeros((n, 3), dtype=dt)
        vp_ss = jnp.zeros((n, 3), dtype=dt)
        vp_ts = jnp.zeros((n, 3), dtype=dt)
        vp_wo = jnp.zeros((n, 3), dtype=dt)
        vp_params = None
        specular_bounce = jnp.ones((n,), dtype=bool)
        prev_pdf = jnp.ones((n,), dtype=dt)
        prev_p = o

        for bounce in range(self.max_depth):
            base = 5 + 7 * bounce
            hit = self._intersect(o, d, jnp.full((n,), INF_T, dtype=dt), time)
            esc = alive & ~hit["hit"]
            env = self._env_radiance(d, theta)
            L = L + jnp.where(esc[..., None], beta * env, 0.0)
            alive = alive & hit["hit"]
            si = compute_interaction(c.tables, hit, o, d, None, time)
            wo = si["wo"]
            if c.area_lights:
                le = self._emitted(si, wo, theta)
                L = L + jnp.where(alive[..., None], beta * le, 0.0)
            ns, ss, ts = shading_frame(si, wo)
            params = eval_material_params(c.materials, si["mat"], si, theta)
            params["outside"] = jnp.sum(si["ns"] * wo, axis=-1) > 0.0
            is_diffuse = (
                (params["type"] != B.MIRROR)
                & ~((params["type"] == B.GLASS) & (params["roughness"] <= B.ROUGH_GLASS_MIN_ALPHA))
                & (si["mat"] >= 0)
                & (params["type"] != B.NONE)
            )
            newly = alive & is_diffuse & ~found
            vp_p = jnp.where(newly[..., None], si["p"], vp_p)
            vp_ns = jnp.where(newly[..., None], ns, vp_ns)
            vp_beta = jnp.where(newly[..., None], beta, vp_beta)
            vp_kd = jnp.where(newly[..., None], params["kd"], vp_kd)
            vp_ss = jnp.where(newly[..., None], ss, vp_ss)
            vp_ts = jnp.where(newly[..., None], ts, vp_ts)
            vp_wo = jnp.where(newly[..., None], wo, vp_wo)
            if self._gather_full_bsdf:
                def _merge(new, old):
                    if not isinstance(new, jnp.ndarray) or new.ndim == 0:
                        return new
                    m = newly.reshape(newly.shape + (1,) * (new.ndim - 1))
                    return jnp.where(m, new, old)
                vp_params = (
                    params if vp_params is None
                    else jax.tree_util.tree_map(_merge, params, vp_params)
                )
            found = found | newly
            alive = alive & ~newly  # diffuse lanes stop; specular continue

            wo_l = _to_local(ns, ss, ts, wo)

            # direct lighting at the visible point (pbrt-v3 sppm.cpp does
            # UniformSampleOneLight here; photons then carry indirect only)
            if c.lights:
                u_sel = sampler.get(pixel_xy, sidx, base + 0)
                u_l = sampler.get2(pixel_xy, sidx, base + 1)
                wi_w, li, l_pdf, l_dist, l_delta = self._sample_one_light(
                    si["p"], u_sel, u_l, theta
                )
                wi_nee = _to_local(ns, ss, ts, wi_w)
                f_nee = B.bsdf_eval(params, wo_l, wi_nee)
                can = newly & (l_pdf > 0.0) & (jnp.max(f_nee, axis=-1) > 0.0)
                shadow_o = si["p"] + si["ng"] * SHADOW_EPS * jnp.sign(
                    jnp.sum(wi_w * si["ng"], axis=-1, keepdims=True)
                )
                occ = self._occluded(shadow_o, wi_w, l_dist - 2 * SHADOW_EPS, time)
                contrib = (
                    beta
                    * f_nee
                    * li
                    * (jnp.abs(wi_nee[..., 2]) / jnp.maximum(l_pdf, 1e-12))[..., None]
                )
                L = L + jnp.where((can & ~occ)[..., None], contrib, 0.0)

            if bounce == self.max_depth - 1:
                break
            u_lobe = sampler.get(pixel_xy, sidx, base + 3)
            u_b = sampler.get2(pixel_xy, sidx, base + 4)
            wi_l, f, pdf, spec = B.bsdf_sample(params, wo_l, u_lobe, u_b)
            wi_w = _to_world(ns, ss, ts, wi_l)
            ok = alive & (pdf > 0.0) & (jnp.max(f, axis=-1) > 0.0)
            beta = jnp.where(
                ok[..., None],
                beta * f * (jnp.abs(wi_l[..., 2]) / jnp.maximum(pdf, 1e-12))[..., None],
                beta,
            )
            alive = ok
            o = si["p"] + si["ng"] * SHADOW_EPS * jnp.sign(
                jnp.sum(wi_w * si["ng"], axis=-1, keepdims=True)
            )
            d = wi_w
            prev_p = si["p"]

        vp = {"p": vp_p, "ns": vp_ns, "beta": vp_beta, "kd": vp_kd,
              "valid": found, "ss": vp_ss, "ts": vp_ts, "wo": vp_wo,
              "params": vp_params}
        return vp, L

    # -- photon pass -------------------------------------------------------

    def _emit_photons(self, sampler, n_photons, iteration):
        """Sample photon origins/directions/powers from the scene's lights.

        Returns (o, d, power [N,3]).  Uses a dedicated 'photon pixel' key so
        photon randomness is decorrelated from camera sampling.
        """
        c = self.c
        dt = jnp.float32
        # fake pixel codes so the deterministic sampler gives fresh values
        lane = jnp.arange(n_photons, dtype=jnp.int32)
        pkey = jnp.stack([lane, jnp.full_like(lane, -7)], axis=-1)
        sidx = jnp.full((n_photons,), iteration, dtype=jnp.uint32)

        n_lights = max(1, len(c.lights))
        u_sel = sampler.get(pkey, sidx, 0)
        pick = jnp.minimum((u_sel * n_lights).astype(jnp.int32), n_lights - 1)
        u_pos = sampler.get2(pkey, sidx, 1)
        u_dir = sampler.get2(pkey, sidx, 3)

        o = jnp.zeros((n_photons, 3), dtype=dt)
        d = uniform_sample_sphere(u_dir)
        power = jnp.zeros((n_photons, 3), dtype=dt)
        from pbrt_tpu.lights import DiffuseAreaLight, DistantLight, PointLight, SpotLight

        for i, lt in enumerate(c.lights):
            mask = pick == i
            if isinstance(lt, PointLight):
                oi = jnp.broadcast_to(lt._pd, (n_photons, 3))
                di = uniform_sample_sphere(u_dir)
                pw = jnp.broadcast_to(lt._id * (4 * PI), (n_photons, 3))
            elif isinstance(lt, DiffuseAreaLight) and lt.tri_p0 is not None:
                x, pdf_tri, tri_idx = lt.area_dist.sample_continuous(u_pos[..., 0])
                frac = jnp.clip(x * lt.area_dist.n - tri_idx, 0.0, 0.999999)
                from pbrt_tpu.core.sampling import uniform_sample_triangle

                b = uniform_sample_triangle(
                    jnp.stack([frac, u_pos[..., 1]], axis=-1)
                )
                p0 = lt.tri_p0[tri_idx]
                p1 = lt.tri_p1[tri_idx]
                p2 = lt.tri_p2[tri_idx]
                oi = p0 + b[..., 0:1] * (p1 - p0) + b[..., 1:2] * (p2 - p0)
                n_l = lt.tri_n[tri_idx]
                # cosine-distributed emission from the surface
                local = cosine_sample_hemisphere(u_dir)
                s1, s2 = coordinate_system(n_l)
                di = local[..., 0:1] * s1 + local[..., 1:2] * s2 + local[..., 2:3] * n_l
                oi = oi + n_l * SHADOW_EPS
                pw = jnp.broadcast_to(
                    lt._ld * (PI * lt.total_area), (n_photons, 3)
                )
            else:
                # env/distant photons: emit inward from a bounding sphere
                mins, maxs = self.c.world_bounds
                center = jnp.asarray(((mins + maxs) / 2).astype(np.float32))
                radius = float(np.linalg.norm(maxs - mins) / 2 + 1e-3) * 1.5
                sp = uniform_sample_sphere(u_pos)
                oi = center + radius * sp
                di = -sp  # inward
                le = lt.le_escaped(-di) if lt.is_infinite else jnp.broadcast_to(
                    getattr(lt, "_ld", jnp.zeros(3)), (n_photons, 3)
                )
                pw = le * (PI * PI * 4 * radius * radius)
            o = jnp.where(mask[..., None], oi, o)
            d = jnp.where(mask[..., None], di, d)
            power = jnp.where(mask[..., None], pw * n_lights, power)
        return o, d, power / n_photons

    def _photon_pass(self, sampler, n_photons, iteration, theta=None):
        """Trace photons; returns deposited (pos, power, valid) arrays with
        max_depth deposits per photon lane."""
        c = self.c
        o, d, power = self._emit_photons(sampler, n_photons, iteration)
        lane = jnp.arange(n_photons, dtype=jnp.int32)
        pkey = jnp.stack([lane, jnp.full_like(lane, -9)], axis=-1)
        sidx = jnp.full((n_photons,), iteration, dtype=jnp.uint32)
        alive = jnp.ones((n_photons,), dtype=bool)
        time = sampler.get(pkey, sidx, 4) if self._animated else None

        dep_p = []
        dep_w = []
        dep_d = []
        dep_ok = []
        for bounce in range(self.max_depth):
            base = 5 + 7 * bounce
            hit = self._intersect(o, d, jnp.full((n_photons,), INF_T), time)
            alive = alive & hit["hit"]
            si = compute_interaction(c.tables, hit, o, d, None, time)
            wo = si["wo"]
            ns, ss, ts = shading_frame(si, wo)
            params = eval_material_params(c.materials, si["mat"], si, theta)
            params["outside"] = jnp.sum(si["ns"] * wo, axis=-1) > 0.0
            diffuse = (
                (params["type"] != B.MIRROR)
                & ~((params["type"] == B.GLASS) & (params["roughness"] <= B.ROUGH_GLASS_MIN_ALPHA))
                & (si["mat"] >= 0)
                & (params["type"] != B.NONE)
            )
            deposit = alive & diffuse & (bounce > 0)  # skip direct (camera handles it)
            dep_p.append(si["p"])
            dep_w.append(jnp.where(deposit[..., None], power, 0.0))
            dep_d.append(d)  # photon travel direction (wi at the vp = -d)
            dep_ok.append(deposit)

            if bounce == self.max_depth - 1:
                break
            wo_l = _to_local(ns, ss, ts, wo)
            u_lobe = sampler.get(pkey, sidx, base + 3)
            u_b = sampler.get2(pkey, sidx, base + 4)
            wi_l, f, pdf, spec = B.bsdf_sample(params, wo_l, u_lobe, u_b)
            wi_w = _to_world(ns, ss, ts, wi_l)
            ok = alive & (pdf > 0.0) & (jnp.max(f, axis=-1) > 0.0)
            power = jnp.where(
                ok[..., None],
                power * f * (jnp.abs(wi_l[..., 2]) / jnp.maximum(pdf, 1e-12))[..., None],
                power,
            )
            alive = ok
            o = si["p"] + si["ng"] * SHADOW_EPS * jnp.sign(
                jnp.sum(wi_w * si["ng"], axis=-1, keepdims=True)
            )
            d = wi_w
        return (
            jnp.concatenate(dep_p, axis=0),
            jnp.concatenate(dep_w, axis=0),
            jnp.concatenate(dep_d, axis=0),
            jnp.concatenate(dep_ok, axis=0),
        )

    # -- gather ------------------------------------------------------------

    @staticmethod
    def _cell_key(q, grid_res):
        """Hash 3D integer cell coords to a uint32 key."""
        from pbrt_tpu.core.rng import hash_u32

        qx = q[..., 0].astype(jnp.uint32)
        qy = q[..., 1].astype(jnp.uint32)
        qz = q[..., 2].astype(jnp.uint32)
        return hash_u32(qx * jnp.uint32(73856093) ^ qy * jnp.uint32(19349663)
                        ^ qz * jnp.uint32(83492791))

    def _gather(self, vp, radius, photon_p, photon_w, photon_d, photon_ok,
                cell_size):
        """Scattered flux at each visible point: sum over in-radius photons
        of f(wo, wi_photon) * power — pbrt's Phi accumulation (sppm.cpp),
        with the real BSDF when the scene has non-matte materials and the
        exact kd/pi shortcut when everything is Lambertian."""
        inv_cs = 1.0 / cell_size
        pq = jnp.floor(photon_p * inv_cs).astype(jnp.int32)
        pkey = self._cell_key(pq, None)
        pkey = jnp.where(photon_ok, pkey, jnp.uint32(0xFFFFFFFF))
        order = jnp.argsort(pkey)
        pkey_s = pkey[order]
        pp_s = photon_p[order]
        pw_s = photon_w[order]
        pd_s = photon_d[order]

        n = vp["p"].shape[0]
        flux = jnp.zeros((n, 3), dtype=jnp.float32)
        r2 = radius * radius
        k = self.max_per_cell
        full = self._gather_full_bsdf and vp.get("params") is not None
        if full:
            wo_l = _to_local(vp["ns"], vp["ss"], vp["ts"], vp["wo"])
        for ox in (-1, 0, 1):
            for oy in (-1, 0, 1):
                for oz in (-1, 0, 1):
                    q = jnp.floor(vp["p"] * inv_cs).astype(jnp.int32) + jnp.asarray(
                        [ox, oy, oz], dtype=jnp.int32
                    )
                    key = self._cell_key(q, None)
                    start = jnp.searchsorted(pkey_s, key, side="left")
                    for j in range(k):
                        idx = jnp.minimum(start + j, pkey_s.shape[0] - 1)
                        match = pkey_s[idx] == key
                        dp = pp_s[idx] - vp["p"]
                        d2 = jnp.sum(dp * dp, axis=-1)
                        ok = match & (d2 <= r2) & vp["valid"]
                        if full:
                            wi_l = _to_local(
                                vp["ns"], vp["ss"], vp["ts"], -pd_s[idx]
                            )
                            f = B.bsdf_eval(vp["params"], wo_l, wi_l)
                        else:
                            f = vp["kd"] * jnp.float32(1.0 / np.pi)
                        flux = flux + jnp.where(ok[..., None], pw_s[idx] * f, 0.0)
        return flux

    # -- main custom render -------------------------------------------------

    def render(self, renderer, spp=None, progress=True):
        """Drive SPPM iterations; returns a film state."""
        import time

        c = self.c
        film = renderer.film
        sampler = renderer.sampler
        camera = renderer.camera
        b = film.cropped_pixel_bounds
        pixels = b.offsets().astype(np.int32)
        n_pix = len(pixels)
        n_iters = self.n_iterations if spp is None else max(1, int(spp))
        n_photons = self.photons_per_iter if self.photons_per_iter > 0 else max(
            4096, n_pix
        )
        # initial radius from scene extent
        mins, maxs = c.world_bounds
        diag = float(np.linalg.norm(maxs - mins))
        radius0 = self.initial_radius if self.initial_radius > 0 else diag * 0.01
        radius = jnp.full((n_pix,), radius0, dtype=jnp.float32)
        n_acc = jnp.zeros((n_pix,), dtype=jnp.float32)
        tau = jnp.zeros((n_pix, 3), dtype=jnp.float32)
        L_direct = jnp.zeros((n_pix, 3), dtype=jnp.float32)
        alpha = 2.0 / 3.0
        pix = jnp.asarray(pixels)

        @jax.jit
        def iteration(it, radius, n_acc, tau, L_direct):
            sidx = jnp.full((n_pix,), it, dtype=jnp.uint32)
            u_film = sampler.get2(pix, sidx, 0)
            p_film = pix.astype(float_t) + u_film
            o, d, w = camera.generate_rays(p_film, sampler.get2(pix, sidx, 2))
            vp, L_dir = self._camera_pass(sampler, pix, sidx, o, d)
            L_direct = L_direct + L_dir
            ph_p, ph_w, ph_d, ph_ok = self._photon_pass(sampler, n_photons, it)
            cell = float(radius0)  # grid sized by the initial (max) radius
            flux = self._gather(vp, radius, ph_p, ph_w, ph_d, ph_ok, cell)
            # SPPM statistics (global-count variant of pbrt 16.2.6);
            # _gather already applied f(wo, wi) per photon
            phi = vp["beta"] * flux
            got = jnp.sum(jnp.abs(flux), axis=-1) > 0
            m_count = jnp.where(got, 1.0, 0.0)
            new_n = n_acc + alpha * m_count
            ratio = jnp.where(
                n_acc + m_count > 0, new_n / jnp.maximum(n_acc + m_count, 1e-6), 1.0
            )
            new_radius = radius * jnp.sqrt(ratio)
            tau = (tau + phi) * ratio[..., None]
            return new_radius, new_n, tau, L_direct

        t0 = time.time()
        for it in range(n_iters):
            radius, n_acc, tau, L_direct = iteration(
                jnp.uint32(it), radius, n_acc, tau, L_direct
            )
            if progress and (it == 0 or it == n_iters - 1):
                jax.block_until_ready(tau)
                log.info("SPPM iteration %d/%d (%.1fs)", it + 1, n_iters, time.time() - t0)

        n_total_photons = n_iters * n_photons
        indirect = tau / jnp.maximum(
            n_total_photons * PI * (radius * radius)[..., None], 1e-12
        )
        rgb = L_direct / n_iters + indirect
        state = film.initial_state()
        h, wdt = b.height, b.width
        img = rgb.reshape(h, wdt, 3)
        return film.set_image(state, img)
