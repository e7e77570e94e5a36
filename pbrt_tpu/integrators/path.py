"""Wavefront path integrator with NEE + MIS (pbrt-v3 §14.5 semantics).

Megabatch design: the bounce loop is unrolled at trace time (max_depth is
static), every lane carries (throughput, radiance, alive) and dead lanes
are masked, not compacted — XLA keeps the whole batch dense.
Sample dimensions are allocated statically per bounce so every sampler
value is a pure function of (pixel, sample index, dimension).

Dimension layout:
  0,1  film jitter     2,3  lens        4  time (motion blur)
  per bounce b, base = 5 + 7*b:
    +0 light select    +1,+2 light u2   +3 lobe select
    +4,+5 bsdf u2      +6 russian roulette
"""

from __future__ import annotations

import functools

import numpy as np

import jax

import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.core.geometry import coordinate_system, shading_frame, vface_forward
from pbrt_tpu.core.sampling import power_heuristic
from pbrt_tpu.materials import eval_material_params
from pbrt_tpu.materials import bsdf as B
from pbrt_tpu.scene.builder import compute_interaction

SHADOW_EPS = 1e-3
INF_T = 1e8


def _to_local(ns, ss, ts, v):
    return jnp.stack(
        [jnp.sum(v * ss, axis=-1), jnp.sum(v * ts, axis=-1), jnp.sum(v * ns, axis=-1)],
        axis=-1,
    )


def _to_world(ns, ss, ts, v):
    return (
        v[..., 0:1] * ss + v[..., 1:2] * ts + v[..., 2:3] * ns
    )


class PathIntegrator:
    """``remat=True`` enables path-replay backprop: each bounce body is
    wrapped in ``jax.checkpoint``, so reverse-mode differentiation *replays*
    the bounce (regenerating its deterministic samples and re-intersecting)
    instead of storing per-bounce wavefront state — O(1)-in-depth memory,
    the autodiff formulation of the BASELINE "path-replay" requirement.
    Forward-only rendering is unaffected."""

    # Subclass knobs (pbrt-v3 §14.3 derived integrators):
    #  * direct_only: non-specular BSDF samples continue for exactly ONE
    #    more segment that may only collect emission (the BSDF-sampled half
    #    of EstimateDirect's MIS pair), then terminate — DirectLighting.
    #  * nee_mis: False disables the power-heuristic downweighting of NEE
    #    (for integrators that drop the BSDF-sampled direct half, Whitted).
    direct_only = False
    nee_mis = True

    def __init__(self, compiled, max_depth=5, rr_threshold=1.0, remat=False):
        self.c = compiled
        self.max_depth = int(max_depth)
        self.rr_threshold = float(rr_threshold)
        self.remat = bool(remat)
        self._animated = bool(
            compiled.tables.get("_flags", {}).get("animated_keys", 0)
        )

    def queries_per_sample(self):
        """Exact intersector-query counts issued per pixel-sample lane:
        (closest, shadow).  The bounce loop is unrolled max_depth times;
        every bounce issues one closest sweep, and every bounce EXCEPT
        the last issues one NEE ``occluded`` sweep (the final vertex
        collects emission only — the loop returns after Le, before NEE;
        pbrt-v3's terminal vertex likewise gets Le only).  Feeds the
        ``render/{closest,shadow}_queries`` counters the bench uses as
        its Mray/s numerator."""
        return self.max_depth, self.max_depth - 1

    def _bsdf_sample(self, params, wo_l, u_lobe, u_b):
        """Hook for derived integrators (Whitted suppresses non-specular
        continuations here) — replaces the former module-global
        ``bsdf_sample`` monkeypatch, which leaked across concurrently
        traced integrators."""
        return B.bsdf_sample(params, wo_l, u_lobe, u_b)

    # -- sorted-carry wavefront --------------------------------------------

    def _use_sorted_carry(self):
        """Keep the wavefront permanently in ray-sorted order across
        bounces instead of sort/unsort-ing around every intersect.

        Each bounce pays ONE co-sort that carries the whole path state
        into the next traversal order, the closest-hit sweep runs
        sort-free, and one final scatter restores lane order for the
        film.  (Shadow sweeps still co-sort per call: their directions
        diverge from the carry order.)  Whether this still pays on the GPU
        is an open measurement (PERF.md).
        """
        if self._animated:
            return False
        import os

        if os.environ.get("PBRT_TPU_NO_SORTED_CARRY", "0") not in ("", "0"):
            return False
        itx = self.c.intersector
        return bool(getattr(itx, "supports_sort_hint", False)) and (
            getattr(itx, "n_tri", 0) > 0
        )

    @staticmethod
    def _detach(*xs):
        """Intersection queries are discrete scene lookups: the hit record
        (t, prim, barycentrics) has zero dependence on material/light
        theta, and detaching the query inputs keeps reverse-mode from
        trying to differentiate the traversal ``while_loop`` (detached
        sampling — the estimator the BASELINE's path-replay scheme
        assumes).  Ray geometry stays attached downstream via
        ``compute_interaction(o, d, ...)``."""
        return tuple(
            None if x is None else jax.lax.stop_gradient(x) for x in xs
        )

    def _intersect(self, o, d, t_max, time, sort=True):
        o, d, t_max, time = self._detach(o, d, t_max, time)
        if self._animated:
            return self.c.intersector.intersect(o, d, t_max, time=time)
        if not sort and getattr(self.c.intersector, "supports_sort_hint", False):
            return self.c.intersector.intersect(o, d, t_max, sort=False)
        return self.c.intersector.intersect(o, d, t_max)

    def _occluded(self, o, d, t_max, time, sort=True):
        o, d, t_max, time = self._detach(o, d, t_max, time)
        if self._animated:
            return self.c.intersector.occluded(o, d, t_max, time=time)
        if not sort and getattr(self.c.intersector, "supports_sort_hint", False):
            return self.c.intersector.occluded(o, d, t_max, sort=False)
        return self.c.intersector.occluded(o, d, t_max)

    # -- light plumbing ----------------------------------------------------

    def _env_radiance(self, d, theta=None):
        le = jnp.zeros(d.shape[:-1] + (3,), dtype=d.dtype)
        env_i = 0
        for lt in self.c.lights:
            if lt.is_infinite:
                ov = theta["env_l"][env_i] if theta is not None else None
                le = le + lt.le_escaped(d, ov)
                env_i += 1
        return le

    def _env_pdf(self, p, d):
        """Combined light-strategy pdf that BSDF-sampled dir d escapes into
        an infinite light (for MIS)."""
        n_lights = len(self.c.lights)
        if n_lights == 0:
            return jnp.zeros(p.shape[:-1], dtype=p.dtype)
        pdf = jnp.zeros(p.shape[:-1], dtype=p.dtype)
        for lt in self.c.lights:
            if lt.is_infinite:
                pdf = pdf + lt.pdf_li(p, d)
        return pdf / n_lights

    def _emitted(self, si, wo, theta=None):
        """Area-light emission toward wo at hit points."""
        n = wo.shape[0]
        le = jnp.zeros((n, 3), dtype=wo.dtype)
        for i, al in enumerate(self.c.area_lights):
            mask = si["light"] == i
            ov = theta["area_l"][i] if theta is not None else None
            lv = al.l_emitted(si["ng"], wo, ov)
            le = jnp.where(mask[..., None], lv, le)
        return le

    def _area_light_pdf(self, prev_p, si, d):
        """pdf that NEE would have sampled this hit point, per lane."""
        n_lights = len(self.c.lights)
        n = d.shape[0]
        pdf = jnp.zeros((n,), dtype=d.dtype)
        if n_lights == 0:
            return pdf
        for i, al in enumerate(self.c.area_lights):
            mask = si["light"] == i
            pv = al.pdf_li_at_hit(prev_p, si["p"], si["ng"], d)
            pdf = jnp.where(mask, pv, pdf)
        return pdf / n_lights

    def _sample_one_light(self, p, u_sel, u2, theta=None):
        """Uniformly pick a light; returns (wi, li, pdf, dist, is_delta)."""
        n = p.shape[0]
        dt = p.dtype
        n_lights = len(self.c.lights)
        wi = jnp.zeros((n, 3), dtype=dt)
        li = jnp.zeros((n, 3), dtype=dt)
        pdf = jnp.zeros((n,), dtype=dt)
        dist = jnp.full((n,), INF_T, dtype=dt)
        delta = jnp.zeros((n,), dtype=bool)
        if n_lights == 0:
            return wi, li, pdf, dist, delta
        pick = jnp.minimum(
            (u_sel * n_lights).astype(jnp.int32), n_lights - 1
        )
        env_i = 0
        area_i = 0
        from pbrt_tpu.lights import DiffuseAreaLight, InfiniteAreaLight

        for i, lt in enumerate(self.c.lights):
            mask = pick == i
            if theta is not None and isinstance(lt, InfiniteAreaLight):
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2, theta["env_l"][env_i])
            elif theta is not None and isinstance(lt, DiffuseAreaLight):
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2, theta["area_l"][area_i])
            else:
                wi_i, li_i, pdf_i, dist_i = lt.sample_li(p, u2)
            if isinstance(lt, InfiniteAreaLight):
                env_i += 1
            if isinstance(lt, DiffuseAreaLight):
                area_i += 1
            wi = jnp.where(mask[..., None], wi_i, wi)
            li = jnp.where(mask[..., None], li_i, li)
            pdf = jnp.where(mask, pdf_i, pdf)
            dist = jnp.where(mask, dist_i, dist)
            delta = jnp.where(mask, lt.is_delta, delta)
        # selection pdf folds in
        pdf = pdf / n_lights
        return wi, li, pdf, dist, delta

    # -- main --------------------------------------------------------------

    def li(self, sampler, pixel_xy, sample_index, o, d, theta=None):
        """Trace radiance for a wavefront of camera rays.

        pixel_xy [N,2] int; sample_index [N]; o,d [N,3] world rays.
        Returns L [N,3].
        """
        c = self.c
        n = o.shape[0]
        dt = o.dtype
        self._sc = self._use_sorted_carry()
        carry = (
            jnp.zeros((n, 3), dtype=dt),  # L
            jnp.ones((n, 3), dtype=dt),  # beta
            jnp.ones((n,), dtype=bool),  # alive
            jnp.ones((n,), dtype=bool),  # specular_bounce (camera "bounce")
            jnp.zeros((n,), dtype=bool),  # gather_only (emission-only lanes)
            jnp.ones((n,), dtype=dt),  # prev_bsdf_pdf
            o,  # prev_p
            o,
            d,
            pixel_xy,  # rides the permutation (samplers are pure in it)
            sample_index,
            jnp.arange(n, dtype=jnp.int32),  # original lane id
        )
        for bounce in range(self.max_depth):
            body = functools.partial(self._bounce, bounce, sampler, theta)
            if self.remat:
                body = jax.checkpoint(body, static_argnums=())
            carry = body(carry)
        L = carry[0]
        if self._sc:
            # one scatter per wavefront restores film lane order (vs the
            # old sort/unsort pair around every intersect)
            lane = carry[-1]
            L = jnp.zeros_like(L).at[lane].set(L, unique_indices=True)
        return L

    def _bounce(self, bounce, sampler, theta, carry):
        c = self.c
        (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf,
         prev_p, o, d, pixel_xy, sample_index, lane) = carry
        n = o.shape[0]
        dt = o.dtype
        if True:
            base = 5 + 7 * bounce
            # dead lanes trace with t_max=0: the sorted Pallas path groups
            # them into packets that terminate at the root test (wavefront
            # compaction without a gather/scatter pass)
            # per-lane shutter time (normalized): pure function of
            # (pixel, sample, dim 4) like every other sample dimension
            time = (
                sampler.get(pixel_xy, sample_index, 4) if self._animated else None
            )
            t_far = jnp.where(alive, INF_T, 0.0).astype(dt)
            # camera rays arrive pixel-major (already a coherent sweep):
            # skip the Morton sort for bounce 0.  In sorted-carry
            # mode bounce>0 lanes were permuted at the END of the previous
            # bounce, so every intersect runs sort-free.
            hit = self._intersect(
                o, d, t_far, time, sort=bounce > 0 and not self._sc
            )

            # --- escaped rays: environment radiance with MIS -------------
            esc = alive & ~hit["hit"]
            env_le = self._env_radiance(d, theta)
            light_pdf = self._env_pdf(prev_p, d)
            w_env = jnp.where(
                specular_bounce,
                1.0,
                power_heuristic(1, prev_bsdf_pdf, 1, light_pdf),
            )
            L = L + jnp.where(esc[..., None], beta * env_le * w_env[..., None], 0.0)
            alive = alive & hit["hit"]

            # --- surface interaction -------------------------------------
            ray_diff = None
            if bounce == 0 and c.tables.get("_flags", {}).get("tex_width"):
                # camera ray differentials (pbrt-v3 GenerateRayDifferential):
                # regenerate the +1px-x / +1px-y neighbors from the same
                # deterministic film/lens samples — a handful of lane ops,
                # cheaper than carrying differential state through bounces
                u_film = sampler.get2(pixel_xy, sample_index, 0)
                p_film = pixel_xy.astype(dt) + u_film
                u_lens = sampler.get2(pixel_xy, sample_index, 2)
                off_x = jnp.asarray([1.0, 0.0], dtype=dt)
                off_y = jnp.asarray([0.0, 1.0], dtype=dt)
                _, dxd, _ = c.camera.generate_rays(p_film + off_x, u_lens)
                _, dyd, _ = c.camera.generate_rays(p_film + off_y, u_lens)
                ray_diff = (dxd, dyd)
            si = compute_interaction(c.tables, hit, o, d, ray_diff, time)
            wo = si["wo"]

            # --- emitted radiance at hit (area lights) with MIS ----------
            if c.area_lights:
                le_hit = self._emitted(si, wo, theta)
                al_pdf = self._area_light_pdf(prev_p, si, d)
                w_le = jnp.where(
                    specular_bounce,
                    1.0,
                    power_heuristic(1, prev_bsdf_pdf, 1, al_pdf),
                )
                L = L + jnp.where(
                    alive[..., None], beta * le_hit * w_le[..., None], 0.0
                )

            if bounce == self.max_depth - 1:
                return (L, beta, alive, specular_bounce, gather_only,
                        prev_bsdf_pdf, prev_p, o, d,
                        pixel_xy, sample_index, lane)

            # emission-only lanes (direct_only: the BSDF-sampled half of
            # EstimateDirect's MIS pair) have now collected their Le — stop.
            # Gated: gather_only is identically False outside direct_only
            # mode, and the no-op mask was seen to perturb XLA's fusion of
            # the bounce body (found by HLO diff)
            if self.direct_only:
                alive = alive & ~gather_only

            # --- shading frame + material params -------------------------
            ns, ss, ts = shading_frame(si, wo)
            wo_l = _to_local(ns, ss, ts, wo)
            params = eval_material_params(c.materials, si["mat"], si, theta)
            # true medium side (pre-face-forward orientation) for dielectrics
            params["outside"] = jnp.sum(si["ns"] * wo, axis=-1) > 0.0
            alive = alive & (si["mat"] >= 0) & (params["type"] != B.NONE)

            # --- next-event estimation -----------------------------------
            if c.lights:
                u_sel = sampler.get(pixel_xy, sample_index, base + 0)
                u_l = sampler.get2(pixel_xy, sample_index, base + 1)
                wi_w, li, l_pdf, l_dist, l_delta = self._sample_one_light(
                    si["p"], u_sel, u_l, theta
                )
                wi_l = _to_local(ns, ss, ts, wi_w)
                f = B.bsdf_eval(params, wo_l, wi_l)
                b_pdf = B.bsdf_pdf(params, wo_l, wi_l)
                can = alive & (l_pdf > 0.0) & (jnp.max(f, axis=-1) > 0.0)
                shadow_o = si["p"] + si["ng"] * SHADOW_EPS * jnp.sign(
                    jnp.sum(wi_w * si["ng"], axis=-1, keepdims=True)
                )
                import os as _os

                shadow_t = jnp.where(can, l_dist - 2 * SHADOW_EPS, 0.0)
                if self.nee_mis:
                    w_l = jnp.where(
                        l_delta, 1.0, power_heuristic(1, l_pdf, 1, b_pdf)
                    )
                else:
                    # Whitted: light sampling is the only direct estimator
                    w_l = jnp.ones_like(l_pdf)
                contrib = (
                    beta
                    * f
                    * li
                    * (jnp.abs(wi_l[..., 2]) * w_l / jnp.maximum(l_pdf, 1e-12))[
                        ..., None
                    ]
                )
                # Merged shadow+carry sort: shadow rays at this bounce
                # originate at the SAME points (si.p +- eps*ng) as the next
                # bounce's rays, and the carry sort key is origin-Morton-
                # major — so instead of paying a second full key-sort per
                # bounce for the shadow wavefront, the shadow columns
                # (origin, direction, t, premasked contribution) RIDE the
                # carry co-sort and the occlusion sweep runs sort-free in
                # next-bounce order.  Bit-identical: occlusion is a boolean
                # any-hit (lane-order invariant) and the NEE add commutes
                # with the permutation.  Off by default
                # (PBRT_TPU_SC_MERGED=1 turns it on).  Which wins on the GPU
                # is ROADMAP 3c.
                merged = self._sc and _os.environ.get(
                    "PBRT_TPU_SC_MERGED", "0"
                ) not in ("", "0")
                if merged and bounce < self.max_depth - 1:
                    nee_cols = (
                        shadow_o, wi_w, shadow_t,
                        jnp.where(can[..., None], contrib, 0.0),
                    )
                else:
                    # shadow wavefronts get their own sort even in
                    # sorted-carry mode (carry order follows the BOUNCE
                    # direction; shadow directions diverge).
                    # PBRT_TPU_SC_NOSORT_SHADOW=1 keeps them unsorted.
                    nee_cols = None
                    shadow_sort = not self._sc or _os.environ.get(
                        "PBRT_TPU_SC_NOSORT_SHADOW", "0"
                    ) in ("", "0")
                    occluded = self._occluded(
                        shadow_o, wi_w, shadow_t, time, sort=shadow_sort
                    )
                    vis = can & ~occluded
                    L = L + jnp.where(vis[..., None], contrib, 0.0)
            else:
                nee_cols = None

            # --- BSDF sampling -------------------------------------------
            u_lobe = sampler.get(pixel_xy, sample_index, base + 3)
            u_b = sampler.get2(pixel_xy, sample_index, base + 4)
            wi_l, f, pdf, spec = self._bsdf_sample(params, wo_l, u_lobe, u_b)
            wi_w = _to_world(ns, ss, ts, wi_l)
            ok = alive & (pdf > 0.0) & (jnp.max(f, axis=-1) > 0.0)
            if self.direct_only:
                # pbrt DirectLightingIntegrator: non-specular continuations
                # exist only to pick up the BSDF-sampled direct-light term
                gather_only = ok & ~spec
                if bounce == self.max_depth - 2:
                    # deepest pbrt vertex (the ctor passes maxDepth+1 so
                    # this vertex still gets its emission-only MIS half):
                    # its gather-only ray traces, but specular recursion
                    # stops — pbrt only recurses while depth+1 < maxDepth
                    ok = ok & ~spec
            beta = jnp.where(
                ok[..., None],
                beta * f * (jnp.abs(wi_l[..., 2]) / jnp.maximum(pdf, 1e-12))[..., None],
                beta,
            )
            alive = ok
            prev_p = si["p"]
            prev_bsdf_pdf = pdf
            specular_bounce = spec
            o = si["p"] + si["ng"] * SHADOW_EPS * jnp.sign(
                jnp.sum(wi_w * si["ng"], axis=-1, keepdims=True)
            )
            d = wi_w

            # --- russian roulette ----------------------------------------
            if bounce > 3:
                max_beta = jnp.max(beta, axis=-1)
                q = jnp.maximum(0.05, 1.0 - max_beta)
                u_rr = sampler.get(pixel_xy, sample_index, base + 6)
                survive = u_rr >= q
                beta = jnp.where(
                    (alive & survive)[..., None],
                    beta / jnp.maximum(1.0 - q, 1e-6)[..., None],
                    beta,
                )
                alive = alive & survive

            # --- sorted-carry permutation --------------------------------
            if self._sc:
                # ONE argsort + ONE packed row-gather moves the whole
                # wavefront into the next bounce's traversal order; the
                # next intersect and its shadow pass then run sort-free
                t_next = jnp.where(alive, INF_T, 0.0).astype(dt)
                keys = c.intersector.sort_keys(o, d, t_next)
                flags = (
                    alive.astype(jnp.int32)
                    | (specular_bounce.astype(jnp.int32) << 1)
                    | (gather_only.astype(jnp.int32) << 2)
                )
                # lax.sort CO-SORT: the 21 carry columns ride the sort
                # with the keys (one multi-operand sort, no gathers)
                ops = (keys,
                       L[:, 0], L[:, 1], L[:, 2],
                       beta[:, 0], beta[:, 1], beta[:, 2],
                       prev_bsdf_pdf,
                       prev_p[:, 0], prev_p[:, 1], prev_p[:, 2],
                       o[:, 0], o[:, 1], o[:, 2],
                       d[:, 0], d[:, 1], d[:, 2],
                       pixel_xy[:, 0], pixel_xy[:, 1], sample_index,
                       lane, flags)
                if nee_cols is not None:
                    # merged shadow+carry sort: the deferred NEE columns
                    # (shadow o/d/t + premasked contribution) ride the same
                    # network — +10 payload operands vs a second key-sort
                    so, sw, st, pre = nee_cols
                    ops = ops + (
                        so[:, 0], so[:, 1], so[:, 2],
                        sw[:, 0], sw[:, 1], sw[:, 2],
                        st,
                        pre[:, 0], pre[:, 1], pre[:, 2],
                    )
                srt = jax.lax.sort(ops, num_keys=1)
                L = jnp.stack(srt[1:4], axis=-1)
                beta = jnp.stack(srt[4:7], axis=-1)
                prev_bsdf_pdf = srt[7]
                prev_p = jnp.stack(srt[8:11], axis=-1)
                o = jnp.stack(srt[11:14], axis=-1)
                d = jnp.stack(srt[14:17], axis=-1)
                pixel_xy = jnp.stack(srt[17:19], axis=-1)
                sample_index = srt[19]
                lane = srt[20]
                flags = srt[21]
                alive = (flags & 1) != 0
                specular_bounce = (flags & 2) != 0
                gather_only = (flags & 4) != 0
                if nee_cols is not None:
                    so_s = jnp.stack(srt[22:25], axis=-1)
                    sw_s = jnp.stack(srt[25:28], axis=-1)
                    st_s = srt[28]
                    pre_s = jnp.stack(srt[29:32], axis=-1)
                    # occlusion sweep in next-bounce order: shadow origins
                    # share the carry key's origin-Morton high bits exactly
                    occluded = self._occluded(
                        so_s, sw_s, st_s, time, sort=False
                    )
                    L = L + jnp.where(occluded[..., None], 0.0, pre_s)

        return (L, beta, alive, specular_bounce, gather_only, prev_bsdf_pdf,
                prev_p, o, d, pixel_xy, sample_index, lane)
