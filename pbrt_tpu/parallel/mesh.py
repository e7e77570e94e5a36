"""SPMD rendering over a jax.sharding.Mesh.

Replaces the reference's designed-but-unwired thread/tile parallelism
(film.rs FilmTile + mutex merge, parallel.rs AtomicFloat — SURVEY.md §2.2)
with a device-mesh mapping:

  * **dp** axis: the ray/pixel batch is sharded — each device traces its
    slice of the wavefront (domain decomposition over pixels = the
    FilmTile analogue, without tiles or locks);
  * **sp** axis: samples-per-pixel are sharded — device (i, j) traces
    sample indices ``s0 + j`` of pixel-slice i;
  * film merge: per-device partial films are **psum**'d over both axes —
    the deterministic collective replacement for mutex/atomic accumulation;
  * gradients: the inverse-rendering loss psum's across the mesh inside
    ``shard_map`` so ``jax.grad`` all-reduces parameter gradients across
    the devices.

Geometry is replicated in device memory (BASELINE small/medium configs);
geometry sharding over a tp axis lives in ``geomshard.py``.

Determinism: sample values depend only on (pixel, sample, dim) — never on
device id — so any mesh shape produces the bit-identical film
(tests/test_sharding.py asserts 1-device == 8-device).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pbrt_tpu import float_t


def default_mesh(n_devices: Optional[int] = None, sp: int = 1) -> Mesh:
    """Build a (dp, sp) mesh over the first n_devices devices."""
    devs = jax.devices()
    n = n_devices or len(devs)
    assert n % sp == 0, f"n_devices {n} not divisible by sp {sp}"
    dp = n // sp
    arr = np.array(devs[:n]).reshape(dp, sp)
    return Mesh(arr, ("dp", "sp"))


class ShardedRenderer:
    """Mesh-parallel wrapper around a compiled Renderer."""

    def __init__(self, renderer, mesh: Mesh):
        self.r = renderer
        self.mesh = mesh
        self.dp = mesh.shape["dp"]
        self.sp = mesh.shape["sp"]
        self._sharded_step = self._build_step()

    def _build_step(self):
        r = self.r
        film = r.film
        sampler = r.sampler
        camera = r.camera
        integrator = r.integrator

        def local_step(state, pixel_xy, s0, lane_mask):
            # state arrives replicated (P()), pixels sharded over dp.
            sp_idx = jax.lax.axis_index("sp")
            n = pixel_xy.shape[0]
            sidx = jnp.full((n,), 0, dtype=jnp.uint32) + s0 + sp_idx.astype(jnp.uint32)
            u_film = sampler.get2(pixel_xy, sidx, 0)
            p_film = pixel_xy.astype(float_t) + u_film
            u_lens = sampler.get2(pixel_xy, sidx, 2)
            o, d, w = camera.generate_rays(p_film, u_lens)
            L = integrator.li(sampler, pixel_xy, sidx, o, d)
            L = jnp.where(jnp.isfinite(L), L, 0.0) * w[..., None]
            zero = {k: jnp.zeros_like(v) for k, v in state.items()}
            partial = film.add_samples(zero, p_film, L, mask=lane_mask)
            # deterministic merge: psum partial films over the whole mesh
            partial = jax.tree_util.tree_map(
                lambda x: jax.lax.psum(x, ("dp", "sp")), partial
            )
            return jax.tree_util.tree_map(jnp.add, state, partial)

        # check_vma=False: the varying-type checker rejects lax.scan
        # carries that start replicated
        fn = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(P(), P("dp", None), P(), P("dp")),
            out_specs=P(),
            check_vma=False,
        )
        return jax.jit(fn)

    def render(self, spp: Optional[int] = None, state=None):
        r = self.r
        film = r.film
        sample_bounds = film.get_sample_bounds()
        pixels = sample_bounds.offsets().astype(np.int32)
        n_pix = len(pixels)
        spp = spp if spp is not None else r.sampler.samples_per_pixel
        # round spp up to a multiple of sp
        rounds = max(1, -(-spp // self.sp))
        batch = min(r.options.ray_batch, max(self.dp, n_pix))
        batch = -(-batch // self.dp) * self.dp  # divisible by dp
        n_chunks = -(-n_pix // batch)
        pad = n_chunks * batch - n_pix
        if pad:
            pixels = np.concatenate([pixels, np.repeat(pixels[-1:], pad, axis=0)])
        mask = np.arange(n_chunks * batch) < n_pix
        chunks = pixels.reshape(n_chunks, batch, 2)
        masks = mask.reshape(n_chunks, batch)
        # --- preemption recovery (SURVEY §5): resume the (round, chunk)
        # sweep from a film checkpoint; the film state is replicated so a
        # restarted pod resumes bit-identically regardless of mesh shape
        ckpt_path = None
        resume_at = 0
        total_steps = rounds * n_chunks
        if self.r.options.checkpoint_dir:
            from pathlib import Path

            from pbrt_tpu.utils.checkpoint import load_checkpoint

            ckpt_path = Path(self.r.options.checkpoint_dir) / "film-mesh.ckpt.npz"
            meta_want = {
                "res": list(film.full_resolution),
                "spp": int(spp),
                "steps": int(total_steps),
                "mesh": sorted(self.mesh.shape.items()),
            }
            loaded = load_checkpoint(ckpt_path)
            if loaded is not None and state is None:
                ck_state, cursor, meta = loaded
                meta["mesh"] = [tuple(x) for x in meta.get("mesh", [])]
                if meta == meta_want and 0 < cursor <= total_steps:
                    state = ck_state
                    resume_at = cursor
        if state is None:
            state = film.initial_state()
        step_i = 0
        for rd in range(rounds):
            s0 = jnp.uint32(rd * self.sp)
            for ci in range(n_chunks):
                if step_i < resume_at:
                    step_i += 1
                    continue
                state = self._sharded_step(
                    state, jnp.asarray(chunks[ci]), s0, jnp.asarray(masks[ci])
                )
                step_i += 1
                if ckpt_path is not None and (
                    step_i % max(1, self.r.options.checkpoint_every) == 0
                    or step_i == total_steps
                ):
                    from pbrt_tpu.utils.checkpoint import save_checkpoint

                    jax.block_until_ready(state["weight"])
                    save_checkpoint(ckpt_path, state, step_i, meta_want)
        jax.block_until_ready(state["weight"])
        return state

    # -- distributed inverse-rendering step --------------------------------

    def build_grad_step(self, target_image, spp: int = 2, lr: float = 0.5):
        """Returns jitted step(theta, pixel_xy) -> (loss, new_theta).

        The loss mean and its parameter gradients are psum'd across the
        mesh inside shard_map — gradient all-reduce across the devices.
        """
        from pbrt_tpu.diff.grad import make_radiance_fn

        r = self.r
        radiance = make_radiance_fn(r)
        target = jnp.asarray(np.asarray(target_image, dtype=float_t))
        bx, by = r.film.cropped_pixel_bounds.p_min

        def local_loss(theta, pixel_xy):
            sp_idx = jax.lax.axis_index("sp")
            n = pixel_xy.shape[0]
            acc = jnp.zeros((n, 3), dtype=float_t)
            for s in range(spp):
                sidx = jnp.full((n,), s * self.sp, dtype=jnp.uint32) + sp_idx.astype(
                    jnp.uint32
                )
                acc = acc + radiance(theta, pixel_xy, sidx)
            # combine sample shards of the same pixels BEFORE the loss
            acc = jax.lax.psum(acc, "sp")
            rendered = acc / (spp * self.sp)
            t = target[pixel_xy[..., 1] - by, pixel_xy[..., 0] - bx]
            # mean over all pixels on the mesh (identical on every sp shard)
            local = jnp.sum((rendered - t) ** 2)
            return jax.lax.psum(local, "dp") / (3.0 * n * self.dp)

        # Differentiate THROUGH the shard_map: jax.grad of the sharded loss
        # w.r.t. the replicated theta performs the cross-device gradient
        # all-reduce as the transpose of theta's broadcast.
        sharded_loss = jax.shard_map(
            local_loss,
            mesh=self.mesh,
            in_specs=(P(), P("dp", None)),
            out_specs=P(),
            check_vma=False,
        )

        def step(theta, pixel_xy):
            loss, g = jax.value_and_grad(sharded_loss)(theta, pixel_xy)
            new_theta = jax.tree_util.tree_map(lambda p, gv: p - lr * gv, theta, g)
            return loss, new_theta

        return jax.jit(step)
