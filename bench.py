"""Benchmark: rays/s/chip, sustained path trace (BASELINE.json metric).

Primary metric (the JSON line's "value"): the Cornell-box scene
(BASELINE config 2: diffuse quads + spheres, path integrator) at 256x256,
32 spp, maxdepth 5 — sustained intersection-query throughput over several
frames.

The same line also carries the HARD paths as extra keys (the bench must
track the BVH path, not just the easy scene):
  config3_mray_s — end-to-end render of the 50k-triangle displaced torus
      (textured matte, point + area lights, MIS) through the BVH
      traversal kernel;
  config5_mray_s — raw closest-hit throughput on a 1,000,000-triangle
      torus, coherent single-origin rays;
  config5_frame_mray_s — END-TO-END 1M-triangle frame through the full
      Renderer;
  config5_sharded_mray_s — the same intersector through the tp-sharded
      shard_map path.  Raw and sharded get the SAME sort treatment: both
      time pre-sorted rays (production wavefronts arrive pre-sorted
      under the sorted-carry integrator), so the pair is apples-to-apples.

Ray accounting: the Mray/s numerators for the render configs come from
the live ``render/{closest,shadow}_queries`` stats counters — the integrator's structural per-sample counts (path:
``maxdepth`` closest sweeps + ``maxdepth-1`` NEE occlusion sweeps; the
final vertex collects emission only, casting no shadow ray) times the
camera samples actually rendered.  For maxdepth D this equals
``n_pix * spp * (2D - 1)``, counter-derived.

Every JSON line names the device (platform, device_kind, count) and the
card's name and power limit as nvidia-smi reports them; the bench exits
non-zero when JAX finds no GPU or when any config fails.
"""

import json
import subprocess
import sys
import time

import numpy as np


def _spread(dts):
    """min/median/max seconds over individually timed reps (a
    single-number bench makes small regressions invisible)."""
    s = sorted(dts)
    return {"min": round(s[0], 4), "median": round(s[len(s) // 2], 4),
            "max": round(s[-1], 4)}


def _timed_renders(r, spp, reps):
    """Time `reps` fresh frames; return (median dt, dts, state, queries
    per frame from the exact stats counters)."""
    import jax

    from pbrt_tpu.utils import stats

    state = r.render(spp=spp, progress=False)  # warmup/compile
    before = stats.snapshot()["counters"]
    dts = []
    for _ in range(reps):
        t0 = time.time()
        state = r.render(spp=spp, state=r.film.initial_state(), progress=False)
        jax.block_until_ready(state["weight"])
        dts.append(time.time() - t0)
    after = stats.snapshot()["counters"]
    queries = (
        after.get("render/closest_queries", 0)
        - before.get("render/closest_queries", 0)
        + after.get("render/shadow_queries", 0)
        - before.get("render/shadow_queries", 0)
    ) / reps
    return sorted(dts)[len(dts) // 2], dts, state, queries


def bench_cornell():
    from pbrt_tpu.testscenes import cornell_renderer

    xres = yres = 256
    spp = 32
    maxdepth = 5
    # measure sustained (production) throughput: a real spp count and a
    # full frame per timed rep
    r = cornell_renderer(
        xres=xres, yres=yres, spp=spp, maxdepth=maxdepth, ray_batch=1 << 18
    )
    dt, dts, state, rays = _timed_renders(r, spp, reps=5)
    assert rays == r.film.get_sample_bounds().area() * spp * (2 * maxdepth - 1)
    img = np.asarray(r.film.to_rgb(state))
    ok = bool(np.isfinite(img).all() and img.max() > 0)
    return rays / dt, dt, ok, _spread(dts)


def bench_config3():
    from pbrt_tpu.testscenes import mesh_scene_renderer

    spp, maxdepth = 8, 4
    r, n_tris = mesh_scene_renderer(
        xres=256, yres=256, spp=spp, maxdepth=maxdepth, ray_batch=1 << 18
    )
    dt, dts, state, rays = _timed_renders(r, spp, reps=5)
    img = np.asarray(r.film.to_rgb(state))
    ok = bool(np.isfinite(img).all() and img.max() > 0)
    return rays / dt, n_tris, ok, _spread(dts)


def bench_config5_frame():
    """END-TO-END BASELINE config 5: a full 1M-triangle frame through the
    Renderer (camera sweep, sorted-carry wavefront, BVH traversal,
    shading, film) — the frame number the intersector microbenches below
    cannot stand in for."""
    from pbrt_tpu.testscenes import mesh_scene_renderer

    spp, maxdepth = 4, 4
    r, n_tris = mesh_scene_renderer(
        xres=256, yres=256, spp=spp, maxdepth=maxdepth, ray_batch=1 << 18,
        nu=1000, nv=500,
    )
    dt, dts, state, rays = _timed_renders(r, spp, reps=3)
    img = np.asarray(r.film.to_rgb(state))
    ok = bool(np.isfinite(img).all() and img.max() > 0)
    return rays / dt, n_tris, ok, _spread(dts)


def _presort_coherent(o, d):
    """The sort treatment BOTH config-5 intersector benches get, outside
    their timing loops: production wavefronts arrive pre-sorted (the
    sorted-carry integrator), so the microbenches time the kernel, not
    the permutation — and raw-vs-sharded stays apples-to-apples.
    Octant + direction-Morton (origins are coincident; accel/bvh.py
    _sort_keys)."""
    def part1by2(v):
        v = v.astype(np.uint32) & 0x3FF
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    octant = (d[:, 0] < 0) * 4 + (d[:, 1] < 0) * 2 + (d[:, 2] < 0)
    ad = np.abs(d)
    qd = np.clip(ad / np.maximum(ad.max(axis=1, keepdims=True), 1e-12),
                 0, 0.999999)
    qdi = (qd * 16).astype(np.uint32)
    dir_m = (part1by2(qdi[:, 0]) | (part1by2(qdi[:, 1]) << 1)
             | (part1by2(qdi[:, 2]) << 2)) & 0xFFF
    order = np.argsort(octant.astype(np.uint32) * 4096 + dir_m)
    return o[order], d[order]


def _config5_rays(n):
    rng = np.random.default_rng(0)
    o = np.tile(np.asarray([3.0, 2.4, 2.2], np.float32), (n, 1))
    tgt = rng.uniform(-1.2, 1.2, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return _presort_coherent(o, d)


def bench_config5():
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.accel.bvh import BVHIntersector
    from pbrt_tpu.testscenes import torus_triangle_data

    td = torus_triangle_data(1000, 500)
    bvh = BVHIntersector(td, None)
    n = 1 << 18
    o, d = _config5_rays(n)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tm = jnp.full((n,), 1e8, jnp.float32)
    # rays pre-sorted above -> sort=False, same treatment as the sharded
    # bench (which also feeds pre-sorted rays to the bare kernel)
    fn = jax.jit(lambda o, d, tm: bvh.intersect(o, d, tm, sort=False))
    out = fn(o, d, tm)
    jax.block_until_ready(out["t"])
    reps = 5
    dts = []
    for _ in range(reps):
        t0 = time.time()
        out = fn(o, d, tm)
        jax.block_until_ready(out["t"])
        dts.append(time.time() - t0)
    dt = sorted(dts)[len(dts) // 2]
    return n / dt, td.count, _spread(dts)


def bench_config5_sharded():
    """BASELINE config 5 through the tp-SHARDED path: a degenerate
    (dp=1, tp=1) shard_map on one card, so the bench tracks the per-shard
    traversal path that a multi-card mesh runs — not just the
    single-card intersector."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from jax.sharding import PartitionSpec as P

    from pbrt_tpu.parallel.geomshard import (
        _shard_specs,
        local_closest_hit,
        shard_triangle_arrays,
    )
    from pbrt_tpu.testscenes import torus_triangle_data

    td = torus_triangle_data(1000, 500)
    shards = shard_triangle_arrays(
        td, np.zeros(td.count, np.int32), np.full(td.count, -1, np.int32),
        1, bvh=True,
    )
    flat = {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:]))
            for k, v in shards.items()}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("dp", "tp"))

    n = 1 << 18
    o, d = _config5_rays(n)  # same pre-sort as bench_config5
    o, d = jnp.asarray(o), jnp.asarray(d)
    tm = jnp.full((n,), 1e8, jnp.float32)

    spec = _shard_specs("tp", True, P)
    fn = jax.jit(jax.shard_map(
        lambda sh, o, d, tm: local_closest_hit(sh, o, d, tm),
        mesh=mesh,
        in_specs=(spec, P("dp", None), P("dp", None), P("dp")),
        out_specs=P("dp"),
        check_vma=False,
    ))
    out = fn(flat, o, d, tm)
    jax.block_until_ready(out)
    reps = 5
    dts = []
    for _ in range(reps):
        t0 = time.time()
        out = fn(flat, o, d, tm)
        jax.block_until_ready(out)
        dts.append(time.time() - t0)
    dt = sorted(dts)[len(dts) // 2]
    return n / dt, td.count, _spread(dts)


def _card():
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU: JAX found {dev.platform}", file=sys.stderr)
        return 2
    value, dt, ok, spread = bench_cornell()
    result = {
        "metric": "rays/s (cornell 256x256, 32spp, path maxdepth=5)",
        "value": round(value, 1),
        "unit": "rays/s",
        "seconds": round(dt, 3),
        "seconds_spread": spread,
        "image_ok": ok,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": _card(),
    }
    print(json.dumps(result), flush=True)
    c3, n_tris3, ok3, spread3 = bench_config3()
    result["config3_mray_s"] = round(c3 / 1e6, 2)
    result["config3_tris"] = int(n_tris3)
    result["config3_seconds_spread"] = spread3
    result["image_ok"] = bool(result["image_ok"] and ok3)
    print(json.dumps(result), flush=True)
    c5, n_tris5, spread5 = bench_config5()
    result["config5_mray_s"] = round(c5 / 1e6, 2)
    result["config5_tris"] = int(n_tris5)
    result["config5_seconds_spread"] = spread5
    print(json.dumps(result), flush=True)
    c5s, _, spread5s = bench_config5_sharded()
    result["config5_sharded_mray_s"] = round(c5s / 1e6, 2)
    result["config5_sharded_seconds_spread"] = spread5s
    print(json.dumps(result), flush=True)
    c5f, _, ok5f, spread5f = bench_config5_frame()
    result["config5_frame_mray_s"] = round(c5f / 1e6, 2)
    result["config5_frame_seconds_spread"] = spread5f
    result["image_ok"] = bool(result["image_ok"] and ok5f)
    print(json.dumps(result))
    return 0 if result["image_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
