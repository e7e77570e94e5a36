#!/usr/bin/env python3
"""Smoke test of the renderer on one NVIDIA GPU, through its entry points.

    python chip_smoke.py            # phases 1-6 on one card
    python chip_smoke.py --four     # the multi-card paths on four cards
    python chip_smoke.py --phases 1,3   # a subset (for iterating)

Phases (one process; nothing else opens the card):
  1 device     the card (nvidia-smi name and power limit), JAX's view of
               it, XLA_FLAGS and the compile-cache directory;
  2 cli        scenes/cornell.pbrt and scenes/check-sphere.pbrt rendered
               to PNG through ``pbrt_tpu.cli.main``;
  3 traversal  the GPU BVH kernel against the XLA walk (on the card) and
               brute force (4,096-ray subset), 262,144 rays against the
               50k- and 1M-triangle tori, closest and any-hit, with times;
  4 frames     config 3 (50k tris, 256x256, 8 spp, maxdepth 4) with the
               kernel and with the XLA walk, and the config-5 frame (1M
               tris, 256x256, 4 spp) through ``Renderer``;
  5 parity     tests/test_refrender.py's scenes against the scalar
               reference and tests/test_grad.py's kd/env gradients against
               finite differences, under those files' tolerances;
  6 determinism  the Cornell film rendered twice, compared bit for bit
               (reported, not enforced).

``--four`` runs only what exists across cards: ``ShardedRenderer`` over a
(dp=2, sp=2) mesh against one card's film, and the 1M-triangle torus
geometry-sharded over tp=4 (forward and gradient) against one card.

A phase that fails is reported and the script exits 1; with no GPU it
exits 2.  Details go to chiprun_out/smoke/results.json.  The last line of
standard output is the JSON verdict.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
OUT = REPO / "chiprun_out" / "smoke"
N_RAYS = 1 << 18
N_BRUTE = 4096  # rays of phase 3 also checked against brute force
#: (nu, nv) of the displaced tori of phase 3: 50,176 and 1,000,000 triangles
TORI = {"50k": (224, 112), "1M": (1000, 500)}


def log(*args):
    print(*args, flush=True)


def card_name_and_limit() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args, reps=5):
    """(first-call seconds, median warm seconds, all warm seconds, out)."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        dts.append(time.perf_counter() - t0)
    return first, sorted(dts)[len(dts) // 2], dts, out


def peak_bytes():
    import jax

    return jax.devices()[0].memory_stats().get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------


def phase_device(res):
    import jax

    dev = jax.devices()[0]
    res["card"] = card_name_and_limit()
    res["platform"] = dev.platform
    res["device_kind"] = dev.device_kind
    res["device_count"] = len(jax.devices())
    res["xla_flags"] = os.environ.get("XLA_FLAGS", "")
    res["compile_cache"] = jax.config.jax_compilation_cache_dir
    log("card:", res["card"])
    log(f"jax: {dev.platform} {dev.device_kind} x{res['device_count']} "
        f"XLA_FLAGS={res['xla_flags']!r} cache={res['compile_cache']}")
    assert dev.platform == "gpu", dev.platform


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def phase_cli(res):
    from pbrt_tpu.cli import main as cli_main
    from pbrt_tpu.core.imageio import read_image

    for name in ("cornell", "check-sphere"):
        png = OUT / f"{name}.png"
        t0 = time.perf_counter()
        rc = cli_main([str(REPO / "scenes" / f"{name}.pbrt"), "-q",
                       "-o", str(png), "--ray-batch", str(N_RAYS)])
        dt = time.perf_counter() - t0
        img, (w, h) = read_image(str(png))
        mean = float(img.mean())
        res[name] = {"rc": rc, "seconds": dt, "size": [w, h], "mean": mean}
        log(f"cli {name}: rc={rc} {w}x{h} mean={mean:.4f} {dt:.1f}s")
        assert rc == 0
        assert np.isfinite(img).all() and img.max() > 0 and mean > 0.01


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def make_rays(bvh, n, seed):
    """Camera rays from the config-3 eye at targets around the torus (some
    miss), plus one bounce in random directions from where they landed."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    half = n // 2
    eye = np.asarray([2.8, 2.2, 2.8], np.float32)
    o1 = np.tile(eye, (half, 1))
    d1 = _unit(rng.uniform(-1.6, 1.6, (half, 3)).astype(np.float32) - eye)
    h = bvh.intersect(jnp.asarray(o1), jnp.asarray(d1),
                      jnp.full((half,), 1e8, jnp.float32), sort=False)
    t = np.where(np.asarray(h["hit"]), np.asarray(h["t"]), 3.0)
    o2 = o1 + d1 * (t[:, None] - 1e-3)
    d2 = _unit(rng.normal(size=(n - half, 3)).astype(np.float32))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2]).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def compare_walks(tk, pk, tx, px, t_max, n):
    """Kernel against XLA walk: (hit-mask mismatches, t violations, prim
    differences that are not exact-t ties, miss-lane violations)."""
    tk, pk, tx, px, t_max = map(np.asarray, (tk, pk, tx, px, t_max))
    hk, hx = pk >= 0, px >= 0
    both = hk & hx
    rel = np.abs(tk - tx) / np.maximum(np.abs(tx), 1e-30)
    t_bad = int((rel[both] > 1e-5).sum())
    prim_diff = both & (pk != px)
    not_tie = int((prim_diff & (rel > 1e-5)).sum())
    miss_bad = int(((~hk) & ((pk != -1) | (tk != t_max))).sum())
    return {
        "lanes": n, "hits": int(hk.sum()),
        "hit_mismatch": int((hk != hx).sum()),
        "t_violations": t_bad, "prim_diff": int(prim_diff.sum()),
        "prim_diff_not_tie": not_tie, "miss_violations": miss_bad,
    }


def phase_traversal(res):
    import jax
    import jax.numpy as jnp

    from pbrt_tpu.accel.bvh import BVHIntersector
    from pbrt_tpu.native import get_lib
    from pbrt_tpu.ops import traverse as T
    from pbrt_tpu.ops.intersect import BruteForceIntersector
    from pbrt_tpu.testscenes import torus_triangle_data

    res["native_builder"] = get_lib() is not None
    log("native builder loaded:", res["native_builder"])
    assert res["native_builder"], "native BVH builder did not load"

    for label, (nu, nv) in TORI.items():
        r = res[label] = {}
        td = torus_triangle_data(nu, nv)
        t0 = time.perf_counter()
        bvh = BVHIntersector(td, None)
        jax.block_until_ready(bvh.tables)
        r["tris"] = int(td.count)
        r["nodes"] = int(bvh.n_nodes)
        r["build_s"] = time.perf_counter() - t0
        o, d = make_rays(bvh, N_RAYS, seed=len(label))
        tm = jnp.full((N_RAYS,), 1e8, jnp.float32)
        rng = np.random.default_rng(7)
        t_sh = jnp.asarray(rng.uniform(0.2, 4.0, N_RAYS).astype(np.float32))
        tb, leaf = bvh.tables, bvh.leaf_size
        runs = {}
        for walk in ("kernel", "xla"):
            for any_hit in (False, True):
                f = T.walk_gpu if walk == "kernel" else jax.jit(
                    T.walk_xla, static_argnames=("any_hit", "leaf_size"))
                tmax = t_sh if any_hit else tm
                first, med, dts, out = timed(
                    lambda o, d, tt, f=f, a=any_hit: f(
                        tb, o, d, tt, any_hit=a, leaf_size=leaf),
                    o, d, tmax)
                key = f"{walk}_{'anyhit' if any_hit else 'closest'}"
                runs[key] = out
                r[key + "_ms"] = med * 1e3
                r[key + "_first_s"] = first
                log(f"{label} {key}: {med * 1e3:.3f} ms (first call "
                    f"{first:.2f} s; reps {[round(x * 1e3, 3) for x in dts]})")
        tk, pk = runs["kernel_closest"][:2]
        tx, px = runs["xla_closest"][:2]
        cmp = r["kernel_vs_xla"] = compare_walks(tk, pk, tx, px, tm, N_RAYS)
        log(f"{label} kernel vs xla: {cmp}")
        # any-hit must equal (closest hit before t_max), up to lanes whose
        # closest t sits within float noise of t_max
        occ = np.asarray(runs["kernel_anyhit"][1]) >= 0
        tk_np, ts_np = np.asarray(tk), np.asarray(t_sh)
        want = (np.asarray(pk) >= 0) & (tk_np < ts_np)
        edge = np.abs(tk_np - ts_np) <= 1e-5 * ts_np
        r["anyhit_violations"] = int(((occ != want) & ~edge).sum())
        occ_x = np.asarray(runs["xla_anyhit"][1]) >= 0
        r["anyhit_kernel_vs_xla"] = int((occ != occ_x).sum())
        log(f"{label} any-hit violations: {r['anyhit_violations']}, "
            f"kernel vs xla any-hit mismatches: {r['anyhit_kernel_vs_xla']}")
        # brute force on a subset of the rays, original prim ids
        sub = np.random.default_rng(3).choice(N_RAYS, N_BRUTE, replace=False)
        os_, ds_, tms = o[sub], d[sub], tm[sub]
        hb = jax.jit(BruteForceIntersector(td, None).intersect)(os_, ds_, tms)
        hv = jax.jit(lambda o, d, t: bvh.intersect(o, d, t, sort=False))(
            os_, ds_, tms)
        bcmp = r["kernel_vs_brute"] = compare_walks(
            hv["t"], np.where(np.asarray(hv["hit"]), hv["prim"], -1),
            hb["t"], np.where(np.asarray(hb["hit"]), hb["prim"], -1),
            tms, N_BRUTE)
        log(f"{label} kernel vs brute ({N_BRUTE} rays): {bcmp}")
        # the sorted path (co-sort, walk, scatter back) against lane order
        hs = jax.jit(lambda o, d, t: bvh.intersect(o, d, t, sort=True))(
            o, d, tm)
        r["sorted_vs_lane_order"] = int(
            (np.asarray(hs["prim"]) != np.asarray(
                jnp.where(pk >= 0, bvh.perm[jnp.maximum(pk, 0)], 0))).sum())
        log(f"{label} sorted-path prim mismatches: {r['sorted_vs_lane_order']}")
        for block in (32, 64, 128):
            _, med, _, _ = timed(
                lambda o, d, tt, b=block: T.walk_gpu(
                    tb, o, d, tt, any_hit=False, leaf_size=leaf, block=b),
                o, d, tm)
            r[f"kernel_closest_block{block}_ms"] = med * 1e3
            log(f"{label} kernel closest block={block}: {med * 1e3:.3f} ms")
        for c in (cmp, bcmp):
            assert c["hit_mismatch"] <= 1e-4 * c["lanes"], c
            assert c["t_violations"] == 0 and c["miss_violations"] == 0, c
            assert c["prim_diff_not_tie"] == 0, c
        assert r["anyhit_violations"] == 0
        del bvh, runs, hb, hv, hs

    # lax.sort with 22 and 24 operands at 262,144 lanes: is there a cliff
    # above 22 operands on this card?
    rng = np.random.default_rng(0)
    key = jnp.asarray(rng.integers(0, 2**31, N_RAYS, dtype=np.uint32))
    cols = [jnp.asarray(rng.normal(size=N_RAYS).astype(np.float32))
            for _ in range(23)]
    for n_ops in (22, 24):
        f = jax.jit(lambda k, *c: jax.lax.sort((k,) + c, num_keys=1))
        first, med, _, _ = timed(f, key, *cols[:n_ops - 1])
        res[f"sort_{n_ops}_operands_ms"] = med * 1e3
        log(f"lax.sort {n_ops} operands x {N_RAYS}: {med * 1e3:.3f} ms "
            f"(first call {first:.2f} s)")


# ---------------------------------------------------------------------------
# phase 4
# ---------------------------------------------------------------------------


def _frame(label, make, spp, reps=3):
    import jax

    t0 = time.perf_counter()
    r, n_tris = make()
    setup = time.perf_counter() - t0
    t0 = time.perf_counter()
    state = r.render(spp=spp, progress=False)
    jax.block_until_ready(state["weight"])
    first = time.perf_counter() - t0
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        state = r.render(spp=spp, state=r.film.initial_state(), progress=False)
        jax.block_until_ready(state["weight"])
        dts.append(time.perf_counter() - t0)
    img = np.asarray(r.film.to_rgb(state))
    med = sorted(dts)[len(dts) // 2]
    out = {"tris": n_tris, "setup_s": setup, "first_s": first,
           "frame_s": med, "frames_s": dts, "peak_bytes": peak_bytes(),
           "mean": float(img.mean())}
    log(f"{label}: frame {med * 1e3:.1f} ms (reps "
        f"{[round(x * 1e3, 1) for x in dts]}), first {first:.1f} s, set-up "
        f"{setup:.1f} s, peak {out['peak_bytes']} B, mean {out['mean']:.4f}")
    assert np.isfinite(img).all() and img.max() > 0
    return out


def phase_frames(res):
    from pbrt_tpu.ops import traverse as T
    from pbrt_tpu.testscenes import mesh_scene_renderer

    def c3():
        return mesh_scene_renderer(xres=256, yres=256, spp=8, maxdepth=4,
                                   ray_batch=N_RAYS)

    def c5():
        return mesh_scene_renderer(xres=256, yres=256, spp=4, maxdepth=4,
                                   ray_batch=N_RAYS, nu=1000, nv=500)

    res["config3_kernel"] = _frame("config 3, kernel", c3, 8)
    # the same frame with the XLA walk in place of the kernel
    kernel = T.walk_gpu
    T.walk_gpu = lambda *a, interpret=False, block=None, **k: T.walk_xla(
        *a, **k)
    try:
        res["config3_xla"] = _frame("config 3, XLA walk", c3, 8)
    finally:
        T.walk_gpu = kernel
    res["config5_kernel"] = _frame("config 5 frame, kernel", c5, 4)


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def phase_parity(res):
    sys.path.insert(0, str(REPO / "tests"))
    import test_grad
    import test_refrender

    for name in ("test_gi_box_matches_scalar_reference",
                 "test_mirror_scene_matches_scalar_reference",
                 "test_check_sphere_matches_scalar_reference",
                 "test_glass_scene_matches_scalar_reference"):
        t0 = time.perf_counter()
        getattr(test_refrender, name)()
        res[name] = time.perf_counter() - t0
        log(f"{name}: ok ({res[name]:.1f} s)")
    r = test_grad.build()
    for name in ("test_grad_matches_finite_difference_kd",
                 "test_grad_matches_finite_difference_env"):
        getattr(test_grad, name)(r)
        res[name] = "ok"
        log(f"{name}: ok")


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------


def phase_determinism(res):
    from pbrt_tpu.testscenes import cornell_renderer

    r = cornell_renderer(xres=256, yres=256, spp=8, maxdepth=5,
                         ray_batch=N_RAYS)
    a = r.render(progress=False)
    b = r.render(state=r.film.initial_state(), progress=False)
    eq = {k: bool(np.array_equal(np.asarray(a[k]), np.asarray(b[k])))
          for k in a}
    diff = float(np.abs(np.asarray(a["xyz"]) - np.asarray(b["xyz"])).max())
    res["bit_equal"] = eq
    res["max_abs_diff_xyz"] = diff
    log(f"cornell rendered twice: bit-equal {eq}, max |diff| {diff}")


# ---------------------------------------------------------------------------
# --four
# ---------------------------------------------------------------------------


def phase_four(res):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pbrt_tpu.cameras import PerspectiveCamera
    from pbrt_tpu.core.film import Film
    from pbrt_tpu.core.filters import BoxFilter
    from pbrt_tpu.core.transform import Transform
    from pbrt_tpu.parallel.geomshard import (
        make_sharded_grad_fn,
        make_sharded_path_fn,
        shard_triangle_arrays,
    )
    from pbrt_tpu.parallel.mesh import ShardedRenderer, default_mesh
    from pbrt_tpu.samplers import HaltonSampler
    from pbrt_tpu.testscenes import mesh_scene_renderer, torus_triangle_data

    assert len(jax.devices()) >= 4, jax.devices()
    # ShardedRenderer (dp=2, sp=2) against one card, config-3 scene
    r, _ = mesh_scene_renderer(xres=128, yres=128, spp=4, maxdepth=4,
                               ray_batch=1 << 16)
    t0 = time.perf_counter()
    one = r.render(spp=4, progress=False)
    jax.block_until_ready(one["weight"])
    res["single_s"] = time.perf_counter() - t0
    sr = ShardedRenderer(r, default_mesh(4, sp=2))
    t0 = time.perf_counter()
    four = sr.render(spp=4)
    res["sharded_s"] = time.perf_counter() - t0
    img1 = np.asarray(r.film.to_rgb(one))
    img4 = np.asarray(r.film.to_rgb(four))
    res["sharded_max_abs_diff"] = float(np.abs(img1 - img4).max())
    log(f"ShardedRenderer dp=2 sp=2 vs one card: max |diff| "
        f"{res['sharded_max_abs_diff']} ({res['sharded_s']:.1f} s vs "
        f"{res['single_s']:.1f} s, both with compilation)")
    assert img4.max() > 0
    np.testing.assert_allclose(img4, img1, atol=1e-5)

    # 1M-triangle torus sharded over tp=4 against one card
    td = torus_triangle_data(1000, 500)
    film = Film((16, 16), ((0, 0), (1, 1)), BoxFilter((0.5, 0.5)))
    cam = PerspectiveCamera(
        Transform.look_at([3, 3, 2.5], [0, 0, 0], [0, 0, 1]).inverse(),
        45.0, (16, 16))
    sampler = HaltonSampler(1)
    kd = np.array([[0.6, 0.5, 0.4]], dtype=np.float32)
    env = np.array([0.8, 0.9, 1.0], dtype=np.float32)
    target = np.full((16, 16, 3), 0.2, dtype=np.float32)
    pixels = jnp.asarray(film.cropped_pixel_bounds.offsets().astype(np.int32))
    sidx = jnp.zeros((pixels.shape[0],), jnp.uint32)
    theta = {"kd": jnp.asarray(kd), "env_l": jnp.asarray(env)}
    outs = {}
    for tp in (1, 4):
        t0 = time.perf_counter()
        shards = shard_triangle_arrays(
            td, np.zeros(td.count, np.int32), np.full(td.count, -1, np.int32),
            tp, bvh=True)
        flat = {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:]))
                for k, v in shards.items()}
        build = time.perf_counter() - t0
        mesh = Mesh(np.array(jax.devices()[:tp]).reshape(1, tp), ("dp", "tp"))
        fwd = make_sharded_path_fn(mesh, cam, sampler, film, kd, env,
                                   max_depth=3, bvh=True)
        _, med, _, st = timed(lambda: fwd(film.initial_state(), flat, pixels,
                                          sidx), reps=3)
        grad = make_sharded_grad_fn(mesh, cam, sampler, film, target,
                                    max_depth=3, bvh=True)
        _, gmed, _, (loss, g) = timed(lambda: grad(theta, flat, pixels, sidx),
                                      reps=3)
        outs[tp] = (np.asarray(film.to_rgb(st)), float(loss),
                    jax.tree_util.tree_map(np.asarray, g))
        res[f"tp{tp}"] = {"build_s": build, "forward_ms": med * 1e3,
                          "grad_ms": gmed * 1e3, "loss": float(loss)}
        log(f"geomshard tp={tp}: build {build:.1f} s, forward "
            f"{med * 1e3:.2f} ms, gradient {gmed * 1e3:.2f} ms, "
            f"loss {float(loss):.6f}")
    (i1, l1, g1), (i4, l4, g4) = outs[1], outs[4]
    res["geomshard_max_abs_diff"] = float(np.abs(i1 - i4).max())
    log(f"geomshard tp=4 vs tp=1: image max |diff| "
        f"{res['geomshard_max_abs_diff']}, loss {l4} vs {l1}")
    assert i1.max() > 0
    np.testing.assert_allclose(i4, i1, atol=2e-6)
    np.testing.assert_allclose(l4, l1, rtol=1e-4)
    for k in g1:
        np.testing.assert_allclose(g4[k], g1[k], rtol=2e-3, atol=1e-5)


PHASES = {
    1: ("device", phase_device),
    2: ("cli", phase_cli),
    3: ("traversal", phase_traversal),
    4: ("frames", phase_frames),
    5: ("parity", phase_parity),
    6: ("determinism", phase_determinism),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card paths only")
    ap.add_argument("--phases", default="1,2,3,4,5,6",
                    help="comma-separated phase numbers (default: all)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"no GPU: JAX found {devs[0].platform}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    import pbrt_tpu  # noqa: F401  (sets the compile cache)

    OUT.mkdir(parents=True, exist_ok=True)
    if args.four:
        todo = [(1, "device", phase_device), (7, "four", phase_four)]
    else:
        todo = [(i, *PHASES[i]) for i in map(int, args.phases.split(","))]
    results, failed = {}, []
    for i, name, fn in todo:
        log(f"== phase {i}: {name}")
        res = results[name] = {}
        t0 = time.perf_counter()
        try:
            fn(res)
        except Exception:  # noqa: BLE001 - report every phase, then fail
            traceback.print_exc()
            res["error"] = traceback.format_exc()[-2000:]
            failed.append(name)
        res["phase_s"] = time.perf_counter() - t0
        log(f"== phase {i}: {name} {'FAILED' if name in failed else 'ok'} "
            f"({res['phase_s']:.1f} s)")
        (OUT / "results.json").write_text(json.dumps(results, indent=1,
                                                     default=str))
    if failed:
        print(f"failed phases: {failed}", file=sys.stderr)
        return 1
    log(card_name_and_limit())
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
