"""Geometry-sharded rendering tests: triangles split over a tp mesh axis
must produce the same image as replicated geometry."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from pbrt_tpu import float_t
from pbrt_tpu.core.film import Film
from pbrt_tpu.core.filters import BoxFilter
from pbrt_tpu.core.transform import Transform
from pbrt_tpu.cameras import PerspectiveCamera
from pbrt_tpu.parallel.geomshard import (
    allreduce_closest,
    local_closest_hit,
    make_sharded_path_fn,
    shard_triangle_arrays,
)
from pbrt_tpu.samplers import HaltonSampler
from pbrt_tpu.shapes import TriangleData, concat_triangle_data


def make_scene_mesh(n=40):
    """A little heightfield of triangles in front of the camera."""
    rng = np.random.default_rng(7)
    xs = np.linspace(-2, 2, n)
    ys = np.linspace(-2, 2, n)
    gx, gy = np.meshgrid(xs, ys)
    gz = 0.3 * np.sin(gx * 2) * np.cos(gy * 2)
    pts = np.stack([gx, gy, gz], axis=-1)
    p0s, p1s, p2s = [], [], []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = pts[i, j], pts[i + 1, j], pts[i + 1, j + 1], pts[i, j + 1]
            p0s += [a, a]
            p1s += [b, c]
            p2s += [c, d]
    uv = np.zeros((len(p0s), 2), dtype=np.float32)
    td = TriangleData(
        p0=np.asarray(p0s, np.float32),
        p1=np.asarray(p1s, np.float32),
        p2=np.asarray(p2s, np.float32),
        uv0=uv, uv1=uv, uv2=uv,
    )
    return concat_triangle_data([td])


def build_mesh(dp, tp):
    devs = np.array(jax.devices()[: dp * tp]).reshape(dp, tp)
    return Mesh(devs, ("dp", "tp"))


def render_with(dp, tp, spp=2, formulation="allreduce", bvh=False):
    td = make_scene_mesh()
    t = td.count
    mats = np.zeros(t, dtype=np.int32)
    lights = np.full(t, -1, dtype=np.int32)
    shards = shard_triangle_arrays(td, mats, lights, tp, bvh=bvh)
    mesh = build_mesh(dp, tp)
    film = Film((16, 16), ((0, 0), (1, 1)), BoxFilter((0.5, 0.5)))
    cam = PerspectiveCamera(
        Transform.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]).inverse(), 50.0, (16, 16)
    )
    sampler = HaltonSampler(spp)
    kd = np.array([[0.6, 0.5, 0.4]], dtype=np.float32)
    env = np.array([0.8, 0.9, 1.0], dtype=np.float32)
    fn = make_sharded_path_fn(mesh, cam, sampler, film, kd, env, max_depth=3,
                              formulation=formulation, bvh=bvh)
    state = film.initial_state()
    pixels = film.cropped_pixel_bounds.offsets().astype(np.int32)
    # lanes = pixels x samples, divisible by the ray-sharding factor
    lane_pix = np.repeat(pixels, spp, axis=0)
    lane_sidx = np.tile(np.arange(spp, dtype=np.uint32), len(pixels))
    ray_shards = dp * tp if formulation == "ring" else dp
    n = (len(lane_pix) // ray_shards) * ray_shards
    flat = {k: np.reshape(v, (-1,) + v.shape[2:]) for k, v in shards.items()}
    state = fn(state, {k: jnp.asarray(v) for k, v in flat.items()},
               jnp.asarray(lane_pix[:n]), jnp.asarray(lane_sidx[:n]))
    return np.asarray(film.to_rgb(state))


def test_local_closest_hit_basic():
    td = make_scene_mesh(10)
    shards = shard_triangle_arrays(td, np.zeros(td.count, np.int32),
                                   np.full(td.count, -1, np.int32), 1)
    flat = {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:])) for k, v in shards.items()}
    o = jnp.asarray(np.array([[0, 0, -3.0], [5, 5, -3.0]], np.float32))
    d = jnp.asarray(np.array([[0, 0, 1.0], [0, 0, 1.0]], np.float32))
    t, idx, b0, b1 = local_closest_hit(flat, o, d, jnp.full((2,), 1e8))
    assert idx[0] >= 0  # center ray hits the heightfield
    assert idx[1] < 0  # ray outside the grid misses


def test_sharded_matches_replicated():
    img_tp1 = render_with(dp=8, tp=1)
    img_tp4 = render_with(dp=2, tp=4)
    np.testing.assert_allclose(img_tp4, img_tp1, atol=2e-6)
    assert img_tp1.max() > 0.05  # actually rendered something


def test_sharded_deterministic_across_meshes():
    img_a = render_with(dp=4, tp=2)
    img_b = render_with(dp=2, tp=4)
    np.testing.assert_allclose(img_a, img_b, atol=2e-6)


def test_ring_matches_allreduce():
    """Ring (rays sharded over tp, ppermute packet rotation) must produce
    the same image as the all-reduce formulation — identical tie-breaks."""
    img_ar = render_with(dp=2, tp=4)
    img_ring = render_with(dp=2, tp=4, formulation="ring")
    np.testing.assert_allclose(img_ring, img_ar, atol=2e-6)
    assert img_ring.max() > 0.05


def test_ring_deterministic_across_meshes():
    img_a = render_with(dp=4, tp=2, formulation="ring")
    img_b = render_with(dp=1, tp=8, formulation="ring")
    img_c = render_with(dp=8, tp=1, formulation="ring")
    np.testing.assert_allclose(img_a, img_b, atol=2e-6)
    np.testing.assert_allclose(img_a, img_c, atol=2e-6)


def test_bvh_shards_match_brute_shards():
    """Per-shard BVH traversal (the config-5 production path) must produce
    the same image as the brute-force sweep."""
    img_brute = render_with(dp=2, tp=4)
    img_bvh = render_with(dp=2, tp=4, bvh=True)
    np.testing.assert_allclose(img_bvh, img_brute, atol=2e-6)
    assert img_bvh.max() > 0.05


def test_bvh_shards_invariant_across_meshes():
    img_a = render_with(dp=8, tp=1, bvh=True)
    img_b = render_with(dp=4, tp=2, bvh=True)
    img_c = render_with(dp=2, tp=4, bvh=True)
    np.testing.assert_allclose(img_a, img_b, atol=2e-6)
    np.testing.assert_allclose(img_a, img_c, atol=2e-6)


def _shard_rays(n=192, seed=3):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    o[:, 2] = -3.0
    tgt = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    tgt[:, 2] = 0.0
    d = tgt - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


def test_shard_kernel_matches_xla_walk(gpu_kernel_interpret):
    """The tp path's per-shard walk: the GPU kernel (interpret mode) must
    agree with the XLA walk on every shard, ids and barycentrics
    included."""
    from pbrt_tpu.parallel.geomshard import _local_bvh_hit

    td = make_scene_mesh(16)
    t = td.count
    tp = 2
    shards = shard_triangle_arrays(
        td, np.zeros(t, np.int32), np.full(t, -1, np.int32), tp, bvh=True
    )
    o, d = _shard_rays()
    tmax = jnp.full((o.shape[0],), 1e8, jnp.float32)
    for s in range(tp):
        sh = {
            k: jnp.asarray(v[s : s + 1] if k == "nn" else v[s])
            for k, v in shards.items()
        }
        t_a, i_a, b0_a, b1_a = _local_bvh_hit(sh, o, d, tmax, "cpu")
        t_b, i_b, b0_b, b1_b = _local_bvh_hit(sh, o, d, tmax, "gpu")
        hit_a = np.asarray(i_a) >= 0
        assert hit_a.any()
        np.testing.assert_array_equal(i_a, i_b)
        np.testing.assert_allclose(t_a, t_b, rtol=1e-6)
        # barycentrics are quotients by the determinant: the two
        # compilations may contract multiply-adds differently
        np.testing.assert_allclose(
            np.asarray(b0_a)[hit_a], np.asarray(b0_b)[hit_a], atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(b1_a)[hit_a], np.asarray(b1_b)[hit_a], atol=1e-5
        )


def test_shard_kernel_inside_shard_map(gpu_kernel_interpret):
    """The per-shard GPU walk inside ``shard_map`` on the 8-device CPU
    mesh: the allreduce hit record must equal the XLA walk's."""
    from jax.sharding import PartitionSpec as P

    from pbrt_tpu.parallel.geomshard import _shard_specs, _local_bvh_hit

    td = make_scene_mesh(20)
    t = td.count
    tp = 4
    shards = shard_triangle_arrays(
        td, np.zeros(t, np.int32), np.full(t, -1, np.int32), tp, bvh=True
    )
    flat = {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:]))
            for k, v in shards.items()}
    mesh = build_mesh(2, tp)
    o, d = _shard_rays(256, seed=4)
    tmax = jnp.full((256,), 1e8, jnp.float32)

    def run(platform):
        def local(sh, o, d, tm):
            t_l, i_l, b0, b1 = _local_bvh_hit(sh, o, d, tm, platform)
            hit = allreduce_closest(sh, t_l, i_l, b0, b1, "tp")
            return hit["t"], hit["prim"], hit["hit"]

        fn = jax.jit(jax.shard_map(
            local, mesh=mesh,
            in_specs=(_shard_specs("tp", True, P), P("dp", None),
                      P("dp", None), P("dp")),
            out_specs=(P("dp"), P("dp"), P("dp")),
            check_vma=False,
        ))
        return [np.asarray(x) for x in fn(flat, o, d, tmax)]

    ta, pa, ha = run("cpu")
    tb, pb, hb = run("gpu")
    assert ha.any() and not ha.all()
    np.testing.assert_array_equal(ha, hb)
    np.testing.assert_array_equal(pa[ha], pb[ha])
    np.testing.assert_allclose(ta, tb, rtol=1e-6)


def _grad_with(dp, tp, bvh=True):
    from pbrt_tpu.parallel.geomshard import make_sharded_grad_fn

    td = make_scene_mesh()
    t = td.count
    mats = np.zeros(t, dtype=np.int32)
    lights = np.full(t, -1, dtype=np.int32)
    shards = shard_triangle_arrays(td, mats, lights, tp, bvh=bvh)
    mesh = build_mesh(dp, tp)
    film = Film((16, 16), ((0, 0), (1, 1)), BoxFilter((0.5, 0.5)))
    cam = PerspectiveCamera(
        Transform.look_at([0, 0, -4], [0, 0, 0], [0, 1, 0]).inverse(), 50.0, (16, 16)
    )
    sampler = HaltonSampler(2)
    theta = {
        "kd": jnp.asarray(np.array([[0.6, 0.5, 0.4]], dtype=np.float32)),
        "env_l": jnp.asarray(np.array([0.8, 0.9, 1.0], dtype=np.float32)),
    }
    target = np.full((16, 16, 3), 0.25, dtype=np.float32)
    fn = make_sharded_grad_fn(mesh, cam, sampler, film, target, max_depth=3,
                              bvh=bvh)
    pixels = film.cropped_pixel_bounds.offsets().astype(np.int32)
    n = (len(pixels) // dp) * dp
    flat = {k: jnp.asarray(np.reshape(v, (-1,) + v.shape[2:]))
            for k, v in shards.items()}
    loss, grads = fn(theta, flat, jnp.asarray(pixels[:n]),
                     jnp.zeros((n,), dtype=jnp.uint32))
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def test_sharded_gradients_invariant_and_nonzero():
    """Path-replay gradient step (config 5): loss and parameter gradients
    must not depend on the (dp, tp) mesh factorization, and kd/env grads
    must actually flow."""
    l_a, g_a = _grad_with(dp=8, tp=1)
    l_b, g_b = _grad_with(dp=2, tp=4)
    assert np.isfinite(l_a) and l_a > 0
    np.testing.assert_allclose(l_a, l_b, rtol=1e-4)
    np.testing.assert_allclose(g_a["kd"], g_b["kd"], rtol=2e-3, atol=1e-5)
    np.testing.assert_allclose(g_a["env_l"], g_b["env_l"], rtol=2e-3, atol=1e-5)
    assert np.abs(g_a["kd"]).max() > 0
    assert np.abs(g_a["env_l"]).max() > 0
