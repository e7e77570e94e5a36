"""Skip-link BVH traversal (ops/traverse.py): the GPU kernel, run in
Pallas interpret mode, against the XLA walk and brute force; the
platform dispatch; padding, dead and miss lanes; tie-breaks; gradients."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrt_tpu.accel.bvh import BVHIntersector, build_bvh
from pbrt_tpu.ops import traverse as T
from pbrt_tpu.ops.intersect import BruteForceIntersector
from pbrt_tpu.shapes import TriangleData

from test_bvh import random_mesh, random_rays


def tables_for(tri, leaf):
    mins, maxs, skips, firsts, counts, perm = build_bvh(
        tri.p0, tri.p1, tri.p2, leaf
    )
    tb = T.pack_tables(mins, maxs, skips, firsts, counts,
                       tri.p0[perm], tri.p1[perm], tri.p2[perm])
    return T.BVHTables(*map(jnp.asarray, tb)), perm


def kernel(tables, o, d, tm, any_hit, leaf, **kw):
    return T.walk_gpu(tables, o, d, tm, any_hit=any_hit, leaf_size=leaf,
                      interpret=True, **kw)


@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
@pytest.mark.parametrize("leaf", [1, 2, 4, 8, 16])
def test_kernel_matches_xla_walk_and_brute(leaf, any_hit):
    tri = random_mesh(400, seed=leaf)
    tables, perm = tables_for(tri, leaf)
    n = 256
    o, d = random_rays(n, seed=30 + leaf, extent=8.0)
    tm = jnp.full((n,), 1e8 if not any_hit else 6.0, jnp.float32)
    tk, pk, b0k, b1k = kernel(tables, o, d, tm, any_hit, leaf)
    tx, px, b0x, b1x = T.walk_xla(tables, o, d, tm, any_hit=any_hit,
                                  leaf_size=leaf)
    hk, hx = np.asarray(pk) >= 0, np.asarray(px) >= 0
    np.testing.assert_array_equal(hk, hx)
    brute = BruteForceIntersector(tri, None)
    if any_hit:
        np.testing.assert_array_equal(hk, np.asarray(brute.occluded(o, d, tm)))
        return
    assert hk.sum() > 20
    np.testing.assert_array_equal(pk, px)
    np.testing.assert_allclose(tk, tx, rtol=1e-6)
    # barycentrics are quotients by the determinant: the two compilations
    # may contract multiply-adds differently
    np.testing.assert_allclose(np.asarray(b0k)[hk], np.asarray(b0x)[hk],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(b1k)[hk], np.asarray(b1x)[hk],
                               atol=1e-5)
    hb = brute.intersect(o, d, tm)
    np.testing.assert_array_equal(np.asarray(hb["hit"]), hk)
    np.testing.assert_allclose(np.asarray(hb["t"])[hk], np.asarray(tk)[hk],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hb["prim"])[hk],
                                  perm[np.asarray(pk)[hk]])


@pytest.mark.parametrize("n", [1, 63, 65, 200])
def test_kernel_pads_rays_to_block(n):
    """Wavefronts that are not a multiple of the block: padded lanes stay
    out of the results and real lanes are unchanged."""
    tri = random_mesh(150, seed=2)
    tables, _ = tables_for(tri, 4)
    o, d = random_rays(n, seed=40, extent=6.0)
    tm = jnp.full((n,), 1e8, jnp.float32)
    out = kernel(tables, o, d, tm, False, 4, block=64)
    ref = T.walk_xla(tables, o, d, tm, any_hit=False, leaf_size=4)
    assert all(a.shape == (n,) for a in out)
    np.testing.assert_array_equal(out[1], ref[1])
    np.testing.assert_allclose(out[0], ref[0], rtol=1e-6)
    for a, b in zip(out[2:], ref[2:]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_kernel_miss_lanes_stay_minus_one():
    """Rays pointing away from the mesh: prim -1, t == t_max, bary 0."""
    tri = random_mesh(300, seed=3, extent=1.0)
    tables, _ = tables_for(tri, 4)
    n = 128
    o = jnp.tile(jnp.asarray([[30.0, 24.0, 22.0]], jnp.float32), (n, 1))
    d = o / jnp.linalg.norm(o, axis=-1, keepdims=True)
    tm = jnp.linspace(1.0, 1e8, n, dtype=jnp.float32)
    for any_hit in (False, True):
        t, prim, b0, b1 = kernel(tables, o, d, tm, any_hit, 4)
        assert (np.asarray(prim) == -1).all()
        np.testing.assert_array_equal(t, tm)
        assert not np.asarray(b0).any() and not np.asarray(b1).any()


def test_kernel_dead_lanes_are_inert():
    """Lanes with t_max <= RAY_EPS (terminated paths) report no hit even
    when their origin sits inside the scene's boxes."""
    tri = random_mesh(300, seed=5, extent=3.0)
    tables, _ = tables_for(tri, 4)
    n = 256
    o, d = random_rays(n, seed=6, extent=3.0)
    tm = jnp.full((n,), 1e8, jnp.float32).at[::2].set(0.0).at[1::4].set(-5.0)
    _, prim, _, _ = kernel(tables, o, d, tm, False, 4)
    _, prim_x, _, _ = T.walk_xla(tables, o, d, tm, any_hit=False,
                                 leaf_size=4)
    live = np.asarray(tm) > 0
    assert not (np.asarray(prim)[~live] >= 0).any()
    np.testing.assert_array_equal(np.asarray(prim)[live],
                                  np.asarray(prim_x)[live])


@pytest.mark.parametrize("walk", ["xla", "kernel"])
def test_tie_ids_pick_the_lower_id(walk):
    """Two copies of every triangle: with tie ids the lower id wins an
    exact-t tie, whichever copy the walk meets first."""
    tri = random_mesh(64, seed=8)
    dup = TriangleData(
        p0=np.concatenate([tri.p0, tri.p0]),
        p1=np.concatenate([tri.p1, tri.p1]),
        p2=np.concatenate([tri.p2, tri.p2]),
        uv0=np.concatenate([tri.uv0, tri.uv0]),
        uv1=np.concatenate([tri.uv1, tri.uv1]),
        uv2=np.concatenate([tri.uv2, tri.uv2]),
    )
    tables, perm = tables_for(dup, 4)
    # copies get ids 1000+i (first) and i (second): the second must win
    orig = np.asarray(perm) % 64
    ids = jnp.asarray(np.where(np.asarray(perm) < 64, 1000 + orig, orig)
                      .astype(np.int32))
    # aim every ray at a triangle's centroid
    rng = np.random.default_rng(9)
    o = rng.uniform(-14, 14, (256, 3)).astype(np.float32)
    c = (tri.p0 + tri.p1 + tri.p2)[rng.integers(0, 64, 256)] / 3.0
    d = (c - o) / np.linalg.norm(c - o, axis=-1, keepdims=True)
    o, d = jnp.asarray(o), jnp.asarray(d)
    tm = jnp.full((256,), 1e8, jnp.float32)
    if walk == "xla":
        t, prim, _, _ = T.walk_xla(tables, o, d, tm, any_hit=False,
                                   leaf_size=4, tie_ids=ids)
    else:
        t, prim, _, _ = kernel(tables, o, d, tm, False, 4, tie_ids=ids)
    hit = np.asarray(prim) >= 0
    assert hit.sum() > 200
    assert (np.asarray(perm)[np.asarray(prim)[hit]] >= 64).all()


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_traverse_dispatches_by_platform(platform, monkeypatch):
    called = []
    monkeypatch.setattr(T, "walk_gpu",
                        lambda *a, **k: called.append("gpu") or "g")
    monkeypatch.setattr(T, "walk_xla",
                        lambda *a, **k: called.append("cpu") or "c")
    z = jnp.zeros((4, 3))
    T.traverse(platform, None, z, z, jnp.ones(4), any_hit=False,
               leaf_size=4)
    assert called == [platform]


def test_unknown_platform_raises():
    tri = random_mesh(8)
    with pytest.raises(ValueError, match="metal"):
        BVHIntersector(tri, None, platform="metal")
    z = jnp.zeros((4, 3))
    with pytest.raises(ValueError, match="rocm"):
        T.traverse("rocm", None, z, z, jnp.ones(4), any_hit=False,
                   leaf_size=4)


@pytest.mark.parametrize("sort", [True, False], ids=["sorted", "lane_order"])
def test_intersector_gpu_path_matches_brute(sort, gpu_kernel_interpret):
    """BVHIntersector on the "gpu" platform (kernel in interpret mode):
    with ``sort=True`` rays are co-sorted, walked and scattered back —
    results must come back in lane order, miss lanes included."""
    tri = random_mesh(600, seed=12)
    bvh = BVHIntersector(tri, None, platform="gpu")
    brute = BruteForceIntersector(tri, None)
    n = 512
    o, d = random_rays(n, seed=13)
    tm = jnp.full((n,), 1e8, jnp.float32).at[::5].set(0.0)
    hv = bvh.intersect(o, d, tm, sort=sort)
    hb = brute.intersect(o, d, tm)
    np.testing.assert_array_equal(np.asarray(hb["hit"]), np.asarray(hv["hit"]))
    m = np.asarray(hb["hit"])
    assert 20 < m.sum() < n
    np.testing.assert_allclose(np.asarray(hb["t"])[m], np.asarray(hv["t"])[m],
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(hb["prim"])[m],
                                  np.asarray(hv["prim"])[m])
    np.testing.assert_allclose(np.asarray(hb["b0"])[m],
                               np.asarray(hv["b0"])[m], atol=1e-4)
    np.testing.assert_array_equal(np.asarray(hv["t"])[~m], np.asarray(tm)[~m])
    t_sh = jnp.full((n,), 12.0, jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(brute.occluded(o, d, t_sh)),
        np.asarray(bvh.occluded(o, d, t_sh, sort=sort)),
    )


def test_gradient_flows_past_traversal(gpu_kernel_interpret):
    """Traversal is not differentiated: a loss that shades hits with a
    parameter has the analytic gradient, and rays that depend on the
    parameter do not break ``jax.grad``."""
    tri = random_mesh(200, seed=14)
    bvh = BVHIntersector(tri, None, platform="gpu")
    o, d = random_rays(128, seed=15)
    tm = jnp.full((128,), 1e8, jnp.float32)

    def loss(k):
        hit = bvh.intersect(o + 0.0 * k, d, tm, sort=False)
        return jnp.sum(jnp.where(hit["hit"], k * hit["t"], 0.0))

    g = jax.grad(loss)(jnp.float32(2.0))
    hit = bvh.intersect(o, d, tm, sort=False)
    want = float(jnp.sum(jnp.where(hit["hit"], hit["t"], 0.0)))
    np.testing.assert_allclose(float(g), want, rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("any_hit", [False, True], ids=["closest", "anyhit"])
def test_kernel_on_card_matches_xla_walk(any_hit):
    """The compiled kernel on the card against the XLA walk there."""
    tri = random_mesh(20000, seed=16)
    tables, _ = tables_for(tri, 4)
    n = 1 << 16
    o, d = random_rays(n, seed=17, extent=8.0)
    tm = jnp.full((n,), 1e8 if not any_hit else 6.0, jnp.float32)
    tk, pk, _, _ = T.walk_gpu(tables, o, d, tm, any_hit=any_hit, leaf_size=4)
    tx, px, _, _ = T.walk_xla(tables, o, d, tm, any_hit=any_hit,
                              leaf_size=4)
    np.testing.assert_array_equal(np.asarray(pk) >= 0, np.asarray(px) >= 0)
    if not any_hit:
        np.testing.assert_allclose(tk, tx, rtol=1e-5)
