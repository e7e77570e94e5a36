"""BVH correctness: traversal must agree exactly with brute force."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.accel.bvh import BVHIntersector, build_bvh
from pbrt_tpu.ops.intersect import BruteForceIntersector
from pbrt_tpu.shapes import TriangleData

SCENES = Path(__file__).resolve().parent.parent / "scenes"


def random_mesh(n_tris, seed=0, extent=10.0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-extent, extent, size=(n_tris, 3)).astype(np.float32)
    e1 = rng.normal(0, 1, size=(n_tris, 3)).astype(np.float32)
    e2 = rng.normal(0, 1, size=(n_tris, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, size=(n_tris, 2)).astype(np.float32)
    return TriangleData(
        p0=base,
        p1=base + e1,
        p2=base + e2,
        uv0=uv,
        uv1=uv,
        uv2=uv,
    )


def random_rays(n_rays, seed=1, extent=14.0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-extent, extent, size=(n_rays, 3)).astype(np.float32)
    d = rng.normal(0, 1, size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(o), jnp.asarray(d)


@pytest.mark.parametrize("n_tris", [1, 5, 63, 500])
def test_bvh_matches_brute_force(n_tris):
    tri = random_mesh(n_tris)
    bvh = BVHIntersector(tri, None)
    brute = BruteForceIntersector(tri, None)
    o, d = random_rays(512)
    t_max = jnp.full((512,), 1e8, dtype=jnp.float32)
    hb = jax.jit(brute.intersect)(o, d, t_max)
    hv = jax.jit(bvh.intersect)(o, d, t_max)
    np.testing.assert_array_equal(np.asarray(hb["hit"]), np.asarray(hv["hit"]))
    hit = np.asarray(hb["hit"])
    np.testing.assert_allclose(
        np.asarray(hb["t"])[hit], np.asarray(hv["t"])[hit], rtol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(hb["prim"])[hit], np.asarray(hv["prim"])[hit]
    )


def test_bvh_occlusion_matches():
    tri = random_mesh(200)
    bvh = BVHIntersector(tri, None)
    brute = BruteForceIntersector(tri, None)
    o, d = random_rays(512, seed=3)
    t_max = jnp.full((512,), 20.0, dtype=jnp.float32)
    ob = np.asarray(jax.jit(brute.occluded)(o, d, t_max))
    ov = np.asarray(jax.jit(bvh.occluded)(o, d, t_max))
    np.testing.assert_array_equal(ob, ov)


def test_build_structure_valid():
    tri = random_mesh(100)
    mins, maxs, skips, firsts, counts, perm = build_bvh(tri.p0, tri.p1, tri.p2)
    m = len(mins)
    assert skips[0] == m  # root subtree covers everything
    assert (skips > np.arange(m)).all()  # skips always advance
    # leaf ranges cover every prim exactly once
    covered = []
    for f, c in zip(firsts, counts):
        if c > 0:
            covered.extend(range(f, f + c))
    assert sorted(covered) == list(range(100))
    assert sorted(perm.tolist()) == list(range(100))
    # parent boxes contain children (DFS order: node i+1 is first child)
    for i in range(m):
        if counts[i] == 0:
            j = i + 1
            assert (mins[i] <= mins[j] + 1e-6).all()
            assert (maxs[i] >= maxs[j] - 1e-6).all()


def test_scene_with_bvh_renders_same_as_brute():
    """Full pipeline: same scene rendered with bvh vs brute-force
    accelerator must match exactly."""
    from pbrt_tpu import Options
    from pbrt_tpu.core.api import PbrtAPI
    from pbrt_tpu.render import render_scene

    def scene_text(accel):
        return f"""
        LookAt 0 1.5 -4  0 0.5 0  0 1 0
        Camera "perspective" "float fov" 50
        Sampler "halton" "integer pixelsamples" 2
        Integrator "path" "integer maxdepth" 2
        Film "image" "integer xresolution" [16] "integer yresolution" [16]
        Accelerator "{accel}" "integer minprims" 1
        WorldBegin
        LightSource "infinite" "rgb L" [.5 .5 .5]
        Material "matte" "rgb Kd" [0.6 0.5 0.4]
        Shape "loopsubdiv" "integer nlevels" 2
            "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
            "point P" [0 1 0  -1 0 -1  1 0 -1  0 0 1]
        WorldEnd
        """

    def run(accel):
        api = PbrtAPI(Options(ray_batch=256), render_on_world_end=False)
        api.init()
        api.parse_string(scene_text(accel))
        return render_scene(api.scene, api.opt, write=False)["image"]

    img_bvh = run("bvh")
    img_brute = run("none")
    np.testing.assert_allclose(img_bvh, img_brute, atol=1e-6)


def test_native_sah_build_matches_brute_force():
    """Native binned-SAH tree must produce identical hits to brute force."""
    from pbrt_tpu.native import bvh_build_native

    tri = random_mesh(2000, seed=11)
    out = bvh_build_native(tri.p0, tri.p1, tri.p2)
    if out is None:
        pytest.skip("native library unavailable")
    bvh = BVHIntersector(tri, None)  # uses native build by default
    brute = BruteForceIntersector(tri, None)
    o, d = random_rays(512, seed=5)
    t_max = jnp.full((512,), 1e8, dtype=jnp.float32)
    hb = jax.jit(brute.intersect)(o, d, t_max)
    hv = jax.jit(bvh.intersect)(o, d, t_max)
    np.testing.assert_array_equal(np.asarray(hb["hit"]), np.asarray(hv["hit"]))
    hit = np.asarray(hb["hit"])
    np.testing.assert_allclose(
        np.asarray(hb["t"])[hit], np.asarray(hv["t"])[hit], rtol=1e-5
    )
    np.testing.assert_array_equal(
        np.asarray(hb["prim"])[hit], np.asarray(hv["prim"])[hit]
    )


def test_native_tokenizer_parity():
    from pbrt_tpu.core.parser import create_from_string
    from pbrt_tpu.native import tokenize_native

    data = (SCENES / "check-sphere.pbrt").read_bytes()
    out = tokenize_native(data)
    if out is None:
        pytest.skip("native library unavailable")
    st, en = out
    native = [data[s:e].decode() for s, e in zip(st, en)]
    python = list(create_from_string(data))
    assert native == python
