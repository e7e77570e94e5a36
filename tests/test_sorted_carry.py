"""Sorted-carry wavefront mode: permuted execution must be invisible.

PathIntegrator keeps the wavefront permanently in ray-sorted order across
bounces (one argsort + one packed row-gather per bounce) instead of
sort/unsort-ing around every intersect.  All ops in
the bounce body are per-lane, so a permutation of lanes must produce the
same image and the same parameter gradients, bit-for-bit on the CPU walk.
"""

import os

import numpy as np
import pytest

import jax

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.render import Renderer, render_scene

# enough triangles (loopsubdiv) to engage the BVH intersector + an area
# light (NEE + MIS) + env light + a mirror: exercises every carry column
SCENE = """
LookAt 0 1.5 -4  0 0.5 0  0 1 0
Camera "perspective" "float fov" 50
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 5
Film "image" "integer xresolution" [16] "integer yresolution" [16]
Accelerator "bvh" "integer minprims" 1
WorldBegin
LightSource "infinite" "rgb L" [.2 .2 .3]
AttributeBegin
  AreaLightSource "diffuse" "rgb L" [4 4 4]
  Translate 0 3 0
  Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
    "point P" [ -0.5 0 -0.5   0.5 0 -0.5   0.5 0 0.5   -0.5 0 0.5 ]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "loopsubdiv" "integer nlevels" 2
    "integer indices" [0 1 2  0 2 3  0 3 1  1 3 2]
    "point P" [0 1 0  -1 0 -1  1 0 -1  0 0 1]
Material "mirror" "rgb Kr" [0.8 0.8 0.8]
AttributeBegin
  Translate 1.2 0.4 0
  Shape "sphere" "float radius" 0.4
AttributeEnd
WorldEnd
"""


def _parse():
    api = PbrtAPI(Options(ray_batch=16 * 16 * 4), render_on_world_end=False)
    api.init()
    api.parse_string(SCENE)
    return api


def _render(disable_sc):
    env = "1" if disable_sc else "0"
    old = os.environ.get("PBRT_TPU_NO_SORTED_CARRY")
    os.environ["PBRT_TPU_NO_SORTED_CARRY"] = env
    try:
        api = _parse()
        return render_scene(api.scene, api.opt, write=False)["image"]
    finally:
        if old is None:
            os.environ.pop("PBRT_TPU_NO_SORTED_CARRY", None)
        else:
            os.environ["PBRT_TPU_NO_SORTED_CARRY"] = old


def test_sorted_carry_image_matches_unsorted():
    img_sc = _render(disable_sc=False)
    img_plain = _render(disable_sc=True)
    assert np.isfinite(img_sc).all()
    np.testing.assert_allclose(img_sc, img_plain, atol=1e-6)


def test_sorted_carry_engaged():
    """The BVH scene must actually take the sorted-carry path (guard
    against silently losing the mode)."""
    api = _parse()
    r = Renderer(api.scene, api.opt)
    assert r.integrator._use_sorted_carry()


def test_sorted_carry_gradients_match():
    """Autodiff must flow through the per-bounce permutation (gather) and
    the final lane-restoring scatter unchanged."""
    from pbrt_tpu.diff.grad import make_radiance_fn

    grads = {}
    for disable in (False, True):
        old = os.environ.get("PBRT_TPU_NO_SORTED_CARRY")
        os.environ["PBRT_TPU_NO_SORTED_CARRY"] = "1" if disable else "0"
        try:
            api = _parse()
            r = Renderer(api.scene, api.opt)
            theta = r.compiled.initial_theta()
            radiance = make_radiance_fn(r, remat=True)
            pixels = np.stack(
                np.meshgrid(np.arange(16), np.arange(16)), -1
            ).reshape(-1, 2).astype(np.int32)
            sidx = np.zeros((len(pixels),), dtype=np.uint32)

            def loss(t):
                return radiance(t, pixels, sidx).mean()

            grads[disable] = jax.jit(jax.grad(loss))(theta)
        finally:
            if old is None:
                os.environ.pop("PBRT_TPU_NO_SORTED_CARRY", None)
            else:
                os.environ["PBRT_TPU_NO_SORTED_CARRY"] = old
    flat_a = jax.tree.leaves(grads[False])
    flat_b = jax.tree.leaves(grads[True])
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)


def test_merged_shadow_sort_matches_per_call_sorts():
    """r5 merged shadow+carry sort: the shadow wavefront rides the carry
    co-sort (10 extra payload operands) instead of paying its own key-sort,
    and the occlusion sweep runs sort-free in next-bounce order.  Occlusion
    is a boolean any-hit (lane-order invariant) and the NEE add commutes
    with the permutation, so the image must be bit-identical to the r4
    per-call shadow-sort machinery."""
    old = os.environ.get("PBRT_TPU_SC_MERGED")
    img_merged = _render(disable_sc=False)  # default: merged ON
    os.environ["PBRT_TPU_SC_MERGED"] = "0"
    try:
        img_percall = _render(disable_sc=False)
    finally:
        if old is None:
            os.environ.pop("PBRT_TPU_SC_MERGED", None)
        else:
            os.environ["PBRT_TPU_SC_MERGED"] = old
    assert np.isfinite(img_merged).all()
    np.testing.assert_array_equal(img_merged, img_percall)


def test_dead_bit_packing_does_not_change_image():
    """The dead-lane sort bit (wavefront compaction) only regroups
    packets; images must be identical with it disabled."""
    old = os.environ.get("PBRT_TPU_NO_DEADBIT")
    img_on = _render(disable_sc=False)
    os.environ["PBRT_TPU_NO_DEADBIT"] = "1"
    try:
        img_off = _render(disable_sc=False)
    finally:
        if old is None:
            os.environ.pop("PBRT_TPU_NO_DEADBIT", None)
        else:
            os.environ["PBRT_TPU_NO_DEADBIT"] = old
    np.testing.assert_allclose(img_on, img_off, atol=1e-6)
