"""Mesh-sharded rendering tests on the virtual 8-device CPU mesh.

What the reference lacks entirely (SURVEY.md §4 "multi-node testing: none")
— here: dp-sharded film equals single-device film exactly (zero-padding
makes the psum merge order-independent per pixel), sp sharding matches to
float tolerance, and the distributed gradient step agrees with the
single-device gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.parallel.mesh import ShardedRenderer, default_mesh
from pbrt_tpu.render import Renderer

SCENE = """
LookAt 0 0 -3  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 2
Film "image" "integer xresolution" [16] "integer yresolution" [16]
WorldBegin
LightSource "infinite" "rgb L" [.3 .5 .7]
Material "matte" "rgb Kd" [0.6 0.5 0.4]
Shape "sphere" "float radius" 1
WorldEnd
"""


def build(ray_batch=256):
    api = PbrtAPI(Options(ray_batch=ray_batch), render_on_world_end=False)
    api.init()
    api.parse_string(SCENE)
    return Renderer(api.scene, api.opt, seed=0)


@pytest.fixture(scope="module")
def single_image():
    r = build()
    state = r.render(spp=4, progress=False)
    return np.asarray(r.film.to_rgb(state))


def test_eight_devices_available():
    assert len(jax.devices()) >= 8


def test_dp_sharded_matches_single(single_image):
    r = build()
    mesh = default_mesh(8, sp=1)
    sr = ShardedRenderer(r, mesh)
    state = sr.render(spp=4)
    img = np.asarray(r.film.to_rgb(state))
    np.testing.assert_allclose(img, single_image, atol=2e-6)


def test_dp_sp_sharded_matches_single(single_image):
    r = build()
    mesh = default_mesh(8, sp=2)
    sr = ShardedRenderer(r, mesh)
    state = sr.render(spp=4)
    img = np.asarray(r.film.to_rgb(state))
    np.testing.assert_allclose(img, single_image, atol=2e-5)


def test_sharded_grad_step_matches_single_device():
    r = build(ray_batch=256)
    target = np.zeros((16, 16, 3), dtype=np.float32)
    theta = r.compiled.initial_theta()
    pixels = r.film.cropped_pixel_bounds.offsets().astype(np.int32)
    pixels_j = jnp.asarray(pixels)

    # single-device reference gradient
    from pbrt_tpu.diff.grad import make_loss_fn

    loss_fn = make_loss_fn(r, target, spp=2)
    ref_loss, ref_g = jax.jit(jax.value_and_grad(loss_fn))(theta, pixels_j)

    # sharded step (dp=4, sp=2): spp=1 x sp=2 = same 2 samples
    mesh = default_mesh(8, sp=2)
    sr = ShardedRenderer(r, mesh)
    step = sr.build_grad_step(target, spp=1, lr=1.0)
    loss, new_theta = step(theta, pixels_j)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    # new_theta = theta - 1.0 * grad  ->  grad = theta - new_theta
    g_kd = np.asarray(theta["kd"] - new_theta["kd"])
    np.testing.assert_allclose(g_kd, np.asarray(ref_g["kd"]), rtol=1e-3, atol=1e-7)


def test_dryrun_multichip_entrypoint():
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_kill_and_resume_bit_identical(tmp_path):
    """Mesh-parallel preemption recovery: a sharded render killed
    mid-sweep and resumed by a fresh ShardedRenderer must equal the
    uninterrupted sharded render exactly."""
    from pbrt_tpu import Options
    from pbrt_tpu.parallel.mesh import ShardedRenderer, default_mesh
    from pbrt_tpu.testscenes import cornell_renderer

    def make(ckdir):
        r = cornell_renderer(xres=16, yres=16, spp=2, maxdepth=2,
                             ray_batch=64)
        r.options.checkpoint_dir = str(ckdir)
        r.options.checkpoint_every = 1
        return ShardedRenderer(r, default_mesh(8, sp=2))

    ref_dir = tmp_path / "ref"
    sr_ref = make(ref_dir)
    img_ref = np.asarray(sr_ref.r.film.to_rgb(sr_ref.render(spp=2)))

    kill_dir = tmp_path / "kill"
    sr1 = make(kill_dir)
    calls = {"n": 0}
    orig = sr1._sharded_step

    def dying(*a, **kw):
        if calls["n"] >= 2:
            raise KeyboardInterrupt("simulated pod preemption")
        calls["n"] += 1
        return orig(*a, **kw)

    sr1._sharded_step = dying
    with pytest.raises(KeyboardInterrupt):
        sr1.render(spp=2)
    assert (kill_dir / "film-mesh.ckpt.npz").exists()

    sr2 = make(kill_dir)
    img2 = np.asarray(sr2.r.film.to_rgb(sr2.render(spp=2)))
    np.testing.assert_array_equal(img2, img_ref)
