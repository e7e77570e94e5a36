"""Camera ray differentials -> texture footprints -> live MIPMap levels.

The reference carries the full EWA machinery as a stub
(reference src/core/mipmap.rs:33-67); these tests pin down the device
build's live path: footprint math on a known plane, trilinear level
selection reaching the coarse pyramid, and reduced aliasing on a
grazing-angle imagemap vs finest-level point sampling.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.core.mipmap import MIPMap
from pbrt_tpu.render import render_scene


def test_mipmap_aniso_levels():
    """Fine checker: tiny footprint keeps contrast, wide footprint
    averages to gray; constant image is footprint-invariant."""
    checker = np.indices((64, 64)).sum(axis=0) % 2
    img = np.repeat(checker[..., None], 3, axis=-1).astype(np.float32)
    mm = MIPMap(img, do_trilinear=False)
    # sample at a texel center so the narrow lookup is a pure texel read
    c = (16.5) / 64.0
    s = jnp.asarray([c, c])
    t = jnp.asarray([c, c])
    narrow = jnp.asarray([[1e-4, 0.0], [1e-4, 0.0]])
    wide = jnp.asarray([[0.5, 0.0], [0.5, 0.0]])
    tiny = np.asarray(mm.lookup_aniso(s, t, narrow, narrow))
    coarse = np.asarray(mm.lookup_aniso(s, t, wide, wide))
    # wide footprint ~= global mean (0.5); narrow keeps texel values
    assert abs(coarse[0, 0] - 0.5) < 0.05
    assert (tiny[0, 0] < 0.25) or (tiny[0, 0] > 0.75)

    const = MIPMap(np.full((32, 32, 3), 0.37, np.float32), do_trilinear=False)
    a = np.asarray(const.lookup_aniso(s, t, narrow, narrow))
    b = np.asarray(const.lookup_aniso(s, t, wide, wide))
    np.testing.assert_allclose(a, 0.37, rtol=1e-4)
    np.testing.assert_allclose(b, 0.37, rtol=1e-4)


def test_footprint_on_known_plane():
    """Quad at z=0 filling uv [0,1]^2, pinhole camera straight above:
    tex_width must equal the projected pixel size / quad extent."""
    from pbrt_tpu.cameras import PerspectiveCamera
    from pbrt_tpu.core.film import Film
    from pbrt_tpu.core.filters import BoxFilter
    from pbrt_tpu.core.transform import Transform
    from pbrt_tpu.ops.intersect import BruteForceIntersector
    from pbrt_tpu.scene.builder import compute_interaction
    from pbrt_tpu.shapes import TriangleData, concat_triangle_data

    ext = 4.0  # quad spans [-2, 2]^2
    td = concat_triangle_data([TriangleData(
        p0=np.array([[-2, -2, 0], [-2, -2, 0]], np.float32),
        p1=np.array([[2, -2, 0], [2, 2, 0]], np.float32),
        p2=np.array([[2, 2, 0], [-2, 2, 0]], np.float32),
        uv0=np.array([[0, 0], [0, 0]], np.float32),
        uv1=np.array([[1, 0], [1, 1]], np.float32),
        uv2=np.array([[1, 1], [0, 1]], np.float32),
    )])
    tables = {
        "tri": {
            "p0": jnp.asarray(td.p0), "p1": jnp.asarray(td.p1),
            "p2": jnp.asarray(td.p2),
            "uv0": jnp.asarray(td.uv0), "uv1": jnp.asarray(td.uv1),
            "uv2": jnp.asarray(td.uv2),
            "n0": jnp.asarray(td.n0), "n1": jnp.asarray(td.n1),
            "n2": jnp.asarray(td.n2),
            "mat": jnp.zeros(2, jnp.int32), "light": jnp.full((2,), -1, jnp.int32),
            "med_in": jnp.full((2,), -1, jnp.int32),
            "med_out": jnp.full((2,), -1, jnp.int32),
        },
        "_flags": {"uv": True, "tri_flat": True, "tex_width": True},
    }
    res = 64
    film = Film((res, res), ((0, 0), (1, 1)), BoxFilter((0.5, 0.5)))
    dist = 5.0
    cam = PerspectiveCamera(
        Transform.look_at([0, 0, dist], [0, 0, 0], [0, 1, 0]).inverse(),
        60.0, (res, res),
    )
    # center pixel, exact centers
    p_film = jnp.asarray([[res / 2, res / 2]], jnp.float32)
    u_lens = jnp.zeros((1, 2))
    o, d, _ = cam.generate_rays(p_film, u_lens)
    _, dxd, _ = cam.generate_rays(p_film + jnp.asarray([1.0, 0.0]), u_lens)
    _, dyd, _ = cam.generate_rays(p_film + jnp.asarray([0.0, 1.0]), u_lens)
    brute = BruteForceIntersector(td, None)
    hit = brute.intersect(o, d, jnp.full((1,), 1e8, jnp.float32))
    assert bool(hit["hit"][0])
    si = compute_interaction(tables, hit, o, d, (dxd, dyd))
    # screen half-width at z=0: tan(30 deg) * dist; pixel size = 2*that/res
    pixel_world = 2 * np.tan(np.radians(30.0)) * dist / res
    expect = pixel_world / ext
    got = float(si["tex_width"][0])
    assert abs(got - expect) / expect < 0.05, (got, expect)


@pytest.fixture
def stripes_png(tmp_path):
    from pbrt_tpu.core.geometry import Bounds2i
    from pbrt_tpu.core.imageio import write_image

    # 1px vertical stripes: max-frequency content in u
    img = np.zeros((64, 64, 3), np.float32)
    img[:, ::2] = 1.0
    path = str(tmp_path / "stripes.png")
    write_image(path, img, Bounds2i((0, 0), (64, 64)), (64, 64))
    return path


def test_grazing_imagemap_aliasing_reduced(stripes_png):
    """Grazing-angle striped floor: with live footprints the far region
    must converge to the stripe mean with far less pixel-to-pixel noise
    than finest-level point sampling."""
    scene = f"""
    LookAt 0 1.0 -6  0 0 4  0 1 0
    Camera "perspective" "float fov" 50
    Sampler "halton" "integer pixelsamples" 4
    Integrator "path" "integer maxdepth" 2
    Film "image" "integer xresolution" [48] "integer yresolution" [48]
    WorldBegin
    LightSource "distant" "rgb L" [3 3 3] "point from" [0 1 0] "point to" [0 0 0]
    Texture "stripes" "spectrum" "imagemap" "string filename" ["{stripes_png}"]
        "float uscale" [40] "float vscale" [40]
    Material "matte" "texture Kd" "stripes"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-40 0 -40  40 0 -40  40 0 40  -40 0 40]
      "float uv" [0 0  1 0  1 1  0 1]
    WorldEnd
    """

    def run(disable_footprints):
        api = PbrtAPI(Options(ray_batch=4096), render_on_world_end=False)
        api.init()
        api.parse_string(scene)
        from pbrt_tpu.render import Renderer

        r = Renderer(api.scene, api.opt)
        if disable_footprints:
            r.compiled.tables["_flags"]["tex_width"] = False
        state = r.render(progress=False)
        return np.asarray(r.film.to_rgb(state))

    img_mip = run(False)
    img_point = run(True)
    # the far region of the floor (just below the horizon at row ~19)
    far = slice(20, 33)
    var_mip = float(img_mip[far, :, 0].std())
    var_point = float(img_point[far, :, 0].std())
    assert var_mip < 0.3 * var_point, (var_mip, var_point)
    # and the filtered image sits near the stripe mean there
    assert abs(float(img_mip[far, :, 0].mean()) - float(img_point[far, :, 0].mean())) < 0.2


def test_checkerboard_closed_form_filtering():
    """Grazing checkered floor: the closed-form box filter must collapse
    far-region aliasing to the check mean, like the imagemap MIP path."""
    scene = """
    LookAt 0 1.0 -6  0 0 4  0 1 0
    Camera "perspective" "float fov" 50
    Sampler "halton" "integer pixelsamples" 4
    Integrator "path" "integer maxdepth" 2
    Film "image" "integer xresolution" [48] "integer yresolution" [48]
    WorldBegin
    LightSource "distant" "rgb L" [3 3 3] "point from" [0 1 0] "point to" [0 0 0]
    Texture "checks" "spectrum" "checkerboard"
        "float uscale" [600] "float vscale" [600]
        "rgb tex1" [1 1 1] "rgb tex2" [0 0 0]
    Material "matte" "texture Kd" "checks"
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-40 0 -40  40 0 -40  40 0 40  -40 0 40]
      "float uv" [0 0  1 0  1 1  0 1]
    WorldEnd
    """

    def run(disable):
        from pbrt_tpu.render import Renderer

        api = PbrtAPI(Options(ray_batch=4096), render_on_world_end=False)
        api.init()
        api.parse_string(scene)
        r = Renderer(api.scene, api.opt)
        assert r.compiled.tables["_flags"]["tex_width"]
        if disable:
            r.compiled.tables["_flags"]["tex_width"] = False
        state = r.render(progress=False)
        return np.asarray(r.film.to_rgb(state))

    img_f = run(False)
    img_p = run(True)
    far = slice(20, 33)
    assert float(img_f[far, :, 0].std()) < 0.3 * float(img_p[far, :, 0].std())
    assert abs(float(img_f[far, :, 0].mean())
               - float(img_p[far, :, 0].mean())) < 0.15
