"""Participating-media tests: transmittance math, phase normalization,
and end-to-end fog attenuation (volpath)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.media import HomogeneousMedium, hg_phase, hg_sample


def test_homogeneous_transmittance():
    m = HomogeneousMedium([0.1, 0.2, 0.3], [0.0, 0.0, 0.0])
    tr = np.asarray(m.transmittance(jnp.asarray([2.0])))
    np.testing.assert_allclose(tr[0], np.exp(-np.array([0.2, 0.4, 0.6])), rtol=1e-5)


def test_distance_sampling_unbiased():
    """E[pass-through weight * indicator] == Tr for a gray medium."""
    m = HomogeneousMedium([0.3, 0.3, 0.3], [0.2, 0.2, 0.2])
    n = 200_000
    u = jnp.asarray(np.random.default_rng(0).uniform(size=n).astype(np.float32))
    t_hit = jnp.full((n,), 2.0)
    t, scattered, beta = m.sample_distance(u, t_hit)
    passed = ~np.asarray(scattered)
    est = np.asarray(beta)[passed].mean(axis=0) * passed.mean()
    np.testing.assert_allclose(est, np.exp(-0.5 * 2.0) * np.ones(3), rtol=0.02)


def test_hg_phase_normalization():
    """Integral of HG over the sphere must be 1."""
    for g in (0.0, 0.4, -0.7):
        mu = np.linspace(-1, 1, 20001)
        vals = np.asarray(hg_phase(jnp.asarray(mu), g))
        integral = 2 * np.pi * np.trapezoid(vals, mu)
        np.testing.assert_allclose(integral, 1.0, rtol=1e-3)


def test_hg_sample_matches_density():
    wo = jnp.asarray(np.tile([0.0, 0.0, -1.0], (100000, 1)).astype(np.float32))
    u2 = jnp.asarray(
        np.random.default_rng(1).uniform(size=(100000, 2)).astype(np.float32)
    )
    wi, pdf = hg_sample(wo, u2, 0.6)
    wi = np.asarray(wi)
    # forward direction is -wo = +z; mean cosine should approach g
    cos = wi[:, 2]
    np.testing.assert_allclose(cos.mean(), 0.6, atol=0.01)
    np.testing.assert_allclose(np.linalg.norm(wi, axis=-1), 1.0, atol=1e-4)


FOG_SCENE = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [{sa} {sa} {sa}] "rgb sigma_s" [0 0 0]
MediumInterface "" "fog"
LookAt 0 0 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
Sampler "halton" "integer pixelsamples" 64
Integrator "volpath" "integer maxdepth" 2
Film "image" "integer xresolution" [9] "integer yresolution" [9]
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [0 0 2]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh"
    "integer indices" [0 1 2 0 2 3]
    "point P" [ -50 -50 0   50 -50 0   50 50 0   -50 50 0 ]
WorldEnd
"""


def render(scene):
    api = PbrtAPI(Options(ray_batch=9 * 9 * 64), render_on_world_end=False)
    api.init()
    api.parse_string(scene)
    from pbrt_tpu.render import render_scene

    return render_scene(api.scene, api.opt, write=False)["image"]


def test_fog_absorption_attenuates_exponentially():
    clear = render(FOG_SCENE.format(sa=1e-6))
    foggy = render(FOG_SCENE.format(sa=0.1))
    # center pixel: camera->plane dist 5, light->plane dist 2
    expected_ratio = np.exp(-0.1 * 5) * np.exp(-0.1 * 2)
    ratio = foggy[4, 4, 0] / clear[4, 4, 0]
    np.testing.assert_allclose(ratio, expected_ratio, rtol=0.1)
    # clear render matches the analytic direct value
    np.testing.assert_allclose(clear[4, 4], [0.6 / np.pi * 10 / 4] * 3, rtol=0.02)


# -- grid media: delta tracking / ratio tracking -----------------------------


def _lane_rng(n, salt=0):
    from pbrt_tpu.media import make_track_rng

    ids = np.arange(n, dtype=np.uint32)
    pixel_xy = jnp.asarray(np.stack([ids % 4096, ids // 4096], axis=-1))
    return make_track_rng(pixel_xy, jnp.zeros((n,), np.uint32), salt)


def test_grid_delta_tracking_constant_density():
    """Constant-density grid: scatter probability over a unit cube crossing
    must equal 1 - exp(-sigma_t * rho * L)."""
    from pbrt_tpu.media import GridDensityMedium

    rho, st = 0.6, 1.2
    grid = np.full((4, 4, 4), rho, dtype=np.float32)
    m = GridDensityMedium([st / 3] * 3, [2 * st / 3] * 3, 0.0, grid, np.eye(4))
    n = 200_000
    o = jnp.broadcast_to(jnp.asarray([0.5, 0.5, -0.5]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, 0.0, 1.0]), (n, 3))
    u = jnp.asarray(np.random.default_rng(0).uniform(size=n).astype(np.float32))
    t, scattered, beta = m.sample(o, d, u, jnp.full((n,), 2.0), _lane_rng(n))
    p_scatter = np.asarray(scattered).mean()
    np.testing.assert_allclose(p_scatter, 1.0 - np.exp(-st * rho), rtol=0.01)
    # scattered lanes carry the single-scatter albedo sigma_s/sigma_t
    b = np.asarray(beta)[np.asarray(scattered)]
    np.testing.assert_allclose(b, 2.0 / 3.0, rtol=1e-4)
    # scatter distances stay inside the cube crossing [0.5, 1.5)
    ts = np.asarray(t)[np.asarray(scattered)]
    assert (ts >= 0.5).all() and (ts <= 1.5).all()


def test_grid_tracking_unbiased_vs_quadrature():
    """Random density field: ratio-tracked Tr and delta-tracked pass-through
    probability both match the quadrature of the medium's own density."""
    from pbrt_tpu.media import GridDensityMedium

    grid = np.random.default_rng(2).uniform(0.2, 1.0, size=(4, 4, 4)).astype(np.float32)
    m = GridDensityMedium([0.5] * 3, [1.0] * 3, 0.0, grid, np.eye(4))
    n = 200_000
    o1 = np.array([0.2, 0.3, -0.2], dtype=np.float32)
    d1 = np.array([0.0, 0.0, 1.0], dtype=np.float32)
    t_max = 1.4
    # ground truth: fine Riemann sum of the same trilinear density
    ts = np.linspace(0.0, t_max, 4001, dtype=np.float32)
    pts = jnp.asarray(o1[None, :] + ts[:, None] * d1[None, :])
    dens = np.asarray(m.density_at(pts))
    tau = m.sigma_t_gray * np.trapezoid(dens, ts)
    expected = np.exp(-tau)

    o = jnp.broadcast_to(jnp.asarray(o1), (n, 3))
    d = jnp.broadcast_to(jnp.asarray(d1), (n, 3))
    tr = np.asarray(m.tr(o, d, jnp.full((n,), t_max), _lane_rng(n, salt=1)))
    np.testing.assert_allclose(tr.mean(axis=0), expected, rtol=0.02)

    u = jnp.asarray(np.random.default_rng(1).uniform(size=n).astype(np.float32))
    _, scattered, _ = m.sample(o, d, u, jnp.full((n,), t_max), _lane_rng(n, salt=2))
    np.testing.assert_allclose((~np.asarray(scattered)).mean(), expected, rtol=0.02)


# -- subsurface scattering (device: interface + interior medium) ---------


def test_dipole_inversion_round_trip():
    """subsurface_from_diffuse must invert the dipole Rd: plugging the
    recovered reduced albedo back into Rd reproduces the requested color."""
    from pbrt_tpu.media.scattering import (
        _dipole_rd,
        _fresnel_moment_a,
        subsurface_from_diffuse,
    )

    kd = np.array([0.1, 0.35, 0.8])
    sigma_a, sigma_s = subsurface_from_diffuse(kd, mfp=0.5, eta=1.33, g=0.0)
    assert (sigma_a >= 0).all() and (sigma_s > 0).all()
    # reconstruct alpha' and check Rd
    alpha = sigma_s / (sigma_a + sigma_s)
    rd = _dipole_rd(alpha, _fresnel_moment_a(1.33))
    assert np.allclose(rd, kd, atol=1e-5)
    # sigma_t' = 1/mfp
    assert np.allclose(sigma_a + sigma_s, 1.0 / 0.5, rtol=1e-6)
    # darker color -> more absorption
    assert sigma_a[0] > sigma_a[2]


def test_scattering_presets():
    from pbrt_tpu.media.scattering import get_medium_scattering_properties

    got = get_medium_scattering_properties("marble")
    assert got is not None
    sa, ss = got
    assert sa.shape == (3,) and ss.shape == (3,)
    assert (ss > 1.0).all()  # marble is strongly scattering
    assert get_medium_scattering_properties("Skin1") is not None  # case-insensitive
    assert get_medium_scattering_properties("unobtanium") is None


def test_subsurface_material_builds_interior_medium():
    """A kdsubsurface sphere compiles to a dielectric surface + an interior
    medium on the (tessellated) triangle tables, and `path` auto-routes
    through volpath."""
    from pbrt_tpu import Options
    from pbrt_tpu.core.api import PbrtAPI
    from pbrt_tpu.scene.builder import build_scene
    from pbrt_tpu.integrators import make_integrator
    from pbrt_tpu.integrators.volpath import VolPathIntegrator
    from pbrt_tpu.materials import bsdf as B

    scene = """
LookAt 0 0 -4  0 0 0  0 1 0
Camera "perspective" "float fov" 40
Sampler "halton" "integer pixelsamples" 4
Integrator "path" "integer maxdepth" 6
Film "image" "integer xresolution" [8] "integer yresolution" [8]
WorldBegin
LightSource "infinite" "rgb L" [1 1 1]
Material "kdsubsurface" "rgb Kd" [0.7 0.4 0.2] "float mfp" 0.2
Shape "sphere" "float radius" 1
WorldEnd
"""
    api = PbrtAPI(Options(ray_batch=1024), render_on_world_end=False)
    api.init()
    api.parse_string(scene)
    c = build_scene(api.scene, api.opt)
    assert len(c.media) == 1  # synthesized interior
    assert c.materials[0].type_id == B.GLASS  # dielectric interface
    med_in = np.asarray(c.tables["tri"]["med_in"])
    assert (med_in == 0).all()
    med_out = np.asarray(c.tables["tri"]["med_out"])
    assert (med_out == -1).all()
    assert isinstance(make_integrator(c), VolPathIntegrator)


# -- shaped volumes: null-material boundaries (pbrt smoke-in-a-box) ----------

FOG_BOX_SCENE = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [{sa} {sa} {sa}] "rgb sigma_s" [0 0 0]
LookAt 0 0 5  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-0.1 0.1 -0.1 0.1]
Sampler "halton" "integer pixelsamples" 64
Integrator "volpath" "integer maxdepth" 2
Film "image" "integer xresolution" [5] "integer yresolution" [5]
WorldBegin
LightSource "point" "rgb I" [10 10 10] "point from" [0 0 3]
AttributeBegin
Material ""
MediumInterface "fog" ""
Shape "trianglemesh"
    "integer indices" [0 3 2  0 2 1  4 5 6  4 6 7  1 2 6  1 6 5
                       0 4 7  0 7 3  0 1 5  0 5 4  3 7 6  3 6 2]
    "point P" [ -1 -1 1   1 -1 1   1 1 1   -1 1 1
                -1 -1 2   1 -1 2   1 1 2   -1 1 2 ]
AttributeEnd
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh"
    "integer indices" [0 1 2 0 2 3]
    "point P" [ -50 -50 0   50 -50 0   50 50 0   -50 50 0 ]
WorldEnd
"""


def test_null_material_fog_box():
    """Fog bounded by a null-material cube (z in [1,2]): the camera ray
    passes through two boundaries (chord 1 of fog), the shadow ray through
    two more.  Expected attenuation exp(-sa*1)^2 vs the clear render, and
    the clear center equals the analytic direct value (Kd/pi * I/d^2)."""
    clear = render(FOG_BOX_SCENE.format(sa=1e-6))
    foggy = render(FOG_BOX_SCENE.format(sa=0.5))
    np.testing.assert_allclose(
        clear[2, 2], [0.6 / np.pi * 10 / 9] * 3, rtol=0.02
    )
    # absorption on the camera leg is resolved by stochastic kill; average
    # the 3x3 center (all rays share the same chord) for 576 samples
    ratio = foggy[1:4, 1:4, 0].mean() / clear[1:4, 1:4, 0].mean()
    np.testing.assert_allclose(ratio, np.exp(-0.5 * 2.0), rtol=0.08)


def test_null_shape_does_not_shadow_in_vacuum():
    """A null-material (shaped-volume boundary) sphere between light and
    floor must not cast a shadow even with no media in the scene —
    pbrt-v3 VisibilityTester::Tr passes through material-less surfaces."""
    tmpl = """
    LookAt 0 3 -6  0 0 0  0 1 0
    Camera "perspective" "float fov" 45
    Sampler "halton" "integer pixelsamples" 8
    Integrator "volpath" "integer maxdepth" 2
    Film "image" "integer xresolution" [24] "integer yresolution" [24]
    WorldBegin
    LightSource "point" "rgb I" [60 60 60] "point from" [0 5 0]
    Material "matte" "rgb Kd" [0.7 0.7 0.7]
    Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
      "point P" [-4 0 -4  4 0 -4  4 0 4  -4 0 4]
    %s
    WorldEnd
    """
    blocker = (
        'AttributeBegin\n  Material ""\n  Translate 0 2.5 0\n'
        '  Shape "sphere" "float radius" 1\nAttributeEnd'
    )
    img_null = render(tmpl % blocker)
    img_open = render(tmpl % "")
    center = (slice(10, 14), slice(10, 14))
    np.testing.assert_allclose(
        img_null[center], img_open[center], atol=0.02
    )
    assert img_open[center].mean() > 0.1
