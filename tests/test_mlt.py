"""MLT evidence beyond the smoke test (VERDICT r2 item 9).

A specular caustic from a point light is the transport MLT exists for:
unidirectional path tracing cannot sample it at all (NEE fails on the
specular lobe, BSDF sampling cannot hit a delta light), so the caustic
region under a glass sphere stays in shadow; BDPT's light-tracing (t=1)
strategy renders it, and MLT — whose target is the full BDPT estimator —
must reproduce it with correct b-normalization and a healthy Markov
chain (acceptance neither frozen nor random-walk-degenerate).
"""

import numpy as np

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.render import Renderer, render_scene

CAUSTIC = """
LookAt 0 2.2 3.2  0 0.4 0  0 1 0
Camera "perspective" "float fov" 45
Sampler "halton" "integer pixelsamples" 8
Integrator "{integ}" "integer maxdepth" 4 {extra}
Film "image" "integer xresolution" [24] "integer yresolution" [24]
WorldBegin
LightSource "point" "rgb I" [40 40 40] "point from" [0 3.0 0]
Material "matte" "rgb Kd" [0.7 0.7 0.7]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -3 0 -3   3 0 -3   3 0 3   -3 0 3 ]
AttributeBegin
  Material "glass"
  Translate 0 1.0 0
  Shape "sphere" "float radius" 0.45
AttributeEnd
WorldEnd
"""


_CACHE = {}


def _render(integ):
    # renders shared across tests (the suite runs on 2-core CPU boxes).
    # MLT's mutation budget is pinned to the sampler's 8 spp: now that
    # mutationsperpixel is honored (r5, render.py custom_render fix) the
    # default 32 would 4x this test's runtime — and the region/b
    # tolerances below were calibrated at the 8-mutation budget.
    if integ in _CACHE:
        return _CACHE[integ]
    extra = '"integer mutationsperpixel" 8' if integ == "mlt" else ""
    api = PbrtAPI(Options(ray_batch=1 << 15), render_on_world_end=False)
    api.init()
    api.parse_string(CAUSTIC.format(integ=integ, extra=extra))
    r = Renderer(api.scene, api.opt)
    state = r.render(progress=False)
    _CACHE[integ] = (np.asarray(r.film.to_rgb(state)), r)
    return _CACHE[integ]


def test_mlt_renders_caustic_path_cannot():
    img_path, _ = _render("path")
    img_bdpt, _ = _render("bdpt")
    img_mlt, r_mlt = _render("mlt")
    assert np.isfinite(img_mlt).all()

    # the caustic focus under the sphere (image center-ish, floor)
    cy, cx = 13, 12
    c = (slice(cy - 2, cy + 3), slice(cx - 2, cx + 3))
    c_bdpt = float(img_bdpt[c].mean())
    c_path = float(img_path[c].mean())
    c_mlt = float(img_mlt[c].mean())
    # BDPT's light tracing finds the caustic; PT sees only the shadow
    assert c_bdpt > 2.0 * c_path, (c_bdpt, c_path)
    # MLT reproduces the hard transport BDPT finds
    assert c_mlt > 2.0 * c_path, (c_mlt, c_path)
    np.testing.assert_allclose(c_mlt, c_bdpt, rtol=0.35)

    # b-normalization: whole-image brightness must agree with BDPT
    np.testing.assert_allclose(img_mlt.mean(), img_bdpt.mean(), rtol=0.15)

    # Markov-chain health: acceptance neither collapsed nor saturated
    mlt = r_mlt.integrator
    assert 0.05 < mlt.last_acceptance < 0.95, mlt.last_acceptance
    assert mlt.last_b > 0.0


def test_mlt_b_matches_bootstrap_luminance():
    """b = E[f] over uniform primary samples is the average image
    luminance of the target estimator — check against the BDPT render."""
    img_bdpt, _ = _render("bdpt")
    _, r_mlt = _render("mlt")
    lum = (
        0.212671 * img_bdpt[..., 0]
        + 0.715160 * img_bdpt[..., 1]
        + 0.072169 * img_bdpt[..., 2]
    )
    np.testing.assert_allclose(
        r_mlt.integrator.last_b, float(lum.mean()), rtol=0.25
    )


FOG_DIRECT = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.25 0.25 0.25] "rgb sigma_s" [0 0 0]
MediumInterface "" "fog"
LookAt 0 0 4  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
Sampler "halton" "integer pixelsamples" 32
Integrator "{integ}" "integer maxdepth" 3 {extra}
Film "image" "integer xresolution" [12] "integer yresolution" [12]
WorldBegin
LightSource "point" "rgb I" [12 12 12] "point from" [0 0 3]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -40 -40 0   40 -40 0   40 40 0   -40 40 0 ]
WorldEnd
"""


def test_mlt_media_target_is_volumetric():
    """Media scenes: MLT's unidirectional target must be the FULL
    volumetric estimator (volpath), not the surface path loop — the fog's
    attenuation is part of f(u).  The r3 fallback silently targeted the
    surface integrator, rendering fog scenes un-attenuated (PARITY known
    gap, now closed): MLT and volpath must agree on the fogged image."""

    def run(integ, extra=""):
        api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False)
        api.init()
        api.parse_string(FOG_DIRECT.format(integ=integ, extra=extra))
        r = Renderer(api.scene, api.opt)
        state = r.render(progress=False)
        return np.asarray(r.film.to_rgb(state))

    vol = run("volpath")
    mlt = run("mlt", '"integer mutationsperpixel" 96')
    assert np.isfinite(mlt).all()
    # whole-image brightness: fog attenuation must be present in the MLT
    # target (the old surface-target bug rendered ~exp(+0.25*chord) hotter)
    np.testing.assert_allclose(mlt.mean(), vol.mean(), rtol=0.15)
    # center region agrees too (smooth direct-light gradient)
    np.testing.assert_allclose(
        mlt[4:8, 4:8].mean(), vol[4:8, 4:8].mean(), rtol=0.2
    )


def test_mlt_motion_blur():
    """MLT shutter-time plumbing (VERDICT r4 item 6): the mutation
    chain's pixel/time dims drive the same keyframe blend as the other
    integrators — blurred MLT == averaged interpolated statics, and the
    smear widens.  Mirrors test_motion_integrators._blur_check with
    MLT-noise tolerances.  Uses the unidirectional (path) MLT target:
    time plumbing is identical across targets, and the animated x BDPT
    x MLT program blows the 2-core compile budget (>80 min observed)."""
    from pbrt_tpu.integrators.mlt import MLTIntegrator

    from tests.test_motion_integrators import MOVE, SCENE, _quad_cols

    def scene(motion):
        return SCENE.format(
            integ="mlt", media="", fogbox="", spp=4, motion=motion,
            extra='"integer mutationsperpixel" 64',
        )

    def run(text):
        api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False)
        api.init()
        api.parse_string(text)
        r = Renderer(api.scene, api.opt)
        r.integrator = MLTIntegrator(
            r.compiled, max_depth=2, mutations_per_pixel=64,
            n_bootstrap=2048, strategy="path",
        )
        state = r.render(progress=False)
        return np.asarray(r.film.to_rgb(state))

    blurred = run(scene(MOVE))
    assert np.isfinite(blurred).all()
    acc = None
    k = 3  # 2-point shutter quadrature leaves ~0.15 edge-row bias
    for i in range(k):
        t = (i + 0.5) / k
        img = run(scene(f"Translate {1.5 * t} 0 0"))
        acc = img if acc is None else acc + img
    avg = acc / k
    np.testing.assert_allclose(blurred.mean(axis=1), avg.mean(axis=1),
                               atol=0.12)
    static0 = run(scene("Translate 0 0 0"))
    row = blurred.shape[0] // 2
    assert _quad_cols(blurred, row) >= _quad_cols(static0, row)


SCATTER_FOG = """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.05 0.05 0.05] "rgb sigma_s" [0.35 0.35 0.35]
    "float g" 0.3
MediumInterface "" "fog"
LookAt 0 0 4  0 0 0  0 1 0
Camera "orthographic" "float screenwindow" [-1 1 -1 1]
Sampler "halton" "integer pixelsamples" 24
Integrator "{integ}" "integer maxdepth" 4 {extra}
Film "image" "integer xresolution" [12] "integer yresolution" [12]
WorldBegin
LightSource "point" "rgb I" [12 12 12] "point from" [0 0 3]
Material "matte" "rgb Kd" [0.6 0.6 0.6]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -40 -40 0   40 -40 0   40 40 0   -40 40 0 ]
WorldEnd
"""


def test_mlt_scattering_fog_matches_volpath():
    """Beyond the r4 absorption-only pin: REAL in-scattering (sigma_s >
    0, HG g=0.3, maxdepth 4 = multiple scattering) — equal-sample MLT
    with the volumetric target must match volpath's fogged image, i.e.
    the combined-target chains allocate adequate effort to the
    volumetric strategies (VERDICT r4 item 6 measured route)."""

    def run(integ, extra=""):
        api = PbrtAPI(Options(ray_batch=1 << 14), render_on_world_end=False)
        api.init()
        api.parse_string(SCATTER_FOG.format(integ=integ, extra=extra))
        r = Renderer(api.scene, api.opt)
        state = r.render(progress=False)
        return np.asarray(r.film.to_rgb(state))

    vol = run("volpath")
    # budgets: chains are deterministic per (scene, seed), so these pin
    # exact reproducible ratios.  b (the bootstrap E[f] normalizer) is
    # the binding constant on this scene: volumetric multiple-scattering
    # f is heavy-tailed and 8k bootstrap samples underestimate b by ~14%
    # (whole-image ratio 0.863 at 8k -> 0.916 at 65k, on the CPU);
    # RESULTS r5 records the sweep.  The r5 fix this test guards:
    # mutationsperpixel was silently overridden by the sampler's
    # pixelsamples through Renderer.render (the parameter was dead).
    mlt = run("mlt", '"integer mutationsperpixel" 128 '
                     '"integer bootstrapsamples" 65536')
    assert np.isfinite(mlt).all()
    np.testing.assert_allclose(mlt.mean(), vol.mean(), rtol=0.15)
    np.testing.assert_allclose(
        mlt[4:8, 4:8].mean(), vol[4:8, 4:8].mean(), rtol=0.2
    )
