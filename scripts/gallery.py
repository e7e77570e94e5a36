"""Render the gallery images into gallery/ (CPU by default; set
GALLERY_CPU=0 to use the accelerator).

    python scripts/gallery.py [check cornell torus glass fog sppm]
"""

import os
import sys
import time
from pathlib import Path

if os.environ.get("GALLERY_CPU", "1") != "0":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax

if os.environ.get("GALLERY_CPU", "1") != "0":
    jax.config.update("jax_platforms", "cpu")

import logging

logging.basicConfig(level=logging.WARNING)

import numpy as np

from pbrt_tpu import Options
from pbrt_tpu.core.api import PbrtAPI
from pbrt_tpu.render import render_scene

OUT = str(REPO / "gallery")
os.makedirs(OUT, exist_ok=True)


def run(name, scene_text=None, scene_file=None, ray_batch=1 << 15):
    t0 = time.time()
    api = PbrtAPI(Options(ray_batch=ray_batch, image_file=f"{OUT}/{name}.png"))
    api.init()
    if scene_file:
        import pbrt_tpu.core.parser as P

        P.parse_file(scene_file, api)
    else:
        api.parse_string(scene_text)
    api.cleanup()
    print(f"{name}: {time.time()-t0:.1f}s", flush=True)


def main():
    which = sys.argv[1:] if len(sys.argv) > 1 else ["check", "cornell", "torus", "glass", "fog", "sppm"]

    if "check" in which:
        text = (REPO / "scenes" / "check-sphere.pbrt").read_text()
        text = text.replace("[400]", "[200]").replace('"integer yresolution" [400]', '"integer yresolution" [200]')
        text = text.replace("128", "48")
        run("check-sphere", text)

    if "cornell" in which:
        from pbrt_tpu.testscenes import CORNELL_BOX

        run(
            "cornell",
            CORNELL_BOX.format(xres=200, yres=200, spp=64, maxdepth=5, filename="x.png"),
        )

    if "torus" in which:
        from pbrt_tpu.testscenes import mesh_scene_renderer

        t0 = time.time()
        r, n_tris = mesh_scene_renderer(xres=200, yres=200, spp=24, maxdepth=4, ray_batch=1 << 15)
        state = r.render(progress=False)
        r.film.write_image(state, filename=f"{OUT}/torus50k.png")
        print(f"torus50k ({n_tris} tris): {time.time()-t0:.1f}s", flush=True)

    if "glass" in which:
        # self-contained (the r2 version read an ephemeral /tmp scene)
        run("glass", """
LookAt 0 1.2 3.2  0 0.6 0  0 1 0
Camera "perspective" "float fov" 50
Sampler "halton" "integer pixelsamples" 48
Integrator "path" "integer maxdepth" 8
Film "image" "integer xresolution" [200] "integer yresolution" [200]
WorldBegin
LightSource "infinite" "rgb L" [0.45 0.55 0.7]
LightSource "point" "rgb I" [14 13 12] "point from" [2 3 2]
Material "glass"
AttributeBegin
  Translate 0 0.7 0
  Shape "sphere" "float radius" 0.65
AttributeEnd
Material "matte" "rgb Kd" [0.55 0.5 0.45]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -4 0 -4   4 0 -4   4 0 4   -4 0 4 ]
WorldEnd
""")

    if "fog" in which:
        run("fog", """
MakeNamedMedium "fog" "string type" "homogeneous"
    "rgb sigma_a" [0.02 0.02 0.02] "rgb sigma_s" [0.12 0.12 0.12]
MediumInterface "" "fog"
LookAt 0 1.4 4  0 0.8 0  0 1 0
Camera "perspective" "float fov" 55
Sampler "halton" "integer pixelsamples" 128
Integrator "volpath" "integer maxdepth" 5
Film "image" "integer xresolution" [200] "integer yresolution" [150]
WorldBegin
LightSource "point" "rgb I" [30 29 26] "point from" [1.5 3 1.5]
Material "matte" "rgb Kd" [0.7 0.3 0.25]
AttributeBegin
  Translate -0.8 0.5 0
  Shape "sphere" "float radius" 0.5
AttributeEnd
Material "matte" "rgb Kd" [0.3 0.5 0.7]
AttributeBegin
  Translate 0.8 0.5 0.4
  Shape "sphere" "float radius" 0.5
AttributeEnd
Material "matte" "rgb Kd" [0.5 0.5 0.5]
Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
  "point P" [ -5 0 -5   5 0 -5   5 0 5   -5 0 5 ]
WorldEnd
""")

    if "sppm" in which:
        sys.path.insert(0, str(REPO / "tests"))
        from test_sppm import BOX

        run(
            "sppm-box",
            BOX.replace("[24]", "[200]").replace(
                '"{integ}" {extra}',
                '"sppm" "integer numiterations" 64 "integer photonsperiteration" 65536',
            ),
        )


def round3_gallery(only=None):
    """Round-3 additions: 1M-triangle torus (streaming BVH), motion blur,
    MLT caustic.  On the accelerator: GALLERY_CPU=0 python scripts/gallery.py r3"""
    from pbrt_tpu.core.api import PbrtAPI as API
    from pbrt_tpu.render import Renderer
    from pbrt_tpu.testscenes import _torus_mesh_params

    if only in (None, "torus1m"):
        _r3_torus1m()
    if only in (None, "motion"):
        _r3_motion()
    if only in (None, "caustic"):
        _r3_caustic()


def _r3_torus1m():
    from pbrt_tpu.core.api import PbrtAPI as API
    from pbrt_tpu.render import Renderer
    from pbrt_tpu.testscenes import _torus_mesh_params

    # 1M-triangle displaced torus through the streaming BVH
    api = API(Options(ray_batch=1 << 18), render_on_world_end=False)
    api.init()
    api.parse_string(
        """
        LookAt 2.8 2.2 2.8  0 0 0  0 0 1
        Camera "perspective" "float fov" 45
        Sampler "halton" "integer pixelsamples" 16
        Integrator "path" "integer maxdepth" 4
        Film "image" "integer xresolution" [512] "integer yresolution" [512]
        Accelerator "bvh"
        WorldBegin
        LightSource "point" "rgb I" [30 28 25] "point from" [3 -3 4]
        AttributeBegin
          AreaLightSource "diffuse" "rgb L" [6 6 7]
          Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
            "point P" [-1 -1 3.5  1 -1 3.5  1 1 3.5  -1 1 3.5]
        AttributeEnd
        Texture "checks" "spectrum" "checkerboard"
            "float uscale" [16] "float vscale" [8]
            "rgb tex1" [.2 .3 .5] "rgb tex2" [.8 .75 .6]
        Material "matte" "texture Kd" "checks"
        """
    )
    ps, n_tris = _torus_mesh_params(1000, 500)
    api.shape("trianglemesh", ps)
    api.parse_string(
        """
        Material "matte" "rgb Kd" [0.4 0.4 0.42]
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
          "point P" [-8 -8 -0.7  8 -8 -0.7  8 8 -0.7  -8 8 -0.7]
        """
    )
    t0 = time.time()
    r = Renderer(api.scene, api.opt)
    state = r.render(progress=False)
    img = np.asarray(r.film.to_rgb(state))
    from pbrt_tpu.core.imageio import write_image

    write_image(f"{OUT}/torus1m.png", img, r.film.cropped_pixel_bounds,
                r.film.full_resolution)
    print(f"torus1m ({n_tris} tris): {time.time()-t0:.1f}s")


def _r3_motion():
    # motion blur: translating sphere
    run("motion", scene_text="""
        LookAt 0 0 -5  0 0 0  0 1 0
        Camera "perspective" "float fov" 50
        Sampler "halton" "integer pixelsamples" 128
        Integrator "path" "integer maxdepth" 3
        Film "image" "integer xresolution" [256] "integer yresolution" [256]
        WorldBegin
        LightSource "infinite" "rgb L" [0.9 0.95 1.0]
        Material "matte" "rgb Kd" [0.4 0.4 0.45]
        Shape "trianglemesh" "integer indices" [0 1 2 0 2 3]
          "point P" [-6 -1.2 -6  6 -1.2 -6  6 -1.2 6  -6 -1.2 6]
        Material "plastic" "rgb Kd" [0.8 0.15 0.1] "rgb Ks" [0.3 0.3 0.3]
        ActiveTransform EndTime
        Translate 1.6 0.5 0
        ActiveTransform All
        Shape "sphere" "float radius" 0.6
        WorldEnd
        """, ray_batch=1 << 17)


def _r3_caustic():
    # MLT caustic: glass sphere over a floor, point light
    run("caustic-mlt", scene_text="""
        LookAt 0 2.2 3.2  0 0.4 0  0 1 0
        Camera "perspective" "float fov" 45
        Sampler "halton" "integer pixelsamples" 64
        Integrator "mlt" "integer maxdepth" 5
        Film "image" "integer xresolution" [256] "integer yresolution" [256]
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
        """, ray_batch=1 << 17)


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "r3":
        round3_gallery(sys.argv[2] if len(sys.argv) > 2 else None)
    else:
        main()
