"""API state-machine tests mirroring api.rs:966-1065 doctests/unit tests."""

from pathlib import Path

import numpy as np
import pytest

from pbrt_tpu.core.api import (
    ALL_TRANSFORMS_BITS,
    START_TRANSFORM_BITS,
    PbrtAPI,
    TransformSet,
)
from pbrt_tpu.core.transform import Transform


def make_api(**kw):
    kw.setdefault("render_on_world_end", False)
    return PbrtAPI(**kw)


def test_transform_set_not_animated():
    assert not TransformSet().is_animated()


def test_identity_translate_scale_rotate_doctests():
    pbrt = make_api()
    pbrt.init()
    pbrt.identity()
    pbrt.assert_transforms(np.eye(4))

    pbrt.translate(2.0, 4.0, 6.0)
    pbrt.assert_transforms(
        np.array([[1, 0, 0, 2], [0, 1, 0, 4], [0, 0, 1, 6], [0, 0, 0, 1.0]])
    )

    pbrt.identity()
    pbrt.scale(2.0, 4.0, 6.0)
    pbrt.assert_transforms(np.diag([2.0, 4.0, 6.0, 1.0]))

    th = np.deg2rad(180.0)
    c, s = np.cos(th), np.sin(th)
    pbrt.identity()
    pbrt.rotate(180.0, 1.0, 0.0, 0.0)
    pbrt.assert_transforms(
        np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])
    )


def test_named_coordinate_systems():
    pbrt = make_api()
    pbrt.init()
    pbrt.identity()
    pbrt.scale(2.0, 2.0, 2.0)
    np.testing.assert_allclose(
        pbrt.current_transform[0].m, np.diag([2.0, 2.0, 2.0, 1.0])
    )
    pbrt.coordinate_system("two")
    pbrt.identity()
    pbrt.scale(3.0, 3.0, 3.0)
    np.testing.assert_allclose(
        pbrt.current_transform[0].m, np.diag([3.0, 3.0, 3.0, 1.0])
    )
    pbrt.coordinate_system_transform("two")
    np.testing.assert_allclose(
        pbrt.current_transform[0].m, np.diag([2.0, 2.0, 2.0, 1.0])
    )


def test_attribute_begin_end_restores_bits():
    pbrt = make_api()
    pbrt.init()
    pbrt.world_begin()
    assert pbrt.active_transform_bits == ALL_TRANSFORMS_BITS
    pbrt.attribute_begin()
    pbrt.active_transform_start_time()
    assert pbrt.active_transform_bits == START_TRANSFORM_BITS
    pbrt.attribute_end()
    assert pbrt.active_transform_bits == ALL_TRANSFORMS_BITS
    pbrt.world_end()


def test_transform_begin_end():
    pbrt = make_api()
    pbrt.init()
    pbrt.world_begin()
    pbrt.transform_begin()
    pbrt.active_transform_start_time()
    assert pbrt.active_transform_bits == START_TRANSFORM_BITS
    pbrt.transform_end()
    assert pbrt.active_transform_bits == ALL_TRANSFORMS_BITS
    pbrt.world_end()


def test_state_guard_options_in_world():
    pbrt = make_api(strict=True)
    pbrt.init()
    pbrt.world_begin()
    with pytest.raises(RuntimeError):
        pbrt.film("image", __import__("pbrt_tpu.core.paramset", fromlist=["ParamSet"]).ParamSet())


def test_state_guard_world_in_options():
    pbrt = make_api(strict=True)
    pbrt.init()
    from pbrt_tpu.core.paramset import ParamSet

    with pytest.raises(RuntimeError):
        pbrt.shape("sphere", ParamSet())


def test_uninitialized_guard():
    pbrt = make_api(strict=True)
    with pytest.raises(RuntimeError):
        pbrt.identity()


def test_camera_stores_inverse_ctm_and_coordsys():
    pbrt = make_api()
    pbrt.init()
    pbrt.translate(1.0, 2.0, 3.0)
    from pbrt_tpu.core.paramset import ParamSet

    pbrt.camera("perspective", ParamSet())
    # camera_to_world = inverse(CTM)
    np.testing.assert_allclose(
        pbrt.scene.camera_to_world[0].m[0:3, 3], [-1, -2, -3]
    )
    assert "camera" in pbrt.named_coordinate_systems


def test_scene_accumulation_check_sphere():
    """Parse the acceptance scene (scenes/check-sphere.pbrt content) and
    verify the full description lands in SceneDescription."""
    scene_text = (
        Path(__file__).resolve().parent.parent / "scenes" / "check-sphere.pbrt"
    ).read_text()
    pbrt = make_api()
    pbrt.init()
    pbrt.parse_string(scene_text)
    sc = pbrt.scene
    assert sc.camera_name == "perspective"
    assert sc.camera_params.find_one_float("fov", 0.0) == 45.0
    assert sc.sampler_name == "halton"
    assert sc.sampler_params.find_one_int("pixelsamples", 0) == 128
    assert sc.integrator_name == "path"
    assert sc.film_params.find_one_int("xresolution", 0) == 400
    # scene was consumed by world_end; shapes/lights accumulated there
    # world_end resets to options state
    from pbrt_tpu.core.api import OPTIONS_BLOCK

    assert pbrt.current_api_state == OPTIONS_BLOCK


def test_scene_records_shapes_lights_materials():
    pbrt = make_api()
    pbrt.init()
    pbrt.parse_string(
        """
        WorldBegin
        LightSource "infinite" "rgb L" [.4 .45 .5]
        AttributeBegin
          Material "mirror"
          Shape "sphere" "float radius" 1
        AttributeEnd
        AttributeBegin
          Texture "checks" "spectrum" "checkerboard"
                  "float uscale" [8] "float vscale" [8]
                  "rgb tex1" [.1 .1 .1] "rgb tex2" [.8 .8 .8]
          Material "matte" "texture Kd" "checks"
          Translate 0 0 -1
          Shape "trianglemesh"
              "integer indices" [0 1 2 0 2 3]
              "point P" [ -20 -20 0   20 -20 0   20 20 0   -20 20 0 ]
              "float st" [ 0 0   1 0    1 1   0 1 ]
        AttributeEnd
        """
    )
    sc = pbrt.scene
    assert len(sc.lights) == 1
    assert sc.lights[0].name == "infinite"
    assert len(sc.shapes) == 2
    sphere, mesh = sc.shapes
    assert sphere.name == "sphere" and sphere.material.name == "mirror"
    assert mesh.name == "trianglemesh" and mesh.material.name == "matte"
    assert mesh.material.params.find_one_texture("Kd", "") == "checks"
    assert "checks" in mesh.material.spectrum_textures
    # translate applied to mesh's object-to-world
    np.testing.assert_allclose(mesh.object_to_world.m[0:3, 3], [0, 0, -1])


def test_material_texture_resolution():
    """Checkerboard texture evaluates on a wavefront."""
    import jax.numpy as jnp

    pbrt = make_api()
    pbrt.init()
    pbrt.parse_string(
        """
        WorldBegin
        Texture "checks" "spectrum" "checkerboard"
                "float uscale" [2] "float vscale" [2]
                "rgb tex1" [0 0 0] "rgb tex2" [1 1 1]
        Shape "sphere"
        """
    )
    tex = pbrt.graphics_state.spectrum_textures["checks"]
    uv = jnp.array([[0.1, 0.1], [0.6, 0.1], [0.6, 0.6], [0.1, 0.6]])
    out = np.asarray(tex.eval({"uv": uv}))
    np.testing.assert_allclose(out[0], [0, 0, 0])
    np.testing.assert_allclose(out[1], [1, 1, 1])
    np.testing.assert_allclose(out[2], [0, 0, 0])
    np.testing.assert_allclose(out[3], [1, 1, 1])


def test_object_instances():
    pbrt = make_api()
    pbrt.init()
    pbrt.parse_string(
        """
        WorldBegin
        ObjectBegin "tree"
        Shape "sphere" "float radius" 1
        ObjectEnd
        Translate 5 0 0
        ObjectInstance "tree"
        Translate 5 0 0
        ObjectInstance "tree"
        """
    )
    sc = pbrt.scene
    assert len(sc.instances["tree"]) == 1
    assert len(sc.instance_uses) == 2
    np.testing.assert_allclose(sc.instance_uses[0][1].m[0:3, 3], [5, 0, 0])
    np.testing.assert_allclose(sc.instance_uses[1][1].m[0:3, 3], [10, 0, 0])


def test_unmatched_attribute_end_ignored():
    pbrt = make_api()
    pbrt.init()
    pbrt.world_begin()
    pbrt.attribute_end()  # should log + ignore, not raise
    pbrt.world_end()


def test_unused_params_reported_per_factory(caplog):
    """Config hygiene (reference api.rs:347,962 pattern): a bogus
    parameter on any factory's ParamSet is warned about at build time,
    while every consumed parameter stays quiet."""
    import logging

    from pbrt_tpu import Options
    from pbrt_tpu.scene.builder import build_scene

    api = PbrtAPI(Options(ray_batch=256), render_on_world_end=False)
    api.init()
    api.parse_string(
        """
        LookAt 0 0 -3  0 0 0  0 1 0
        Camera "perspective" "float fov" 40 "float bogus_cam_knob" [1]
        Sampler "halton" "integer pixelsamples" 2
        Integrator "path" "integer maxdepth" 2
        Film "image" "integer xresolution" [8] "integer yresolution" [8]
        WorldBegin
        LightSource "infinite" "rgb L" [1 1 1]
        Material "matte" "rgb Kd" [0.5 0.5 0.5] "float bogus_mat_knob" [2]
        Shape "sphere" "float radius" 1 "float bogus_shape_knob" [3]
        WorldEnd
        """
    )
    with caplog.at_level(logging.WARNING, logger="pbrt_tpu"):
        build_scene(api.scene, api.opt)
    text = caplog.text
    assert "bogus_cam_knob" in text
    assert "bogus_mat_knob" in text
    assert "bogus_shape_knob" in text
    # consumed parameters must not be flagged
    assert "'fov' not used" not in text
    assert "'Kd' not used" not in text
    assert "'radius' not used" not in text
