"""Compile a parsed SceneDescription into flat device tables + render objects.

This is the ``world_end -> MakeScene`` step the reference never implements
(api.rs:432-473 is commented-out C++).  Output is SoA: all triangles of the
scene concatenated (pre-transformed to world space at build time), analytic
spheres with their transform pairs, per-primitive material/light ids, a
material entry list, and light objects.  Everything the jitted wavefront
touches is a jnp array gathered by primitive index.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.cameras import make_camera
from pbrt_tpu.core.film import Film
from pbrt_tpu.core.filters import make_filter
from pbrt_tpu.lights import DiffuseAreaLight, Light, make_light
from pbrt_tpu.materials import MaterialEntry, build_material
from pbrt_tpu.ops.intersect import KIND_SPHERE, KIND_TRI
from pbrt_tpu.ops.intersect_soa import SoABruteForceIntersector
from pbrt_tpu.samplers import make_sampler
from pbrt_tpu.shapes import SphereData, TriangleData, concat_triangle_data, make_shape

# device matrix products run at full f32 (no TF32 on the GPU)
HIGHEST = jax.lax.Precision.HIGHEST

log = logging.getLogger("pbrt_tpu")


@dataclasses.dataclass
class CompiledScene:
    film: Film
    camera: object
    sampler: object
    integrator_name: str
    integrator_params: object
    accelerator_name: str
    materials: List[MaterialEntry]
    lights: List[Light]
    area_lights: List[DiffuseAreaLight]
    tables: Dict[str, object]
    intersector: object
    tri_data: Optional[TriangleData]
    sph_data: Optional[SphereData]
    world_bounds: tuple
    media: list = dataclasses.field(default_factory=list)
    media_names: dict = dataclasses.field(default_factory=dict)
    camera_medium: int = -1

    def initial_theta(self):
        """Differentiable scene-parameter pytree (materials + light colors).

        Keys: material slots from ``material_theta`` plus per-light emission
        arrays ``env_l`` [n_infinite, 3] and ``area_l`` [n_area, 3].
        Pass to integrator/render fns; gradients flow to every leaf.
        """
        from pbrt_tpu.lights import InfiniteAreaLight
        from pbrt_tpu.materials import material_theta

        theta = material_theta(self.materials)
        env = [
            np.asarray(lt.l_rgb, dtype=float_t)
            for lt in self.lights
            if isinstance(lt, InfiniteAreaLight)
        ]
        theta["env_l"] = jnp.asarray(
            np.stack(env) if env else np.zeros((0, 3), dtype=float_t)
        )
        area = [np.asarray(al.l_emit, dtype=float_t) for al in self.area_lights]
        theta["area_l"] = jnp.asarray(
            np.stack(area) if area else np.zeros((0, 3), dtype=float_t)
        )
        # texel-level image-texture parameters: {tex_id: flat pyramid};
        # iterate nested mix children (and mix_amount textures) too, so
        # image-textured mix children are differentiable
        from pbrt_tpu.materials import iter_entries_deep
        from pbrt_tpu.textures.imagemap import ImageTexture

        tex_images = {}
        for e in iter_entries_deep(self.materials):
            texes = list(e.textures.values())
            if e.mix_amount is not None:
                texes.append(e.mix_amount)
            for tex in texes:
                if isinstance(tex, ImageTexture):
                    tex_images[tex.tex_id] = tex.mipmap._flat
        theta["tex_images"] = tex_images
        return theta


def _tessellate_emitting_sphere(sph_rec_data: SphereData, sub=24):
    """Emitting spheres become triangles so area sampling is uniform."""
    from pbrt_tpu.core.paramset import ParamSet
    from pbrt_tpu.core.transform import Transform

    parts = []
    for i in range(sph_rec_data.count):
        r = float(sph_rec_data.radius[i])
        us = np.linspace(0, 2 * np.pi, 2 * sub + 1)
        vs = np.linspace(0, np.pi, sub + 1)
        uu, vv = np.meshgrid(us, vs, indexing="ij")
        x = r * np.sin(vv) * np.cos(uu)
        y = r * np.sin(vv) * np.sin(uu)
        z = r * np.cos(vv)
        pts = np.stack([x, y, z], axis=-1)
        t = Transform(sph_rec_data.o2w[i])
        pts_w = t.apply_p(pts.reshape(-1, 3)).reshape(pts.shape)
        nrm_w = t.apply_n(pts.reshape(-1, 3)).reshape(pts.shape)
        nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
        nrm_w = nrm_w / np.where(nn == 0, 1, nn)
        p0s, p1s, p2s, n0s, n1s, n2s, uv0s, uv1s, uv2s = ([] for _ in range(9))
        nu, nv = uu.shape[0] - 1, uu.shape[1] - 1
        for a in range(nu):
            for b in range(nv):
                quad = [(a, b), (a + 1, b), (a + 1, b + 1), (a, b + 1)]
                for tri in ((0, 1, 2), (0, 2, 3)):
                    i0, i1, i2 = (quad[k] for k in tri)
                    p0s.append(pts_w[i0]); p1s.append(pts_w[i1]); p2s.append(pts_w[i2])
                    n0s.append(nrm_w[i0]); n1s.append(nrm_w[i1]); n2s.append(nrm_w[i2])
                    uv0s.append((i0[0] / nu, i0[1] / nv))
                    uv1s.append((i1[0] / nu, i1[1] / nv))
                    uv2s.append((i2[0] / nu, i2[1] / nv))
        td = TriangleData(
            p0=np.asarray(p0s, dtype=float_t), p1=np.asarray(p1s, dtype=float_t),
            p2=np.asarray(p2s, dtype=float_t),
            uv0=np.asarray(uv0s, dtype=float_t), uv1=np.asarray(uv1s, dtype=float_t),
            uv2=np.asarray(uv2s, dtype=float_t),
            n0=np.asarray(n0s, dtype=float_t), n1=np.asarray(n1s, dtype=float_t),
            n2=np.asarray(n2s, dtype=float_t),
        )
        keep = td.areas() > 1e-14
        td = TriangleData(*(getattr(td, f)[keep] for f in
                            ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2")))
        parts.append(td)
    return concat_triangle_data(parts)


def build_scene(desc, options=None, seed: int = 0) -> CompiledScene:
    """SceneDescription (core/api.py) -> CompiledScene."""
    # --- film / filter / camera / sampler --------------------------------
    filt = make_filter(desc.filter_name, desc.filter_params)
    desc.filter_params.report_unused()
    fp = desc.film_params
    xres = fp.find_one_int("xresolution", 1280)
    yres = fp.find_one_int("yresolution", 720)
    if options is not None and getattr(options, "quick_render", False):
        xres = max(1, xres // 4)
        yres = max(1, yres // 4)
    crop = fp.find_float("cropwindow")
    if crop is not None and len(crop) == 4:
        crop_window = ((float(crop[0]), float(crop[2])), (float(crop[1]), float(crop[3])))
    else:
        crop_window = ((0.0, 0.0), (1.0, 1.0))
    filename = fp.find_one_string("filename", "pbrt.png")
    if options is not None and getattr(options, "image_file", ""):
        filename = options.image_file
    film = Film(
        (xres, yres),
        crop_window,
        filt,
        fp.find_one_float("diagonal", 35.0),
        filename,
        fp.find_one_float("scale", 1.0),
        fp.find_one_float("maxsampleluminance", float("inf")),
    )
    fp.report_unused()
    camera = make_camera(desc.camera_name, desc.camera_params, desc.camera_to_world[0], film)
    if desc.camera_to_world.is_animated():
        from pbrt_tpu.core.animated import AnimatedTransform as _AT

        c_at = _AT(
            desc.camera_to_world[0], desc.camera_to_world[1],
            desc.transform_start_time, desc.transform_end_time,
        )
        if c_at.actually_animated and hasattr(camera, "set_animation"):
            so = desc.camera_params.find_one_float("shutteropen", 0.0)
            sc = desc.camera_params.find_one_float("shutterclose", 1.0)
            camera.set_animation(c_at.key_transforms(so, sc))
    desc.camera_params.report_unused()
    sampler = make_sampler(desc.sampler_name, desc.sampler_params, seed)
    desc.sampler_params.report_unused()

    # --- participating media ---------------------------------------------
    from pbrt_tpu.media import make_medium as _make_medium

    media = []
    media_names = {}
    for m_name, m_params in desc.named_media.items():
        kind = m_params.find_one_string("type", "homogeneous")
        media.append(_make_medium(kind, m_params))
        m_params.report_unused()
        media_names[m_name] = len(media) - 1

    def med_id(name: str) -> int:
        if not name:
            return -1
        idx = media_names.get(name)
        if idx is None:
            log.error("Named medium '%s' undefined.", name)
            return -1
        return idx

    camera_medium = med_id(desc.camera_medium)

    # --- expand instances into plain shapes ------------------------------
    shape_records = list(desc.shapes)
    for inst_name, xform in desc.instance_uses:
        for rec in desc.instances.get(inst_name, []):
            new = dataclasses.replace(
                rec,
                object_to_world=xform * rec.object_to_world,
                world_to_object=(xform * rec.object_to_world).inverse(),
                object_instance=None,
                # instance expansion composes only the start slot; a stale
                # end slot would animate with the wrong composition
                # (object_instance already warns on animated instancing)
                object_to_world_end=None,
            )
            shape_records.append(new)

    # --- materials (dedup by identity of record content) ------------------
    materials: List[MaterialEntry] = []
    mat_cache = {}

    def mat_index(record) -> int:
        key = id(record)
        if key in mat_cache:
            return mat_cache[key]
        materials.append(build_material(record))
        # config hygiene after every factory (reference pattern
        # api.rs:347,962); mix children resolve recursively
        record.params.report_unused()
        mat_cache[key] = len(materials) - 1
        return mat_cache[key]

    # --- shapes -> triangle/sphere tables --------------------------------
    tri_parts: List[TriangleData] = []
    tri_mat: List[np.ndarray] = []
    tri_light: List[np.ndarray] = []
    tri_med_in: List[np.ndarray] = []
    tri_med_out: List[np.ndarray] = []
    sph_parts: List[SphereData] = []
    sph_mat: List[int] = []
    area_lights: List[DiffuseAreaLight] = []
    # group shapes by their area-light record instance
    pending_area: Dict[int, dict] = {}

    # subsurface materials synthesize their interior medium (one per
    # material record); the shape's inside-medium pointer is rewired to it
    sss_med_cache: Dict[int, int] = {}

    def sss_medium_index(record) -> int:
        key = id(record)
        if key not in sss_med_cache:
            from pbrt_tpu.media.scattering import make_subsurface_medium

            media.append(make_subsurface_medium(record))
            sss_med_cache[key] = len(media) - 1
        return sss_med_cache[key]

    # --- motion blur: keyframed world-space geometry ----------------------
    # Animated records (2-slot CTM at Shape time) get K decompose+slerp
    # keyframes across the shutter (core/animated.py); static records in an
    # animated scene replicate so every key table shares topology.
    from pbrt_tpu.core.animated import AnimatedTransform

    shutter_open = desc.camera_params.find_one_float("shutteropen", 0.0)
    shutter_close = desc.camera_params.find_one_float("shutterclose", 1.0)
    anim_xforms = {}
    n_keys = 0
    for rec in shape_records:
        if rec.object_to_world_end is not None:
            at = AnimatedTransform(
                rec.object_to_world, rec.object_to_world_end,
                desc.transform_start_time, desc.transform_end_time,
            )
            if at.actually_animated:
                anim_xforms[id(rec)] = at
                n_keys = max(n_keys, at.n_keys())
    scene_animated = bool(anim_xforms)
    tri_key_parts: List[List[TriangleData]] = [[] for _ in range(max(n_keys, 1))]

    for rec in shape_records:
        at = anim_xforms.get(id(rec))
        if scene_animated:
            xfs = (
                at.key_transforms(shutter_open, shutter_close, n_keys)
                if at is not None
                else [rec.object_to_world] * n_keys
            )
            key_shapes = [
                make_shape(rec.name, rec.params, xf, rec.reverse_orientation)
                for xf in xfs
            ]
            shape = key_shapes[0]
        else:
            shape = make_shape(rec.name, rec.params, rec.object_to_world, rec.reverse_orientation)
            key_shapes = None
        if shape is None:
            continue
        rec.params.report_unused()
        m_idx = mat_index(rec.material)
        has_area = bool(rec.area_light_name)
        is_sss = rec.material.name in ("subsurface", "kdsubsurface")
        has_medium = bool(rec.inside_medium) or bool(rec.outside_medium)
        if isinstance(shape, SphereData) and (
            has_area or is_sss or has_medium or (scene_animated and at is not None)
        ):
            # medium interfaces (and area sampling) live on the triangle
            # tables, so spheres that need either become meshes; animated
            # spheres tessellate too (keyframed triangles carry the motion)
            if key_shapes is not None:
                key_shapes = [_tessellate_emitting_sphere(s) for s in key_shapes]
                counts = {s.count for s in key_shapes}
                if len(counts) != 1:
                    raise ValueError(
                        "animated sphere tessellation produced inconsistent "
                        "topology across keyframes"
                    )
                shape = key_shapes[0]
            else:
                shape = _tessellate_emitting_sphere(shape)
        if isinstance(shape, TriangleData):
            if scene_animated:
                if key_shapes is None or isinstance(key_shapes[0], SphereData):
                    key_shapes = [shape] * n_keys
                for k in range(n_keys):
                    tri_key_parts[k].append(key_shapes[k])
            light_idx = -1
            if has_area:
                ap = rec.area_light_params
                from pbrt_tpu.core.spectrum import promote_rgb

                l_emit = promote_rgb(
                    ap.find_one_spectrum_raw("L", np.ones(3, dtype=float_t))
                    * ap.find_one_spectrum_raw("scale", np.ones(3, dtype=float_t)),
                    illuminant=True,
                )
                two_sided = ap.find_one_bool("twosided", False)
                al = DiffuseAreaLight(
                    l_emit, two_sided, shape.p0, shape.p1, shape.p2
                )
                ap.report_unused()
                area_lights.append(al)
                light_idx = len(area_lights) - 1
            tri_parts.append(shape)
            tri_mat.append(np.full(shape.count, m_idx, dtype=np.int32))
            tri_light.append(np.full(shape.count, light_idx, dtype=np.int32))
            m_in = sss_medium_index(rec.material) if is_sss else med_id(rec.inside_medium)
            tri_med_in.append(np.full(shape.count, m_in, dtype=np.int32))
            tri_med_out.append(np.full(shape.count, med_id(rec.outside_medium), dtype=np.int32))
        elif isinstance(shape, SphereData):
            sph_parts.append(shape)
            sph_mat.extend([m_idx] * shape.count)

    tri_data = concat_triangle_data(tri_parts)
    tri_key_data = (
        [concat_triangle_data(parts) for parts in tri_key_parts]
        if scene_animated and tri_key_parts[0]
        else None
    )
    tri_mat_arr = (
        np.concatenate(tri_mat) if tri_mat else np.zeros(0, dtype=np.int32)
    )
    tri_light_arr = (
        np.concatenate(tri_light) if tri_light else np.zeros(0, dtype=np.int32)
    )
    tri_med_in_arr = (
        np.concatenate(tri_med_in) if tri_med_in else np.zeros(0, dtype=np.int32)
    )
    tri_med_out_arr = (
        np.concatenate(tri_med_out) if tri_med_out else np.zeros(0, dtype=np.int32)
    )
    sph_data = None
    if sph_parts:
        sph_data = SphereData(
            o2w=np.concatenate([s.o2w for s in sph_parts]),
            w2o=np.concatenate([s.w2o for s in sph_parts]),
            radius=np.concatenate([s.radius for s in sph_parts]),
            z_min=np.concatenate([s.z_min for s in sph_parts]),
            z_max=np.concatenate([s.z_max for s in sph_parts]),
            phi_max=np.concatenate([s.phi_max for s in sph_parts]),
            reverse_orientation=np.concatenate([s.reverse_orientation for s in sph_parts]),
        )

    # --- lights -----------------------------------------------------------
    lights: List[Light] = []
    for lr in desc.lights:
        lt = make_light(lr)
        if lt is not None:
            lights.append(lt)
    lights.extend(area_lights)
    from pbrt_tpu.utils import stats

    stats.count("scene/lights", len(lights))
    stats.count("scene/materials", len(materials))
    if tri_data is not None:
        stats.count("scene/triangles", int(tri_data.count))
    if sph_parts:
        stats.count("scene/spheres", int(sum(s.count for s in sph_parts)))
    if not lights:
        log.warning("No light sources defined in scene; rendering will be black.")

    # --- world bounds ------------------------------------------------------
    mins = np.full(3, np.inf)
    maxs = np.full(3, -np.inf)
    if tri_data is not None:
        for p in (tri_data.p0, tri_data.p1, tri_data.p2):
            mins = np.minimum(mins, p.min(axis=0))
            maxs = np.maximum(maxs, p.max(axis=0))
    if sph_data is not None:
        from pbrt_tpu.core.transform import Transform

        for i in range(sph_data.count):
            c = Transform(sph_data.o2w[i]).apply_p(np.zeros(3))
            r = sph_data.radius[i] * np.abs(sph_data.o2w[i][:3, :3]).max()
            mins = np.minimum(mins, c - r)
            maxs = np.maximum(maxs, c + r)
    if not np.isfinite(mins).all():
        mins, maxs = -np.ones(3), np.ones(3)

    # --- device tables -----------------------------------------------------
    # select_rows' one-hot-matmul read path multiplies EVERY row into every
    # lane (0 * NaN = NaN), so a single non-finite table entry would poison
    # whole wavefronts; reject it at build time where it's attributable.
    def _check_finite(name, arr):
        if np.issubdtype(np.asarray(arr).dtype, np.floating) and not np.isfinite(
            arr
        ).all():
            raise ValueError(
                f"Non-finite values in scene table '{name}' "
                "(bad mesh/transform input?)"
            )

    tables: Dict[str, object] = {}
    if tri_data is not None:
        tables["tri"] = {
            "p0": jnp.asarray(tri_data.p0),
            "p1": jnp.asarray(tri_data.p1),
            "p2": jnp.asarray(tri_data.p2),
            "uv0": jnp.asarray(tri_data.uv0),
            "uv1": jnp.asarray(tri_data.uv1),
            "uv2": jnp.asarray(tri_data.uv2),
            "n0": jnp.asarray(tri_data.n0),
            "n1": jnp.asarray(tri_data.n1),
            "n2": jnp.asarray(tri_data.n2),
            "mat": jnp.asarray(tri_mat_arr),
            "light": jnp.asarray(tri_light_arr),
            "med_in": jnp.asarray(tri_med_in_arr),
            "med_out": jnp.asarray(tri_med_out_arr),
        }
        if tri_data.tan0 is not None:
            tables["tri"]["tan0"] = jnp.asarray(tri_data.tan0)
            tables["tri"]["tan1"] = jnp.asarray(tri_data.tan1)
            tables["tri"]["tan2"] = jnp.asarray(tri_data.tan2)
        for k in ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2"):
            _check_finite(f"tri.{k}", getattr(tri_data, k))
    if sph_data is not None:
        tables["sph"] = {
            "o2w": jnp.asarray(sph_data.o2w.astype(float_t)),
            "w2o": jnp.asarray(sph_data.w2o.astype(float_t)),
            "radius": jnp.asarray(sph_data.radius),
            "z_min": jnp.asarray(sph_data.z_min),
            "z_max": jnp.asarray(sph_data.z_max),
            "phi_max": jnp.asarray(sph_data.phi_max),
            "reverse": jnp.asarray(sph_data.reverse_orientation),
            "mat": jnp.asarray(np.asarray(sph_mat, dtype=np.int32)),
        }
        for k in ("o2w", "w2o", "radius", "z_min", "z_max"):
            _check_finite(f"sph.{k}", getattr(sph_data, k))

    # --- static interaction flags (prune per-bounce decode work) -----------
    # uv is consumed only by texture mappings; scenes whose textures are all
    # constants never read it, so its computation (incl. the sphere
    # arctan2/arccos parameterization) is statically dropped.
    from pbrt_tpu.textures.constant import ConstantTexture

    from pbrt_tpu.materials import iter_entries_deep

    uv_needed = any(
        not isinstance(tex, ConstantTexture)
        for e in iter_entries_deep(materials)
        for tex in e.textures.values()
    ) or any(e.mix_children is not None for e in materials)
    tri_flat = False
    if tri_data is not None:
        fn = np.cross(tri_data.p1 - tri_data.p0, tri_data.p2 - tri_data.p0)
        nn = np.linalg.norm(fn, axis=-1, keepdims=True)
        fn = fn / np.where(nn == 0, 1.0, nn)
        tri_flat = all(
            np.allclose(getattr(tri_data, f), fn, atol=1e-5)
            for f in ("n0", "n1", "n2")
        )
    # ray differentials are generated (and footprints computed) only when
    # a texture can consume them (imagemap MIP/EWA levels, closed-form
    # box-filtered checkerboard) — everything else point-samples
    from pbrt_tpu.textures.checkerboard import CheckerboardTexture
    from pbrt_tpu.textures.imagemap import ImageTexture

    tex_width_needed = any(
        isinstance(tex, (ImageTexture, CheckerboardTexture))
        for e in iter_entries_deep(materials)
        for tex in e.textures.values()
    )
    tables["_flags"] = {
        "uv": bool(uv_needed),
        "tri_flat": bool(tri_flat),
        "tex_width": bool(uv_needed and tex_width_needed),
        # K > 0: per-lane shutter times blend geometry between K keyframes
        "animated_keys": int(n_keys) if tri_key_data is not None else 0,
    }
    if tri_key_data is not None:
        # packed [T, 18] per key: p0 p1 p2 n0 n1 n2 (compute_interaction
        # blends per-lane-gathered rows with the lane's hat weights)
        tables["tri_keys"] = [
            jnp.asarray(
                np.concatenate(
                    [kd.p0, kd.p1, kd.p2, kd.n0, kd.n1, kd.n2], axis=1
                ).astype(float_t)
            )
            for kd in tri_key_data
        ]

    min_prims = desc.accelerator_params.find_one_int("minprims", 512)
    use_bvh = (
        desc.accelerator_name in ("bvh", "kdtree")
        and tri_data is not None
        and tri_data.count >= min_prims
    )
    if tri_key_data is not None:
        # animated scenes take the keyframe-blending sweep (no BVH yet:
        # bounds would need shutter expansion; fine at test-scene scale)
        from pbrt_tpu.ops.animated_intersect import AnimatedIntersector

        intersector = AnimatedIntersector(tri_key_data, sph_data)
    elif use_bvh:
        from pbrt_tpu.accel.bvh import BVHIntersector

        intersector = BVHIntersector(tri_data, sph_data)
    else:
        intersector = SoABruteForceIntersector(tri_data, sph_data)
    desc.accelerator_params.report_unused()

    return CompiledScene(
        film=film,
        camera=camera,
        sampler=sampler,
        integrator_name=desc.integrator_name,
        integrator_params=desc.integrator_params,
        accelerator_name=desc.accelerator_name,
        materials=materials,
        lights=lights,
        area_lights=area_lights,
        tables=tables,
        intersector=intersector,
        tri_data=tri_data,
        sph_data=sph_data,
        world_bounds=(mins, maxs),
        media=media,
        media_names=media_names,
        camera_medium=camera_medium,
    )


# ---------------------------------------------------------------------------
# Interaction computation (device)
# ---------------------------------------------------------------------------


# Small-table read strategy lives in ops/tables.py (shared with lights
# and Distribution1D); re-exported here for existing callers.
from pbrt_tpu.ops.tables import (  # noqa: E402,F401
    ONE_HOT_MAX_ROWS,
    WHERE_CHAIN_MAX_ROWS,
    select_rows,
)


def _tri_cols(tr, need_normals=True, need_uv=True):
    """Pack the triangle attribute table into one [T, C] f32 matrix plus a
    name -> column-slice layout map.

    Base layout: p0 p1 p2 (9) [n0 n1 n2 (9)] [uv0 uv1 uv2 (6)]
    mat light med_in med_out (4) [tan0 tan1 tan2 (9)].  Normal/uv blocks
    are omitted when statically unneeded (flat meshes / untextured scenes)
    — every dropped column removes T selects per lane from the fused
    row-select chain.  Ints are exact in f32 below 2^24.  The concat folds
    at compile time (tables are jit constants).
    """
    names = ["p0", "p1", "p2"]
    if need_normals:
        names += ["n0", "n1", "n2"]
    if need_uv:
        names += ["uv0", "uv1", "uv2"]
    names += ["mat", "light", "med_in", "med_out"]
    if "tan0" in tr:
        names += ["tan0", "tan1", "tan2"]
    ft = tr["p0"].dtype
    parts = []
    layout = {}
    at = 0
    for nm in names:
        v = tr[nm]
        if v.ndim == 1:
            v = v[:, None]
        parts.append(v.astype(ft))
        layout[nm] = slice(at, at + v.shape[1])
        at += v.shape[1]
    return jnp.concatenate(parts, axis=1), layout


def _sph_cols(sp):
    """Pack the sphere table: w2o rows (12) radius z_min z_max phi_max
    reverse mat (6) -> [S, 18]."""
    ft = sp["radius"].dtype
    parts = [
        sp["w2o"][:, :3, :4].reshape(sp["w2o"].shape[0], 12),
        sp["radius"][:, None],
        sp["z_min"][:, None],
        sp["z_max"][:, None],
        sp["phi_max"][:, None],
        sp["reverse"][:, None],
        sp["mat"][:, None],
    ]
    return jnp.concatenate([p.astype(ft) for p in parts], axis=1)


def compute_interaction(tables, hit, o, d, ray_diff=None, time=None):
    """Hit record -> SoA surface interaction dict.

    Keys: p [N,3], ng, ns [N,3], uv [N,2], mat [N], light [N], wo [N,3].
    Misses get mat=-1/light=-1.

    ``ray_diff=(dxd, dyd)`` — directions of the +1-pixel-x / +1-pixel-y
    camera rays sharing origin ``o`` (pbrt-v3 GenerateRayDifferential) —
    adds ``duvdx``/``duvdy`` [N,2] and ``tex_width`` [N] (max uv-space
    footprint component) to the dict: offsets are transferred to the hit
    plane, then projected onto the triangle's (dpdu, dpdv) via the dual
    basis of the first fundamental form — branch-free, unlike pbrt's
    pick-two-axes 2x2 solve (SurfaceInteraction::ComputeDifferentials).
    Sphere hits get an arc-length estimate ||dpdx|| / (r * pi).

    ``time`` ([N] normalized shutter time) blends triangle vertices and
    shading normals between the scene's keyframe tables (motion blur);
    requires ``tables["tri_keys"]``.
    """
    n = o.shape[0]
    dt = o.dtype
    t = hit["t"]
    p = o + d * t[..., None]
    ng = jnp.zeros((n, 3), dtype=dt).at[:, 2].set(1.0)
    ns = ng
    # winding-order geometric normal, NOT flipped to agree with authored
    # shading normals — medium-transition (inside/outside) tests must use
    # this one, or inward-pointing shading normals invert med_in/med_out
    ng_raw = ng
    uv = jnp.zeros((n, 2), dtype=dt)
    mat = jnp.full((n,), -1, dtype=jnp.int32)
    light = jnp.full((n,), -1, dtype=jnp.int32)
    med_in = jnp.full((n,), -1, dtype=jnp.int32)
    med_out = jnp.full((n,), -1, dtype=jnp.int32)
    duvdx = jnp.zeros((n, 2), dtype=dt)
    duvdy = jnp.zeros((n, 2), dtype=dt)
    tex_width = jnp.zeros((n,), dtype=dt)

    def _plane_offsets(ng_plane):
        """Transfer the +1px offset rays to the hit plane: dpdx, dpdy."""
        dxd, dyd = ray_diff

        def transfer(dd):
            denom = jnp.sum(dd * ng_plane, axis=-1)
            tt = jnp.sum((p - o) * ng_plane, axis=-1) / jnp.where(
                jnp.abs(denom) > 1e-9, denom, 1.0
            )
            ok = jnp.abs(denom) > 1e-9
            return jnp.where(ok[..., None], o + dd * tt[..., None] - p, 0.0)

        return transfer(dxd), transfer(dyd)

    flags = tables.get("_flags", {})
    uv_needed = bool(flags.get("uv", True))
    tri_flat = bool(flags.get("tri_flat", False))

    if "tri" in tables:
        tr = tables["tri"]
        idx = jnp.clip(hit["prim"], 0, tr["p0"].shape[0] - 1)
        is_tri = hit["hit"] & (hit["kind"] == KIND_TRI)
        cols, lay = _tri_cols(tr, need_normals=not tri_flat, need_uv=uv_needed)
        rows = select_rows(cols, idx).astype(dt)
        krows = None
        if time is not None and "tri_keys" in tables:
            # per-lane keyframe blend of [p0 p1 p2 n0 n1 n2] rows
            from pbrt_tpu.ops.animated_intersect import time_weights

            keys = tables["tri_keys"]
            kw = time_weights(
                jnp.broadcast_to(time, idx.shape).astype(dt), len(keys)
            )
            krows = 0.0
            for k, kc in enumerate(keys):
                krows = krows + kw[:, k:k + 1] * select_rows(kc, idx).astype(dt)
        if krows is not None:
            p0, p1, p2 = krows[:, 0:3], krows[:, 3:6], krows[:, 6:9]
        else:
            p0, p1, p2 = rows[:, lay["p0"]], rows[:, lay["p1"]], rows[:, lay["p2"]]
        b0 = hit["b0"]
        b1 = hit["b1"]
        b2 = 1.0 - b0 - b1
        mat_t = jnp.round(rows[:, lay["mat"]][:, 0]).astype(jnp.int32)
        light_t = jnp.round(rows[:, lay["light"]][:, 0]).astype(jnp.int32)
        med_in_t = jnp.round(rows[:, lay["med_in"]][:, 0]).astype(jnp.int32)
        med_out_t = jnp.round(rows[:, lay["med_out"]][:, 0]).astype(jnp.int32)
        ng_t = jnp.cross(p1 - p0, p2 - p0)
        ng_t = ng_t / jnp.maximum(jnp.linalg.norm(ng_t, axis=-1, keepdims=True), 1e-12)
        ng_raw_t = ng_t
        if tri_flat:
            # every mesh normal equals the +winding face normal (checked at
            # build time), so interpolation and orientation are identities
            ns_t = ng_t
        else:
            if krows is not None:
                n0, n1, n2 = krows[:, 9:12], krows[:, 12:15], krows[:, 15:18]
            else:
                n0, n1, n2 = rows[:, lay["n0"]], rows[:, lay["n1"]], rows[:, lay["n2"]]
            ns_t = b2[..., None] * n0 + b0[..., None] * n1 + b1[..., None] * n2
            ns_norm = jnp.linalg.norm(ns_t, axis=-1, keepdims=True)
            ns_t = jnp.where(ns_norm > 1e-9, ns_t / jnp.maximum(ns_norm, 1e-12), ng_t)
            # orient geometric normal to agree with shading normal
            ng_t = jnp.where(
                jnp.sum(ng_t * ns_t, axis=-1, keepdims=True) < 0, -ng_t, ng_t
            )
        m = is_tri[..., None]
        if uv_needed:
            uv0, uv1, uv2 = rows[:, lay["uv0"]], rows[:, lay["uv1"]], rows[:, lay["uv2"]]
            uv_t = b2[..., None] * uv0 + b0[..., None] * uv1 + b1[..., None] * uv2
            uv = jnp.where(m, uv_t, uv)
            if ray_diff is not None:
                dpdx, dpdy = _plane_offsets(ng_raw_t)
                # (dpdu, dpdv) from the uv parameterization (triangle.cpp)
                duv02 = uv0 - uv2
                duv12 = uv1 - uv2
                dp02 = p0 - p2
                dp12 = p1 - p2
                det_uv = duv02[..., 0] * duv12[..., 1] - duv02[..., 1] * duv12[..., 0]
                inv_uv = jnp.where(
                    jnp.abs(det_uv) > 1e-12,
                    1.0 / jnp.where(det_uv == 0, 1.0, det_uv), 0.0
                )[..., None]
                dpdu = (duv12[..., 1:2] * dp02 - duv02[..., 1:2] * dp12) * inv_uv
                dpdv = (-duv12[..., 0:1] * dp02 + duv02[..., 0:1] * dp12) * inv_uv
                # dual basis of the first fundamental form: du = dp . fu
                E = jnp.sum(dpdu * dpdu, axis=-1)
                F = jnp.sum(dpdu * dpdv, axis=-1)
                G = jnp.sum(dpdv * dpdv, axis=-1)
                det_g = E * G - F * F
                inv_g = jnp.where(det_g > 1e-20, 1.0 / jnp.maximum(det_g, 1e-30), 0.0)
                fu = (G[..., None] * dpdu - F[..., None] * dpdv) * inv_g[..., None]
                fv = (E[..., None] * dpdv - F[..., None] * dpdu) * inv_g[..., None]
                duvdx_t = jnp.stack(
                    [jnp.sum(dpdx * fu, axis=-1), jnp.sum(dpdx * fv, axis=-1)],
                    axis=-1,
                )
                duvdy_t = jnp.stack(
                    [jnp.sum(dpdy * fu, axis=-1), jnp.sum(dpdy * fv, axis=-1)],
                    axis=-1,
                )
                duvdx = jnp.where(m, duvdx_t, duvdx)
                duvdy = jnp.where(m, duvdy_t, duvdy)
                w_t = jnp.maximum(
                    jnp.max(jnp.abs(duvdx_t), axis=-1),
                    jnp.max(jnp.abs(duvdy_t), axis=-1),
                )
                tex_width = jnp.where(is_tri, w_t, tex_width)
        ng = jnp.where(m, ng_t, ng)
        ng_raw = jnp.where(m, ng_raw_t, ng_raw)
        ns = jnp.where(m, ns_t, ns)
        mat = jnp.where(is_tri, mat_t, mat)
        light = jnp.where(is_tri, light_t, light)
        med_in = jnp.where(is_tri, med_in_t, med_in)
        med_out = jnp.where(is_tri, med_out_t, med_out)
        if "tan0" in tr:
            # curve tangent (hair shading); zero on non-curve triangles
            tang_t = (
                b2[..., None] * rows[:, lay["tan0"]]
                + b0[..., None] * rows[:, lay["tan1"]]
                + b1[..., None] * rows[:, lay["tan2"]]
            )
            tang = jnp.where(m, tang_t, jnp.zeros((n, 3), dtype=dt))

    if "sph" in tables:
        sp = tables["sph"]
        idx = jnp.clip(hit["prim"], 0, sp["radius"].shape[0] - 1)
        is_sph = hit["hit"] & (hit["kind"] == KIND_SPHERE)
        srows = select_rows(_sph_cols(sp), idx).astype(dt)
        m3 = srows[:, 0:12].reshape(-1, 3, 4)
        p_obj = (
            jnp.einsum("nij,nj->ni", m3[:, :, :3], p, precision=HIGHEST)
            + m3[:, :, 3]
        )
        n_obj = p_obj / jnp.maximum(
            jnp.linalg.norm(p_obj, axis=-1, keepdims=True), 1e-12
        )
        # normal transform: (w2o)^T applied to object normal
        n_w = jnp.einsum("nji,nj->ni", m3[:, :, :3], n_obj, precision=HIGHEST)
        n_w = n_w / jnp.maximum(jnp.linalg.norm(n_w, axis=-1, keepdims=True), 1e-12)
        n_w = jnp.where(srows[:, 16:17] != 0.0, -n_w, n_w)
        m = is_sph[..., None]
        if uv_needed:
            # (phi, theta) parameterization — arctan2/arccos are among the
            # most expensive elementwise ops, so this block is statically
            # skipped for untextured scenes
            phi = jnp.arctan2(p_obj[..., 1], p_obj[..., 0])
            phi = jnp.where(phi < 0, phi + 2 * np.pi, phi)
            r = srows[:, 12]
            u_s = phi / srows[:, 15]
            zmin = srows[:, 13]
            zmax = srows[:, 14]
            theta = jnp.arccos(jnp.clip(p_obj[..., 2] / jnp.maximum(r, 1e-12), -1, 1))
            theta_min = jnp.arccos(jnp.clip(zmax / jnp.maximum(r, 1e-12), -1, 1))
            theta_max = jnp.arccos(jnp.clip(zmin / jnp.maximum(r, 1e-12), -1, 1))
            v_s = (theta - theta_min) / jnp.maximum(theta_max - theta_min, 1e-9)
            uv = jnp.where(m, jnp.stack([u_s, v_s], axis=-1), uv)
            if ray_diff is not None:
                dpdx, dpdy = _plane_offsets(n_w)
                # arc-length footprint estimate: uv spans ~pi*r of surface
                wid = jnp.maximum(
                    jnp.linalg.norm(dpdx, axis=-1), jnp.linalg.norm(dpdy, axis=-1)
                ) / jnp.maximum(r * np.pi, 1e-9)
                tex_width = jnp.where(is_sph, wid, tex_width)
                duvdx = jnp.where(m, jnp.stack([wid, wid], -1), duvdx)
                duvdy = jnp.where(m, jnp.zeros((n, 2), dtype=dt), duvdy)
        ng = jnp.where(m, n_w, ng)
        ng_raw = jnp.where(m, n_w, ng_raw)
        ns = jnp.where(m, n_w, ns)
        mat = jnp.where(is_sph, jnp.round(srows[:, 17]).astype(jnp.int32), mat)

    out = {
        "p": p,
        "ng": ng,
        "ng_raw": ng_raw,
        "ns": ns,
        "uv": uv,
        "mat": mat,
        "light": light,
        "med_in": med_in,
        "med_out": med_out,
        "wo": -d,
    }
    if ray_diff is not None:
        out["tex_width"] = tex_width
        out["duvdx"] = duvdx
        out["duvdy"] = duvdy
    if "tri" in tables and "tan0" in tables["tri"]:
        out["tang"] = tang
    return out
