"""Material table: pbrt material records -> per-lane BSDF parameters.

pbrt-v3's 15 material plugins reduce on device to a compact lobe-parameter
space (see materials/bsdf.py): every material fills slots
(kd/ks/kr/kt/roughness/eta/metal_eta/metal_k/sigma) via textures, and a
type id selects the lobe combination.  Scene build produces a list of
:class:`MaterialEntry`; at shading time :func:`eval_material_params`
evaluates each entry's textures across the wavefront and mask-selects into
SoA parameter arrays.  Materials with only constant textures cost a single
gather.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import float_t
from pbrt_tpu.core.paramset import TextureParams
from pbrt_tpu.materials import bsdf as B

log = logging.getLogger("pbrt_tpu")

# copper (pbrt-v3 metal default) converted to RGB
COPPER_ETA = np.array([0.200438, 0.924033, 1.10221], dtype=np.float64)
COPPER_K = np.array([3.91295, 2.44763, 2.14219], dtype=np.float64)


@dataclass
class MaterialEntry:
    type_id: int
    textures: Dict[str, object] = field(default_factory=dict)  # slot -> Texture
    remap_roughness: bool = True
    metal_eta: np.ndarray = None
    metal_k: np.ndarray = None
    eta_const: float = 1.5
    # hair-only fields (pbrt-v3 HairMaterial): pigment source + cuticle tilt
    hair_mode: str = ""  # "sigma_a" | "color" | "melanin"
    hair_sigma_a: np.ndarray = None  # for melanin mode (precomputed RGB)
    hair_alpha: float = 2.0  # scale tilt, degrees
    # mix-only fields (pbrt-v3 MixMaterial): two child entries + blend tex
    mix_children: Optional[tuple] = None  # (MaterialEntry, MaterialEntry)
    mix_amount: object = None  # spectrum texture, default 0.5
    # fourier-only field: loaded .bsdf table (materials/fourier.py)
    fourier_table: object = None


_SPECTRUM_SLOTS = ("kd", "ks", "kr", "kt")
_FLOAT_SLOTS = ("roughness", "sigma", "eta_tex", "opacity")


def build_material(record) -> MaterialEntry:
    """MaterialRecord (core/api.py) -> MaterialEntry."""
    tp = TextureParams(
        record.params,
        record.params,
        record.float_textures,
        record.spectrum_textures,
    )
    name = record.name
    gray = lambda v: np.full(3, v, dtype=float_t)

    def spec_tex(pname, default):
        return tp.get_spectrum_texture(pname, gray(default))

    def float_tex(pname, default):
        return tp.get_float_texture(pname, default)

    if name in ("", "none"):
        return MaterialEntry(B.NONE)
    if name == "matte":
        return MaterialEntry(
            B.MATTE,
            {"kd": spec_tex("Kd", 0.5), "sigma": float_tex("sigma", 0.0)},
        )
    if name == "mirror":
        return MaterialEntry(B.MIRROR, {"kr": spec_tex("Kr", 0.9)})
    if name == "glass":
        e = MaterialEntry(
            B.GLASS,
            {
                "kr": spec_tex("Kr", 1.0),
                "kt": spec_tex("Kt", 1.0),
                "roughness": float_tex("uroughness", 0.0),
            },
        )
        e.eta_const = tp.find_float("eta", tp.find_float("index", 1.5))
        return e
    if name == "plastic":
        e = MaterialEntry(
            B.PLASTIC,
            {
                "kd": spec_tex("Kd", 0.25),
                "ks": spec_tex("Ks", 0.25),
                "roughness": float_tex("roughness", 0.1),
            },
            remap_roughness=tp.find_bool("remaproughness", True),
        )
        return e
    if name == "metal":
        e = MaterialEntry(
            B.METAL,
            {"roughness": float_tex("roughness", 0.01)},
            remap_roughness=tp.find_bool("remaproughness", True),
        )
        e.metal_eta = np.asarray(tp.find_spectrum("eta", COPPER_ETA.astype(float_t)), dtype=np.float64)
        e.metal_k = np.asarray(tp.find_spectrum("k", COPPER_K.astype(float_t)), dtype=np.float64)
        return e
    if name == "substrate":
        return MaterialEntry(
            B.SUBSTRATE,
            {
                "kd": spec_tex("Kd", 0.5),
                "ks": spec_tex("Ks", 0.5),
                "roughness": float_tex("uroughness", 0.1),
            },
            remap_roughness=tp.find_bool("remaproughness", True),
        )
    if name == "uber":
        e = MaterialEntry(
            B.UBER,
            {
                "kd": spec_tex("Kd", 0.25),
                "ks": spec_tex("Ks", 0.25),
                "kr": spec_tex("Kr", 0.0),
                "kt": spec_tex("Kt", 0.0),
                "roughness": float_tex("roughness", 0.1),
                "opacity": spec_tex("opacity", 1.0),
            },
            remap_roughness=tp.find_bool("remaproughness", True),
        )
        e.eta_const = tp.find_float("eta", tp.find_float("index", 1.5))
        return e
    if name == "translucent":
        return MaterialEntry(
            B.TRANSLUCENT,
            {
                "kd": spec_tex("Kd", 0.25),
                "kt": spec_tex("transmit", 0.5),
                "roughness": float_tex("roughness", 0.1),
            },
        )
    if name in ("disney",):
        log.warning("Material 'disney' approximated by substrate lobes")
        return MaterialEntry(
            B.SUBSTRATE,
            {
                "kd": spec_tex("color", 0.5),
                "ks": spec_tex("color", 0.5),
                "roughness": float_tex("roughness", 0.5),
            },
        )
    if name == "hair":
        # pbrt-v3 src/materials/hair.cpp CreateHairMaterial pigment priority:
        # sigma_a > color > eumelanin/pheomelanin > default brown (ce=1.3)
        from pbrt_tpu.materials.hair import sigma_a_from_concentration

        e = MaterialEntry(
            B.HAIR,
            {
                "beta_m": float_tex("beta_m", 0.3),
                "beta_n": float_tex("beta_n", 0.3),
            },
        )
        e.eta_const = tp.find_float("eta", 1.55)
        e.hair_alpha = tp.find_float("alpha", 2.0)
        sig = tp.get_spectrum_texture_or_none("sigma_a")
        col = tp.get_spectrum_texture_or_none("color")
        ce = tp.get_float_texture_or_none("eumelanin")
        cp = tp.get_float_texture_or_none("pheomelanin")
        if sig is not None:
            e.hair_mode = "sigma_a"
            e.textures["sigma_a"] = sig
        elif col is not None:
            e.hair_mode = "color"
            e.textures["sigma_a"] = col  # converted at eval (needs beta_n)
        else:
            from pbrt_tpu.textures.constant import ConstantTexture

            def const_of(t, d):
                return float(np.asarray(t.value).reshape(-1)[0]) if isinstance(t, ConstantTexture) else d

            ce_v = const_of(ce, 0.0) if ce is not None else 0.0
            cp_v = const_of(cp, 0.0) if cp is not None else 0.0
            if ce is None and cp is None:
                ce_v = 1.3  # pbrt default brown
            e.hair_mode = "melanin"
            e.hair_sigma_a = sigma_a_from_concentration(ce_v, cp_v).astype(float_t)
        return e
    if name == "mix":
        # pbrt-v3 MixMaterial: f = amount * f1 + (1 - amount) * f2; children
        # were resolved against the named-material registry at record time
        children = getattr(record, "mix_children", None)
        if not children or children[0] is None or children[1] is None:
            log.error("mix material missing children; using matte")
            return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})
        # nested mix children are kept as-is: theta/eval/bsdf all recurse
        kids = [build_material(ch) for ch in children]
        e = MaterialEntry(kids[0].type_id)
        e.mix_children = (kids[0], kids[1])
        e.mix_amount = spec_tex("amount", 0.5)
        return e
    if name in ("subsurface", "kdsubsurface"):
        # device subsurface = dielectric interface + interior medium
        # traced volumetrically (media/scattering.py); the surface BSDF here
        # mirrors pbrt-v3 SubsurfaceMaterial's specular/microfacet dielectric
        # (materials/subsurface.cpp ComputeScatteringFunctions); the builder
        # attaches the interior medium to the shape
        e = MaterialEntry(
            B.GLASS,
            {
                "kr": spec_tex("Kr", 1.0),
                "kt": spec_tex("Kt", 1.0),
                "roughness": float_tex("uroughness", 0.0),
            },
            remap_roughness=tp.find_bool("remaproughness", True),
        )
        e.eta_const = tp.find_float("eta", 1.33)
        return e
    if name == "fourier":
        from pbrt_tpu.materials.fourier import FourierTable

        fname = tp.find_filename("bsdffile", "")
        try:
            table = FourierTable.read(fname)
        except (OSError, ValueError) as err:
            log.error("fourier material: %s; using matte", err)
            return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})
        e = MaterialEntry(B.FOURIER)
        e.fourier_table = table
        e.eta_const = table.eta
        return e
    log.warning("Material '%s' unknown; using matte.", name)
    return MaterialEntry(B.MATTE, {"kd": spec_tex("Kd", 0.5)})


def iter_entries_deep(entries):
    """Yield every MaterialEntry including nested mix children (and each
    mix entry itself); used by build-time scans that must see textures
    buried arbitrarily deep in mix trees."""
    for e in entries:
        yield e
        if e.mix_children is not None:
            yield from iter_entries_deep(list(e.mix_children))


def material_theta(entries):
    """Extract the differentiable constant-parameter pytree from entries.

    Slots backed by ConstantTexture become rows of [M,3]/[M] arrays; rows for
    procedural/image textures hold the defaults and are ignored at eval.
    Used for inverse rendering: pass (possibly optimized) ``theta`` back into
    :func:`eval_material_params` and gradients flow to these leaves.

    Scenes containing mix materials get a split pytree {"a": ..., "b": ...}
    holding the two per-child entry lists' rows (mix entries replaced by
    child 0 / child 1, other entries duplicated); eval routes each half to
    the matching child parameter set so gradients flow through both lobes.
    """
    if any(e.mix_children is not None for e in entries):
        # recursive split: nested mix children produce nested {a, b} dicts
        return {
            "a": material_theta(
                [e.mix_children[0] if e.mix_children is not None else e
                 for e in entries]
            ),
            "b": material_theta(
                [e.mix_children[1] if e.mix_children is not None else e
                 for e in entries]
            ),
        }
    return _material_theta_flat(entries)


def _material_theta_flat(entries):
    from pbrt_tpu.textures.constant import ConstantTexture

    m = len(entries)
    out = {
        "kd": np.zeros((m, 3), dtype=float_t),
        "ks": np.zeros((m, 3), dtype=float_t),
        "kr": np.zeros((m, 3), dtype=float_t),
        "kt": np.zeros((m, 3), dtype=float_t),
        "roughness": np.full((m,), 0.1, dtype=float_t),
        "sigma": np.zeros((m,), dtype=float_t),
    }
    for k, e in enumerate(entries):
        for slot in ("kd", "ks", "kr", "kt"):
            tex = e.textures.get(slot)
            if isinstance(tex, ConstantTexture):
                v = np.asarray(tex.value, dtype=float_t).reshape(-1)
                out[slot][k] = v if v.size == 3 else np.full(3, float(v[0]))
        for slot in ("roughness", "sigma"):
            tex = e.textures.get(slot)
            if isinstance(tex, ConstantTexture):
                out[slot][k] = float(np.asarray(tex.value).reshape(-1)[0])
    return {k: jnp.asarray(v) for k, v in out.items()}


def eval_material_params(entries, mat_id, si, theta=None):
    """Evaluate all material entries over the wavefront -> SoA params dict.

    Mix materials produce a second complete parameter set under
    params["mix_b"] plus blend weights (see bsdf.py's mix-aware wrappers);
    scenes without mix take the single-set path unchanged.
    """
    if not any(e.mix_children is not None for e in entries):
        return _eval_material_params_single(entries, mat_id, si, theta)
    # split each mix entry into its two children, preserving indices so
    # mat_id keeps addressing the same rows; children that are themselves
    # mix entries recurse through this same function
    entries_a = [e.mix_children[0] if e.mix_children is not None else e
                 for e in entries]
    entries_b = [e.mix_children[1] if e.mix_children is not None else e
                 for e in entries]
    # material_theta produced split per-child rows for mix scenes; route
    # each half to the matching child entry list (tex_images apply to both)
    theta_a = theta_b = None
    if theta is not None:
        if "a" not in theta:
            raise ValueError(
                "mix scenes need the split {a, b} theta from material_theta; "
                "got a flat parameter pytree"
            )
        tex = {"tex_images": theta["tex_images"]} if "tex_images" in theta else {}
        theta_a = {**theta["a"], **tex}
        theta_b = {**theta["b"], **tex}
    params = eval_material_params(entries_a, mat_id, si, theta_a)
    params_b = eval_material_params(entries_b, mat_id, si, theta_b)
    n = mat_id.shape[0]
    dt = params["kd"].dtype
    amt = jnp.ones((n, 3), dtype=dt)
    is_mix = jnp.zeros((n,), dtype=bool)
    for k, e in enumerate(entries):
        if e.mix_children is None:
            continue
        mask = mat_id == k
        v = e.mix_amount.eval(si)
        if v.ndim == 1:
            v = v[..., None] * jnp.ones((1, 3), dtype=dt)
        amt = jnp.where(mask[..., None], jnp.clip(v, 0.0, 1.0), amt)
        is_mix = is_mix | mask
    y = jnp.asarray([0.212671, 0.715160, 0.072169], dtype=dt)
    pa = jnp.sum(amt * y, axis=-1)
    params["mix_b"] = params_b
    params["mix_amt"] = amt
    params["mix_pa"] = jnp.where(is_mix, jnp.clip(pa, 1e-3, 1.0 - 1e-3), 1.0)
    return params


def _eval_material_params_single(entries, mat_id, si, theta=None):
    """Evaluate one entry list over the wavefront -> SoA params dict.

    mat_id: [N] int32 indices into ``entries`` (-1 = background/none).
    theta: optional differentiable override pytree from
    :func:`material_theta`; constant-texture slots then read from theta
    (gathered by mat_id) so gradients flow, while procedural/image textures
    still evaluate normally.
    """
    n = mat_id.shape[0]
    dt = si["p"].dtype if "p" in si else jnp.float32
    zeros3 = jnp.zeros((n, 3), dtype=dt)
    zeros1 = jnp.zeros((n,), dtype=dt)
    params = {
        "type": jnp.full((n,), B.NONE, dtype=jnp.int32),
        "kd": zeros3,
        "ks": zeros3,
        "kr": zeros3,
        "kt": zeros3,
        "roughness": zeros1 + 1e-3,
        "eta": zeros1 + 1.5,
        "metal_eta": jnp.broadcast_to(jnp.asarray(COPPER_ETA, dtype=dt), (n, 3)),
        "metal_k": jnp.broadcast_to(jnp.asarray(COPPER_K, dtype=dt), (n, 3)),
        "sigma": zeros1,
    }

    def put3(slot, mask, val):
        params[slot] = jnp.where(mask[..., None], val, params[slot])

    def put1(slot, mask, val):
        params[slot] = jnp.where(mask, val, params[slot])

    from pbrt_tpu.textures.constant import ConstantTexture

    # static set of present material types: bsdf lobe code for absent types
    # is pruned from the compiled program entirely
    params["_active"] = frozenset(e.type_id for e in entries)

    if theta is not None and "tex_images" in theta:
        si = {**si, "_tex": theta["tex_images"]}

    safe_id = jnp.clip(mat_id, 0, max(len(entries) - 1, 0))
    for k, e in enumerate(entries):
        mask = mat_id == k
        put1("type", mask, e.type_id)
        for slot in ("kd", "ks", "kr", "kt"):
            tex = e.textures.get(slot)
            if tex is None:
                continue
            if theta is not None and isinstance(tex, ConstantTexture):
                v = jnp.broadcast_to(theta[slot][safe_id], (n, 3))
            else:
                v = tex.eval(si)
                if v.ndim == 1:
                    v = v[..., None] * jnp.ones((1, 3), dtype=dt)
            put3(slot, mask, v)
        rtex = e.textures.get("roughness")
        if rtex is not None:
            if theta is not None and isinstance(rtex, ConstantTexture):
                r = theta["roughness"][safe_id]
            else:
                r = rtex.eval(si)
                if r.ndim > 1:
                    r = r.mean(axis=-1)
            raw = r
            if e.remap_roughness:
                r = B.roughness_to_alpha(r)
            # zero roughness means perfectly smooth (specular glass), and
            # must survive the remap (pbrt builds a specular BxDF there)
            r = jnp.where(raw <= 1e-5, 1e-4, jnp.maximum(r, 1e-3))
            put1("roughness", mask, r)
        stex = e.textures.get("sigma")
        if stex is not None:
            if theta is not None and isinstance(stex, ConstantTexture):
                s = theta["sigma"][safe_id]
            else:
                s = stex.eval(si)
                if s.ndim > 1:
                    s = s.mean(axis=-1)
            put1("sigma", mask, s)
        put1("eta", mask, e.eta_const)
        if e.metal_eta is not None:
            put3("metal_eta", mask, jnp.asarray(e.metal_eta.astype(np.float32)))
            put3("metal_k", mask, jnp.asarray(e.metal_k.astype(np.float32)))

    # hair parameter block, present only when the scene has hair lanes
    if any(e.type_id == B.HAIR for e in entries):
        from pbrt_tpu.materials.hair import sigma_a_from_reflectance

        params["sigma_a"] = zeros3
        params["beta_m"] = zeros1 + 0.3
        params["beta_n"] = zeros1 + 0.3
        params["hair_alpha"] = zeros1 + 2.0
        for k, e in enumerate(entries):
            if e.type_id != B.HAIR:
                continue
            mask = mat_id == k

            def fval(slot, default):
                tex = e.textures.get(slot)
                if tex is None:
                    return jnp.full((n,), default, dtype=dt)
                v = tex.eval(si)
                return v.mean(axis=-1) if v.ndim > 1 else v

            beta_m = fval("beta_m", 0.3)
            beta_n = fval("beta_n", 0.3)
            put1("beta_m", mask, beta_m)
            put1("beta_n", mask, beta_n)
            put1("hair_alpha", mask, e.hair_alpha)
            if e.hair_mode == "melanin":
                sig = jnp.broadcast_to(jnp.asarray(e.hair_sigma_a, dtype=dt), (n, 3))
            else:
                sig = e.textures["sigma_a"].eval(si)
                if sig.ndim == 1:
                    sig = sig[..., None] * jnp.ones((1, 3), dtype=dt)
                if e.hair_mode == "color":
                    sig = sigma_a_from_reflectance(sig, beta_n[..., None])
            put3("sigma_a", mask, sig)

    # fourier tables: one device bundle per fourier entry
    if any(e.type_id == B.FOURIER for e in entries):
        params["fourier"] = [
            {**e.fourier_table.device_arrays(), "mask": mat_id == k}
            for k, e in enumerate(entries)
            if e.type_id == B.FOURIER
        ]
    return params
