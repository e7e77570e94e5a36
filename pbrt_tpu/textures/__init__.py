"""Texture evaluation, batched over lanes.

The reference defines ``Texture<T>::evaluate(&SurfaceInteraction)`` per hit
(/root/reference/src/core/texture.rs:24-30) and implements only the
constant texture (textures/constant.rs).  Here a texture evaluates a whole
*wavefront* at once: ``eval(si)`` takes an SoA interaction dict of jnp
arrays (``uv`` [N,2], ``p`` [N,3], ...) and returns ``[N]`` floats or
``[N,3]`` spectra — branchless, fully vectorized, differentiable w.r.t. its
parameters.

Factory dispatch mirrors api.rs:905-943's texture-kind table; all twelve
pbrt-v3 texture kinds are real here (eleven are ``unimplemented!()`` in the
reference).
"""

from __future__ import annotations

import logging

log = logging.getLogger("pbrt_tpu")

from pbrt_tpu.textures.constant import ConstantTexture, create_constant_float, create_constant_spectrum
from pbrt_tpu.textures.scale import ScaleTexture
from pbrt_tpu.textures.mix import MixTexture, BilerpTexture
from pbrt_tpu.textures.checkerboard import CheckerboardTexture
from pbrt_tpu.textures.uv import UVTexture
from pbrt_tpu.textures.imagemap import ImageTexture
from pbrt_tpu.textures.noise import DotsTexture, FBmTexture, WrinkledTexture, WindyTexture, MarbleTexture


def _make_texture(name, tex2world, tp, *, spectral: bool):
    from pbrt_tpu.textures import factories

    fn = factories.FACTORIES.get(name)
    if fn is None:
        kind = "Spectrum" if spectral else "Float"
        log.warning("%s texture '%s' is unknown", kind, name)
        return None
    return fn(tex2world, tp, spectral)


def make_float_texture(name, tex2world, tp):
    """api.rs:905-923 dispatch, all kinds implemented."""
    return _make_texture(name, tex2world, tp, spectral=False)


def make_spectrum_texture(name, tex2world, tp):
    """api.rs:925-943 dispatch, all kinds implemented."""
    return _make_texture(name, tex2world, tp, spectral=True)
