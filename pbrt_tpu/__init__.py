"""pbrt_tpu — a differentiable physically based renderer in JAX.

A from-scratch JAX/XLA/Pallas implementation of the capability surface of
pbrt-v3 (as committed to by the reference Rust port, wathiede/pbrt):
scene-file parsing, the pbrt API state machine, film/filter/spectrum math,
sampler sequences, and a full wavefront Monte-Carlo path tracer with
reverse-mode pixel gradients — designed structure-of-arrays first so the hot
loops compile to wide device kernels and scale over device meshes with
``shard_map``.

Design stance (not a port):
  * megabatches of rays are the unit of work — no per-ray recursion;
  * branchless kernels selected by segment/sort instead of trait dispatch;
  * host Python only for parsing, orchestration and image I/O;
  * deterministic sample sequences that are pure functions of
    (pixel, sample index, dimension) — never of device id — so renders are
    bit-stable across shardings.

Float policy mirrors the reference's ``float-as-double`` cargo feature
(reference src/lib.rs:24-44): float32 by default, float64 when
``PBRT_TPU_DOUBLE=1`` is set in the environment before import.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

__version__ = "0.1.0"

# ---------------------------------------------------------------------------
# Float policy (reference: src/lib.rs:24-44, cargo feature "float-as-double")
# ---------------------------------------------------------------------------

_DOUBLE = os.environ.get("PBRT_TPU_DOUBLE", "0") not in ("", "0", "false")

if _DOUBLE:  # pragma: no cover - exercised via env-flag CI job
    import jax

    jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: JAX_COMPILATION_CACHE_DIR when it is
# set (JAX reads it itself), else one fixed directory inside the checkout
# (git-ignored).  A fixed path matters: the path is part of the cache key.
# Opt out with PBRT_TPU_NO_COMPILE_CACHE=1.
if "JAX_COMPILATION_CACHE_DIR" not in os.environ and os.environ.get(
    "PBRT_TPU_NO_COMPILE_CACHE", "0"
) in ("", "0", "false"):
    import jax

    jax.config.update(
        "jax_compilation_cache_dir",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache"),
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)

#: numpy dtype used for all "Float" quantities (f32 unless PBRT_TPU_DOUBLE=1).
float_t = np.float64 if _DOUBLE else np.float32
#: machine epsilon for the active Float type.
EPSILON = float(np.finfo(float_t).eps)
ONE_MINUS_EPSILON = float(np.nextafter(float_t(1.0), float_t(0.0)))

PI = 3.14159265358979323846
INV_PI = 0.31830988618379067154
INV_2PI = 0.15915494309189533577
INV_4PI = 0.07957747154594766788
PI_OVER_2 = 1.57079632679489661923
PI_OVER_4 = 0.78539816339744830961
SQRT_2 = 1.41421356237309504880

INFINITY = float("inf")
#: gamma(3) float error bound used for robust ray offsets (pbrt-v3 §3.9).
MACHINE_EPSILON = EPSILON * 0.5


def gamma_n(n: int) -> float:
    """pbrt's conservative floating-point error bound gamma(n)."""
    return (n * MACHINE_EPSILON) / (1 - n * MACHINE_EPSILON)


# ---------------------------------------------------------------------------
# Global options (reference: src/lib.rs:56-82)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Options:
    """Renderer options, mostly fed from CLI flags.

    Mirrors the reference ``pbrt::Options`` (src/lib.rs:59-82) and extends it
    with device knobs.
    """

    num_threads: int = 1  # kept for CLI parity; parallelism is the mesh
    quick_render: bool = False
    quiet: bool = False
    verbose: bool = False
    image_file: str = ""
    # device extensions
    mesh_shape: tuple | None = None  # e.g. (("dp", 4), ("sp", 2))
    ray_batch: int = 1 << 16  # rays per wavefront step
    # preemption recovery: when set, Renderer.render saves the film state +
    # sweep cursor to <checkpoint_dir>/film.ckpt.npz every
    # ``checkpoint_every`` chunks and resumes bit-identically from it
    checkpoint_dir: str | None = None
    checkpoint_every: int = 8
    # full spectral transport (the reference's `sampled-spectrum` cargo
    # feature, Cargo.toml:26-28, as a render mode); default from env like
    # PBRT_TPU_DOUBLE.  n_spectral_bins must be a multiple of 3 and divide
    # 60 evenly into strides (60, 30, 15, 6, 3).
    sampled_spectrum: bool = os.environ.get(
        "PBRT_TPU_SAMPLED_SPECTRUM", "0"
    ) not in ("", "0", "false")
    n_spectral_bins: int = 15


# ---------------------------------------------------------------------------
# Scalar math utilities (reference: src/lib.rs:92-203)
# ---------------------------------------------------------------------------


def gamma_correct(value):
    """sRGB gamma curve; works on scalars and numpy arrays.

    Matches reference ``gamma_correct`` (src/lib.rs:93-99).
    """
    v = np.asarray(value, dtype=float_t)
    lo = 12.92 * v
    hi = 1.055 * np.power(np.maximum(v, 1e-12), 1.0 / 2.4) - 0.055
    out = np.where(v <= 0.0031308, lo, hi).astype(float_t)
    return out if out.ndim else out.item()


def inverse_gamma_correct(value):
    """Inverse of :func:`gamma_correct` (pbrt-v3 InverseGammaCorrect)."""
    v = np.asarray(value, dtype=float_t)
    lo = v / 12.92
    hi = np.power((np.maximum(v, 0.0) + 0.055) / 1.055, 2.4)
    out = np.where(v <= 0.04045, lo, hi).astype(float_t)
    return out if out.ndim else out.item()


def clamp(val, low, high):
    """Clamp ``val`` to [low, high] (reference src/lib.rs:115-126)."""
    if val < low:
        return low
    if val > high:
        return high
    return val


def lerp(t, v1, v2):
    """Linear interpolation (reference src/lib.rs:139-141)."""
    return (1.0 - t) * v1 + t * v2


def quadratic(a, b, c):
    """Roots of a quadratic, computed in f64 for stability.

    Returns ``None`` or ``(t0, t1)`` with ``t0 <= t1``; matches reference
    ``quadratic`` (src/lib.rs:181-203) including the numerically stable
    Citardauq formulation.
    """
    a, b, c = float(a), float(b), float(c)
    discrim = b * b - 4.0 * a * c
    if discrim < 0.0:
        return None
    root_discrim = discrim ** 0.5
    if b < 0.0:
        q = -0.5 * (b - root_discrim)
    else:
        q = -0.5 * (b + root_discrim)
    t0 = float_t(q / a).item() if a != 0 else float("inf")
    t1 = float_t(c / q).item() if q != 0 else float("inf")
    if t0 > t1:
        t0, t1 = t1, t0
    return (t0, t1)


__all__ = [
    "Options",
    "float_t",
    "EPSILON",
    "ONE_MINUS_EPSILON",
    "PI",
    "INV_PI",
    "INV_2PI",
    "INV_4PI",
    "PI_OVER_2",
    "PI_OVER_4",
    "SQRT_2",
    "INFINITY",
    "gamma_n",
    "gamma_correct",
    "inverse_gamma_correct",
    "clamp",
    "lerp",
    "quadratic",
]
