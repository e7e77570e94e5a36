"""Geometry: host-side bounds/points plus batched device vector math.

The reference models scalar ``Vector3<T>``/``Point3<T>`` objects
(reference src/core/geometry/vector.rs, point.rs).  The device build
inverts this to structure-of-arrays: a "vector" is the trailing axis of a
``[..., 3]`` jnp array and every op below is batched.  Host-side integer
bounds (``Bounds2i``) keep the reference's exact semantics because the film
crop/tile math depends on them (film.rs:90-101, bounds.rs:182-288).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

import jax.numpy as jnp

from pbrt_tpu import float_t

# ---------------------------------------------------------------------------
# Host 2D points / bounds (reference geometry/bounds.rs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Bounds2i:
    """Integer 2D bounds [p_min, p_max); row-major iteration.

    Matches reference ``Bounds2i`` (geometry/bounds.rs): the default is an
    inverted (empty) bounds; the two-point constructor canonicalizes
    min/max; ``intersect`` deliberately does *not* canonicalize so an empty
    intersection stays empty (bounds.rs:244-252).
    """

    p_min: Tuple[int, int]
    p_max: Tuple[int, int]

    @staticmethod
    def from_points(p0, p1) -> "Bounds2i":
        return Bounds2i(
            (min(p0[0], p1[0]), min(p0[1], p1[1])),
            (max(p0[0], p1[0]), max(p0[1], p1[1])),
        )

    @staticmethod
    def empty() -> "Bounds2i":
        big = 2 ** 31 - 1
        return Bounds2i((big, big), (-big, -big))

    def diagonal(self) -> Tuple[int, int]:
        return (self.p_max[0] - self.p_min[0], self.p_max[1] - self.p_min[1])

    def area(self) -> int:
        d = self.diagonal()
        return d[0] * d[1]

    @property
    def width(self) -> int:
        return self.p_max[0] - self.p_min[0]

    @property
    def height(self) -> int:
        return self.p_max[1] - self.p_min[1]

    def is_empty(self) -> bool:
        return self.p_max[0] <= self.p_min[0] or self.p_max[1] <= self.p_min[1]

    def inside_exclusive(self, p) -> bool:
        return (
            self.p_min[0] <= p[0] < self.p_max[0]
            and self.p_min[1] <= p[1] < self.p_max[1]
        )

    def intersect(self, other: "Bounds2i") -> "Bounds2i":
        # No canonicalization: empty results stay inverted (bounds.rs:244-252).
        return Bounds2i(
            (max(self.p_min[0], other.p_min[0]), max(self.p_min[1], other.p_min[1])),
            (min(self.p_max[0], other.p_max[0]), min(self.p_max[1], other.p_max[1])),
        )

    def __iter__(self) -> Iterator[Tuple[int, int]]:
        # Row-major pixel iteration (bounds.rs:284-288).
        for y in range(self.p_min[1], self.p_max[1]):
            for x in range(self.p_min[0], self.p_max[0]):
                yield (x, y)

    def offsets(self) -> np.ndarray:
        """All pixel coordinates as an [N, 2] int array, row-major."""
        xs = np.arange(self.p_min[0], self.p_max[0])
        ys = np.arange(self.p_min[1], self.p_max[1])
        gx, gy = np.meshgrid(xs, ys)
        return np.stack([gx.ravel(), gy.ravel()], axis=-1)


@dataclasses.dataclass(frozen=True)
class Bounds2f:
    p_min: Tuple[float, float]
    p_max: Tuple[float, float]

    @staticmethod
    def from_points(p0, p1) -> "Bounds2f":
        return Bounds2f(
            (min(p0[0], p1[0]), min(p0[1], p1[1])),
            (max(p0[0], p1[0]), max(p0[1], p1[1])),
        )

    def diagonal(self) -> Tuple[float, float]:
        return (self.p_max[0] - self.p_min[0], self.p_max[1] - self.p_min[1])

    def area(self) -> float:
        d = self.diagonal()
        return d[0] * d[1]

    def lerp(self, t) -> Tuple[float, float]:
        return (
            (1 - t[0]) * self.p_min[0] + t[0] * self.p_max[0],
            (1 - t[1]) * self.p_min[1] + t[1] * self.p_max[1],
        )


# ---------------------------------------------------------------------------
# Host 3D bounds for BVH builds (numpy, vectorized over primitives)
# ---------------------------------------------------------------------------


class Bounds3:
    """Axis-aligned 3D boxes stored SoA as [N, 3] mins and maxes."""

    __slots__ = ("mins", "maxs")

    def __init__(self, mins, maxs):
        self.mins = np.asarray(mins, dtype=float_t)
        self.maxs = np.asarray(maxs, dtype=float_t)

    @staticmethod
    def empty(n=1):
        inf = np.float32(np.inf)
        return Bounds3(np.full((n, 3), inf), np.full((n, 3), -inf))

    def union(self, other: "Bounds3") -> "Bounds3":
        return Bounds3(np.minimum(self.mins, other.mins), np.maximum(self.maxs, other.maxs))

    def centroid(self) -> np.ndarray:
        return 0.5 * (self.mins + self.maxs)

    def surface_area(self) -> np.ndarray:
        d = np.maximum(self.maxs - self.mins, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


# ---------------------------------------------------------------------------
# Device vector math over [..., 3] arrays
# ---------------------------------------------------------------------------


def vdot(a, b):
    return jnp.sum(a * b, axis=-1)


def vabsdot(a, b):
    return jnp.abs(vdot(a, b))


def vcross(a, b):
    # f64-free robust cross is unnecessary at f32 scene scales; XLA fuses this.
    return jnp.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        axis=-1,
    )


def vlength_squared(v):
    return vdot(v, v)


def vlength(v):
    return jnp.sqrt(vlength_squared(v))


def vnormalize(v):
    return v * jax_rsqrt_safe(vlength_squared(v))[..., None]


def jax_rsqrt_safe(x, eps=1e-20):
    return jnp.where(x > eps, jax_rsqrt(x), jnp.zeros_like(x))


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(x)


def vface_forward(n, v):
    """Flip n to lie in the hemisphere of v."""
    return jnp.where(vdot(n, v)[..., None] < 0.0, -n, n)


def coordinate_system(v1):
    """Build an orthonormal basis around unit vector v1 (pbrt-v3 §2.2.4).

    Returns (v2, v3) with v1 x v2 = v3; branchless (Duff et al. 2017).
    """
    sign = jnp.where(v1[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + v1[..., 2])
    b = v1[..., 0] * v1[..., 1] * a
    v2 = jnp.stack(
        [1.0 + sign * v1[..., 0] * v1[..., 0] * a, sign * b, -sign * v1[..., 0]],
        axis=-1,
    )
    v3 = jnp.stack([b, sign + v1[..., 1] * v1[..., 1] * a, -v1[..., 1]], axis=-1)
    return v2, v3


def shading_frame(si, wo):
    """Face-forwarded shading frame (ns, ss, ts) for a wavefront interaction.

    Curve lanes (``si["tang"]`` nonzero) align ss (local x) with the fiber
    tangent — the frame the hair BSDF requires (pbrt-v3 builds its BSDF frame
    from dpdu, which for curves is the spine direction).  Other lanes keep the
    branchless default basis; the table is only present when a scene contains
    curves, so non-curve scenes compile to the plain two-op path.
    """
    ns = vface_forward(si["ns"], wo)
    ss, ts = coordinate_system(ns)
    tang = si.get("tang") if isinstance(si, dict) else None
    if tang is not None:
        t_perp = tang - jnp.sum(tang * ns, axis=-1, keepdims=True) * ns
        t_len = jnp.linalg.norm(t_perp, axis=-1, keepdims=True)
        use = (jnp.sum(tang * tang, axis=-1) > 1e-12) & (t_len[..., 0] > 1e-9)
        ss = jnp.where(use[..., None], t_perp / jnp.maximum(t_len, 1e-12), ss)
        ts = jnp.where(use[..., None], jnp.cross(ns, ss), ts)
    return ns, ss, ts


def spherical_direction(sin_theta, cos_theta, phi):
    return jnp.stack(
        [sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), cos_theta], axis=-1
    )


def spherical_theta(v):
    return jnp.arccos(jnp.clip(v[..., 2], -1.0, 1.0))


def spherical_phi(v):
    p = jnp.arctan2(v[..., 1], v[..., 0])
    return jnp.where(p < 0.0, p + 2.0 * jnp.pi, p)


def distance(a, b):
    return vlength(a - b)


def lerp_v(t, a, b):
    return (1.0 - t) * a + t * b
