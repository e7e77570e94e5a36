"""Shapes: host-side construction into flat device tables.

Design decision (SURVEY.md §7): the device intersector knows exactly
TWO primitive kinds — analytic spheres and triangles.  Every other pbrt-v3
shape (disk, cylinder, cone, paraboloid, hyperboloid, heightfield,
loopsubdiv) is tessellated at scene-build time into triangles *with exact
analytic vertex normals*, so shading quality matches the analytic surface
while the hot kernel stays branchless.  This trades a little build-time
memory for removing per-shape dynamic dispatch from the inner loop — the
reference's trait-object design (``Box<dyn Shape>``) inverted.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from pbrt_tpu import float_t

log = logging.getLogger("pbrt_tpu")


@dataclass
class TriangleData:
    """Host SoA for a batch of triangles (world space)."""

    p0: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    uv0: np.ndarray
    uv1: np.ndarray
    uv2: np.ndarray
    n0: Optional[np.ndarray] = None  # shading normals (world), or None
    n1: Optional[np.ndarray] = None
    n2: Optional[np.ndarray] = None
    tan0: Optional[np.ndarray] = None  # curve tangents (world), hair shading
    tan1: Optional[np.ndarray] = None
    tan2: Optional[np.ndarray] = None

    @property
    def count(self) -> int:
        return len(self.p0)

    def areas(self) -> np.ndarray:
        c = np.cross(self.p1 - self.p0, self.p2 - self.p0)
        return 0.5 * np.linalg.norm(c, axis=-1)


@dataclass
class SphereData:
    """Host SoA for analytic spheres (kept in object space + transforms)."""

    o2w: np.ndarray  # [S,4,4]
    w2o: np.ndarray
    radius: np.ndarray
    z_min: np.ndarray
    z_max: np.ndarray
    phi_max: np.ndarray  # radians
    reverse_orientation: np.ndarray  # bool

    @property
    def count(self) -> int:
        return len(self.radius)

    def areas(self) -> np.ndarray:
        # pbrt sphere area: phi_max * r * (z_max - z_min); account scale ~ uniform
        scale = np.cbrt(np.abs(np.linalg.det(self.o2w[:, :3, :3])))
        r = self.radius * scale
        return self.phi_max * r * (self.z_max - self.z_min) * scale


def _mesh_from_params(params, o2w, reverse):
    """Triangle mesh from ``Shape "trianglemesh"`` params (pbrt-v3 §3.6)."""
    indices = params.find_int("indices")
    pts = params.find_point3f("P")
    if indices is None or pts is None:
        log.error("trianglemesh missing 'indices' or 'P'; skipping")
        return None
    idx = np.asarray(indices, dtype=np.int64).reshape(-1, 3)
    pts_w = o2w.apply_p(pts)
    uv = params.find_point2f("uv")
    if uv is None:
        uv = params.find_point2f("st")
        if uv is None:
            fl = params.find_float("uv")
            if fl is None:
                fl = params.find_float("st")
            if fl is not None:
                uv = np.asarray(fl, dtype=float_t).reshape(-1, 2)
    normals = params.find_normal3f("N")
    if normals is not None:
        normals = o2w.apply_n(normals)
        norm = np.linalg.norm(normals, axis=-1, keepdims=True)
        normals = normals / np.where(norm == 0, 1.0, norm)
        if reverse:
            normals = -normals
    # per-vertex -> per-triangle-corner
    i0, i1, i2 = idx[:, 0], idx[:, 1], idx[:, 2]
    if uv is not None:
        uv = np.asarray(uv, dtype=float_t)
        uv0, uv1, uv2 = uv[i0], uv[i1], uv[i2]
    else:
        t = len(idx)
        uv0 = np.tile(np.array([[0.0, 0.0]], dtype=float_t), (t, 1))
        uv1 = np.tile(np.array([[1.0, 0.0]], dtype=float_t), (t, 1))
        uv2 = np.tile(np.array([[1.0, 1.0]], dtype=float_t), (t, 1))
    return TriangleData(
        p0=pts_w[i0].astype(float_t),
        p1=pts_w[i1].astype(float_t),
        p2=pts_w[i2].astype(float_t),
        uv0=uv0,
        uv1=uv1,
        uv2=uv2,
        n0=normals[i0] if normals is not None else None,
        n1=normals[i1] if normals is not None else None,
        n2=normals[i2] if normals is not None else None,
    )


def _grid_mesh(o2w, reverse, px, pz_fn, nrm_fn, nu, nv, u_range, v_range, wrap_u):
    """Tessellate a parametric surface (u, v) -> (point, normal)."""
    us = np.linspace(u_range[0], u_range[1], nu + 1)
    vs = np.linspace(v_range[0], v_range[1], nv + 1)
    uu, vv = np.meshgrid(us, vs, indexing="ij")  # [nu+1, nv+1]
    pts = pz_fn(uu, vv)  # [nu+1, nv+1, 3] object space
    nrm = nrm_fn(uu, vv)
    pts_w = o2w.apply_p(pts.reshape(-1, 3)).reshape(nu + 1, nv + 1, 3)
    nrm_w = o2w.apply_n(nrm.reshape(-1, 3)).reshape(nu + 1, nv + 1, 3)
    nn = np.linalg.norm(nrm_w, axis=-1, keepdims=True)
    nrm_w = nrm_w / np.where(nn == 0, 1.0, nn)
    if reverse:
        nrm_w = -nrm_w
    # uv in [0,1]
    u01 = (uu - u_range[0]) / (u_range[1] - u_range[0])
    v01 = (vv - v_range[0]) / (v_range[1] - v_range[0])
    uvc = np.stack([u01, v01], axis=-1)

    p0s, p1s, p2s, uv0s, uv1s, uv2s, n0s, n1s, n2s = ([] for _ in range(9))
    for i in range(nu):
        for j in range(nv):
            quad = [(i, j), (i + 1, j), (i + 1, j + 1), (i, j + 1)]
            for tri in ((0, 1, 2), (0, 2, 3)):
                a, b, c = (quad[k] for k in tri)
                p0s.append(pts_w[a]); p1s.append(pts_w[b]); p2s.append(pts_w[c])
                uv0s.append(uvc[a]); uv1s.append(uvc[b]); uv2s.append(uvc[c])
                n0s.append(nrm_w[a]); n1s.append(nrm_w[b]); n2s.append(nrm_w[c])
    td = TriangleData(
        p0=np.asarray(p0s, dtype=float_t),
        p1=np.asarray(p1s, dtype=float_t),
        p2=np.asarray(p2s, dtype=float_t),
        uv0=np.asarray(uv0s, dtype=float_t),
        uv1=np.asarray(uv1s, dtype=float_t),
        uv2=np.asarray(uv2s, dtype=float_t),
        n0=np.asarray(n0s, dtype=float_t),
        n1=np.asarray(n1s, dtype=float_t),
        n2=np.asarray(n2s, dtype=float_t),
    )
    # drop degenerate triangles (poles etc.)
    keep = td.areas() > 1e-12
    if not keep.all():
        td = TriangleData(
            *(getattr(td, f)[keep] for f in ("p0", "p1", "p2", "uv0", "uv1", "uv2", "n0", "n1", "n2"))
        )
    return td


TESS_U = 64
TESS_V = 32


def make_shape(name: str, params, o2w, reverse: bool):
    """Build a shape -> TriangleData | SphereData | None.

    Tessellation density for quadrics comes from the optional
    "tessellation" int param (default 64x32).
    """
    two_pi = 2.0 * np.pi
    if name == "trianglemesh":
        return _mesh_from_params(params, o2w, reverse)
    if name == "plymesh":
        from pbrt_tpu.shapes.plyread import mesh_from_ply

        return mesh_from_ply(params, o2w, reverse)
    if name == "heightfield":
        nu = params.find_one_int("nu", 0)
        nv = params.find_one_int("nv", 0)
        pz = params.find_float("Pz")
        if nu <= 0 or nv <= 0 or pz is None:
            log.error("heightfield missing nu/nv/Pz")
            return None
        z = np.asarray(pz, dtype=float_t).reshape(nv, nu)

        def pfn(uu, vv):
            iu = np.clip((uu * (nu - 1)).astype(int), 0, nu - 1)
            iv = np.clip((vv * (nv - 1)).astype(int), 0, nv - 1)
            return np.stack([uu, vv, z[iv, iu]], axis=-1)

        def nfn(uu, vv):
            iu = np.clip((uu * (nu - 1)).astype(int), 0, nu - 2)
            iv = np.clip((vv * (nv - 1)).astype(int), 0, nv - 2)
            dzdu = (z[iv, iu + 1] - z[iv, iu]) * (nu - 1)
            dzdv = (z[iv + 1, iu] - z[iv, iu]) * (nv - 1)
            n = np.stack([-dzdu, -dzdv, np.ones_like(dzdu)], axis=-1)
            return n

        return _grid_mesh(o2w, reverse, None, pfn, nfn, nu - 1, nv - 1, (0, 1), (0, 1), False)
    if name == "sphere":
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", -radius)
        z_max = params.find_one_float("zmax", radius)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))
        return SphereData(
            o2w=o2w.m[None].astype(np.float64),
            w2o=o2w.m_inv[None].astype(np.float64),
            radius=np.array([radius], dtype=float_t),
            z_min=np.array([np.clip(min(z_min, z_max), -radius, radius)], dtype=float_t),
            z_max=np.array([np.clip(max(z_min, z_max), -radius, radius)], dtype=float_t),
            phi_max=np.array([np.clip(phi_max, 0.0, two_pi)], dtype=float_t),
            reverse_orientation=np.array([reverse]),
        )
    if name == "disk":
        h = params.find_one_float("height", 0.0)
        radius = params.find_one_float("radius", 1.0)
        inner = params.find_one_float("innerradius", 0.0)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))

        def pfn(uu, vv):
            # u: phi, v: radius from outer (v=0) to inner (v=1), pbrt disk param
            r = radius + (inner - radius) * vv
            return np.stack([r * np.cos(uu), r * np.sin(uu), np.full_like(uu, h)], axis=-1)

        def nfn(uu, vv):
            return np.broadcast_to(
                np.array([0.0, 0.0, 1.0]), uu.shape + (3,)
            ).copy()

        return _grid_mesh(o2w, reverse, None, pfn, nfn, TESS_U, 2, (0, phi_max), (0, 1), phi_max >= two_pi - 1e-6)
    if name == "cylinder":
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", -1.0)
        z_max = params.find_one_float("zmax", 1.0)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))

        def pfn(uu, vv):
            return np.stack(
                [radius * np.cos(uu), radius * np.sin(uu), z_min + vv * (z_max - z_min)],
                axis=-1,
            )

        def nfn(uu, vv):
            return np.stack([np.cos(uu), np.sin(uu), np.zeros_like(uu)], axis=-1)

        return _grid_mesh(o2w, reverse, None, pfn, nfn, TESS_U, TESS_V, (0, phi_max), (0, 1), True)
    if name == "cone":
        radius = params.find_one_float("radius", 1.0)
        height = params.find_one_float("height", 1.0)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))

        def pfn(uu, vv):
            r = radius * (1 - vv)
            return np.stack([r * np.cos(uu), r * np.sin(uu), vv * height], axis=-1)

        def nfn(uu, vv):
            # surface normal of cone x^2+y^2 = (r(1-z/h))^2
            return np.stack(
                [height * np.cos(uu), height * np.sin(uu), np.full_like(uu, radius)],
                axis=-1,
            )

        return _grid_mesh(o2w, reverse, None, pfn, nfn, TESS_U, TESS_V, (0, phi_max), (0, 1 - 1e-4), True)
    if name == "paraboloid":
        radius = params.find_one_float("radius", 1.0)
        z_min = params.find_one_float("zmin", 0.0)
        z_max = params.find_one_float("zmax", 1.0)
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))
        k = z_max / (radius * radius)

        def pfn(uu, vv):
            z = z_min + vv * (z_max - z_min)
            r = np.sqrt(np.maximum(z / k, 0.0))
            return np.stack([r * np.cos(uu), r * np.sin(uu), z], axis=-1)

        def nfn(uu, vv):
            z = z_min + vv * (z_max - z_min)
            r = np.sqrt(np.maximum(z / k, 1e-12))
            # gradient of (x^2+y^2 - z/k)
            return np.stack(
                [2 * r * np.cos(uu), 2 * r * np.sin(uu), -np.full_like(uu, 1.0 / k)],
                axis=-1,
            )

        return _grid_mesh(o2w, reverse, None, pfn, nfn, TESS_U, TESS_V, (0, phi_max), (1e-4, 1), True)
    if name == "hyperboloid":
        p1 = params.find_one_point3f("p1", np.array([0.0, 0.0, 0.0]))
        p2 = params.find_one_point3f("p2", np.array([1.0, 1.0, 1.0]))
        phi_max = np.deg2rad(params.find_one_float("phimax", 360.0))

        def pfn(uu, vv):
            # line from p1 to p2 revolved around z (pbrt-v3 §3.8.3)
            pr = p1[None, None] * (1 - vv[..., None]) + p2[None, None] * vv[..., None]
            x = pr[..., 0] * np.cos(uu) - pr[..., 1] * np.sin(uu)
            y = pr[..., 0] * np.sin(uu) + pr[..., 1] * np.cos(uu)
            return np.stack([x, y, pr[..., 2]], axis=-1)

        def nfn(uu, vv):
            eps = 1e-4
            p = pfn(uu, vv)
            pu = pfn(uu + eps, vv)
            pv = pfn(uu, np.minimum(vv + eps, 1.0))
            du = pu - p
            dv = pv - p
            return np.cross(du, dv)

        return _grid_mesh(o2w, reverse, None, pfn, nfn, TESS_U, TESS_V, (0, phi_max), (0, 1), True)
    if name == "loopsubdiv":
        from pbrt_tpu.shapes.loopsubdiv import loop_subdivide

        return loop_subdivide(params, o2w, reverse)
    if name == "curve":
        from pbrt_tpu.shapes.curve import make_curve

        return make_curve(params, o2w, reverse)
    if name == "nurbs":
        from pbrt_tpu.shapes.nurbs import make_nurbs

        return make_nurbs(params, o2w, reverse)
    log.error("Shape '%s' unknown.", name)
    return None


def concat_triangle_data(parts):
    """Concatenate TriangleData batches, densifying missing normals."""
    parts = [p for p in parts if p is not None and p.count > 0]
    if not parts:
        return None

    def normals_of(td):
        if td.n0 is not None:
            return td.n0, td.n1, td.n2
        e1 = td.p1 - td.p0
        e2 = td.p2 - td.p0
        ng = np.cross(e1, e2)
        n = np.linalg.norm(ng, axis=-1, keepdims=True)
        ng = ng / np.where(n == 0, 1.0, n)
        return ng, ng, ng

    n0s, n1s, n2s = zip(*(normals_of(p) for p in parts))

    def tangents_of(td):
        # zero tangent marks "not a curve"; hair lanes never read these
        if td.tan0 is not None:
            return td.tan0, td.tan1, td.tan2
        z = np.zeros_like(td.p0)
        return z, z, z

    has_tan = any(p.tan0 is not None for p in parts)
    t0s = t1s = t2s = None
    if has_tan:
        t0s, t1s, t2s = zip(*(tangents_of(p) for p in parts))
    return TriangleData(
        p0=np.concatenate([p.p0 for p in parts]),
        p1=np.concatenate([p.p1 for p in parts]),
        p2=np.concatenate([p.p2 for p in parts]),
        uv0=np.concatenate([p.uv0 for p in parts]),
        uv1=np.concatenate([p.uv1 for p in parts]),
        uv2=np.concatenate([p.uv2 for p in parts]),
        n0=np.concatenate(n0s),
        n1=np.concatenate(n1s),
        n2=np.concatenate(n2s),
        tan0=np.concatenate(t0s) if has_tan else None,
        tan1=np.concatenate(t1s) if has_tan else None,
        tan2=np.concatenate(t2s) if has_tan else None,
    )
