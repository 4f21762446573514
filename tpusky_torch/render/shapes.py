"""Analytic shapes with brute-force vectorised intersection.

The shapes of `tpusky/render/shapes.py`: every ray tests every shape in
closed form and the closest hit wins by a masked minimum. Shapes are
canonical objects under an affine transform: 0 = unit sphere, 1 =
rectangle [-1,1]^2 in z=0, 2 = unit disk in z=0, 3 = cube [-1,1]^3, 4 =
cylinder (unit radius, z in [0,1], open-ended). A shape may carry an
area emitter (`emitter_idx >= 0`), sampled uniformly in area by
`sample_position`; a cube may not (R8 below).
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import (PI, dot, mat3_apply, mat3_apply_t, normalize,
                        safe_acos, safe_sqrt)

SPHERE, RECTANGLE, DISK, CUBE, CYLINDER = 0, 1, 2, 3, 4
KINDS = (SPHERE, RECTANGLE, DISK, CUBE, CYLINDER)

_RAY_EPS = 1e-4


class ShapeTable(NamedTuple):
    """SoA shape set. `kind` is a tuple of Python ints, so the intersection
    loop picks one closed form per shape when it is built."""
    kind: tuple                  # (N,) ints
    to_world: torch.Tensor       # (N, 4, 4) affine object->world
    to_object: torch.Tensor      # (N, 4, 4) inverse
    bsdf_idx: torch.Tensor       # (N,) int64 index into the BSDF table
    emitter_idx: torch.Tensor    # (N,) int64 area-emitter index (-1 = none)
    area: torch.Tensor           # (N,) world-space surface area


def check_emitters(kinds, emitter_idx):
    """Refuse an area emitter on a cube. The reference's `sample_position`
    has no cube branch: a cube takes the unit sphere's sample
    (`tpusky/render/shapes.py:169-179`), a point inside the cube whose
    shadow ray the cube's own faces block, so its area NEE is biased
    (R8 in ROADMAP.md)."""
    for k, e in zip(kinds, np.asarray(emitter_idx).reshape(-1)):
        if int(k) == CUBE and int(e) >= 0:
            raise NotImplementedError(
                "an area emitter on a cube (R8: the reference samples a "
                "cube emitter as the unit sphere inside it)")


def _world_area(kind: int, t2w) -> float:
    """Surface area of the canonical shape under an affine transform, in
    float64 on the host: exact for rectangles and disks, spheres and
    cylinders exact under uniform scaling, cubes from the mean face
    scaling (`tpusky/render/shapes.py:56-84`)."""
    lin = np.asarray(t2w, np.float64)[:3, :3]
    c01 = np.linalg.norm(np.cross(lin[:, 0], lin[:, 1]))
    if kind == RECTANGLE:
        return 4.0 * c01
    if kind == DISK:
        return np.pi * c01
    if kind == SPHERE:
        return 4.0 * np.pi * np.abs(np.linalg.det(lin)) ** (2.0 / 3.0)
    c12 = np.linalg.norm(np.cross(lin[:, 1], lin[:, 2]))
    c02 = np.linalg.norm(np.cross(lin[:, 0], lin[:, 2]))
    if kind == CYLINDER:
        return np.pi * (c02 + c12)
    return 8.0 * (c01 + c12 + c02)          # cube


def make_shape_table(shapes, device="cuda") -> ShapeTable:
    """Build a ShapeTable from a list of dicts {kind, to_world (4x4),
    bsdf_idx, emitter_idx}."""
    n = len(shapes)
    kind = np.zeros((n,), np.int32)
    t2w = np.zeros((n, 4, 4), np.float32)
    bsdf = np.zeros((n,), np.int64)
    emit = np.full((n,), -1, np.int64)
    area = np.zeros((n,), np.float32)
    for i, s in enumerate(shapes):
        if s["kind"] not in KINDS:
            raise NotImplementedError(f"shape kind {s['kind']}")
        kind[i] = s["kind"]
        t2w[i] = np.asarray(s.get("to_world", np.eye(4)), np.float32)
        bsdf[i] = s.get("bsdf_idx", 0)
        emit[i] = s.get("emitter_idx", -1)
        area[i] = _world_area(int(kind[i]), t2w[i])
    check_emitters(kind, emit)
    t2o = np.linalg.inv(t2w)
    return ShapeTable(tuple(int(k) for k in kind),
                      torch.tensor(t2w, device=device),
                      torch.tensor(t2o, device=device),
                      torch.tensor(bsdf, device=device),
                      torch.tensor(emit, device=device),
                      torch.tensor(area, device=device))


def _rows(m, v, transpose=False):
    """Per-lane (..., 4, 4) linear part times (..., 3), summed in the
    reference's order (`tpusky/render/shapes.py:185-194`)."""
    a = m[..., :3, :3]
    if transpose:
        return (v[..., 0:1] * a[..., 0, :] + v[..., 1:2] * a[..., 1, :]
                + v[..., 2:3] * a[..., 2, :])
    return (v[..., 0:1] * a[..., :, 0] + v[..., 1:2] * a[..., :, 1]
            + v[..., 2:3] * a[..., :, 2])


@lru_cache(maxsize=None)
def _kinds_on(kinds: tuple, device: torch.device) -> torch.Tensor:
    """A table's shape kinds as an int64 tensor on a device, copied once
    (a render then makes no host-device copy for them)."""
    return torch.tensor(kinds, dtype=torch.int64, device=device)


def sample_position(table: ShapeTable, shape_idx, u2):
    """Uniform-area sample on the lanes' shapes -> (p_world, n_world,
    pdf_area = 1 / area). shape_idx (...,) int64, u2 (..., 2). Rectangle,
    disk, sphere and cylinder; each lane gathers its shape's rows (the
    tables refuse a cube emitter, `check_emitters`)."""
    kind = _kinds_on(tuple(table.kind), u2.device)[shape_idx]
    t2w = table.to_world[shape_idx]
    t2o = table.to_object[shape_idx]
    inv_area = 1.0 / table.area[shape_idx]
    zero = torch.zeros_like(u2[..., 0])
    p_rect = torch.stack([2.0 * u2[..., 0] - 1.0, 2.0 * u2[..., 1] - 1.0,
                          zero], -1)
    r = torch.sqrt(u2[..., 0])
    phi = 2.0 * PI * u2[..., 1]
    cos_phi, sin_phi = torch.cos(phi), torch.sin(phi)
    p_disk = torch.stack([r * cos_phi, r * sin_phi, zero], -1)
    z = 1.0 - 2.0 * u2[..., 0]
    sr = safe_sqrt(1.0 - z * z)
    p_sph = torch.stack([sr * cos_phi, sr * sin_phi, z], -1)
    p_cyl = torch.stack([cos_phi, sin_phi, u2[..., 0]], -1)
    n_cyl = torch.stack([cos_phi, sin_phi, zero], -1)
    n_plane = torch.stack([zero, zero, torch.ones_like(zero)], -1)

    is_rect = (kind == RECTANGLE)[..., None]
    is_disk = (kind == DISK)[..., None]
    is_cyl = (kind == CYLINDER)[..., None]
    p_local = torch.where(is_rect, p_rect, torch.where(
        is_disk, p_disk, torch.where(is_cyl, p_cyl, p_sph)))
    n_local = torch.where(is_rect | is_disk, n_plane,
                          torch.where(is_cyl, n_cyl, p_sph))
    p_world = _rows(t2w, p_local) + t2w[..., :3, 3]
    n_world = normalize(_rows(t2o, n_local, transpose=True))
    return p_world, n_world, inv_area


def _isect_sphere(o, d):
    """Unit sphere |o + t d|^2 = 1 -> (t, local normal, hit)."""
    a = dot(d, d)
    b = 2.0 * dot(o, d)
    c = dot(o, o) - 1.0
    disc = b * b - 4.0 * a * c
    sq = safe_sqrt(disc)
    q = -0.5 * (b + torch.sign(b) * sq)
    t0 = q / a
    t1 = c / torch.where(q == 0.0, 1.0, q)
    tn, tf = torch.minimum(t0, t1), torch.maximum(t0, t1)
    inf = torch.inf
    t = torch.where(tn > _RAY_EPS, tn, torch.where(tf > _RAY_EPS, tf, inf))
    t = torch.where(disc >= 0.0, t, inf)
    hit = torch.isfinite(t)
    pp = o + torch.where(hit, t, 0.0)[..., None] * d
    return t, pp, hit           # normal == position on the unit sphere


def _isect_plane(o, d, disk: bool):
    """z = 0 plane clipped to the unit rectangle/disk."""
    dz = d[..., 2]
    t_pl = -o[..., 2] / torch.where(dz == 0.0, 1.0, dz)
    pp = o + t_pl[..., None] * d
    if disk:
        inside = pp[..., 0] ** 2 + pp[..., 1] ** 2 <= 1.0
    else:
        inside = (pp[..., 0].abs() <= 1.0) & (pp[..., 1].abs() <= 1.0)
    ok = (dz != 0.0) & (t_pl > _RAY_EPS) & inside
    t = torch.where(ok, t_pl, torch.inf)
    n = torch.zeros_like(pp)
    n[..., 2] = 1.0
    return t, n, ok


def _isect_cylinder(o, d):
    """x^2 + y^2 = 1, z in [0, 1], open-ended."""
    a_cy = d[..., 0] ** 2 + d[..., 1] ** 2
    b_cy = 2.0 * (o[..., 0] * d[..., 0] + o[..., 1] * d[..., 1])
    c_cy = o[..., 0] ** 2 + o[..., 1] ** 2 - 1.0
    disc = b_cy * b_cy - 4.0 * a_cy * c_cy
    sq = safe_sqrt(disc)
    a_safe = torch.where(a_cy == 0.0, 1.0, a_cy)
    t0 = (-b_cy - sq) / (2.0 * a_safe)
    t1 = (-b_cy + sq) / (2.0 * a_safe)

    def valid(tc):
        z = o[..., 2] + tc * d[..., 2]
        return (tc > _RAY_EPS) & (z >= 0.0) & (z <= 1.0)

    inf = torch.inf
    t = torch.where(valid(t0), t0, torch.where(valid(t1), t1, inf))
    t = torch.where((disc >= 0.0) & (a_cy > 0.0), t, inf)
    hit = torch.isfinite(t)
    pp = o + torch.where(hit, t, 0.0)[..., None] * d
    n = torch.stack([pp[..., 0], pp[..., 1], torch.zeros_like(t)], -1)
    return t, n, hit


def _isect_cube(o, d):
    """Slab test on [-1, 1]^3; the normal is the axis of the largest
    |coordinate| at the hit (the first on a tie, as `jnp.argmax`)."""
    inv_d = 1.0 / torch.where(d == 0.0, 1e-20, d)
    tl = (-1.0 - o) * inv_d
    th = (1.0 - o) * inv_d
    t_near = torch.minimum(tl, th).amax(-1)
    t_far = torch.maximum(tl, th).amin(-1)
    hit = (t_near <= t_far) & (t_far > _RAY_EPS)
    t = torch.where(hit, torch.where(t_near > _RAY_EPS, t_near, t_far),
                    torch.inf)
    hit = hit & torch.isfinite(t)
    pp = o + torch.where(torch.isfinite(t), t, 0.0)[..., None] * d
    axis = pp.abs().argmax(-1)
    onehot = torch.arange(3, device=o.device) == axis[..., None]
    return t, torch.sign(pp) * onehot, hit


def _intersect_one(kind: int, o_l, d_l):
    if kind == SPHERE:
        return _isect_sphere(o_l, d_l)
    if kind in (RECTANGLE, DISK):
        return _isect_plane(o_l, d_l, disk=(kind == DISK))
    if kind == CYLINDER:
        return _isect_cylinder(o_l, d_l)
    if kind == CUBE:
        return _isect_cube(o_l, d_l)
    raise NotImplementedError(f"shape kind {kind}")


def _to_local(shapes: ShapeTable, s: int, o, d):
    m = shapes.to_object[s]
    lin = m[:3, :3]
    return lin, mat3_apply(lin, o) + m[:3, 3], mat3_apply(lin, d)


def _local_uv(kind: int, pp):
    """Texture coordinates at a local hit point pp (..., 3), the
    reference's convention for each kind (`tpusky/render/shapes.py:
    228-231, 247, 271-274, 290`): a sphere's longitude and colatitude, a
    rectangle's or disk's (x, y) mapped to [0, 1], a cylinder's longitude
    and height; a cube has none (zeros)."""
    if kind in (SPHERE, CYLINDER):
        u = torch.atan2(pp[..., 1], pp[..., 0]) / (2 * PI) + 0.5
        v = (safe_acos(pp[..., 2]) / PI if kind == SPHERE
             else pp[..., 2].clamp(0.0, 1.0))
        return torch.stack([u, v], -1)
    if kind in (RECTANGLE, DISK):
        return 0.5 * (pp[..., :2] + 1.0)
    return torch.zeros_like(pp[..., :2])


def ray_intersect(shapes: ShapeTable, o, d, uv: bool = False):
    """Closest-hit intersection of world rays against every shape.
    o, d: (..., 3) -> (t, p, n (unit, world), shape_idx, hit); with `uv`,
    (t, p, n, uv (..., 2), shape_idx, hit), uv 0 on a miss, as the
    reference's. Only a textured scene asks for uv."""
    batch = o.shape[:-1]
    best_t = torch.full(batch, torch.inf, device=o.device)
    best_n = torch.zeros(batch + (3,), device=o.device)
    best_uv = torch.zeros(batch + (2,), device=o.device) if uv else None
    best_idx = torch.full(batch, -1, dtype=torch.long, device=o.device)
    for s, kind in enumerate(shapes.kind):
        lin, o_l, d_l = _to_local(shapes, s, o, d)
        t, n_l, hit = _intersect_one(kind, o_l, d_l)
        # world normal: inverse-transpose of object->world == to_object^T
        n_w = mat3_apply_t(lin, n_l)
        closer = hit & (t < best_t)
        best_t = torch.where(closer, t, best_t)
        best_n = torch.where(closer[..., None], n_w, best_n)
        best_idx = torch.where(closer, s, best_idx)
        if uv:
            pp = o_l + torch.where(hit, t, 0.0)[..., None] * d_l
            best_uv = torch.where(closer[..., None], _local_uv(kind, pp),
                                  best_uv)

    valid = torch.isfinite(best_t) & (best_idx >= 0)
    # made on the device: torch.tensor of Python numbers (or an item set
    # from one) would copy from the host and wait for the device
    up = torch.eye(3, device=o.device)[2]
    best_n = normalize(torch.where(valid[..., None], best_n, up))
    p = o + torch.where(valid, best_t, 0.0)[..., None] * d
    if uv:
        return best_t, p, best_n, best_uv, best_idx, valid
    return best_t, p, best_n, best_idx, valid


def ray_test(shapes: ShapeTable, o, d, maxt):
    """Shadow-ray predicate: does anything lie within (eps, maxt)? maxt a
    scalar or (...,)."""
    occluded = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    for s, kind in enumerate(shapes.kind):
        _, o_l, d_l = _to_local(shapes, s, o, d)
        t, _, hit = _intersect_one(kind, o_l, d_l)
        occluded = occluded | (hit & (t < maxt))
    return occluded
