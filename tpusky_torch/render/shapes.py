"""Analytic shapes with brute-force vectorised intersection.

The sphere, rectangle and disk of `tpusky/render/shapes.py`: every ray
tests every shape in closed form and the closest hit wins by a masked
minimum. Shapes are canonical objects under an affine transform:
0 = unit sphere, 1 = rectangle [-1,1]^2 in z=0, 2 = unit disk in z=0.
Cubes and cylinders (kinds 3, 4) are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import dot, mat3_apply, mat3_apply_t, normalize, safe_sqrt

SPHERE, RECTANGLE, DISK = 0, 1, 2
KINDS = (SPHERE, RECTANGLE, DISK)

_RAY_EPS = 1e-4


class ShapeTable(NamedTuple):
    """SoA shape set. `kind` is a tuple of Python ints, so the intersection
    loop picks one closed form per shape when it is built."""
    kind: tuple                  # (N,) ints
    to_world: torch.Tensor       # (N, 4, 4) affine object->world
    to_object: torch.Tensor      # (N, 4, 4) inverse
    bsdf_idx: torch.Tensor       # (N,) int64 index into the BSDF table


def make_shape_table(shapes, device="cuda") -> ShapeTable:
    """Build a ShapeTable from a list of dicts {kind, to_world (4x4),
    bsdf_idx}."""
    n = len(shapes)
    kind = np.zeros((n,), np.int32)
    t2w = np.zeros((n, 4, 4), np.float32)
    bsdf = np.zeros((n,), np.int64)
    for i, s in enumerate(shapes):
        if s["kind"] not in KINDS:
            raise NotImplementedError(f"shape kind {s['kind']}")
        if s.get("emitter_idx", -1) >= 0:
            raise NotImplementedError("area emitters")
        kind[i] = s["kind"]
        t2w[i] = np.asarray(s.get("to_world", np.eye(4)), np.float32)
        bsdf[i] = s.get("bsdf_idx", 0)
    t2o = np.linalg.inv(t2w)
    return ShapeTable(tuple(int(k) for k in kind),
                      torch.tensor(t2w, device=device),
                      torch.tensor(t2o, device=device),
                      torch.tensor(bsdf, device=device))


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


def _intersect_one(kind: int, o_l, d_l):
    if kind == SPHERE:
        return _isect_sphere(o_l, d_l)
    if kind in (RECTANGLE, DISK):
        return _isect_plane(o_l, d_l, disk=(kind == DISK))
    raise NotImplementedError(f"shape kind {kind}")


def _to_local(shapes: ShapeTable, s: int, o, d):
    m = shapes.to_object[s]
    lin = m[:3, :3]
    return lin, mat3_apply(lin, o) + m[:3, 3], mat3_apply(lin, d)


def ray_intersect(shapes: ShapeTable, o, d):
    """Closest-hit intersection of world rays against every shape.
    o, d: (..., 3) -> (t, p, n (unit, world), shape_idx, hit)."""
    batch = o.shape[:-1]
    best_t = torch.full(batch, torch.inf, device=o.device)
    best_n = torch.zeros(batch + (3,), device=o.device)
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

    valid = torch.isfinite(best_t) & (best_idx >= 0)
    up = torch.tensor([0.0, 0.0, 1.0], device=o.device)
    best_n = normalize(torch.where(valid[..., None], best_n, up))
    p = o + torch.where(valid, best_t, 0.0)[..., None] * d
    return best_t, p, best_n, best_idx, valid


def ray_test(shapes: ShapeTable, o, d, maxt):
    """Shadow-ray predicate: does anything lie within (eps, maxt)?"""
    occluded = torch.zeros(o.shape[:-1], dtype=torch.bool, device=o.device)
    for s, kind in enumerate(shapes.kind):
        _, o_l, d_l = _to_local(shapes, s, o, d)
        t, _, hit = _intersect_one(kind, o_l, d_l)
        occluded = occluded | (hit & (t < maxt))
    return occluded
