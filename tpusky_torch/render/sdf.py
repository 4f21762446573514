"""Signed-distance grids (Mitsuba's `sdfgrid.cpp`), `tpusky/render/sdf.py`
in PyTorch.

A trilinear SDF sampled on a regular D^3 grid over the unit cube [0, 1]^3
(nodes at i / (D - 1)), placed by an affine to_world. A ray is sphere
traced in the grid's local space for a fixed `_N_STEPS` steps, detached:
the march only locates the root. One attached Newton step

    t* = t - sdf(o + t d) / <grad sdf, d>

then carries the hit distance through the implicit function theorem, so
gradients reach the grid's values and the transform without going
through the march (the reference's stand-in for `sdfgrid.cpp`'s
differentiable position).

A lookup reads one int64 cell index a lane and gathers that cell's eight
corners from an (8, (D-1)^3) corner table (`_corner_table`), the layout
of `render/medium.py`'s density grid. The march runs without autograd; a
fixed step count keeps it free of host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .medium import _take

_N_STEPS = 64           # sphere-tracing steps
_HIT_EPS = 1e-4         # |sdf| below this is a hit
_RAY_EPS = 1e-4


class SDFGrid(NamedTuple):
    values: torch.Tensor    # (D, D, D) signed distances at the nodes
    to_local: torch.Tensor  # (4, 4) world -> unit cube
    to_world: torch.Tensor  # (4, 4)
    bsdf_idx: int           # the material row


def make_sdf_grid(values, to_world=None, bsdf_idx: int = 0,
                  device="cuda") -> SDFGrid:
    """A grid of node values (D, D, D), indexed [x, y, z], placed by
    to_world (4, 4; identity when None), its inverse taken on the host in
    float32 as the reference's."""
    t2w = (np.eye(4, dtype=np.float32) if to_world is None
           else np.asarray(to_world, np.float32))

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return SDFGrid(f32(values), f32(np.linalg.inv(t2w)), f32(t2w),
                   int(bsdf_idx))


def sphere_sdf_grid(res: int = 32, radius: float = 0.4,
                    center=(0.5, 0.5, 0.5)) -> np.ndarray:
    """An analytic sphere baked onto a res^3 grid (`sdfgrid.cpp`'s
    example)."""
    g = (np.arange(res) + 0.0) / (res - 1)
    x, y, z = np.meshgrid(g, g, g, indexing="ij")
    c = np.asarray(center)
    return (np.sqrt((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
            - radius).astype(np.float32)


def _corner_table(values):
    """(8, (D-1)^3) each cell's corners, rows in (dx, dy, dz) bit order
    [c000, c001, c010, c011, c100, c101, c110, c111]; cell (ix, iy, iz) at
    (ix (D-1) + iy) (D-1) + iz."""
    d = values.shape[0] - 1
    return torch.stack([values[dx:dx + d, dy:dy + d, dz:dz + d].reshape(-1)
                        for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)])


def _trilinear(table, n_nodes: int, p):
    """The trilinear field at local points p (..., 3), clamped to
    [0, 1]^3 (`tpusky/render/sdf.py:69-96`), from its corner table."""
    d = n_nodes - 1
    q = p.clamp(0.0, 1.0) * d
    i0 = q.to(torch.int64).clamp(0, d - 1)
    f = q - i0
    ix, iy, iz = i0.unbind(-1)
    fx, fy, fz = f.unbind(-1)
    cell = (ix * d + iy) * d + iz
    c = [_take(table[k], cell) for k in range(8)]
    c00 = c[0] * (1 - fz) + c[1] * fz
    c01 = c[2] * (1 - fz) + c[3] * fz
    c10 = c[4] * (1 - fz) + c[5] * fz
    c11 = c[6] * (1 - fz) + c[7] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def _to_local(a, p):
    """The affine (4, 4) `a` applied to points (..., 3)."""
    return p @ a[:3, :3].T + a[:3, 3]


def sdf_eval(sdf: SDFGrid, p_world):
    """The SDF at world points (a local-space distance)."""
    return _trilinear(_corner_table(sdf.values), sdf.values.shape[0],
                      _to_local(sdf.to_local, p_world))


def _grad_local(table, n_nodes: int, p, eps=1e-3):
    """The central-difference gradient of the trilinear field (local)."""
    steps = torch.eye(3, dtype=p.dtype, device=p.device) * eps
    return torch.stack([(_trilinear(table, n_nodes, p + e)
                         - _trilinear(table, n_nodes, p - e)) / (2 * eps)
                        for e in steps], -1)


def _cube_interval(ol, dl):
    """The ray's overlap with the unit cube -> (t0, t1, overlaps)."""
    tiny = torch.where(dl >= 0, 1e-12, -1e-12)
    inv = 1.0 / torch.where(dl.abs() < 1e-12, tiny, dl)
    ta = (0.0 - ol) * inv
    tb = (1.0 - ol) * inv
    t0 = torch.minimum(ta, tb).amax(-1)
    t1 = torch.maximum(ta, tb).amin(-1)
    ok = (t0 <= t1) & (t1 > _RAY_EPS)
    return t0.clamp(min=_RAY_EPS), t1, ok


def _march(table, n_nodes: int, ol, dl, t0, t1, box_ok):
    """`_N_STEPS` sphere-tracing steps from t0 -> the last t (inf where
    the ray misses the cube)."""
    t = torch.where(box_ok, t0, torch.inf)
    done = ~box_ok
    for _ in range(_N_STEPS):
        s = _trilinear(table, n_nodes, ol + t[..., None] * dl)
        hit_now = s.abs() < _HIT_EPS
        adv = torch.where(done | hit_now, 0.0, s.clamp(min=_HIT_EPS))
        t = t + adv
        done = done | hit_now | (t > t1)
    return t


def sdf_intersect(sdf: SDFGrid, o, d):
    """Sphere-trace world rays -> (t_world, n_world, hit): the march in
    local space (the SDF's metric), then one attached Newton step; t
    converted back through the direction's length."""
    a = sdf.to_local
    n_nodes = sdf.values.shape[0]
    table = _corner_table(sdf.values)
    ol = _to_local(a, o)
    dl_raw = d @ a[:3, :3].T
    dscale = torch.linalg.vector_norm(dl_raw, dim=-1)
    dl = dl_raw / dscale.clamp(min=1e-12)[..., None]
    t0, t1, box_ok = _cube_interval(ol, dl)
    with torch.no_grad():
        t_m = _march(table.detach(), n_nodes, ol.detach(), dl.detach(),
                     t0.detach(), t1.detach(), box_ok)
        # a lane that misses the cube ends at inf; it takes t = 0 from here
        # on, so that no NaN reaches the gradient through it (the
        # reference's o + inf d is NaN there)
        finite = torch.isfinite(t_m)
        t_m = torch.where(finite, t_m, 0.0)
        p_m = ol.detach() + t_m[..., None] * dl.detach()
        s_final = _trilinear(table.detach(), n_nodes, p_m)
    hit = box_ok & (s_final.abs() < 10 * _HIT_EPS) & finite

    # one attached Newton step: implicit-function-theorem gradients
    grad = _grad_local(table, n_nodes, p_m)
    denom = (grad * dl).sum(-1)
    s_att = _trilinear(table, n_nodes, p_m)
    tiny = torch.where(denom >= 0, 1e-6, -1e-6)
    t_att = t_m - s_att / torch.where(denom.abs() < 1e-6, tiny, denom)
    n_local = grad / torch.linalg.vector_norm(grad, dim=-1,
                                              keepdim=True).clamp(min=1e-9)
    # normals by the inverse transpose's linear part
    n_world = n_local @ a[:3, :3]
    n_world = n_world / torch.linalg.vector_norm(
        n_world, dim=-1, keepdim=True).clamp(min=1e-9)
    t_world = torch.where(hit, t_att / dscale.clamp(min=1e-12), torch.inf)
    return t_world, n_world, hit


def sdf_test(sdf: SDFGrid, o, d, maxt):
    """Any hit within maxt -> bool (...,)."""
    t, _, hit = sdf_intersect(sdf, o, d)
    return hit & (t < maxt)
