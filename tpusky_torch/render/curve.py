"""Curves: B-spline and linear curves as tables of rounded cones
(Mitsuba's `bsplinecurve.cpp` and `linearcurve.cpp`), `tpusky/render/
curve.py` in PyTorch.

Each curve is flattened on the host into sphere-swept segments whose
radius varies linearly along them: a linear curve joins its control
points, a cubic uniform B-spline gives `subdiv` segments a span through
the basis B(t) = 1/6 [(1-t)^3, 3t^3 - 6t^2 + 4, -3t^3 + 3t^2 + 3t + 1,
t^3]. The table is padded to a multiple of 128 segments.

A ray meets a rounded cone in closed form (the body's quadratic and two
sphere caps, `_cone_parts`). `curve_intersect` walks the 128-segment
tiles as the reference does, every lane against every segment of a tile,
the closest by the first minimum and tiles merged by a strict `<`, with
at most `_LANES` lanes at once so that the (lanes, 128) temporaries stay
bounded (the layout of `render/mesh.py`'s plain version). That walk runs
without autograd and finds each lane's segment; the winning segment's
hit, normal and tangent are then computed again a lane, attached, by the
same operations, so a hit equals the walk's and its gradient is the
reference's without a (lanes, 128) tape. There is no kernel: the dense
walk is the reference's algorithm on any device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import safe_sqrt, unit

_TILE = 128
_RAY_EPS = 1e-4
# lanes a step of the walk: cache-sized on the CPU, fewer launches on the
# card
_LANES = {"cpu": 1 << 12, "cuda": 1 << 18}


class CurveTable(NamedTuple):
    """Every curve segment of a scene, padded to a tile multiple: segment
    i sweeps a sphere from (pa, ra) to (pb, rb)."""
    pa: torch.Tensor        # (S, 3)
    pb: torch.Tensor        # (S, 3)
    ra: torch.Tensor        # (S,)
    rb: torch.Tensor        # (S,)
    bsdf_idx: torch.Tensor  # (S,) int64
    valid: torch.Tensor     # (S,) bool, False on padding


def _bspline_flatten(pts: np.ndarray, radii: np.ndarray, subdiv: int):
    """Cubic uniform B-spline -> polyline (points, radii)."""
    n = len(pts)
    if n < 4:
        return pts, radii
    out_p, out_r = [], []
    ts = np.linspace(0.0, 1.0, subdiv + 1)
    for s in range(n - 3):
        p = pts[s:s + 4]
        r = radii[s:s + 4]
        t = ts[:-1] if s < n - 4 else ts
        b0 = (1 - t) ** 3 / 6.0
        b1 = (3 * t ** 3 - 6 * t ** 2 + 4) / 6.0
        b2 = (-3 * t ** 3 + 3 * t ** 2 + 3 * t + 1) / 6.0
        b3 = t ** 3 / 6.0
        basis = np.stack([b0, b1, b2, b3], axis=-1)     # (K, 4)
        out_p.append(basis @ p)
        out_r.append(basis @ r)
    return np.concatenate(out_p), np.concatenate(out_r)


def make_curve_table(curves, subdiv: int = 8, device="cuda") -> CurveTable:
    """curves: dicts {points (P, 3), radii (P,) or radius (float, 0.1 by
    default), kind 'linear' or 'bspline' (the default), to_world (4, 4),
    bsdf_idx} -> the table on `device`, built on the host as the
    reference's (radii scaled by the cube root of the linear part's
    determinant)."""
    pas, pbs, ras, rbs, mats = [], [], [], [], []
    for c in curves:
        pts = np.asarray(c["points"], np.float32)
        radii = c.get("radii")
        if radii is None:
            radii = np.full((len(pts),), float(c.get("radius", 0.1)),
                            np.float32)
        else:
            radii = np.asarray(radii, np.float32)
        t2w = np.asarray(c.get("to_world", np.eye(4)), np.float32)
        pts = pts @ t2w[:3, :3].T + t2w[:3, 3]
        radii = radii * float(np.cbrt(abs(np.linalg.det(t2w[:3, :3]))))
        if c.get("kind", "bspline") == "bspline":
            pts, radii = _bspline_flatten(pts, radii, subdiv)
        pas.append(pts[:-1])
        pbs.append(pts[1:])
        ras.append(radii[:-1])
        rbs.append(radii[1:])
        mats.append(np.full((len(pts) - 1,), c.get("bsdf_idx", 0), np.int64))
    pa = np.concatenate(pas) if pas else np.zeros((0, 3), np.float32)
    pb = np.concatenate(pbs) if pbs else np.zeros((0, 3), np.float32)
    ra = np.concatenate(ras) if ras else np.zeros((0,), np.float32)
    rb = np.concatenate(rbs) if rbs else np.zeros((0,), np.float32)
    mat = np.concatenate(mats) if mats else np.zeros((0,), np.int64)
    s = len(pa)
    pad = (-s) % _TILE
    valid = np.concatenate([np.ones((s,), bool), np.zeros((pad,), bool)])
    # padding: tiny far-away cones, masked by `valid`, finite either way
    pad_a = np.full((pad, 3), 1e6, np.float32)
    pad_b = pad_a + np.array([1.0, 0.0, 0.0], np.float32)

    def cat1(a, v):
        return np.concatenate([a, np.full((pad,), v, a.dtype)])

    def dev(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)
    return CurveTable(dev(np.concatenate([pa, pad_a]).astype(np.float32)),
                      dev(np.concatenate([pb, pad_b]).astype(np.float32)),
                      dev(cat1(ra.astype(np.float32), 1e-3)),
                      dev(cat1(rb.astype(np.float32), 1e-3)),
                      dev(cat1(mat, 0), torch.int64),
                      dev(valid, torch.bool))


def read_curve_file(path: str):
    """The reference's ASCII curve format: 'x y z radius' lines, a blank
    line between curves -> [(points (P, 3), radii (P,))]."""
    out, pts = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                if pts:
                    out.append(pts)
                    pts = []
                continue
            vals = [float(v) for v in line.split()]
            pts.append(vals[:4] if len(vals) >= 4 else vals + [0.1])
    if pts:
        out.append(pts)
    return [(np.asarray(p, np.float32)[:, :3],
             np.asarray(p, np.float32)[:, 3]) for p in out]


def _dot3(a, b):
    """a . b over component tuples, each product and sum rounded in the
    reference's order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cone_parts(pa, pb, ra, rb, o, d):
    """The rounded cones (components broadcast against the rays') met by
    rays o, d -> (t of the body, the first cap, the second cap, each inf
    where that part is missed; the body's y; oa; ob; ba; d2), in the
    operations of `tpusky/render/curve.py:139-190`."""
    ba = tuple(b - a for a, b in zip(pa, pb))
    oa = tuple(x - a for x, a in zip(o, pa))
    ob = tuple(x - b for x, b in zip(o, pb))
    rr = ra - rb
    m0 = _dot3(ba, ba)
    m1 = _dot3(ba, oa)
    m2 = _dot3(ba, d)
    m3 = _dot3(d, oa)
    m5 = _dot3(oa, oa)
    m6 = _dot3(ob, d)
    m7 = _dot3(ob, ob)
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra - m0 * ra * ra
    h = k1 * k1 - k0 * k2
    sq = safe_sqrt(h)
    k2s = torch.where(k2.abs() < 1e-12, 1e-12, k2)
    t_body = (-sq - k1) / k2s
    y = m1 - ra * rr + t_body * m2
    body_ok = ((h > 0.0) & (y > 0.0) & (y < d2) & (d2 > 0.0)
               & (t_body > _RAY_EPS))
    # the sphere caps
    h1 = m3 * m3 - m5 + ra * ra
    h2 = m6 * m6 - m7 + rb * rb
    t_ca = -m3 - safe_sqrt(h1)
    t_cb = -m6 - safe_sqrt(h2)
    ca_ok = (h1 > 0.0) & (t_ca > _RAY_EPS)
    cb_ok = (h2 > 0.0) & (t_cb > _RAY_EPS)
    return (torch.where(body_ok, t_body, torch.inf),
            torch.where(ca_ok, t_ca, torch.inf),
            torch.where(cb_ok, t_cb, torch.inf), y, oa, ob, ba, d2)


def _cone_t(t_parts, valid):
    """The closest part's t, inf where no part of a valid cone is hit."""
    t_body, t_ca, t_cb = t_parts
    t = torch.minimum(t_body, torch.minimum(t_ca, t_cb))
    return torch.where(torch.isfinite(t) & valid, t, torch.inf)


def _tile_t(curve: CurveTable, tile: int, o, d):
    """(lanes, 128) t of rays o, d (N, 3) against one tile."""
    sl = slice(tile * _TILE, (tile + 1) * _TILE)
    seg = [x[sl] for x in (curve.pa, curve.pb)]
    pa, pb = (tuple(x[:, c] for c in range(3)) for x in seg)
    oc = tuple(o[:, c:c + 1] for c in range(3))
    dc = tuple(d[:, c:c + 1] for c in range(3))
    parts = _cone_parts(pa, pb, curve.ra[sl], curve.rb[sl], oc, dc)
    return _cone_t(parts[:3], curve.valid[sl])


def _walk(curve: CurveTable, o, d):
    """Each ray's closest segment (int64, -1 on a miss): the tiles in
    order, the first minimum within one, a strict `<` across them."""
    out, step = [], _LANES.get(o.device.type, _LANES["cuda"])
    n_tiles = curve.pa.shape[0] // _TILE
    for r0 in range(0, o.shape[0], step):
        oc, dc = o[r0:r0 + step], d[r0:r0 + step]
        bt = torch.full(oc.shape[:1], torch.inf, device=o.device)
        bseg = torch.full(oc.shape[:1], -1, dtype=torch.int64,
                          device=o.device)
        for tile in range(n_tiles):
            t = _tile_t(curve, tile, oc, dc)
            t_min, local = t.min(-1)
            closer = t_min < bt
            bt = torch.where(closer, t_min, bt)
            bseg = torch.where(closer, tile * _TILE + local, bseg)
        out.append(bseg)
    return torch.cat(out)


def curve_intersect(curve: CurveTable, o, d):
    """Closest hit against every segment -> (t, n, material index, hit,
    tangent): t inf and hit False on a miss; the winning segment's unit
    tangent sets the hair BCSDF's fiber frame (`hair.cpp` wants +y along
    the fiber)."""
    batch = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    with torch.no_grad():
        seg = _walk(curve, o.detach(), d.detach()).clamp(min=0)
    pa, pb = curve.pa[seg], curve.pb[seg]
    t_body, t_ca, t_cb, y, oa, ob, ba, d2 = _cone_parts(
        pa.unbind(-1), pb.unbind(-1), curve.ra[seg], curve.rb[seg],
        o.unbind(-1), d.unbind(-1))
    t = _cone_t((t_body, t_ca, t_cb), curve.valid[seg])
    hit = torch.isfinite(t)
    # the winning part's normal (:184-195)
    t_f = torch.where(hit, t, 0.0)[..., None]
    oa, ob, ba = (torch.stack(x, -1) for x in (oa, ob, ba))
    n_body = d2[..., None] * (oa + t_f * d) - ba * y[..., None]
    n = torch.where((t == t_ca)[..., None], oa + t_f * d,
                    torch.where((t == t_cb)[..., None], ob + t_f * d,
                                n_body))
    n = unit(n)
    tg = unit(pb - pa)
    return (t.reshape(batch), n.reshape(batch + (3,)),
            curve.bsdf_idx[seg].reshape(batch), hit.reshape(batch),
            tg.reshape(batch + (3,)))


def curve_test(curve: CurveTable, o, d, maxt):
    """Any hit within (eps, maxt) -> bool (...,); maxt a scalar or
    (...,)."""
    batch = o.shape[:-1]
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    # a number is filled on the device: a copy from the host would wait
    maxt = (maxt.expand(batch) if isinstance(maxt, torch.Tensor)
            else torch.full(batch, maxt, device=o.device)).reshape(-1)
    out, step = [], _LANES.get(o.device.type, _LANES["cuda"])
    n_tiles = curve.pa.shape[0] // _TILE
    with torch.no_grad():
        for r0 in range(0, o.shape[0], step):
            oc, dc = o[r0:r0 + step], d[r0:r0 + step]
            mt = maxt[r0:r0 + step, None]
            occ = torch.zeros(oc.shape[:1], dtype=torch.bool,
                              device=o.device)
            for tile in range(n_tiles):
                occ = occ | (_tile_t(curve, tile, oc, dc) < mt).any(-1)
            out.append(occ)
    return torch.cat(out).reshape(batch)
