"""Projective (boundary-term) gradients of visibility discontinuities
(`tpusky/ad/projective.py`; Mitsuba's projective integrators
`direct_projective.py`, `prb_projective.py`).

Differentiating the render misses the boundary term: the image changes
discontinuously where silhouettes and edges sweep across pixels. Each
shape's discontinuity curves are parameterised analytically as a
differentiable function of its `to_world`, projected to the image, and
the boundary integral

    dI/dtheta  ⊇  ∫_curves k(u) (f⁻(u) − f⁺(u)) (v(u)·n̂(u)) dσ(u)

is estimated by Monte Carlo in pixel coordinates: u(t, theta) is the
curve point, v = du/dtheta comes by autograd through the construction,
n̂ is the image-space normal and f⁻/f⁺ the radiance just off the curve on
either side, probed through the scene's own path integrator
(`integrator._path_sample` on the detached scene: on the card K2/K3 for
the sky, K14 for a mesh). Where the radiance is continuous across a
candidate curve the probed jump vanishes, so no curve needs classifying.

Curves: the sphere's silhouette circle (from the back-projected eye), a
rectangle's 4 edges, a disk's rim, a cube's 12 edges, a cylinder's rims
and its two side silhouettes, and a mesh's edges on the silhouette from
the eye, sampled by length and differentiated in a global translation of
the mesh. (The reference samples every edge: across an edge of
continuous shading its two-sided probes still read a jump of O(delta),
and summed over every edge that biases the term, R26; Mitsuba's
projective integrators sample silhouette edges.) Beyond
the camera's view: shadow curves of delta directional lights
(`shadow_boundary_grad`) and a blocker's silhouette seen from the end of
a detached BSDF walk (`indirect_boundary_grad`,
`indirect_boundary_grad_mesh`). `guide_bins` turns on boundary-sample
guiding (`ad/guiding.py`).

Every estimator takes `plain=True` to probe through the kernels' plain
versions on any device: the reference the card's kernels are held
against.

Random numbers are the reference's: `render.sampler.uniform` is
`jax.random.uniform` bitwise, `fold_in` and `split` its key derivations,
and the probes' lanes repeat each ray `probe_spp` times in the
reference's order, so every probe draws the reference's streams. A key is
the reference key's two uint32 words (`render.loader.prng_key(seed)`).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..ops.math import Frame
from ..render import integrator as integ
from ..render import sensors as sensors_mod
from ..render import shapes as shapes_mod
from ..render.bsdf import sample as bsdf_sample
from ..render.bsdf import table_kinds
from ..render.mesh import mesh_intersect
from ..render.sampler import fold_in, split, uniform
from ..render.scene import with_mesh_tables
from ..render.shapes import CUBE, CYLINDER, DISK, RECTANGLE, SPHERE
from .guiding import build_curve_guide, sample_curve_guide

__all__ = ["film_uv", "primary_boundary_grad", "shadow_boundary_grad",
           "indirect_boundary_grad", "indirect_boundary_grad_mesh",
           "boundary_grad"]


# ---------------------------------------------------------------------------
# camera projection (the inverse of sensors.perspective_ray)

def film_uv(sensor, p):
    """World points p (..., 3) -> (film uv in [0, 1]^2 (..., 2), valid):
    differentiable; not valid behind the camera."""
    cam = (p - sensor.to_world[:3, 3]) @ sensor.to_world[:3, :3]
    z = cam[..., 2]
    valid = z > sensor.near
    zs = torch.where(valid, z, 1.0)
    tan_half = torch.tan(0.5 * torch.deg2rad(sensor.fov_x_deg))
    u = (cam[..., 0] / (zs * tan_half) + 1.0) * 0.5
    v = (1.0 - cam[..., 1] / zs * sensor.aspect / tan_half) * 0.5
    return torch.stack([u, v], -1), valid


# ---------------------------------------------------------------------------
# discontinuity curves: object space -> world, differentiable in to_world.
# `eye` is (3,) or one per curve point (K, 3).

def _xform_p(t2w, p):
    return p @ t2w[:3, :3].T + t2w[:3, 3]


def _sphere_curve(t2w, eye, t):
    """Silhouette circle of the unit sphere seen from `eye`: tangency is
    affine-invariant, so in object space the points x with |x| = 1 and
    x·(x − o) = 0, a circle of radius sqrt(1 − 1/|o|²) about o/|o|² in the
    plane ⊥ o. t in [0, 2π)."""
    o = _xform_p(torch.linalg.inv(t2w), eye)
    d2 = (o * o).sum(-1, keepdim=True).clamp(min=1.0 + 1e-6)   # eye inside
    c = o / d2
    rho = torch.sqrt(1.0 - 1.0 / d2)
    w = o / torch.sqrt(d2)
    ex = torch.eye(3, dtype=o.dtype, device=o.device)
    a = torch.where(w.detach()[..., :1].abs() < 0.9, ex[0], ex[1])
    e1 = torch.linalg.cross(w, a.expand_as(w), dim=-1)
    e1 = e1 / torch.linalg.vector_norm(e1, dim=-1, keepdim=True)
    e2 = torch.linalg.cross(w, e1, dim=-1)
    x = c + rho * (torch.cos(t)[:, None] * e1 + torch.sin(t)[:, None] * e2)
    return _xform_p(t2w, x)


_RECT_CORNERS = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0],
                          [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0]], np.float32)


def _cube_edges():
    e0, e1 = [], []
    for axis in range(3):
        for sa in (-1.0, 1.0):
            for sb in (-1.0, 1.0):
                p0, p1 = np.zeros(3), np.zeros(3)
                o1, o2 = (axis + 1) % 3, (axis + 2) % 3
                p0[axis], p1[axis] = -1.0, 1.0
                p0[o1] = p1[o1] = sa
                p0[o2] = p1[o2] = sb
                e0.append(p0)
                e1.append(p1)
    return np.asarray(e0, np.float32), np.asarray(e1, np.float32)


_CUBE_E0, _CUBE_E1 = _cube_edges()


def _polyline_curve(e0, e1, t2w, t):
    """Piecewise-linear curve over segments e0 -> e1; t in [0, n_seg)."""
    e0 = torch.as_tensor(e0, device=t2w.device)
    e1 = torch.as_tensor(e1, device=t2w.device)
    seg = torch.floor(t).long().clamp(0, e0.shape[0] - 1)
    f = t - seg
    return _xform_p(t2w, e0[seg] + f[:, None] * (e1[seg] - e0[seg]))


def _rect_curve(t2w, eye, t):
    return _polyline_curve(_RECT_CORNERS, np.roll(_RECT_CORNERS, -1, 0),
                           t2w, t)


def _cube_curve(t2w, eye, t):
    return _polyline_curve(_CUBE_E0, _CUBE_E1, t2w, t)


def _disk_curve(t2w, eye, t):
    return _xform_p(t2w, torch.stack([torch.cos(t), torch.sin(t),
                                      torch.zeros_like(t)], -1))


def _cylinder_curve(t2w, eye, t):
    """The rims (t in [0, 4π)) and the two view-dependent side silhouette
    lines (t in [4π, 4π + 2)): the unit circle's tangency against the
    back-projected eye, as the sphere's but in the xy plane."""
    o = _xform_p(torch.linalg.inv(t2w), eye)
    oxy = o[..., :2]
    d2 = (oxy * oxy).sum(-1, keepdim=True).clamp(min=1.0 + 1e-6)
    c2 = oxy / d2
    rho = torch.sqrt(1.0 - 1.0 / d2)
    perp = torch.stack([-oxy[..., 1], oxy[..., 0]], -1) / torch.sqrt(d2)
    two_pi = 2.0 * math.pi
    rim = t < 2.0 * two_pi
    phi = torch.where(rim, t, 0.0)
    zr = torch.where(phi < two_pi, 0.0, 1.0)
    p_rim = torch.stack([torch.cos(phi), torch.sin(phi), zr], -1)
    s = torch.where(rim, 0.0, t - 2.0 * two_pi)     # [0, 2): line + frac
    side = torch.where(s < 1.0, 1.0, -1.0)
    fz = torch.where(s < 1.0, s, s - 1.0)
    xy = c2 + side[:, None] * rho * perp
    p_line = torch.cat([xy, fz[:, None]], -1)
    return _xform_p(t2w, torch.where(rim[:, None], p_rim, p_line))


# the curve family and its parameter's length per shape kind
_CURVES = {
    SPHERE: (_sphere_curve, 2.0 * math.pi),
    RECTANGLE: (_rect_curve, 4.0),
    DISK: (_disk_curve, 2.0 * math.pi),
    CUBE: (_cube_curve, 12.0),
    CYLINDER: (_cylinder_curve, 4.0 * math.pi + 2.0),
}


def _tangent_in_t(fn, t):
    """d fn(t) / dt by forward mode (fn maps (K,) to (K, n))."""
    with fwAD.dual_level():
        out = fn(fwAD.make_dual(t, torch.ones_like(t)))
        return fwAD.unpack_dual(out).tangent.detach()


def _grad_in(fn, theta):
    """d fn(theta) / d theta, fn scalar-valued, by autograd."""
    with torch.enable_grad():
        th = theta.detach().clone().requires_grad_(True)
        return torch.autograd.grad(fn(th), th)[0]


# ---------------------------------------------------------------------------
# radiance probes

def _path_radiance(scene, o, d, key, n_pts, probe_spp, max_depth, rr_depth,
                   mode, kinds, plain):
    """Mean radiance (n_pts, C) of `probe_spp` paths per point, the rays
    o, d (n_pts * probe_spp, 3) repeated point-major, through the scene's
    own path engine (the scene detached: no gradient reaches a probe)."""
    lane = torch.arange(n_pts * probe_spp, dtype=torch.int64,
                        device=o.device)
    smp = integ._SamplerCtx("independent", key, lane // probe_spp,
                            lane % probe_spp, probe_spp)
    with torch.no_grad():
        rad = integ._path_sample(scene, o, d, smp, max_depth, rr_depth, mode,
                                 kinds=kinds, plain=plain)
    rad = torch.where(torch.isfinite(rad), rad, 0.0)
    return rad.reshape(n_pts, probe_spp, -1).mean(1)


def _probe_radiance(scene, sensor, film_cfg, u_pix, key, probe_spp,
                    max_depth, rr_depth, mode, kinds, tag, plain):
    """Radiance through pixel-space points u_pix (K, 2), `probe_spp`
    paths each -> (K, C)."""
    k_pts = u_pix.shape[0]
    scale = torch.tensor([film_cfg.width, film_cfg.height],
                         dtype=u_pix.dtype, device=u_pix.device)
    o, d = sensors_mod.sample_ray(sensor, u_pix / scale)
    o = o.repeat_interleave(probe_spp, 0)
    d = d.repeat_interleave(probe_spp, 0)
    return _path_radiance(scene, o, d, fold_in(key, tag), k_pts, probe_spp,
                          max_depth, rr_depth, mode, kinds, plain)


def _gather_grad_image(grad_image, u_pix, valid):
    """grad_image (H, W, C) at the pixel holding each u_pix (box filter);
    zero outside the film."""
    h, w = grad_image.shape[:2]
    ix = torch.floor(u_pix[:, 0]).long()
    iy = torch.floor(u_pix[:, 1]).long()
    inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h) & valid
    g = grad_image[iy.clamp(0, h - 1), ix.clamp(0, w - 1)]
    return torch.where(inside[:, None], g, 0.0)


def _stratified(key, n: int, device):
    """n stratified uniforms in [0, 1): (i + u_i) / n."""
    return (torch.arange(n, device=device) + uniform(key, (n,), device)) / n


def _normals(tau):
    """Image-space unit normals (tau_y, −tau_x) of tangents tau (K, 2)
    and |tau|."""
    tau_n = torch.linalg.vector_norm(tau, dim=-1)
    nrm = torch.stack([tau[:, 1], -tau[:, 0]], -1) \
        / tau_n.clamp(min=1e-12)[:, None]
    return nrm, tau_n


# ---------------------------------------------------------------------------
# the boundary estimator

def _curve_boundary_grad(curve_fn, theta, t_len, scene, sensor, film_cfg,
                         grad_image, key, n_samples, probe_spp, probe_delta,
                         max_depth, rr_depth, mode, kinds, tag,
                         guide_bins: int = 0, guide_frac: float = 0.25,
                         plain: bool = False):
    """d(loss)/d theta of one curve family; curve_fn(theta, t (K,)) -> world
    points (K, 3), differentiable in theta.

    guide_bins > 0: a seed pass (guide_frac of the budget, single-delta
    1-spp probes) scores |jump| |tau| on a stratified t grid, and the main
    pass draws t from its histogram, dividing by the guided density."""
    dev = grad_image.device
    scale = torch.tensor([film_cfg.width, film_cfg.height],
                         dtype=torch.float32, device=dev)
    theta0 = theta.detach()

    def u_of(theta_, t_):
        uv, valid = film_uv(sensor, curve_fn(theta_, t_))
        return uv * scale, valid

    guided_pdf = None
    if guide_bins:
        n_seed = max(int(n_samples * guide_frac), guide_bins)
        n_samples = max(n_samples - n_seed, 1)
        t_seed = _stratified(fold_in(key, tag + 29), n_seed, dev) * t_len
        u_s, valid_s = u_of(theta0, t_seed)
        nrm_s, tau_sn = _normals(
            _tangent_in_t(lambda tt: u_of(theta0, tt)[0], t_seed))
        ok_s = valid_s & (tau_sn > 1e-12) & torch.isfinite(tau_sn)
        u_s = u_s.detach()
        fm = _probe_radiance(scene, sensor, film_cfg,
                             u_s - probe_delta * nrm_s, key, 1, max_depth,
                             rr_depth, mode, kinds, tag + 31, plain)
        fp = _probe_radiance(scene, sensor, film_cfg,
                             u_s + probe_delta * nrm_s, key, 1, max_depth,
                             rr_depth, mode, kinds, tag + 33, plain)
        g_s = _gather_grad_image(grad_image, u_s, ok_s)
        score = ((fm - fp) * g_s).sum(-1).abs() * tau_sn
        score = torch.where(ok_s, score, 0.0)
        guide = build_curve_guide(score, t_seed, t_len, n_bins=guide_bins)
        u_main = _stratified(fold_in(key, tag + 37), n_samples, dev)
        t, guided_pdf = sample_curve_guide(guide, u_main)
    else:
        t = _stratified(fold_in(key, tag + 17), n_samples, dev) * t_len

    # curve points, tangents and normals, all fixed but u(theta)
    u_pix, valid = u_of(theta0, t)
    nrm, tau_n = _normals(_tangent_in_t(lambda tt: u_of(theta0, tt)[0], t))
    ok = valid & (tau_n > 1e-12) & torch.isfinite(tau_n)
    u_sg = u_pix.detach()

    # two-point sqrt(delta)-Richardson probes: beside a curved silhouette
    # the one-sided radiance goes as f(0) + c sqrt(delta) (the grazing
    # cosine), so 2 f(delta) − f(4 delta) cancels the sqrt(delta) term
    def probe(offset, tg):
        return _probe_radiance(scene, sensor, film_cfg, u_sg + offset, key,
                               probe_spp, max_depth, rr_depth, mode, kinds,
                               tg, plain)

    f_minus = 2.0 * probe(-probe_delta * nrm, tag) \
        - probe(-4.0 * probe_delta * nrm, tag + 2)
    f_plus = 2.0 * probe(probe_delta * nrm, tag + 1) \
        - probe(4.0 * probe_delta * nrm, tag + 3)
    g_px = _gather_grad_image(grad_image, u_sg, ok)
    jump = ((f_minus - f_plus) * g_px).sum(-1)
    if guided_pdf is not None:
        mc_w = 1.0 / (guided_pdf.clamp(min=1e-12) * n_samples)
    else:
        mc_w = t_len / n_samples
    wgt = torch.where(ok, jump * tau_n, 0.0) * mc_w

    def g(theta_):
        u_, _ = u_of(theta_, t)
        u_ = torch.where(ok[:, None], u_, 0.0)     # masked lanes NaN-free
        return (wgt * (nrm * u_).sum(-1)).sum()

    return _grad_in(g, theta)


def _kinds(scene, kinds):
    return table_kinds(scene.bsdfs) if kinds is None else kinds


def primary_boundary_grad(scene, sensor, film_cfg, grad_image, key, *,
                          n_samples: int = 4096, probe_spp: int = 4,
                          probe_delta: float = 0.15, max_depth: int = 2,
                          rr_depth: int = 1000, mode: str = "rgb",
                          kinds=None, shape_indices=None,
                          guide_bins: int = 0, guide_frac: float = 0.25,
                          plain: bool = False):
    """Boundary-term gradient of loss = Σ grad_image · image with respect
    to each analytic shape's to_world and, if the scene has a mesh, a
    global translation of it, along the mesh's silhouette edges ->
    (d_to_world (N, 4, 4), d_mesh (3,) or None)."""
    kinds = _kinds(scene, kinds)
    scene = with_mesh_tables(scene, plain)
    eye = sensor.to_world[:3, 3]
    t2w_all = scene.shapes.to_world.detach()
    out = torch.zeros_like(t2w_all)
    idxs = range(t2w_all.shape[0]) if shape_indices is None \
        else shape_indices
    for j in idxs:
        kind = scene.shapes.kind[j]
        if kind not in _CURVES:
            continue
        curve, t_len = _CURVES[kind]
        out[j] = _curve_boundary_grad(
            lambda th, tt, c=curve: c(th, eye, tt), t2w_all[j], t_len,
            scene, sensor, film_cfg, grad_image, key, n_samples, probe_spp,
            probe_delta, max_depth, rr_depth, mode, kinds,
            tag=1000 + 32 * j, guide_bins=guide_bins, guide_frac=guide_frac,
            plain=plain)

    d_mesh = None
    if scene.mesh is not None:
        e0, e1, lens, n_a, n_b = _mesh_edges(scene.mesh)
        # the edges on the silhouette seen from the eye: one adjacent face
        # turned to it, one away (a face's plane holds its edge, so the
        # test holds along the whole edge), or a boundary edge
        to_eye = e0 - eye
        sil = ((n_a * to_eye).sum(-1) * (n_b * to_eye).sum(-1)) < 0.0
        e0, e1, lens = e0[sil], e1[sil], lens[sil]
        if e0.shape[0]:
            total = float(lens.sum())
            cdf = torch.cumsum(lens / lens.sum(), 0)

            def mesh_curve(offset, t_):
                # t in [0, 1): the edge by the length-weighted CDF, then
                # the fraction along it
                e = torch.searchsorted(cdf, t_.detach(), right=True)
                e = e.clamp(0, cdf.shape[0] - 1)
                lo = torch.where(e > 0, cdf[(e - 1).clamp(min=0)], 0.0)
                f = (t_ - lo) / (cdf[e] - lo).clamp(min=1e-12)
                return e0[e] + f[:, None] * (e1[e] - e0[e]) + offset

            # t uniform in arclength over [0, L): the edge's density
            # (len_e / L) / len_e = 1 / L
            d_mesh = _curve_boundary_grad(
                lambda off, tt: mesh_curve(off, tt / total),
                torch.zeros(3, device=t2w_all.device), total, scene, sensor,
                film_cfg, grad_image, key, n_samples, probe_spp,
                probe_delta, max_depth, rr_depth, mode, kinds, tag=900000,
                guide_bins=guide_bins, guide_frac=guide_frac, plain=plain)
    return out, d_mesh


_EDGE_CACHE = {}
_EDGE_CACHE_MAX = 8


def _mesh_edges(mesh):
    """Unique edges of the mesh's valid triangles, on the host and cached
    -> (e0, e1, lens, n_a, n_b) on the mesh's device: the endpoints as
    first met, the lengths and the geometric normals of the (up to two)
    faces that share the edge. A boundary edge (one face) gets n_b = −n_a,
    so the silhouette test (n_a·(e − x)) (n_b·(e − x)) < 0 always passes
    there. Edges are met triangle by triangle for the corner pairs (0, 1),
    (1, 2), (2, 0) in turn and keyed on their endpoints rounded to 1e-5,
    in the reference's order. The cache keys on the bytes of v0."""
    v0 = mesh.v0.detach().cpu().numpy()
    key_id = (v0.shape, str(v0.dtype), hashlib.sha1(v0.tobytes()).hexdigest(),
              str(mesh.v0.device))
    if key_id in _EDGE_CACHE:
        return _EDGE_CACHE[key_id]
    valid = mesh.valid.cpu().numpy()
    v1 = v0 + mesh.e1.detach().cpu().numpy()
    v2 = v0 + mesh.e2.detach().cpu().numpy()
    tris = np.stack([v0, v1, v2], axis=1)[valid]          # (T, 3, 3)
    geo_n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    geo_n /= np.maximum(np.linalg.norm(geo_n, axis=-1, keepdims=True), 1e-12)
    quant = np.round(tris * 1e5).astype(np.int64)
    pairs = ((0, 1), (1, 2), (2, 0))
    # every (pair, triangle) occurrence in the order the reference meets
    # them, keyed on (lesser, greater) endpoint
    pa = np.concatenate([quant[:, a] for a, _ in pairs])
    pb = np.concatenate([quant[:, b] for _, b in pairs])
    diff = pa != pb                          # the first differing column
    col, rows = diff.argmax(1), np.arange(pa.shape[0])
    a_first = ~diff.any(1) | (pa[rows, col] < pb[rows, col])
    lo = np.where(a_first[:, None], pa, pb)
    hi = np.where(a_first[:, None], pb, pa)
    keys = np.concatenate([lo, hi], 1)
    _, inverse = np.unique(keys, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    occ = np.arange(keys.shape[0])
    order = np.lexsort((occ, inverse))       # by edge, then as met
    first = np.ones(order.shape[0], bool)
    first[1:] = inverse[order][1:] != inverse[order][:-1]
    firsts = order[first]                    # each edge's first meeting
    second = np.full(firsts.shape[0], -1)
    pos = np.flatnonzero(first)
    has2 = np.append(pos[1:], order.shape[0]) - pos > 1
    second[has2] = order[pos[has2] + 1]
    by_meet = np.argsort(firsts, kind="stable")
    firsts, second = firsts[by_meet], second[by_meet]
    ends_a = np.concatenate([tris[:, a] for a, _ in pairs])
    ends_b = np.concatenate([tris[:, b] for _, b in pairs])
    geo_all = np.concatenate([geo_n] * 3)
    e0 = ends_a[firsts].astype(np.float32)
    e1 = ends_b[firsts].astype(np.float32)
    n_a = geo_all[firsts].astype(np.float32)
    n_b = np.where((second >= 0)[:, None], geo_all[np.maximum(second, 0)],
                   -geo_all[firsts]).astype(np.float32)
    lens = np.linalg.norm(e1 - e0, axis=-1)
    keep = lens > 1e-9
    dev = mesh.v0.device
    res = tuple(torch.as_tensor(np.ascontiguousarray(x[keep]), device=dev)
                for x in (e0, e1, lens, n_a, n_b))
    if len(_EDGE_CACHE) >= _EDGE_CACHE_MAX:
        _EDGE_CACHE.pop(next(iter(_EDGE_CACHE)))
    _EDGE_CACHE[key_id] = res
    return res


# ---------------------------------------------------------------------------
# shadow boundaries of delta directional lights (the sun-shadow case)

def _shadow_curve(curve_fn, light_dir, receiver_table, theta, t):
    """A blocker's light-silhouette curve projected along the light onto
    the receivers (a ShapeTable without the blocker, so tangency roundoff
    cannot hit it again); differentiable in theta through the silhouette
    point, NaN where no receiver is hit."""
    y = curve_fn(theta, t)
    d = (light_dir / torch.linalg.vector_norm(light_dir)).expand_as(y)
    _t, p, _n, _idx, valid = shapes_mod.ray_intersect(receiver_table,
                                                      y + 1e-4 * d, d)
    return torch.where(valid[:, None], p, torch.nan)


def _table_without(table, j: int):
    """The ShapeTable without shape j (on the host: static)."""
    keep = [i for i in range(len(table.kind)) if i != j]
    dev = table.to_world.device
    if not keep:
        ph = np.eye(4, dtype=np.float32)
        ph[:3, 3] = 3e4
        return shapes_mod.make_shape_table(
            [dict(kind=0, to_world=ph, bsdf_idx=0, emitter_idx=-1)],
            device=dev)
    sel = torch.tensor(keep, device=dev)
    return shapes_mod.ShapeTable(
        tuple(table.kind[i] for i in keep), table.to_world[sel].detach(),
        table.to_object[sel].detach(), table.bsdf_idx[sel],
        table.emitter_idx[sel], table.area[sel].detach())


def shadow_boundary_grad(scene, sensor, film_cfg, grad_image, key,
                         light_dir, *, blocker_indices=None,
                         n_samples: int = 4096, probe_spp: int = 4,
                         probe_delta: float = 0.15, max_depth: int = 2,
                         rr_depth: int = 1000, mode: str = "rgb",
                         kinds=None, guide_bins: int = 0,
                         guide_frac: float = 0.25, plain: bool = False):
    """Boundary gradient of the shadow curves that blockers cast under a
    delta directional light along `light_dir` (the propagation direction)
    -> d_to_world (N, 4, 4). The curve on a receiver is the projection
    along the light of the blocker's silhouette seen from the light (for
    the sphere, the same tangency with the eye far away); the jump (lit
    against shadowed) is probed on both sides."""
    kinds = _kinds(scene, kinds)
    scene = with_mesh_tables(scene, plain)
    t2w_all = scene.shapes.to_world.detach()
    ld = torch.as_tensor(np.asarray(light_dir, np.float32),
                         device=t2w_all.device)
    ld = ld / torch.linalg.vector_norm(ld)
    out = torch.zeros_like(t2w_all)
    idxs = range(t2w_all.shape[0]) if blocker_indices is None \
        else blocker_indices
    for j in idxs:
        kind = scene.shapes.kind[j]
        if kind not in _CURVES:
            continue
        curve, t_len = _CURVES[kind]
        virtual_eye = t2w_all[j][:3, 3] - 1e5 * ld   # a directional view
        receiver = _table_without(scene.shapes, j)

        def cfn(th, tt, c=curve, ve=virtual_eye, rt=receiver):
            return _shadow_curve(lambda th2, t2: c(th2, ve, t2), ld, rt, th,
                                 tt)

        out[j] = _curve_boundary_grad(
            cfn, t2w_all[j], t_len, scene, sensor, film_cfg, grad_image,
            key, n_samples, probe_spp, probe_delta, max_depth, rr_depth,
            mode, kinds, tag=500000 + 32 * j, guide_bins=guide_bins,
            guide_frac=guide_frac, plain=plain)
    return out


# ---------------------------------------------------------------------------
# indirect boundaries: a blocker's silhouette seen from a receiver

def _flip_to(ng, d):
    """The normal facing against d."""
    return torch.where((ng * -d).sum(-1, keepdim=True) >= 0, ng, -ng)


def _prefix_walk(scene, o, d, key, depth: int, kinds):
    """A detached BSDF walk of `depth` bounces from primary rays, the
    receiver vertex of a deep boundary chain (the role of the reference's
    `prb_projective.py` seed-ray walk) -> (p, n_shading, shape_idx,
    throughput (K, 3), active)."""
    n = o.shape[0]
    dev = o.device
    thr = torch.ones((n, 3), device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    smp = integ._SamplerCtx("independent", fold_in(key, 99173), lane,
                            torch.zeros_like(lane), 1)
    shapes = scene.shapes
    with torch.no_grad():
        for k in range(depth):
            _t, p, ng, shape_idx, hit = shapes_mod.ray_intersect(shapes, o, d)
            active = active & hit
            frame = Frame(_flip_to(ng, d))
            mat_idx = shapes.bsdf_idx[shape_idx.clamp(min=0)]
            u = smp.next(810_000 + 3 * k, 3)
            wo, weight, pdf_b, _delta = bsdf_sample(
                scene.bsdfs, mat_idx, frame.to_local(-d), u[..., :2],
                u[..., 2], None, kinds=kinds)
            thr = thr * weight
            active = active & (pdf_b > 0.0)
            d = frame.to_world(wo)
            o = p + torch.sign((ng * d).sum(-1))[..., None] * ng * (
                1e-3 * torch.linalg.vector_norm(p, dim=-1,
                                                keepdim=True).clamp(min=1.0))
        _t, p, ng, shape_idx, hit = shapes_mod.ray_intersect(shapes, o, d)
    return p, _flip_to(ng, d), shape_idx, thr, active & hit


def _renorm(v):
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(
        min=1e-12)


def _li_probes(scene, off, omega, nrm, key, tags, probe_spp, probe_delta,
               max_depth, rr_depth, mode, kinds, plain):
    """Incident radiance at the receivers `off` just off the silhouette
    on either side of the directions omega (K, 3), `probe_spp` paths each
    (single-delta probes: the jump of Li is a step) -> (Li⁻, Li⁺)."""
    n_x = off.shape[0]
    o_r = off.repeat_interleave(probe_spp, 0)

    def li(d_probe, tag):
        return _path_radiance(scene, o_r, d_probe.repeat_interleave(
            probe_spp, 0), fold_in(key, tag), n_x, probe_spp, max_depth - 1,
            rr_depth, mode, kinds, plain)
    return (li(_renorm(omega - probe_delta * nrm), tags[0]),
            li(_renorm(omega + probe_delta * nrm), tags[1]))


def _sphere_normals(omega, tau):
    """The in-sphere curve normal omega x tau, normalised, and |tau|."""
    tau_n = torch.linalg.vector_norm(tau, dim=-1)
    return _renorm(torch.linalg.cross(omega, tau, dim=-1)), tau_n


def indirect_boundary_grad(scene, sensor, film_cfg, grad_image, key, *,
                           blocker_indices=None, n_x: int = 8192,
                           probe_spp: int = 4, probe_delta: float = 0.02,
                           max_depth: int = 3, rr_depth: int = 1000,
                           mode: str = "rgb", kinds=None,
                           prefix_depth: int = 0, plain: bool = False):
    """One-indirect-level boundary gradient with respect to analytic
    blockers' translations -> (N, 3).

    For receivers x (camera-visible diffuse points, or the ends of a
    detached BSDF walk of `prefix_depth` bounces, weighted by its
    throughput), the incident radiance is discontinuous across each
    blocker's silhouette seen from x (its `_CURVES` family with the eye at
    x); the spherical Reynolds term ∮ f cos (Li⁻ − Li⁺)(x, ω) (v·n̂) dℓ(ω)
    is estimated with one stratified curve sample per camera ray. It adds
    to `primary_boundary_grad` and `shadow_boundary_grad` without double
    counting."""
    kinds = _kinds(scene, kinds)
    scene = with_mesh_tables(scene, plain)
    dev = grad_image.device
    w, h = film_cfg.width, film_cfg.height
    shapes = scene.shapes._replace(to_world=scene.shapes.to_world.detach(),
                                   to_object=scene.shapes.to_object.detach())
    n_shapes = shapes.to_world.shape[0]
    out = torch.zeros((n_shapes, 3), device=dev)

    k_u, k_t, k_p = split(fold_in(key, 31337), 3)
    uv = uniform(k_u, (n_x, 2), dev)
    o, d = sensors_mod.sample_ray(sensor, uv)
    if prefix_depth > 0:
        p, nsh, shape_idx, thr_walk, hit = _prefix_walk(
            scene._replace(shapes=shapes), o, d, key, prefix_depth, kinds)
    else:
        with torch.no_grad():
            _t, p, ng, shape_idx, hit = shapes_mod.ray_intersect(shapes, o, d)
        nsh = _flip_to(ng, d)
        thr_walk = torch.ones((n_x, 3), device=dev)
    mat_idx = shapes.bsdf_idx[shape_idx.clamp(min=0)]
    albedo = scene.bsdfs.albedo[mat_idx].detach()
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)
    g_px = _gather_grad_image(grad_image, uv * scale, hit)
    off = p + nsh * (1e-3 * torch.linalg.vector_norm(
        p, dim=-1, keepdim=True).clamp(min=1.0))

    idxs = range(n_shapes) if blocker_indices is None else blocker_indices
    tt01 = (torch.arange(n_x, device=dev) % 64 + uniform(k_t, (n_x,), dev)) \
        / 64.0
    for j in idxs:
        kind_j = int(shapes.kind[j])
        if kind_j not in _CURVES:
            continue
        curve_j, t_len_j = _CURVES[kind_j]
        tt = tt01 * t_len_j

        def omega_of(c, t_, curve=curve_j, j=j):
            """Candidate discontinuity directions from each x to shape j
            translated by c -> (K, 3) unit vectors."""
            t2w = shapes.to_world[j].clone()
            t2w[:3, 3] = t2w[:3, 3] + c
            return _renorm(curve(t2w, p, t_) - p)

        c0 = torch.zeros(3, device=dev)
        omega = omega_of(c0, tt).detach()
        nrm, tau_n = _sphere_normals(omega, _tangent_in_t(
            lambda t_: omega_of(c0, t_), tt))
        cos_x = (nsh * omega).sum(-1)
        # x on the blocker or behind it: no term
        ok = (hit & (shape_idx != j) & (cos_x > 1e-3) & (tau_n > 1e-9)
              & torch.isfinite(tau_n))
        li_m, li_p = _li_probes(scene, off, omega, nrm, k_p,
                                (64 * j, 64 * j + 1), probe_spp, probe_delta,
                                max_depth, rr_depth, mode, kinds, plain)
        f_cos = thr_walk * albedo * (1.0 / math.pi) * cos_x[..., None]
        jump = ((li_m - li_p) * f_cos * g_px).sum(-1)
        # stratified t over 64 bins times the film-area factor: the 64s
        # cancel to jump |tau| t_len W H / n_x
        wgt = torch.where(ok, jump * tau_n, 0.0) \
            * (t_len_j / 64.0) * (w * h / n_x) * 64.0

        def gfun(c, tt=tt, omega_of=omega_of, ok=ok, wgt=wgt, nrm=nrm):
            om = torch.where(ok[:, None], omega_of(c, tt), 0.0)
            return (wgt * (nrm * om).sum(-1)).sum()

        out[j] = _grad_in(gfun, c0)
    return out


def indirect_boundary_grad_mesh(scene, sensor, film_cfg, grad_image, key,
                                *, n_x: int = 16384, probe_spp: int = 4,
                                probe_delta: float = 0.02,
                                max_depth: int = 3, rr_depth: int = 1000,
                                mode: str = "rgb", kinds=None,
                                plain: bool = False):
    """One-indirect-level boundary gradient with respect to a global
    translation of the scene's triangle mesh -> (3,).

    The candidate discontinuities of Li(x, ·) are the mesh's edges; an
    edge point counts only where the edge is a silhouette seen from the
    receiver x, which the adjacent-face test (n_a·(e − x)) (n_b·(e − x))
    < 0 selects per (x, edge point). Edge points are drawn by arclength,
    one stratified sample per camera ray; ω(c, t) = normalize(e(t) + c −
    x) is differentiable in the offset c. Receivers are camera-visible
    points on analytic shapes: a lane whose ray meets the mesh first is
    masked."""
    dev = grad_image.device
    if scene.mesh is None:
        return torch.zeros(3, device=dev)
    kinds = _kinds(scene, kinds)
    scene = with_mesh_tables(scene, plain)
    w, h = film_cfg.width, film_cfg.height
    e0, e1, lens, n_a, n_b = _mesh_edges(scene.mesh)
    if e0.shape[0] == 0:
        return torch.zeros(3, device=dev)
    cdf = torch.cumsum(lens / lens.sum(), 0)

    k_u, k_t, k_p = split(fold_in(key, 424242), 3)
    uv = uniform(k_u, (n_x, 2), dev)
    o, d = sensors_mod.sample_ray(sensor, uv)
    with torch.no_grad():
        t_hit, p, ng, shape_idx, hit = shapes_mod.ray_intersect(
            scene.shapes, o, d)
        tm = mesh_intersect(scene.mesh, o, d, plain,
                            tables=scene.mesh_tables)[0]
    mesh_closer = torch.isfinite(tm) & (tm < t_hit)
    albedo = scene.bsdfs.albedo[
        scene.shapes.bsdf_idx[shape_idx.clamp(min=0)]].detach()
    scale = torch.tensor([w, h], dtype=torch.float32, device=dev)
    g_px = _gather_grad_image(grad_image, uv * scale, hit & ~mesh_closer)
    nsh = _flip_to(ng, d)

    tt = (torch.arange(n_x, device=dev) % 64 + uniform(k_t, (n_x,), dev)) \
        / 64.0

    def edge_of(t_):
        e = torch.searchsorted(cdf, t_.detach(), right=True).clamp(
            0, cdf.shape[0] - 1)
        lo = torch.where(e > 0, cdf[(e - 1).clamp(min=0)], 0.0)
        f = (t_ - lo) / (cdf[e] - lo).clamp(min=1e-12)
        return e0[e] + f[..., None] * (e1[e] - e0[e]), e

    def omega_of(c, t_):
        return _renorm(edge_of(t_)[0] + c - p)

    c0 = torch.zeros(3, device=dev)
    omega = omega_of(c0, tt).detach()
    nrm, tau_n = _sphere_normals(omega, _tangent_in_t(
        lambda t_: omega_of(c0, t_), tt))
    cos_x = (nsh * omega).sum(-1)

    # the per-lane silhouette ("facing the receiver") test
    pt0, eidx = edge_of(tt)
    to_edge = pt0 - p
    sil = ((n_a[eidx] * to_edge).sum(-1) * (n_b[eidx] * to_edge).sum(-1)
           ) < 0.0
    ok = (hit & ~mesh_closer & sil & (cos_x > 1e-3) & (tau_n > 1e-9)
          & torch.isfinite(tau_n))

    off = p + nsh * (1e-3 * torch.linalg.vector_norm(
        p, dim=-1, keepdim=True).clamp(min=1.0))
    li_m, li_p = _li_probes(scene, off, omega, nrm, k_p, (7001, 7002),
                            probe_spp, probe_delta, max_depth, rr_depth,
                            mode, kinds, plain)
    f_cos = albedo * (1.0 / math.pi) * cos_x[..., None]
    jump = ((li_m - li_p) * f_cos * g_px).sum(-1)
    # t uniform over [0, 1): the mean times 1; the film factor W H / n_x
    wgt = torch.where(ok, jump * tau_n, 0.0) * (w * h / n_x)

    def gfun(c):
        om = torch.where(ok[:, None], omega_of(c, tt), 0.0)
        return (wgt * (nrm * om).sum(-1)).sum()

    return _grad_in(gfun, c0)


def boundary_grad(scene, sensor, film_cfg, grad_image, key, *,
                  light_dir=None, indirect=False, **kw):
    """Primary, and optionally directional-shadow and one-level indirect,
    boundary gradients -> (d_to_world (N, 4, 4), d_mesh (3,) or None).
    The projective backward is the interior gradient (autograd through
    the render) plus this; `indirect=True` adds `indirect_boundary_grad`'s
    translations to the to_world translation column."""
    shape_indices = kw.pop("shape_indices", None)
    blocker_indices = kw.pop("blocker_indices", None)
    d_shapes, d_mesh = primary_boundary_grad(
        scene, sensor, film_cfg, grad_image, key,
        shape_indices=shape_indices, **kw)
    if light_dir is not None:
        d_shapes = d_shapes + shadow_boundary_grad(
            scene, sensor, film_cfg, grad_image, fold_in(key, 77), light_dir,
            blocker_indices=blocker_indices, **kw)
    if indirect:
        kw_ind = {k: v for k, v in kw.items()
                  if k in ("probe_spp", "max_depth", "rr_depth", "mode",
                           "kinds", "plain")}
        d_tr = indirect_boundary_grad(
            scene, sensor, film_cfg, grad_image, fold_in(key, 78),
            blocker_indices=blocker_indices, **kw_ind)
        d_shapes = d_shapes.clone()
        d_shapes[:, :3, 3] += d_tr
    return d_shapes, d_mesh
