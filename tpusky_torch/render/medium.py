"""Participating media and phase functions (`tpusky/render/medium.py`).

A medium region is a convex boundary (the unit sphere or the unit cube
under a transform, or the whole of space), so a ray's overlap with it is
one interval in closed form: the path tracer needs no inside/outside
state and no null-boundary events. A region's extinction is `sigma_t`,
times the trilinear `density` grid where it has one (a cube region: the
heterogeneous medium of `heterogeneous.cpp` over a `gridvolume`), times
the SGGX projected area for a microflake medium. A grid's line integral
is a midpoint march of `n_steps` fixed steps, every lane the same
lookups, and free flight inverts it (cumsum, then the first step that
reaches the drawn optical depth). Several regions are sampled by Poisson
superposition (`stack_sample`): each draws its own free flight, the
nearest scatter wins, and the weights compose as products over regions.

Gradients follow the reference's split: the sampling side (the drawn
optical depth, the march inversion, the scatter test, the pdf and
survival denominators) is detached, the value side (sigma_s, the density
at the point, the optical depths in the numerators) attached. Where a
grid's march runs under autograd its per-step planes are rematerialised
in the backward (`torch.utils.checkpoint`), so the backward of a frame
keeps a few floats a lane for each march, not 64 steps' planes.

`Medium` is a NamedTuple of tensors; `kind`, `n_steps`, `phase` and
`channel_mis` are Python values (static in the reference,
`medium.py:101-111`). Plain tensor code on any device: the reference has
no kernel here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.distr import (continuous_pdf, continuous_sample_pdf,
                         make_continuous)
from ..ops.math import norm, safe_sqrt

__all__ = ["Medium", "make_medium", "hg_pdf", "hg_sample",
           "rayleigh_pdf", "rayleigh_sample", "phase_pdf", "phase_sample",
           "tab_pdf", "tab_sample", "sggx_pdf", "sggx_sample",
           "sggx_projected_area", "medium_interval", "transmittance",
           "eval_density", "line_density", "sample_interaction",
           "as_stack", "stack_sample", "stack_transmittance",
           "stack_phase_pdf", "stack_phase_sample"]

GLOBAL, SPHERE, CUBE = -1, 0, 1   # boundary kinds
_PHASE_KINDS = ("hg", "hg2", "rayleigh", "tab", "sggx")
_INV_4PI = 1.0 / (4.0 * math.pi)


class Medium(NamedTuple):
    sigma_t: torch.Tensor             # (C,) extinction
    albedo: torch.Tensor              # (C,) single-scattering albedo
    g: torch.Tensor                   # () HG asymmetry (0: isotropic)
    to_local: torch.Tensor            # (4, 4) world -> unit-shape space
    density: Optional[torch.Tensor] = None   # (D, H, W) grid, z-major
    phase_tab: Optional[torch.Tensor] = None  # (N,) tabphase on cos [-1, 1]
    sggx_s: Optional[torch.Tensor] = None    # (6,) [Sxx Syy Szz Sxy Sxz Syz]
    g2: Optional[torch.Tensor] = None        # () the blend's HG "hg2"
    phase_w: Optional[torch.Tensor] = None   # () blend weight of child b
    kind: int = SPHERE                # GLOBAL | SPHERE | CUBE
    n_steps: int = 64                 # march steps of a grid
    phase: object = "hg"              # a kind of _PHASE_KINDS or
    #                                   ("blend", a, b) (`blendphase.cpp`)
    channel_mis: bool = False         # spectral-MIS free flight (volpath)


def _has(phase, kind):
    return phase == kind or (isinstance(phase, tuple) and kind in phase)


def make_medium(sigma_t, albedo, g=0.0, to_world=None, kind: str = "sphere",
                density=None, n_steps: int = 64, phase="hg", phase_tab=None,
                sggx_s=None, g2=0.0, phase_w=0.5, channel_mis: bool = False,
                device="cuda") -> Medium:
    """A region from host-side values, as the reference's `make_medium`:
    `kind` in {'global', 'sphere', 'cube'}; `to_world` maps the unit
    sphere or the cube [-1, 1]^3 onto the region; `density` an optional
    (D, H, W) grid over a cube region; `phase` 'hg' | 'rayleigh' | 'tab'
    (with `phase_tab`) | 'sggx' (with `sggx_s`) | ('blend', a, b) with
    weight `phase_w` on b ('hg2' = HG with `g2`). A gradient reaches a
    region through tensors put in with `_replace`."""
    k = {"global": GLOBAL, "sphere": SPHERE, "cube": CUBE}[kind]

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    if density is not None:
        if k != CUBE:
            raise ValueError("grid density requires a cube boundary "
                             "(gridvolume is box-shaped, `grid.cpp`)")
        density = f32(density)
        if density.ndim != 3:
            raise ValueError("density grid must be (D, H, W)")
    t2w = (np.eye(4, dtype=np.float32) if to_world is None
           else np.asarray(to_world, np.float32))
    if isinstance(phase, (tuple, list)):
        phase = tuple(phase)
        if (len(phase) != 3 or phase[0] != "blend"
                or phase[1] not in _PHASE_KINDS
                or phase[2] not in _PHASE_KINDS):
            raise ValueError(f"bad blend phase spec {phase!r}")
    elif phase not in _PHASE_KINDS:
        raise ValueError(f"unknown phase function {phase!r}")
    if _has(phase, "tab"):
        phase_tab = f32(phase_tab)
        if phase_tab.ndim != 1 or phase_tab.shape[0] < 2:
            raise ValueError("tab phase needs >= 2 values")
    else:
        phase_tab = None
    sggx_s = f32(sggx_s).reshape(6) if _has(phase, "sggx") else None
    return Medium(f32(sigma_t).reshape(-1), f32(albedo).reshape(-1),
                  f32(g).reshape(()),
                  f32(np.linalg.inv(t2w.astype(np.float64))
                      .astype(np.float32)),
                  density, phase_tab, sggx_s, f32(g2).reshape(()),
                  f32(phase_w).reshape(()), k, int(n_steps), phase,
                  bool(channel_mis))


def n_channels(media) -> int:
    """The largest channel count of a region's sigma_t and albedo."""
    return max(max(m.sigma_t.shape[0], m.albedo.shape[0])
               for m in as_stack(media))


# ---------------------------------------------------------------------------
# the boundary interval
# ---------------------------------------------------------------------------

def _affine(a, p):
    """a[:3, :3] p + a[:3, 3] for (..., 3) points, summed in the
    reference's order."""
    return torch.stack([p[..., 0] * a[i, 0] + p[..., 1] * a[i, 1]
                        + p[..., 2] * a[i, 2] + a[i, 3] for i in range(3)],
                       -1)


def _linear(a, v):
    return torch.stack([v[..., 0] * a[i, 0] + v[..., 1] * a[i, 1]
                        + v[..., 2] * a[i, 2] for i in range(3)], -1)


def medium_interval(med: Medium, o, d):
    """Overlap [t0, t1] of rays (o, d) with the region, clamped to t >= 0;
    an empty overlap gives t0 == t1 == 0 (`medium.py:177-209`)."""
    if med.kind == GLOBAL:
        zeros = torch.zeros(o.shape[:-1], device=o.device)
        return zeros, torch.full_like(zeros, torch.inf)
    a = med.to_local
    ol = _affine(a, o)
    dl = _linear(a, d)
    if med.kind == SPHERE:
        qa = (dl * dl).sum(-1)
        qb = 2.0 * (ol * dl).sum(-1)
        qc = (ol * ol).sum(-1) - 1.0
        disc = qb * qb - 4.0 * qa * qc
        ok = disc > 0.0
        sq = safe_sqrt(disc)        # zero gradient on a miss: no NaN
        t0 = (-qb - sq) / (2.0 * qa)
        t1 = (-qb + sq) / (2.0 * qa)
    else:                           # the slab test against [-1, 1]^3
        inv = 1.0 / torch.where(dl.abs() < 1e-12,
                                torch.where(dl >= 0, 1e-12, -1e-12), dl)
        ta = (-1.0 - ol) * inv
        tb = (1.0 - ol) * inv
        t0 = torch.minimum(ta, tb).amax(-1)
        t1 = torch.maximum(ta, tb).amin(-1)
        ok = t0 <= t1
    t0 = t0.clamp(min=0.0)
    t1 = t1.clamp(min=0.0)
    empty = ~ok | (t1 <= t0)
    return torch.where(empty, 0.0, t0), torch.where(empty, 0.0, t1)


# ---------------------------------------------------------------------------
# grid density
# ---------------------------------------------------------------------------

def _corner_table(grid):
    """(8, D H W) each cell's eight corner values, rows [c000, c001,
    c010, c011, c100, c101, c110, c111] in (z, y, x) bit order, the
    upper corners clamped at the last cell as the reference clamps them
    (`medium.py:234-236`): a lookup gathers the rows at one cell index."""
    def up(g, dim):                 # g at index min(i + 1, n - 1)
        n = g.shape[dim]
        return g.index_select(dim, torch.arange(
            1, n + 1, device=g.device).clamp(max=n - 1))
    g100 = up(grid, 0)
    g010, g110 = up(grid, 1), up(g100, 1)
    return torch.stack([grid, up(grid, 2), g010, up(g010, 2), g100,
                        up(g100, 2), g110, up(g110, 2)]).reshape(8, -1)


def _take(row, idx):
    """row[idx]; under autograd through `index_select`, whose backward
    is an `index_add_`, where the indexing's own accumulates by a sort
    (~100x slower on the card with a grid's many repeated cells)."""
    if row.requires_grad and torch.is_grad_enabled():
        return row.index_select(0, idx.reshape(-1)).reshape(idx.shape)
    return row[idx]


def _grid_coords(l, n):
    """Grid coordinate f in [0, n-1] of local coordinates l in [-1, 1]
    -> (the cell's lower index as a float, the fraction into it)."""
    f = ((l + 1.0) * 0.5).clamp(0.0, 1.0) * (n - 1)
    i0 = torch.floor(f)
    return i0, f - i0


def _trilinear(grid, table, coords):
    """Trilinear density of `grid` (its corner table `table`) at grid
    coordinates `coords` ((x0, tx), (y0, ty), (z0, tz)) (`medium.py:
    216-259`): (z, y, x) order, x fastest."""
    dz, hy, wx = grid.shape
    (x0, tx), (y0, ty), (z0, tz) = coords
    # the cell index, in float32 where that is exact (up to 2^24 cells),
    # int64 once for the eight gathers (each would widen an int32 index)
    if dz * hy * wx <= 1 << 24:
        cell = torch.add(x0, torch.add(y0, z0, alpha=hy), alpha=wx).long()
    else:
        cell = (z0.long() * hy + y0.long()) * wx + x0.long()
    c = [_take(table[k], cell) for k in range(8)]
    c0 = torch.lerp(torch.lerp(c[0], c[1], tx), torch.lerp(c[2], c[3], tx),
                    ty)
    c1 = torch.lerp(torch.lerp(c[4], c[5], tx), torch.lerp(c[6], c[7], tx),
                    ty)
    return torch.lerp(c0, c1, tz)


def eval_density(med: Medium, p):
    """Trilinear density at world points p (`grid.cpp` interpolation):
    local [-1, 1]^3 onto the grid's extent [0, n-1] per axis, points
    outside clamped."""
    a, g = med.to_local, med.density
    return _trilinear(g, _corner_table(g), [_grid_coords(
        p[..., 0] * a[i, 0] + p[..., 1] * a[i, 1] + p[..., 2] * a[i, 2]
        + a[i, 3], g.shape[2 - i]) for i in range(3)])


def _march(grid, to_local, o, d, t0, seg, n: int):
    """Densities at the midpoints of n equal steps along [t0, t0 + seg]
    -> ((..., n), step length (...)) (`medium.py:262-274`). Each axis's
    grid coordinate is affine in the step's fraction along the segment,
    (o_l + d_l t0 + 1) / 2 (m - 1) + d_l seg / 2 (m - 1) frac, from the
    ray in local space: one plane an axis before the clamp."""
    dt = seg / n
    frac = (torch.arange(n, dtype=torch.float32, device=o.device) + 0.5) / n
    ol, dl = _affine(to_local, o), _linear(to_local, d)
    coords = []
    for i in range(3):
        m = grid.shape[2 - i] - 1
        start = (ol[..., i] + dl[..., i] * t0 + 1.0) * (0.5 * m)
        f = torch.addcmul(start[..., None], (dl[..., i] * seg
                                             * (0.5 * m))[..., None],
                          frac).clamp(0.0, m)
        i0 = torch.floor(f)
        coords.append((i0, f - i0))
    return _trilinear(grid, _corner_table(grid), coords), dt


def _remat(fn, *args):
    """fn(*args), its intermediates rematerialised in the backward when
    autograd records it (the march's planes are not kept)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def _march_sum(grid, to_local, o, d, t0, seg, scale, n: int):
    """Integrated density over [t0, t0 + seg] (times `scale` if given)."""
    dens, dt = _march(grid, to_local, o, d, t0, seg, n)
    out = dens.sum(-1) * dt
    return out if scale is None else out * scale


def _dir_scale(med: Medium, d):
    """SGGX media attenuate by the projected area along -d
    (`homogeneous.cpp:156`); None for every other phase function."""
    if not _has(med.phase, "sggx"):
        return None
    return sggx_projected_area(-d, med.sggx_s)


def line_density(med: Medium, o, d, t_max):
    """Integrated density over the overlap clipped to [0, t_max]: the
    overlap's length without a grid; the directional SGGX scale
    included."""
    t0, t1 = medium_interval(med, o, d)
    seg = (torch.minimum(t1, t_max) - torch.minimum(t0, t_max)).clamp(min=0)
    scale = _dir_scale(med, d)
    if med.density is None:
        return seg if scale is None else seg * scale
    n = med.n_steps
    return _remat(lambda g, a, o_, d_, t_, s_, sc: _march_sum(
        g, a, o_, d_, t_, s_, sc, n), med.density, med.to_local, o, d,
        torch.minimum(t0, t_max), seg, scale)


def transmittance(med: Medium, o, d, t_max):
    """Per-channel transmittance along (o, d) up to t_max."""
    return torch.exp(-med.sigma_t * line_density(med, o, d, t_max)[..., None])


def _sampling_survival(med: Medium, dd):
    """P(the sampler draws no scatter) after optical depth `dd` per unit
    sigma (`medium.py:313-321`)."""
    if med.channel_mis:
        return torch.exp(-med.sigma_t * dd[..., None]).mean(-1)
    return torch.exp(-med.sigma_t.mean() * dd)


def _sampling_pdf(med: Medium, x):
    """The free flight's density per unit integrated density at x
    (`medium.py:324-333`)."""
    if med.channel_mis:
        return (med.sigma_t * torch.exp(-med.sigma_t * x[..., None])).mean(-1)
    sb = med.sigma_t.mean()
    return sb * torch.exp(-sb * x)


def _grid_flight(grid, to_local, o, d, t0, seg, scale, xi, n: int):
    """A grid's free flight to the optical depth xi along [t0, t0 + seg]
    from one march (`medium.py:391-419`) -> (total optical depth, optical
    depth at the point, density at the point: attached; total optical
    depth, distance from t0: detached), per unit sigma. The step and the
    point are found on the detached values, so a rematerialised run finds
    the same ones."""
    dens, dt = _march(grid, to_local, o, d, t0, seg, n)
    if scale is not None:
        dens = dens * scale[..., None]
    cum = torch.cumsum(dens, -1) * dt[..., None]
    cum_det, dens_det, dt_det = cum.detach(), dens.detach(), dt.detach()
    # the first step whose cumulative density reaches xi
    k_c = (cum_det < xi[..., None]).sum(-1).clamp(max=n - 1)
    prev = (k_c - 1).clamp(min=0)[..., None]
    at = k_c[..., None]
    s = k_c * dt_det + (xi - torch.where(
        k_c > 0, cum_det.gather(-1, prev)[..., 0], 0.0)) / dens_det.gather(
            -1, at)[..., 0].clamp(min=1e-12)
    dens_s = dens.gather(-1, at)[..., 0]
    d_s = (torch.where(k_c > 0, cum.gather(-1, prev)[..., 0], 0.0)
           + dens_s * (s - k_c * dt_det).clamp(min=0.0))
    return cum[..., -1], d_s, dens_s, cum_det[..., -1], s


def sample_interaction(med: Medium, o, d, seg_t0, seg, u):
    """Free flight over the clipped segment [seg_t0, seg_t0 + seg]
    (`medium.py:336-434`) -> (scatter, s, T_seg, w_pass, w_scat): whether
    a scatter falls in the segment, its distance from seg_t0 (0 where
    none, finite), the transmittance across the segment, the
    pass-through weight T_seg / P(no scatter) and the scatter weight
    sigma_s dens T(s) / pdf(s), each (..., C)."""
    if med.channel_mis:
        c = med.sigma_t.shape[0]
        uc = (u * c).clamp(0.0, c - 1e-6)
        c_pick = torch.floor(uc)
        u_d = uc - c_pick                   # sample reuse (distr_1d.h:173)
        oh = c_pick[..., None] == torch.arange(c, dtype=c_pick.dtype,
                                               device=u.device)
        sig_c = torch.where(oh, med.sigma_t, 0.0).sum(-1).detach()
        xi = -torch.log((1.0 - u_d).clamp(min=1e-12)) / sig_c.clamp(min=1e-12)
    else:
        sigma_bar = med.sigma_t.mean().detach()
        xi = -torch.log((1.0 - u).clamp(min=1e-12)) / sigma_bar
    xi = xi.detach()
    scale = _dir_scale(med, d)
    if med.density is None:
        s = xi if scale is None else xi / scale.detach().clamp(min=1e-8)
        d_total = seg if scale is None else seg * scale        # attached
        d_total_det = d_total.detach()
        d_s = s if scale is None else s.detach() * scale
        dens_s = None
    else:
        n = med.n_steps
        d_total, d_s, dens_s, d_total_det, s = _remat(
            lambda g, a, o_, d_, t_, s_, sc: _grid_flight(
                g, a, o_, d_, t_, s_, sc, xi, n),
            med.density, med.to_local, o, d, seg_t0, seg, scale)
    scatter = xi < d_total_det
    s = torch.where(scatter, torch.minimum(s, seg), 0.0).detach()
    t_seg = torch.exp(-med.sigma_t * d_total[..., None])        # attached
    w_pass = t_seg / _sampling_survival(med, d_total_det).detach().clamp(
        min=1e-30)[..., None]
    sigma_s = med.albedo * med.sigma_t
    xi_c = torch.minimum(xi, d_total_det)   # D(s) where it scatters
    d_s = torch.where(scatter, d_s, 0.0)    # NaN-safe masked lanes
    value = sigma_s * torch.exp(-med.sigma_t * d_s[..., None])
    pdf = _sampling_pdf(med, xi_c).detach().clamp(min=1e-30)[..., None]
    if dens_s is not None:
        value = value * dens_s[..., None]
        pdf = pdf * dens_s.detach().clamp(min=1e-30)[..., None]
    return scatter, s, t_seg, w_pass, value / pdf


# ---------------------------------------------------------------------------
# stacks of regions
# ---------------------------------------------------------------------------

def as_stack(med):
    """A scene's medium (one Medium or a tuple of regions) as a tuple."""
    return (med,) if isinstance(med, Medium) else tuple(med)


def stack_transmittance(med, o, d, t_max):
    """Per-channel transmittance through every region along (o, d) up to
    t_max: the product of the regions' factors."""
    t = 1.0
    for mi in as_stack(med):
        t = t * transmittance(mi, o, d, t_max)
    return t


def stack_sample(media, o, d, t_eff, u):
    """Joint free flight over K regions by Poisson superposition
    (`medium.py:458-515`): each region draws on its own clipped interval,
    the nearest scatter wins, and its weight takes the other regions'
    T_j(t*) / survival_j(t*). `u` (..., K). -> (scatter, t_scat (global
    ray distance, 0 where none), region one-hot (K, ...), T_seg, w_pass,
    w_scat)."""
    k = len(media)
    scs, s_glob, per = [], [], []
    t_seg, w_pass = 1.0, 1.0
    for i, mi in enumerate(media):
        m_t0, m_t1 = medium_interval(mi, o, d)
        seg_t0 = torch.minimum(m_t0, t_eff)
        seg = (torch.minimum(m_t1, t_eff) - seg_t0).clamp(min=0.0)
        sc_i, s_i, t_i, wp_i, ws_i = sample_interaction(
            mi, o, d, seg_t0, seg, u[..., i])
        scs.append(sc_i)
        s_glob.append(torch.where(sc_i, seg_t0 + s_i, torch.inf))
        per.append(ws_i)
        t_seg = t_seg * t_i
        w_pass = w_pass * wp_i
    if k == 1:
        t_scat = torch.where(scs[0], s_glob[0], 0.0)
        return (scs[0], t_scat, torch.ones_like(scs[0])[None], t_seg, w_pass,
                per[0])
    s_arr = torch.stack(s_glob)
    idx = s_arr.argmin(0)
    scatter = torch.stack(scs).any(0)
    t_scat = torch.where(scatter, s_arr.amin(0), 0.0)
    oh = torch.arange(k, device=o.device).reshape(
        (k,) + (1,) * idx.ndim) == idx[None]
    cross = []
    for mi in media:
        # attached numerator, detached survival denominator
        dj = line_density(mi, o, d, t_scat)
        cross.append(torch.exp(-mi.sigma_t * dj[..., None])
                     / _sampling_survival(mi, dj.detach()).detach().clamp(
                         min=1e-30)[..., None])
    w_scat = torch.zeros_like(per[0])
    for i in range(k):
        w_i = per[i]
        for j in range(k):
            if j != i:
                w_i = w_i * cross[j]
        w_scat = torch.where(oh[i][..., None], w_i, w_scat)
    return scatter, t_scat, oh, t_seg, w_pass, w_scat


def stack_phase_pdf(media, region_oh, d_prop, wo):
    """The winning region's phase pdf."""
    out = 0.0
    for i, mi in enumerate(media):
        out = torch.where(region_oh[i], phase_pdf(mi, d_prop, wo), out)
    return out


def stack_phase_sample(media, region_oh, d_prop, u):
    """Sample the winning region's phase function -> (wo, pdf)."""
    wo = pdf = None
    for i, mi in enumerate(media):
        wo_i, pdf_i = phase_sample(mi, d_prop, u)
        wo = wo_i if wo is None else torch.where(region_oh[i][..., None],
                                                 wo_i, wo)
        pdf = pdf_i if pdf is None else torch.where(region_oh[i], pdf_i, pdf)
    return wo, pdf


# ---------------------------------------------------------------------------
# phase functions
# ---------------------------------------------------------------------------

def hg_pdf(g, cos_theta):
    """Henyey-Greenstein value == pdf per solid angle (`hg.cpp:86-101`) in
    the propagation convention (cos_theta = dot(d_prop, wo); g > 0
    forward)."""
    denom = 1.0 + g * g - 2.0 * g * cos_theta
    return _INV_4PI * (1.0 - g * g) / (
        denom * torch.sqrt(denom.clamp(min=1e-12))).clamp(min=1e-12)


def _frame_dir(fwd, cos_t, u_phi):
    """The direction at angle theta about `fwd`, azimuth 2 pi u_phi."""
    cos_t = cos_t.clamp(-1.0, 1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    phi = 2.0 * math.pi * u_phi
    t1v, t2v = _ortho_frame(fwd)
    return ((sin_t * torch.cos(phi))[..., None] * t1v
            + (sin_t * torch.sin(phi))[..., None] * t2v
            + cos_t[..., None] * fwd)


def hg_sample(g, d_prop, u):
    """wo ~ HG about d_prop by the inverse CDF (`hg.cpp:103-127`),
    isotropic where |g| < 1e-4 -> (wo, pdf)."""
    u1, u2 = u[..., 0], u[..., 1]
    g_ = torch.as_tensor(g, dtype=u1.dtype, device=u1.device).expand(
        u1.shape)
    sqr = (1.0 - g_ * g_) / (1.0 - g_ + 2.0 * g_ * u1)
    small = g_.abs() < 1e-4
    cos_hg = (1.0 + g_ * g_ - sqr * sqr) / (2.0 * torch.where(small, 1.0,
                                                              g_))
    cos_t = torch.where(small, 1.0 - 2.0 * u1, cos_hg).clamp(-1.0, 1.0)
    return _frame_dir(d_prop, cos_t, u2), hg_pdf(g_, cos_t)


def rayleigh_pdf(cos_theta):
    """3 / (16 pi) (1 + cos^2)."""
    return (3.0 / (16.0 * math.pi)) * (1.0 + cos_theta * cos_theta)


def rayleigh_sample(d_prop, u):
    """The exact inverse CDF (`rayleigh.cpp::sample`): c = w - 1/w with
    w = cbrt((q + sqrt(q^2 + 4)) / 2), q = 8 u - 4."""
    q = 8.0 * u[..., 0] - 4.0
    w = (0.5 * (q + torch.sqrt(q * q + 4.0))).pow(1.0 / 3.0)
    cos_t = w - 1.0 / w.clamp(min=1e-12)
    return (_frame_dir(d_prop, cos_t, u[..., 1]),
            rayleigh_pdf(cos_t.clamp(-1.0, 1.0)))


def tab_pdf(values, cos_theta):
    """Tabulated phase on a uniform cos grid over [-1, 1], cos = 1
    forward (`tabphase.cpp:116`): the normalised pdf over 2 pi."""
    return continuous_pdf(make_continuous(values, -1.0, 1.0),
                          cos_theta) / (2.0 * math.pi)


def tab_sample(values, d_prop, u):
    """Inverse-CDF sample of the tabulated phase (`tabphase.cpp:77-104`)."""
    cos_t, pdf = continuous_sample_pdf(make_continuous(values, -1.0, 1.0),
                                       u[..., 0])
    return _frame_dir(d_prop, cos_t, u[..., 1]), pdf / (2.0 * math.pi)


def sggx_projected_area(wi, s):
    """sigma(wi) = sqrt(wi^T S wi) (`microflake.h`)."""
    x, y, z = wi[..., 0], wi[..., 1], wi[..., 2]
    sig2 = (x * x * s[..., 0] + y * y * s[..., 1] + z * z * s[..., 2]
            + 2.0 * (x * y * s[..., 3] + x * z * s[..., 4]
                     + y * z * s[..., 5]))
    return safe_sqrt(sig2)


def _sggx_ndf(wm, s):
    """D(wm) = det(S)^(3/2) / (pi (wm^T adj(S) wm)^2)."""
    sxx, syy, szz = s[..., 0], s[..., 1], s[..., 2]
    sxy, sxz, syz = s[..., 3], s[..., 4], s[..., 5]
    det = (sxx * syy * szz - sxx * syz * syz - syy * sxz * sxz
           - szz * sxy * sxy + 2.0 * sxy * sxz * syz).abs()
    x, y, z = wm[..., 0], wm[..., 1], wm[..., 2]
    den = (x * x * (syy * szz - syz * syz)
           + y * y * (sxx * szz - sxz * sxz)
           + z * z * (sxx * syy - sxy * sxy)
           + 2.0 * (x * y * (sxz * syz - szz * sxy)
                    + x * z * (sxy * syz - syy * sxz)
                    + y * z * (sxy * sxz - sxx * syz)))
    return det.clamp(min=0.0) * safe_sqrt(det) / (
        math.pi * (den * den).clamp(min=1e-20))


def _unit(v):
    return v / norm(v, keepdim=True).clamp(min=1e-12)


def _ortho_frame(n):
    """Orthonormal (s, t) about n: s = normalize(a x n), t = n x s, with
    a the z axis unless n is near it."""
    off_z = n[..., 2].abs() < 0.999
    a = torch.stack([torch.where(off_z, 0.0, 1.0),
                     torch.zeros_like(n[..., 0]),
                     torch.where(off_z, 1.0, 0.0)], -1)
    sv = _unit(torch.linalg.cross(a, n, dim=-1))
    return sv, torch.linalg.cross(n, sv, dim=-1)


def sggx_pdf(wi, wo, s):
    """Specular SGGX value == pdf D(wh) / (4 sigma(wi)), wi = -d_prop
    (`sggx.cpp::eval_pdf`)."""
    wh = _unit(wi + wo)
    return 0.25 * _sggx_ndf(wh, s) / sggx_projected_area(wi, s).clamp(
        min=1e-8)


def sggx_sample(wi, u, s):
    """A visible SGGX normal, reflected (`microflake.h::sggx_sample`,
    `sggx.cpp::sample`) -> (wo, pdf)."""
    sv, tv = _ortho_frame(wi)

    def smul(v):
        return torch.stack([
            s[..., 0] * v[..., 0] + s[..., 3] * v[..., 1]
            + s[..., 4] * v[..., 2],
            s[..., 3] * v[..., 0] + s[..., 1] * v[..., 1]
            + s[..., 5] * v[..., 2],
            s[..., 4] * v[..., 0] + s[..., 5] * v[..., 1]
            + s[..., 2] * v[..., 2]], -1)
    ss, st, si = smul(sv), smul(tv), smul(wi)
    s_kk = (sv * ss).sum(-1)
    s_jj = (tv * st).sum(-1)
    s_ii = (wi * si).sum(-1)
    s_kj = (sv * st).sum(-1)
    s_ki = (sv * si).sum(-1)
    s_ji = (tv * si).sum(-1)
    det = (s_kk * (s_jj * s_ii - s_ji * s_ji)
           - s_kj * (s_kj * s_ii - s_ji * s_ki)
           + s_ki * (s_kj * s_ji - s_jj * s_ki)).abs()
    inv_sqrt_ii = 1.0 / safe_sqrt(s_ii).clamp(min=1e-12)
    tmp = safe_sqrt(s_jj * s_ii - s_ji * s_ji)
    inv_tmp = 1.0 / tmp.clamp(min=1e-12)
    zero = torch.zeros_like(det)
    m_k = torch.stack([safe_sqrt(det) * inv_tmp, zero, zero], -1)
    m_j = torch.stack([-inv_sqrt_ii * (s_ki * s_ji - s_kj * s_ii) * inv_tmp,
                       inv_sqrt_ii * tmp, zero], -1)
    m_i = inv_sqrt_ii[..., None] * torch.stack([s_ki, s_ji, s_ii], -1)
    r = safe_sqrt(u[..., 0])
    phi = 2.0 * math.pi * u[..., 1]
    uvw = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                       safe_sqrt(1.0 - u[..., 0])], -1)
    wm_l = _unit(uvw[..., 0:1] * m_k + uvw[..., 1:2] * m_j
                 + uvw[..., 2:3] * m_i)
    wm = _unit(wm_l[..., 0:1] * sv + wm_l[..., 1:2] * tv
               + wm_l[..., 2:3] * wi)
    wo = _unit(2.0 * (wi * wm).sum(-1, keepdim=True) * wm - wi)
    pdf = 0.25 * _sggx_ndf(wm, s) / sggx_projected_area(wi, s).clamp(
        min=1e-8)
    return wo, pdf


def _child_pdf(med: Medium, kind: str, d_prop, wo):
    c = (d_prop * wo).sum(-1)
    if kind == "rayleigh":
        return rayleigh_pdf(c)
    if kind == "tab":
        return tab_pdf(med.phase_tab, c)
    if kind == "sggx":
        return sggx_pdf(-d_prop, wo, med.sggx_s)
    return hg_pdf(med.g2 if kind == "hg2" else med.g, c)


def _child_sample(med: Medium, kind: str, d_prop, u):
    if kind == "rayleigh":
        return rayleigh_sample(d_prop, u)
    if kind == "tab":
        return tab_sample(med.phase_tab, d_prop, u)
    if kind == "sggx":
        return sggx_sample(-d_prop, u, med.sggx_s)
    return hg_sample(med.g2 if kind == "hg2" else med.g, d_prop, u)


def phase_pdf(med: Medium, d_prop, wo):
    """Phase value == pdf; d_prop the propagation direction."""
    if isinstance(med.phase, tuple):
        _, a, b = med.phase
        w = med.phase_w
        return ((1.0 - w) * _child_pdf(med, a, d_prop, wo)
                + w * _child_pdf(med, b, d_prop, wo))
    return _child_pdf(med, med.phase, d_prop, wo)


def phase_sample(med: Medium, d_prop, u):
    """Sample wo about d_prop -> (wo, pdf); a blend picks its child by
    sample reuse on u[..., 0] (`medium.py:807-824`)."""
    if not isinstance(med.phase, tuple):
        return _child_sample(med, med.phase, d_prop, u)
    _, a, b = med.phase
    w = med.phase_w
    pick_b = u[..., 0] < w
    u0 = torch.where(pick_b, u[..., 0] / w.clamp(min=1e-12),
                     (u[..., 0] - w) / (1.0 - w).clamp(min=1e-12))
    u2 = torch.stack([u0.clamp(0.0, 1.0 - 1e-7), u[..., 1]], -1)
    wo_a, _ = _child_sample(med, a, d_prop, u2)
    wo_b, _ = _child_sample(med, b, d_prop, u2)
    wo = torch.where(pick_b[..., None], wo_b, wo_a)
    return wo, phase_pdf(med, d_prop, wo)
