"""Measured BRDFs: the RGL adaptive parameterization (Dupuy & Jakob 2018,
Mitsuba's `measured.cpp`; material kind 17) and the polarized pBRDF
(`measured_polarized.cpp`; kind 18), `tpusky/render/measured.py` in
PyTorch.

An RGL file (`ops/tensorfile.py::read_tensor_file`) holds five tensors
over an incident-direction grid (phi_i, theta_i): the visible-NDF warp
`vndf` (P, T, H, W) that places the half vector, the `luminance` warp
(P, T, H, W) applied before it, the retro-reflection factors `ndf` and
`sigma` (H, W), and the reflectance spectra `spectra` (P, T, L, H2, W2),
or `rgb` (P, T, 3, H2, W2) in an RGB file. The half vector is
parameterized as u_theta = sqrt(2 theta / pi), u_phi = (phi + pi) /
(2 pi), phi relative to phi_i for isotropic data.

The reference's `Marginal2D<Dim, true>` samples a bilinear density by
quadratic CDF inversion in each cell and blends the warps of the
surrounding parameter slices linearly. Blending commutes with prefix
sums, so every slice's CDF tables are built once on the host in float64
(`_build_warp`, numpy); a lane gathers the rows of its four slices,
blends them, searches each axis by counting and solves one quadratic an
axis. An anisotropic file is reduced by the sign folding of
`measured.cpp:246-252`.

The pBRDF holds Mueller matrices `M` (Pd, Td, Th, L, 4, 4) over the
Rusinkiewicz angles (phi_d, theta_d, theta_h) and wavelength, read
multilinearly; its sampling is 10% cosine hemisphere and 90% GGX
reflection at `alpha_sample`.

A dataset lives on one device as a NamedTuple of tensors with its static
facts (isotropic, jacobian, reduction; alpha_sample, wavelength) as
Python values. Nothing here is differentiated: the datasets are data.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import mueller as mu
from ..ops import warp
from ..ops.math import PI, safe_acos, safe_asin, unit


class ParamWarp2D(NamedTuple):
    """A continuous 2-D warp over S = P T parameter slices (vertex grid
    H x W over [0, 1]^2), each slice normalised."""
    density: torch.Tensor   # (S, H, W) vertex densities
    marg: torch.Tensor      # (S, H) marginal vertex values
    cdf_y: torch.Tensor     # (S, H) marginal CDF nodes (cdf_y[-1] = 1)
    cdf_x: torch.Tensor     # (S, H, W) each row's conditional CDF nodes


class MeasuredBRDF(NamedTuple):
    """An RGL measured-BRDF dataset (kind 17)."""
    phi_i: torch.Tensor         # (P,)
    theta_i: torch.Tensor       # (T,)
    wavelengths: torch.Tensor   # (L,); 0, 1, 2 for an RGB file
    ndf: torch.Tensor           # (Hn, Wn)
    sigma: torch.Tensor         # (Hs, Ws)
    vndf: ParamWarp2D
    luminance: ParamWarp2D
    spectra: torch.Tensor       # (P, T, L, H2, W2)
    isotropic: bool
    jacobian: bool
    reduction: int


class MeasuredPolarized(NamedTuple):
    """A pBSDF dataset (kind 18, a `.pbsdf` file). `alpha_sample` only
    steers the GGX sampling lobe; `wavelength` > 0 pins one wavelength for
    RGB renders (-1: the RGB primaries 600, 550, 450 nm)."""
    phi_d: torch.Tensor         # (Pd,)
    theta_d: torch.Tensor       # (Td,)
    theta_h: torch.Tensor       # (Th,)
    wvls: torch.Tensor          # (L,)
    m_data: torch.Tensor        # (Pd, Td, Th, L, 4, 4)
    alpha_sample: float = 0.1
    wavelength: float = -1.0


def _build_warp(data, device="cuda") -> ParamWarp2D:
    """data (P, T, H, W) vertex values -> the per-slice normalised CDF
    tables, built on the host in float64 (`tpusky/render/measured.py:
    95-115`), on `device` in float32."""
    _, _, h, w = data.shape
    v = np.maximum(np.asarray(data, np.float64), 0.0).reshape(-1, h, w)
    dy = 1.0 / (h - 1)
    dx = 1.0 / (w - 1)
    # marginal vertex values: the integral over x of the bilinear row
    marg = ((v[..., :-1] + v[..., 1:]) * 0.5).sum(-1) * dx       # (S, H)
    cell_y = (marg[:, :-1] + marg[:, 1:]) * 0.5 * dy
    total = np.maximum(cell_y.sum(-1, keepdims=True), 1e-12)
    cdf_y = np.concatenate([np.zeros((v.shape[0], 1)),
                            np.cumsum(cell_y, -1)], -1) / total
    marg = marg / total
    v = v / total[..., None]
    # each vertex row's conditional CDF along x
    cell_x = (v[..., :-1] + v[..., 1:]) * 0.5 * dx
    cdf_x = np.concatenate([np.zeros((v.shape[0], h, 1)),
                            np.cumsum(cell_x, -1)], -1)          # (S,H,W)
    return ParamWarp2D(*(torch.tensor(a.astype(np.float32), device=device)
                         for a in (v, marg, cdf_y, cdf_x)))


def load_measured(fields: dict, device="cuda") -> MeasuredBRDF:
    """Assemble a dataset from a parsed tensor file (`read_tensor_file`):
    `spectra` and `wavelengths` for a spectral file, `rgb` for an RGB
    one."""
    theta_i = np.asarray(fields["theta_i"], np.float32)
    phi_i = np.asarray(fields["phi_i"], np.float32)
    spectral = "wavelengths" in fields
    wav = (np.asarray(fields["wavelengths"], np.float32) if spectral
           else np.array([0.0, 1.0, 2.0], np.float32))
    spectra = np.asarray(fields["spectra" if spectral else "rgb"],
                         np.float32)
    isotropic = phi_i.shape[0] <= 2
    reduction = 1
    if not isotropic:
        reduction = int(round((2 * np.pi) / (phi_i[-1] - phi_i[0])))
    jac = bool(np.asarray(fields["jacobian"]).ravel()[0])

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)
    return MeasuredBRDF(
        f32(phi_i), f32(theta_i), f32(wav), f32(fields["ndf"]),
        f32(fields["sigma"]),
        _build_warp(np.asarray(fields["vndf"], np.float32), device),
        _build_warp(np.asarray(fields["luminance"], np.float32), device),
        f32(spectra), isotropic, jac, reduction)


def load_measured_polarized(fields: dict, alpha_sample=0.1,
                            wavelength=-1.0,
                            device="cuda") -> MeasuredPolarized:
    """Assemble a pBSDF dataset from a parsed `.pbsdf` tensor file (the
    field layout of `measured_polarized.cpp:113-160`: the angle grids as
    (1, N) rows)."""
    def grid(name):
        return torch.tensor(np.asarray(fields[name], np.float32).ravel(),
                            device=device)
    m = np.asarray(fields["M"], np.float32)
    if m.ndim != 6 or m.shape[-2:] != (4, 4):
        raise ValueError("invalid pBSDF 'M' tensor")
    return MeasuredPolarized(grid("phi_d"), grid("theta_d"), grid("theta_h"),
                             grid("wvls"), torch.tensor(m, device=device),
                             float(alpha_sample), float(wavelength))


# ---------------------------------------------------------------------------
# parameter-slice weights
# ---------------------------------------------------------------------------

def _grid_weights(grid, x):
    """Linear interpolation on a sorted 1-D grid -> (lower index int64,
    weight of the upper one)."""
    n = grid.shape[0]
    if n == 1:
        return torch.zeros_like(x, dtype=torch.int64), torch.zeros_like(x)
    i = (torch.searchsorted(grid, x.contiguous(), right=True) - 1).clamp(
        0, n - 2)
    g0 = grid[i]
    g1 = grid[i + 1]
    w = ((x - g0) / (g1 - g0).clamp(min=1e-9)).clamp(0.0, 1.0)
    return i, w


def _slice_weights(m: MeasuredBRDF, phi_i, theta_i):
    """The four (slice index, weight) pairs of the (phi_i, theta_i)
    grid."""
    n_p, t_n = m.phi_i.shape[0], m.theta_i.shape[0]
    ip, wp = _grid_weights(m.phi_i, phi_i)
    it, wt = _grid_weights(m.theta_i, theta_i)
    idx = []
    for dp, wq in ((0, 1.0 - wp), (1, wp)):
        for dt, wr in ((0, 1.0 - wt), (1, wt)):
            s = ((ip + dp).clamp(max=n_p - 1) * t_n
                 + (it + dt).clamp(max=t_n - 1))
            idx.append((s, wq * wr))
    return idx


# ---------------------------------------------------------------------------
# the continuous marginal warp: sample, invert
# ---------------------------------------------------------------------------

def _solve_quadratic_cdf(c, f0, f1, dx):
    """t in [0, 1] with c = f0 t dx + (f1 - f0) t^2 dx / 2, in Muller's
    form 2c' / (f0 + sqrt(f0^2 + 2 (f1 - f0) c')), c' = c / dx."""
    cp = c / max(dx, 1e-12)
    a2 = f1 - f0
    disc = (f0 * f0 + 2.0 * a2 * cp).clamp(min=0.0)
    denom = f0 + torch.sqrt(disc)
    return (2.0 * cp / denom.clamp(min=1e-12)).clamp(0.0, 1.0)


def _fetch_row(tab, s, row):
    """Row `row` of slice `s` of an (S, H, W) table -> (..., W)."""
    s_, h, w = tab.shape
    return tab.reshape(s_ * h, w)[s * h + row]


def _pick(tab, idx):
    """tab[..., idx] of (..., K) rows at (...,) indices."""
    return torch.gather(tab, -1, idx[..., None])[..., 0]


def _blend(tab, slices):
    """The slices' rows of an (S, ...) table blended by their weights."""
    return sum(wq[..., None] * tab[s] for s, wq in slices)


def _blend_rows(tab, slices, row):
    return sum(wq[..., None] * _fetch_row(tab, s, row) for s, wq in slices)


def _warp_sample(wp: ParamWarp2D, slices, u):
    """Sample the blended warp at uniforms u (..., 2) -> (position
    (..., 2), pdf)."""
    h = wp.marg.shape[-1]
    w = wp.density.shape[-1]
    dy = 1.0 / (h - 1)
    dx = 1.0 / (w - 1)
    cdf_y = _blend(wp.cdf_y, slices)                        # (..., H)
    marg = _blend(wp.marg, slices)
    uy = u[..., 1]
    row = ((cdf_y <= uy[..., None]).sum(-1) - 1).clamp(0, h - 2)
    c_y = uy - _pick(cdf_y, row)
    m0 = _pick(marg, row)
    m1 = _pick(marg, row + 1)
    t_y = _solve_quadratic_cdf(c_y, m0, m1, dy)
    y = (row.to(u.dtype) + t_y) * dy

    # the interpolated row's density and conditional CDF
    r_d = ((1.0 - t_y[..., None]) * _blend_rows(wp.density, slices, row)
           + t_y[..., None] * _blend_rows(wp.density, slices, row + 1))
    r_c = ((1.0 - t_y[..., None]) * _blend_rows(wp.cdf_x, slices, row)
           + t_y[..., None] * _blend_rows(wp.cdf_x, slices, row + 1))
    m_y = ((1.0 - t_y) * m0 + t_y * m1).clamp(min=1e-12)

    ux = u[..., 0] * m_y
    col = ((r_c <= ux[..., None]).sum(-1) - 1).clamp(0, w - 2)
    c_x = ux - _pick(r_c, col)
    f0 = _pick(r_d, col)
    f1 = _pick(r_d, col + 1)
    t_x = _solve_quadratic_cdf(c_x, f0, f1, dx)
    x = (col.to(u.dtype) + t_x) * dx
    return torch.stack([x, y], -1), (1.0 - t_x) * f0 + t_x * f1


def _warp_invert(wp: ParamWarp2D, slices, pos):
    """The inverse of `_warp_sample`: positions (..., 2) -> (uniforms
    (..., 2), pdf)."""
    h = wp.marg.shape[-1]
    w = wp.density.shape[-1]
    dy = 1.0 / (h - 1)
    dx = 1.0 / (w - 1)
    x = pos[..., 0].clamp(0.0, 1.0)
    y = pos[..., 1].clamp(0.0, 1.0)
    row = (y / dy).to(torch.int64).clamp(0, h - 2)
    t_y = y / dy - row.to(y.dtype)
    col = (x / dx).to(torch.int64).clamp(0, w - 2)
    t_x = x / dx - col.to(x.dtype)

    cdf_y = _blend(wp.cdf_y, slices)
    marg = _blend(wp.marg, slices)
    m0 = _pick(marg, row)
    m1 = _pick(marg, row + 1)
    uy = _pick(cdf_y, row) + dy * (m0 * t_y + 0.5 * (m1 - m0) * t_y * t_y)

    def row_fetch(tab):
        return ((1.0 - t_y[..., None]) * _blend_rows(tab, slices, row)
                + t_y[..., None] * _blend_rows(tab, slices, row + 1))
    r_d = row_fetch(wp.density)
    r_c = row_fetch(wp.cdf_x)
    m_y = ((1.0 - t_y) * m0 + t_y * m1).clamp(min=1e-12)
    f0 = _pick(r_d, col)
    f1 = _pick(r_d, col + 1)
    gx = _pick(r_c, col) + dx * (f0 * t_x + 0.5 * (f1 - f0) * t_x * t_x)
    ux = gx / m_y
    pdf = (1.0 - t_x) * f0 + t_x * f1
    return torch.stack([ux.clamp(0.0, 1.0), uy.clamp(0.0, 1.0)], -1), pdf


def _bilinear_taps(h, w, pos):
    """(x0, y0, tx, ty) of a bilinear lookup on an H x W vertex grid,
    pos in [0, 1]^2 (x along W)."""
    fx = pos[..., 0].clamp(0.0, 1.0) * (w - 1)
    fy = pos[..., 1].clamp(0.0, 1.0) * (h - 1)
    x0 = fx.to(torch.int64).clamp(0, w - 2)
    y0 = fy.to(torch.int64).clamp(0, h - 2)
    return x0, y0, fx - x0, fy - y0


def _bilinear_2d(tab, pos):
    """Bilinear lookup of an (H, W) vertex grid at pos (..., 2)."""
    h, w = tab.shape
    x0, y0, tx, ty = _bilinear_taps(h, w, pos)
    flat = tab.reshape(-1)

    def tap(dy_, dx_):
        return flat[(y0 + dy_) * w + x0 + dx_]
    return ((1 - tx) * (1 - ty) * tap(0, 0) + tx * (1 - ty) * tap(0, 1)
            + (1 - tx) * ty * tap(1, 0) + tx * ty * tap(1, 1))


def _bilinear_2d_param(density, slices, pos):
    """The slices' bilinear lookups of an (S, H, W) stack, blended."""
    _, h, w = density.shape
    x0, y0, tx, ty = _bilinear_taps(h, w, pos)
    flat = density.reshape(-1)

    def tap(s, dy_, dx_):
        return flat[(s * h + y0 + dy_) * w + x0 + dx_]
    out = 0.0
    for s, wq in slices:
        out = out + wq * ((1 - tx) * (1 - ty) * tap(s, 0, 0)
                          + tx * (1 - ty) * tap(s, 0, 1)
                          + (1 - tx) * ty * tap(s, 1, 0)
                          + tx * ty * tap(s, 1, 1))
    return out


# ---------------------------------------------------------------------------
# kind 17 (local shading frame)
# ---------------------------------------------------------------------------

def _elevation(d):
    """The stable elevation of `measured.cpp:195-200`."""
    dist = torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2
                      + (d[..., 2] - 1.0) ** 2)
    return 2.0 * safe_asin(0.5 * dist)


def _theta2u(theta):
    return torch.sqrt((theta * (2.0 / PI)).clamp(min=0.0))


def _phi2u(phi):
    return (phi + PI) * (0.5 / PI)


def _flip(m: MeasuredBRDF, wi):
    """The anisotropic reduction's sign folding (`measured.cpp:246-252`)
    -> the (..., 3) sign vector, None for an isotropic or unreduced
    file."""
    if m.reduction < 2:
        return None
    sy = torch.sign(torch.where(wi[..., 1] == 0.0, 1.0, wi[..., 1]))
    sx = (torch.sign(torch.where(wi[..., 0] == 0.0, 1.0, wi[..., 0]))
          if m.reduction == 4 else sy)
    return torch.stack([sx, sy, torch.ones_like(sx)], -1)


def _spectra_eval(m: MeasuredBRDF, slices, sample, wavelengths):
    """The slices' reflectance at warped coordinates `sample` for each
    output channel (`measured.cpp:297-303`): RGB planes, or the spectra
    lerped at the hero wavelengths."""
    _, _, l, h2, w2 = m.spectra.shape
    flat = m.spectra.reshape(-1)
    x0, y0, tx, ty = _bilinear_taps(h2, w2, sample)

    def plane(s, li):
        def tap(dy_, dx_):
            return flat[((s * l + li) * h2 + y0 + dy_) * w2 + x0 + dx_]
        return ((1 - tx) * (1 - ty) * tap(0, 0) + tx * (1 - ty) * tap(0, 1)
                + (1 - tx) * ty * tap(1, 0) + tx * ty * tap(1, 1))
    out = []
    for ci in range(3 if wavelengths is None else wavelengths.shape[-1]):
        if wavelengths is None:
            acc = sum(wq * plane(s, ci) for s, wq in slices)
        else:
            li0, lw = _grid_weights(m.wavelengths, wavelengths[..., ci])
            li1 = (li0 + 1).clamp(0, l - 1)
            acc = sum(wq * ((1.0 - lw) * plane(s, li0) + lw * plane(s, li1))
                      for s, wq in slices)
        out.append(acc)
    return torch.stack(out, -1)


def _retro(m: MeasuredBRDF, u_m, u_wi):
    """The jacobian files' factor ndf(u_m) / (4 sigma(u_wi))."""
    return (_bilinear_2d(m.ndf, u_m)
            / (4.0 * _bilinear_2d(m.sigma, u_wi)).clamp(min=1e-9))


def measured_eval_pdf(m: MeasuredBRDF, wi, wo, wavelengths=None):
    """(f cos_o (..., C), pdf) of the upper-hemisphere reflection
    (`measured.cpp:316-366` and :399-440)."""
    active = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    flip = _flip(m, wi)
    wi_f, wo_f = (wi, wo) if flip is None else (wi * flip, wo * flip)
    half = wi_f + wo_f
    half = half / torch.linalg.vector_norm(half, dim=-1,
                                           keepdim=True).clamp(min=1e-12)
    theta_i = _elevation(wi_f)
    phi_i = torch.atan2(wi_f[..., 1], wi_f[..., 0])
    theta_m = _elevation(half)
    phi_m = torch.atan2(half[..., 1], half[..., 0])
    phi_rel = phi_m - phi_i if m.isotropic else phi_m
    u_phi = _phi2u(phi_rel)
    u_m = torch.stack([_theta2u(theta_m), u_phi - torch.floor(u_phi)], -1)
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)

    slices = _slice_weights(m, phi_i, theta_i)
    sample, vndf_pdf = _warp_invert(m.vndf, slices, u_m)
    spec = _spectra_eval(m, slices, sample, wavelengths)
    if m.jacobian:
        spec = spec * _retro(m, u_m, u_wi)[..., None]
    lum_pdf = _bilinear_2d_param(m.luminance.density, slices, sample)
    sin_theta_m = torch.sqrt((half[..., 0] ** 2
                              + half[..., 1] ** 2).clamp(min=0.0))
    jacobian = ((2.0 * PI ** 2 * u_m[..., 0] * sin_theta_m).clamp(min=1e-6)
                * 4.0 * (wi_f * half).sum(-1))
    pdf = vndf_pdf * lum_pdf / jacobian.clamp(min=1e-9)
    spec = torch.where(active[..., None] & torch.isfinite(spec), spec, 0.0)
    pdf = torch.where(active & torch.isfinite(pdf), pdf, 0.0)
    return spec, pdf


def measured_sample(m: MeasuredBRDF, wi, u2, wavelengths=None):
    """Sample wo by the luminance, then the VNDF warp (`measured.cpp:
    201-315`) -> (wo, weight = f cos / pdf (..., C), pdf)."""
    active = wi[..., 2] > 0.0
    flip = _flip(m, wi)
    wi_f = wi if flip is None else wi * flip
    theta_i = _elevation(wi_f)
    phi_i = torch.atan2(wi_f[..., 1], wi_f[..., 0])
    u_wi = torch.stack([_theta2u(theta_i), _phi2u(phi_i)], -1)
    slices = _slice_weights(m, phi_i, theta_i)

    u = torch.stack([u2[..., 1], u2[..., 0]], -1)
    u, lum_pdf = _warp_sample(m.luminance, slices, u)
    u_m, vndf_pdf = _warp_sample(m.vndf, slices, u)
    phi_m = (2.0 * u_m[..., 1] - 1.0) * PI
    theta_m = u_m[..., 0] * u_m[..., 0] * (PI / 2.0)
    if m.isotropic:
        phi_m = phi_m + phi_i
    sin_tm = torch.sin(theta_m)
    cos_tm = torch.cos(theta_m)
    half = torch.stack([torch.cos(phi_m) * sin_tm, torch.sin(phi_m) * sin_tm,
                        cos_tm], -1)
    wi_dot_m = (wi_f * half).sum(-1)
    jacobian = ((2.0 * PI ** 2 * u_m[..., 0] * sin_tm).clamp(min=1e-6)
                * 4.0 * wi_dot_m)
    wo_f = half * (2.0 * wi_dot_m)[..., None] - wi_f
    pdf = vndf_pdf * lum_pdf / jacobian.clamp(min=1e-9)

    spec = _spectra_eval(m, slices, u, wavelengths)
    if m.jacobian:
        spec = spec * _retro(m, u_m, u_wi)[..., None]
    wo = wo_f if flip is None else wo_f * flip
    active = active & (wo[..., 2] > 0.0) & (pdf > 1e-9)
    weight = torch.where(active[..., None] & torch.isfinite(spec),
                         spec / pdf.clamp(min=1e-9)[..., None], 0.0)
    pdf = torch.where(active & torch.isfinite(pdf), pdf, 0.0)
    return wo, weight, pdf


# ---------------------------------------------------------------------------
# kind 18: the polarized pBRDF
# ---------------------------------------------------------------------------

def _rotate_z(v, angle):
    """v rotated about +z by `angle`."""
    s, c = torch.sin(angle), torch.cos(angle)
    return torch.stack([v[..., 0] * c - v[..., 1] * s,
                        v[..., 0] * s + v[..., 1] * c, v[..., 2]], -1)


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def _rusinkiewicz(i, o):
    """(phi_d, theta_h, theta_d) of a direction pair in the standard
    frame (`measured_polarized.cpp::directions_to_rusinkiewicz`)."""
    h = unit(i + o)
    n = torch.zeros_like(h)
    n[..., 2] = 1.0
    b = unit(_cross(n, h))
    t = unit(_cross(b, h))
    td = safe_acos((h * i).sum(-1))
    th = safe_acos(h[..., 2])
    i_prj = unit(i - (i * h).sum(-1, keepdim=True) * h)
    cos_pd = (t * i_prj).sum(-1).clamp(-1.0, 1.0)
    sin_pd = (b * i_prj).sum(-1).clamp(-1.0, 1.0)
    return torch.atan2(sin_pd, cos_pd), th, td


def _mp_interp(mp: MeasuredPolarized, pd, td, th, lam):
    """The (4, 4) Mueller block, multilinear over the four grids ->
    (..., 4, 4)."""
    n_pd, n_td = mp.phi_d.shape[0], mp.theta_d.shape[0]
    n_th, n_l = mp.theta_h.shape[0], mp.wvls.shape[0]
    flat = mp.m_data.reshape(-1, 16)
    ip, wp = _grid_weights(mp.phi_d, pd)
    it, wt = _grid_weights(mp.theta_d, td)
    ih, wh = _grid_weights(mp.theta_h, th)
    il, wl = _grid_weights(mp.wvls, lam)
    out = 0.0
    for dp, a in ((0, 1.0 - wp), (1, wp)):
        for dt, b in ((0, 1.0 - wt), (1, wt)):
            for dh, c in ((0, 1.0 - wh), (1, wh)):
                for dl, d in ((0, 1.0 - wl), (1, wl)):
                    idx = ((((ip + dp).clamp(max=n_pd - 1) * n_td
                             + (it + dt).clamp(max=n_td - 1)) * n_th
                            + (ih + dh).clamp(max=n_th - 1)) * n_l
                           + (il + dl).clamp(max=n_l - 1))
                    out = out + (a * b * c * d)[..., None] * flat[idx]
    return out.reshape(out.shape[:-1] + (4, 4))


def _mp_lambda_channels(mp: MeasuredPolarized, wavelengths, like):
    """Each channel's wavelength: the hero wavelengths, the pinned one, or
    the RGB primaries."""
    if wavelengths is not None:
        return [wavelengths[..., i] for i in range(wavelengths.shape[-1])]
    if mp.wavelength > 0.0:
        return [torch.full_like(like, mp.wavelength)] * 3
    return [torch.full_like(like, lam) for lam in (600.0, 550.0, 450.0)]


def _standard_pair(wi, wo):
    """(phi_std, wo_std, wi_std): the pair rotated about z so that wi's
    azimuth is 0."""
    phi_std = torch.atan2(wi[..., 1], wi[..., 0])
    phi_std = torch.where(phi_std < 0.0, phi_std + 2.0 * PI, phi_std)
    return phi_std, _rotate_z(wo, -phi_std), _rotate_z(wi, -phi_std)


def mp_eval_mueller(mp: MeasuredPolarized, wi, wo, wavelengths=None):
    """The polarized eval -> Mueller (..., C, 4, 4) for the implicit
    Stokes bases of (-wo, wi), cos_theta_o included
    (`measured_polarized.cpp:215-312`, the radiance-mode branch)."""
    active = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    phi_std, wo_std, wi_std = _standard_pair(wi, wo)
    pd, th, td = _rusinkiewicz(wo_std, wi_std)
    value = torch.stack([_mp_interp(mp, pd, td, th, lam) for lam in
                         _mp_lambda_channels(mp, wavelengths, pd)], -3)
    # NaN-encoded invalid configurations give 0; M00 is clamped at 0
    bad = torch.isnan(value).any(-1).any(-1)
    value = torch.where(bad[..., None, None], 0.0, value)
    e00 = torch.zeros((4, 4), dtype=torch.bool, device=value.device)
    e00[0, 0] = True
    value = torch.where(e00, value.clamp(min=0.0), value)

    zo_std = -wo_std
    to_std = unit(_cross(wo_std - wi_std, zo_std))
    yo_std = unit(_cross(to_std, zo_std))
    xo_std = _cross(yo_std, zo_std)
    ti_std = unit(_cross(wi_std - wo_std, wi_std))
    yi_std = unit(_cross(ti_std, wi_std))
    xi_std = _cross(yi_std, wi_std)
    xo_hat = _rotate_z(xo_std, phi_std)
    xi_hat = _rotate_z(xi_std, phi_std)
    value = mu.rotate_mueller_basis(
        value, -wo, xo_hat, mu.stokes_basis(-wo),
        wi, xi_hat, mu.stokes_basis(wi))
    value = value * wo[..., 2].clamp(min=0.0)[..., None, None, None]
    return torch.where(active[..., None, None, None], value, 0.0)


_MP_COS_WEIGHT = 0.1     # COSINE_HEMISPHERE_PDF_WEIGHT


def mp_eval_pdf(mp: MeasuredPolarized, wi, wo, wavelengths=None):
    """The unpolarized eval and the sampling pdf: M00 times cos_theta_o
    (..., C); pdf 0.1 cosine + 0.9 GGX(alpha_sample)."""
    from .bsdf import _ggx_ndf
    active = (wi[..., 2] > 0.0) & (wo[..., 2] > 0.0)
    _, wo_std, wi_std = _standard_pair(wi, wo)
    pd, th, td = _rusinkiewicz(wo_std, wi_std)
    vals = [torch.nan_to_num(_mp_interp(mp, pd, td, th, lam)[..., 0, 0])
            .clamp(min=0.0)
            for lam in _mp_lambda_channels(mp, wavelengths, pd)]
    value = torch.stack(vals, -1) * wo[..., 2].clamp(min=0.0)[..., None]
    h = unit(wi + wo)
    alpha = torch.full_like(pd, max(mp.alpha_sample, 1e-3))
    d_ndf = _ggx_ndf(h, alpha)
    wih = (wi * h).sum(-1)
    pdf_mf = d_ndf * h[..., 2] / (4.0 * wih.abs()).clamp(min=1e-6)
    pdf = (_MP_COS_WEIGHT * warp.INV_PI * wo[..., 2].clamp(min=0.0)
           + (1.0 - _MP_COS_WEIGHT) * pdf_mf)
    return (torch.where(active[..., None], value, 0.0),
            torch.where(active, pdf, 0.0))


def mp_sample(mp: MeasuredPolarized, wi, u2, u1):
    """Sample wo: 10% cosine hemisphere, 90% GGX reflection
    (`measured_polarized.cpp:190-214`)."""
    from .bsdf import _ggx_sample, _reflect
    wo_diff = warp.square_to_cosine_hemisphere(u2)
    m = _ggx_sample(torch.full_like(u1, max(mp.alpha_sample, 1e-3)), u2)
    wo_mf = _reflect(wi, m)
    return torch.where((u1 < _MP_COS_WEIGHT)[..., None], wo_diff, wo_mf)
