"""Hosek-Wilkie sun+sky model: precompute, radiance, sampling, pdf.

The PyTorch counterpart of `tpusky/models/sunsky/model.py`, in RGB and
spectral mode. `precompute` derives the per-configuration state from the
parameters in plain tensor ops; the per-direction functions come in two
versions:

* the plain PyTorch versions `_eval_rgb_plain`, `_hit_rgb_plain`,
  `_sample_eval_rgb_plain` and their spectral counterparts
  `_eval_spec_plain`, `_hit_spec_plain`, `_sample_eval_spec_plain`, which
  the CPU tests hold against the JAX package and which serve as the
  reference for the kernels;
* the hand-written CUDA kernels behind `eval`, `eval_pdf` and
  `sample_eval` (`ops/cuda/sunsky_kernel.py`), launched for CUDA tensors:
  K1-K3 in RGB mode, whose backward under autograd is the adjoint kernel
  K5 (radiance) or K6 (the NEE block's radiance) with the pdf detached,
  K7 or K8 with it attached; K9-K11 in spectral mode, whose backward is
  K12 (eval and hit) or K13 (NEE), each with or without the pdf.

Reference behaviour (`src/emitters/sunsky.cpp`): 9-parameter sky formula
(:538-555), 45-segment sun polynomial with baked limb darkening
(:572-614) or, spectral, an order-6 limb-darkening polynomial per
wavelength (:631-650), TGMM sky sampling (:661-763) mixed with uniform
sun-cone sampling by a 64-point Gauss-Legendre luminance ratio
(:772-886).

All direction arguments are unit vectors in the emitter's local frame
(+z = up); batch dims broadcast.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ...ops import warp
from ...ops.distr import (ContinuousDistribution, DiscreteDistribution,
                          continuous_sample_pdf, discrete_sample_reuse,
                          make_continuous, make_discrete)
from ...ops.math import (Frame, cbrt, dir_to_sph, erfinv, gaussian_cdf,
                         lerp, poly_powers, safe_acos, safe_sqrt, sph_dir,
                         unit_angle, unit_angle_z)
from ...ops.quad import gauss_legendre
from ...ops.spectrum import cie1931_y, luminance_rgb, sample_shifted
from . import constants as C
from .tables import SunskyTables, n_channels

PI = math.pi
_F32 = torch.float32


class SunskyParams(NamedTuple):
    """Model inputs: turbidity in [1, 10]; albedo in [0, 1], (3,) in RGB
    mode, (11,) in spectral mode; a unit sun direction in the local frame;
    scales; the sun's half aperture (radians); the disc surrogate's ramp
    width (see `_disc_weight`)."""
    turbidity: torch.Tensor
    albedo: torch.Tensor
    sun_direction: torch.Tensor
    sky_scale: torch.Tensor
    sun_scale: torch.Tensor
    sun_half_aperture: torch.Tensor
    disc_softness: torch.Tensor


def make_params(turbidity=3.0, albedo=0.3, sun_direction=None, sky_scale=1.0,
                sun_scale=1.0, sun_aperture_deg=C.SUN_APERTURE_DEG,
                mode: str = "rgb", disc_softness=1.0,
                device="cuda") -> SunskyParams:
    def f32(v):
        if isinstance(v, torch.Tensor):
            return v.to(dtype=_F32, device=device)
        return torch.tensor(np.array(v, np.float32), device=device)

    nc = n_channels(mode)
    albedo = f32(albedo).broadcast_to((nc,)).clone()
    if sun_direction is None:
        sun_direction = [0.0, 0.0, 1.0]
    sun_direction = f32(sun_direction)
    sun_direction = sun_direction / torch.sqrt((sun_direction ** 2).sum())
    return SunskyParams(f32(turbidity), albedo, sun_direction,
                        f32(sky_scale), f32(sun_scale),
                        torch.deg2rad(f32(0.5 * sun_aperture_deg)),
                        f32(disc_softness))


class SunskyState(NamedTuple):
    params: SunskyParams
    sun_angles: torch.Tensor          # (2,) local (phi, theta)
    sun_frame_s: torch.Tensor         # orthonormal frame around the sun
    sun_frame_t: torch.Tensor
    sun_frame_n: torch.Tensor
    sky_params: torch.Tensor          # (NC, 9), NC = 3 (RGB) or 11
    sky_radiance: torch.Tensor        # (NC,)
    sun_radiance: torch.Tensor        # RGB (45, 72): [c * 24 + k * 6 + j];
    #                                   spectral (45, 44): [c * 4 + k]
    sun_ld: Optional[torch.Tensor]    # (11, 6) limb darkening; None in RGB
    gaussians: torch.Tensor           # (20, 5)
    gaussian_distr: DiscreteDistribution
    sky_sampling_w: torch.Tensor      # ()
    # wavelength distribution over [360, 720] nm; None in RGB mode
    spectral_distr: Optional[ContinuousDistribution]


# ---------------------------------------------------------------------------
# Precompute
# ---------------------------------------------------------------------------

_BEZIER_COEFS = np.array([1.0, 5.0, 10.0, 10.0, 5.0, 1.0], np.float32)


def _take0(table, idx):
    """table[idx] along axis 0 for a 0-d integer tensor idx."""
    return table.index_select(0, idx.reshape(1))[0]


def _turbidity_lerp(table, turbidity):
    """Lerp a table with leading turbidity axis (size 10, levels 1..10)."""
    t_high = torch.floor(turbidity)
    t_rem = turbidity - t_high
    t_high_i = t_high.long()
    low = _take0(table, (t_high_i - 1).clamp(0, C.N_TURBIDITY - 1))
    high = _take0(table, t_high_i.clamp(0, C.N_TURBIDITY - 1))
    high = torch.where(t_high_i < C.N_TURBIDITY, high, 0.0)
    return lerp(low, high, t_rem)


def _sky_table_interp(table, albedo, turbidity, eta):
    """(10, 2, 6, 3, ...) table -> (3, ...): quintic Bernstein blend over
    the 6 elevation control points in x = cbrt(2 eta / pi), then lerps
    over turbidity and albedo; zero outside eta in [0, pi/2]."""
    x = cbrt(2.0 * eta / PI).clamp(0.0, 1.0)
    coefs = torch.as_tensor(_BEZIER_COEFS, device=table.device)
    bern = (coefs * poly_powers(x, C.N_SKY_CTRL_PTS)
            * poly_powers(1.0 - x, C.N_SKY_CTRL_PTS).flip(-1))
    bern = bern.reshape((1, 1, C.N_SKY_CTRL_PTS) + (1,) * (table.ndim - 3))
    bez = (table * bern).sum(2)                       # (10, 2, 3, ...)
    by_alb = _turbidity_lerp(bez, turbidity)          # (2, 3, ...)
    alb = albedo.reshape((-1,) + (1,) * (by_alb.ndim - 2))
    res = lerp(by_alb[0], by_alb[1], alb)
    valid = (eta >= 0.0) & (eta <= 0.5 * PI)
    return torch.where(valid, res, 0.0)


def _tgmm_mixture(tgmm, turbidity, eta):
    """Blend the 4 neighbouring (turbidity, elevation) TGMM fits -> (20, 5)
    gaussians [mu_phi, mu_theta, sigma_phi, sigma_theta, w], weights scaled
    by the bilinear factors."""
    eta_f = ((torch.rad2deg(eta) - 2.0) / 3.0).clamp(0.0, C.N_ETAS - 1)
    t_f = (turbidity - 2.0).clamp(0.0, C.N_TGMM_TURBIDITY - 1)
    eta_lo = torch.floor(eta_f).long().clamp(0, C.N_ETAS - 1)
    t_lo = torch.floor(t_f).long().clamp(0, C.N_TGMM_TURBIDITY - 1)
    eta_hi = (eta_lo + 1).clamp(max=C.N_ETAS - 1)
    t_hi = (t_lo + 1).clamp(max=C.N_TGMM_TURBIDITY - 1)
    eta_rem = eta_f - eta_lo
    t_rem = t_f - t_lo

    corners = [(t_lo, eta_lo), (t_lo, eta_hi), (t_hi, eta_lo), (t_hi, eta_hi)]
    factors = torch.stack([(1 - t_rem) * (1 - eta_rem), (1 - t_rem) * eta_rem,
                           t_rem * (1 - eta_rem), t_rem * eta_rem])
    mixes = torch.stack([_take0(_take0(tgmm, t), e) for t, e in corners])
    weights = mixes[..., -1] * factors[:, None]
    mixes = torch.cat([mixes[..., :-1], weights[..., None]], -1)
    return mixes.reshape(C.N_MIX_GAUSSIANS, C.N_GAUSSIAN_PARAMS)


def precompute(tables: SunskyTables, params: SunskyParams,
               mode: str = "rgb") -> SunskyState:
    """Derive the renderer-facing state from model parameters; `mode` is
    the tables' ("rgb" or "spectral")."""
    sun_dir = params.sun_direction / torch.sqrt(
        (params.sun_direction ** 2).sum())
    phi, theta = dir_to_sph(sun_dir)
    frame = Frame(sun_dir)
    eta = 0.5 * PI - theta

    sky_params = _sky_table_interp(tables.sky_params, params.albedo,
                                   params.turbidity, eta)
    sky_radiance = _sky_table_interp(tables.sky_rad, params.albedo,
                                     params.turbidity, eta)
    sun_radiance = _turbidity_lerp(tables.sun_rad, params.turbidity)
    sun_radiance = sun_radiance.reshape(C.N_SUN_SEGMENTS, -1)
    gaussians = _tgmm_mixture(tables.tgmm, params.turbidity, eta)

    state = SunskyState(params, torch.stack([phi, theta]), frame.s, frame.t,
                        frame.n, sky_params, sky_radiance, sun_radiance,
                        tables.sun_ld, gaussians,
                        make_discrete(gaussians[:, -1]),
                        torch.full((), 0.5, dtype=_F32, device=eta.device),
                        None)
    sky_w, spectral_distr = _estimate_sky_sun_ratio(state, mode)
    return state._replace(sky_sampling_w=sky_w,
                          spectral_distr=spectral_distr)


# ---------------------------------------------------------------------------
# Radiance evaluation
# ---------------------------------------------------------------------------

# flat (k, j) index pairs of the RGB sun coefficient block
_SUN_RGB_K = np.arange(C.N_SUN_CTRL_PTS * C.N_SUN_LD_PARAMS) \
    // C.N_SUN_LD_PARAMS
_SUN_RGB_J = np.arange(C.N_SUN_CTRL_PTS * C.N_SUN_LD_PARAMS) \
    % C.N_SUN_LD_PARAMS


def _sky_formula(coefs, mean_rad, cos_theta, gamma):
    """Hosek-Wilkie sky radiance; coefs (..., 9), scalars broadcast."""
    cos_gamma = torch.cos(gamma)
    cos_gamma_sqr = cos_gamma * cos_gamma
    a, b, c, d, e, f, g, i, h = (coefs[..., k] for k in range(9))
    c1 = 1.0 + a * torch.exp(b / (cos_theta + 0.01))
    # h (param 8) is the mie anisotropy; i (param 7) weighs the zenith term
    base = 1.0 + h * h - 2.0 * h * cos_gamma
    chi = (1.0 + cos_gamma_sqr) / (base * safe_sqrt(base))
    c2 = (c + d * torch.exp(e * gamma) + f * cos_gamma_sqr + g * chi
          + i * safe_sqrt(cos_theta.clamp(min=0.0)))
    return c1 * c2 * mean_rad


def _sun_segment(cos_theta):
    """Piecewise-polynomial segment index and local coordinate x."""
    elevation = 0.5 * PI - safe_acos(cos_theta)
    pos_f = cbrt(2.0 * elevation / PI) * C.N_SUN_SEGMENTS
    pos = torch.floor(pos_f).long().clamp(0, C.N_SUN_SEGMENTS - 1)
    break_x = 0.5 * PI * (pos.to(cos_theta.dtype) / C.N_SUN_SEGMENTS) ** 3
    return pos, (elevation - break_x).clamp(min=0.0)


def _cos_psi(gamma, sun_half_aperture):
    """Cosine of the angle to the sun's limb (for limb darkening)."""
    sol_rad_sin = torch.sin(sun_half_aperture)
    sin_gamma = torch.sin(gamma)
    return safe_sqrt(1.0 - (sin_gamma * sin_gamma)
                     / (sol_rad_sin * sol_rad_sin))


def area_ratio(sun_half_aperture):
    """Ratio of the physical sun disc's solid angle to a custom aperture's."""
    full = torch.cos(torch.tensor(C.SUN_HALF_APERTURE, dtype=_F32,
                                  device=sun_half_aperture.device))
    return (1.0 - full) / (1.0 - torch.cos(sun_half_aperture))


def _sun_rgb_from_flat(coefs_flat, x, cos_psi):
    """RGB sun radiance from (..., 72) coefficients laid out as
    [c * 24 + k * 6 + j] (channel, elevation power, limb power)."""
    xp = poly_powers(x, C.N_SUN_CTRL_PTS)
    cp = poly_powers(cos_psi, C.N_SUN_LD_PARAMS)
    w = xp[..., _SUN_RGB_K] * cp[..., _SUN_RGB_J]          # (..., 24)
    block = C.N_SUN_CTRL_PTS * C.N_SUN_LD_PARAMS
    return torch.stack([(coefs_flat[..., c * block:(c + 1) * block] * w)
                        .sum(-1) for c in range(3)], -1)


def eval_sky_rgb(state: SunskyState, cos_theta, gamma):
    """Sky radiance, RGB channels -> (..., 3). No scale/normalisation."""
    return _sky_formula(state.sky_params, state.sky_radiance,
                        cos_theta[..., None], gamma[..., None])


def eval_sun_rgb(state: SunskyState, cos_theta, gamma):
    """Sun radiance with baked limb darkening -> (..., 3)."""
    pos, x = _sun_segment(cos_theta)
    return _sun_rgb_from_flat(state.sun_radiance[pos], x,
                              _cos_psi(gamma, state.params.sun_half_aperture))


def _disc_weight(state, gamma):
    """Sun-disc indicator with a straight-through surrogate gradient: the
    value is exactly the hard cone test (`sunsky.cpp:303`); the gradient
    routes through a linear ramp in cos(gamma) of half-width
    0.5 * (1 - cos(aperture)) * disc_softness (see the reference package's
    `_disc_weight` for why)."""
    cos_cut = torch.cos(state.params.sun_half_aperture)
    cos_g = torch.cos(gamma)
    hard = (cos_g >= cos_cut).to(cos_g.dtype)
    eps = 0.5 * (1.0 - cos_cut) * state.params.disc_softness
    smooth = ((cos_g - cos_cut) / eps.clamp(min=1e-12) + 0.5).clamp(0.0, 1.0)
    return smooth + (hard - smooth).detach()


def _eval_rgb_plain(state: SunskyState, d):
    """RGB radiance (..., 3) in plain tensor ops: K1's plain version."""
    cos_theta = d[..., 2]
    gamma = unit_angle(state.sun_frame_n, d)
    below = cos_theta < 0.0
    cos_theta_c = cos_theta.clamp(min=0.0)
    p = state.params
    sky = eval_sky_rgb(state, cos_theta_c, gamma)
    sun = eval_sun_rgb(state, cos_theta_c, gamma)
    w_disc = _disc_weight(state, gamma)
    res = (p.sky_scale * sky
           + w_disc[..., None]
           * (p.sun_scale * sun * area_ratio(p.sun_half_aperture)
              * C.SPEC_TO_RGB_SUN_CONV))
    res = res * C.CIE_Y_NORMALIZATION
    return torch.where(below[..., None], 0.0, res)


def _select_channels(all_ch, idx):
    """all_ch (..., 11) at the integer channels idx (..., W) -> (..., W),
    the batch dimensions broadcast."""
    batch = torch.broadcast_shapes(all_ch.shape[:-1], idx.shape[:-1])
    return torch.gather(all_ch.expand(batch + all_ch.shape[-1:]), -1,
                        idx.expand(batch + idx.shape[-1:]))


def _eval_sun_all_channels(state: SunskyState, cos_theta):
    """Spectral sun radiance (no limb darkening) at all 11 dataset
    channels -> (..., 11)."""
    pos, x = _sun_segment(cos_theta)
    coefs = state.sun_radiance[pos]                         # (..., 44)
    coefs = coefs.reshape(coefs.shape[:-1] + (C.N_WAVELENGTHS,
                                              C.N_SUN_CTRL_PTS))
    return (coefs * poly_powers(x, C.N_SUN_CTRL_PTS)[..., None, :]).sum(-1)


def _eval_sun_ld_all(state: SunskyState, gamma):
    """Spectral limb-darkening factor at all 11 channels -> (..., 11)."""
    cp = poly_powers(_cos_psi(gamma, state.params.sun_half_aperture),
                     C.N_SUN_LD_PARAMS)                     # (..., 6)
    return (cp[..., None, :] * state.sun_ld).sum(-1)


def eval_spectral(state: SunskyState, cos_theta, gamma, wavelengths):
    """Spectral radiance at arbitrary wavelengths (..., W): each of sky,
    sun and limb darkening is lerped between the two dataset channels
    around a wavelength, then they are combined (a lerp of the product
    would differ); zero outside [320, 720] nm."""
    norm_wl = (wavelengths - C.WAVELENGTHS[0]) / C.WAVELENGTH_STEP
    valid = (norm_wl >= 0.0) & (norm_wl <= C.N_WAVELENGTHS - 1)
    idx_low = torch.floor(norm_wl).long().clamp(0, C.N_WAVELENGTHS - 1)
    idx_high = (idx_low + 1).clamp(max=C.N_WAVELENGTHS - 1)
    lerp_f = norm_wl - idx_low

    def at_wavelengths(all_ch):
        return lerp(_select_channels(all_ch, idx_low),
                    _select_channels(all_ch, idx_high), lerp_f)

    sky = at_wavelengths(_sky_formula(state.sky_params, state.sky_radiance,
                                      cos_theta[..., None], gamma[..., None]))
    sun = at_wavelengths(_eval_sun_all_channels(state, cos_theta))
    sun_ld = at_wavelengths(_eval_sun_ld_all(state, gamma))
    p = state.params
    w_disc = _disc_weight(state, gamma)
    res = (p.sky_scale * sky
           + w_disc[..., None] * (p.sun_scale * sun * sun_ld
                                  * area_ratio(p.sun_half_aperture)))
    active = (cos_theta >= 0.0)[..., None] & valid
    return torch.where(active, res, 0.0)


def _eval_spec_plain(state: SunskyState, d, wavelengths):
    """Spectral radiance (..., W) in plain tensor ops: K9's plain version.
    The formulas' input is clamped to the upper hemisphere so that masked
    lanes stay finite under autograd."""
    cos_theta = d[..., 2]
    gamma = unit_angle(state.sun_frame_n, d)
    res = eval_spectral(state, cos_theta.clamp(min=0.0), gamma, wavelengths)
    return torch.where((cos_theta < 0.0)[..., None], 0.0, res)


def _kernels():
    from ...ops.cuda import sunsky_kernel
    return sunsky_kernel


def _flat_wavelengths(wavelengths, batch):
    """Wavelengths broadcast to the lanes' batch -> contiguous (N, W)."""
    nw = wavelengths.shape[-1]
    return wavelengths.broadcast_to(batch + (nw,)).reshape(-1, nw) \
        .contiguous()


def _need_wavelengths(mode, wavelengths):
    if mode not in ("rgb", "spectral"):
        raise ValueError(f"unknown color mode {mode!r}")
    if mode == "spectral" and wavelengths is None:
        raise ValueError("spectral mode needs wavelengths")


def eval(state: SunskyState, d, mode: str = "rgb", plain: bool = False,
         wavelengths=None):
    """Emitted radiance along local direction d (pointing at the sky)
    (reference `sunsky.cpp:303-352`): RGB mode -> (..., 3) linear sRGB,
    kernel K1 (K5 backward) for CUDA tensors; spectral mode -> (..., W) at
    `wavelengths` (..., W) in nm, kernel K9 (K12 backward). `plain=True` runs the plain
    version on any device (the reference the kernels are held against)."""
    _need_wavelengths(mode, wavelengths)
    if mode == "spectral":
        if plain:
            return _eval_spec_plain(state, d, wavelengths)
        batch = d.shape[:-1]
        out = _kernels().sunsky_eval_spec(
            state, d.reshape(-1, 3).contiguous(),
            _flat_wavelengths(wavelengths, batch))
        return out.reshape(batch + out.shape[-1:])
    if plain:
        return _eval_rgb_plain(state, d)
    out = _kernels().sunsky_eval_rgb(state, d.reshape(-1, 3).contiguous())
    return out.reshape(d.shape[:-1] + (3,))


# ---------------------------------------------------------------------------
# Importance sampling
# ---------------------------------------------------------------------------

_TRUNC_A = (0.0, 0.0)
_TRUNC_B = (2.0 * np.pi, 0.5 * np.pi)


def _trunc(bounds, like):
    return torch.tensor(np.asarray(bounds, np.float32), device=like.device)


def sample_sky(state: SunskyState, sample):
    """Sample a sky direction from the truncated gaussian mixture.
    sample: (..., 2) uniform -> local unit directions (..., 3)."""
    idx, reused = discrete_sample_reuse(state.gaussian_distr, sample[..., 0])
    reused = reused.detach()        # sample placement, not differentiable
    g = state.gaussians[idx]                        # (..., 5)
    mu = g[..., 0:2]
    sigma = g[..., 2:4]
    cdf_a = gaussian_cdf(mu, sigma, _trunc(_TRUNC_A, g))
    cdf_b = gaussian_cdf(mu, sigma, _trunc(_TRUNC_B, g))
    u = torch.stack([reused, sample[..., 1]], -1)
    p = lerp(cdf_a, cdf_b, u).clamp(C.EPSILON_F32, 1.0 - C.EPSILON_F32)
    angles = math.sqrt(2.0) * erfinv(2.0 * p - 1.0) * sigma + mu
    phi = angles[..., 0] + state.sun_angles[0] - 0.5 * PI
    theta = angles[..., 1].clamp(max=0.5 * PI - C.EPSILON_F32)
    return sph_dir(theta, phi)


def sample_sun(state: SunskyState, sample):
    """Uniform direction in the sun cone; sample (..., 2) -> (..., 3)."""
    local = warp.square_to_uniform_cone(
        sample, torch.cos(state.params.sun_half_aperture))
    return (local[..., 0:1] * state.sun_frame_s
            + local[..., 1:2] * state.sun_frame_t
            + local[..., 2:3] * state.sun_frame_n)


def tgmm_pdf(state: SunskyState, angles, active):
    """TGMM density in (phi, theta) space (no solid-angle jacobian)."""
    phi = angles[..., 0] - (state.sun_angles[0] - 0.5 * PI)
    phi = torch.where(phi < 0, phi + 2 * PI, phi)
    phi = torch.where(phi > 2 * PI, phi - 2 * PI, phi)
    theta = angles[..., 1]
    active = active & (theta >= 0.0) & (theta <= 0.5 * PI)

    g = state.gaussians                             # (20, 5)
    mu, sigma, w = g[:, 0:2], g[:, 2:4], g[:, 4]
    cdf_a = gaussian_cdf(mu, sigma, _trunc(_TRUNC_A, g))
    cdf_b = gaussian_cdf(mu, sigma, _trunc(_TRUNC_B, g))
    volume = ((cdf_b[:, 0] - cdf_a[:, 0]) * (cdf_b[:, 1] - cdf_a[:, 1])
              * sigma[:, 0] * sigma[:, 1])
    x = torch.stack([phi, theta], -1)[..., None, :]      # (..., 1, 2)
    z = (x - mu) / sigma                                 # (..., 20, 2)
    pdf = (w * warp.square_to_std_normal_pdf(z) / volume).sum(-1)
    return torch.where(active, pdf, 0.0)


def compute_pdfs(state: SunskyState, d, check_sun):
    """(sky_pdf, sun_pdf) of a local direction d; solid-angle measure.
    check_sun (bool or (...,) bool): count the cone pdf only inside the
    cone (False for directions drawn from the cone itself)."""
    cos_theta = d[..., 2]
    sin_theta = safe_sqrt(d[..., 0] ** 2 + d[..., 1] ** 2)
    active = (cos_theta >= 0.0) & (sin_theta != 0.0)
    sin_theta = sin_theta.clamp(min=C.SIN_OFFSET)

    phi, theta = dir_to_sph(d)
    sky_pdf = tgmm_pdf(state, torch.stack([phi, theta], -1),
                       active) / sin_theta

    cos_cutoff = torch.cos(state.params.sun_half_aperture)
    cone_pdf = warp.square_to_uniform_cone_pdf(cos_cutoff)
    in_cone = (state.sun_frame_n * d).sum(-1) >= cos_cutoff
    check_sun = torch.as_tensor(check_sun, device=d.device)
    sun_pdf = torch.where(~check_sun | in_cone, cone_pdf, 0.0)
    sun_pdf = torch.where(active, sun_pdf, 0.0)
    return sky_pdf, sun_pdf


def sample_direction(state: SunskyState, sample):
    """Importance-sample an emitter direction: sample (..., 2) uniform ->
    (d_local (..., 3), pdf (...,)). Mixture of TGMM sky sampling and
    uniform sun-cone sampling weighted by the luminance ratio."""
    w = state.sky_sampling_w.detach()     # strategy choice = placement
    pick_sky = sample[..., 0] < w
    sky_u = torch.stack([(sample[..., 0] / w.clamp(min=1e-12)).clamp(0, 1),
                         sample[..., 1]], -1)
    sun_u = torch.stack([((sample[..., 0] - w)
                          / (1 - w).clamp(min=1e-12)).clamp(0, 1),
                         sample[..., 1]], -1)
    d = torch.where(pick_sky[..., None], sample_sky(state, sky_u),
                    sample_sun(state, sun_u))
    sky_pdf, sun_pdf = compute_pdfs(state, d, check_sun=pick_sky)
    pdf = lerp(sun_pdf, sky_pdf, w)
    pdf = torch.where(d[..., 2] >= 0.0, pdf, 0.0)
    return d, pdf


def pdf_direction(state: SunskyState, d):
    """Solid-angle pdf of `sample_direction` for local direction d."""
    sky_pdf, sun_pdf = compute_pdfs(state, d, check_sun=True)
    return lerp(sun_pdf, sky_pdf, state.sky_sampling_w)


# ---------------------------------------------------------------------------
# Emitter-hit and NEE blocks (kernels K2 and K3)
# ---------------------------------------------------------------------------


def _hit_rgb_plain(state: SunskyState, d):
    """(radiance, pdf) toward d: K2's plain version."""
    return _eval_rgb_plain(state, d), pdf_direction(state, d)


def _sample_eval_rgb_plain(state: SunskyState, u2):
    """(direction, radiance, pdf) of an NEE sample: K3's plain version."""
    d, pdf = sample_direction(state, u2)
    d = d.detach()            # sample placement (`prb.py:147-160`)
    return d, _eval_rgb_plain(state, d), pdf


def _hit_spec_plain(state: SunskyState, d, wavelengths):
    """(spectral radiance, pdf) toward d: K10's plain version."""
    return _eval_spec_plain(state, d, wavelengths), pdf_direction(state, d)


def _sample_eval_spec_plain(state: SunskyState, u2, wavelengths):
    """(direction, spectral radiance, pdf) of an NEE sample: K11's plain
    version."""
    d, pdf = sample_direction(state, u2)
    d = d.detach()            # sample placement (`prb.py:147-160`)
    return d, _eval_spec_plain(state, d, wavelengths), pdf


def eval_pdf(state: SunskyState, d, mode: str = "rgb",
             pdf_detached: bool = False, plain: bool = False,
             wavelengths=None):
    """Radiance + solid-angle pdf toward local direction d (the
    emitter-hit MIS block): kernel K2 for CUDA tensors, or K10 in
    spectral mode. pdf_detached=True is the render contract (the pdf is
    only used detached): K5 (K12 without the pdf) backward; with the pdf
    attached K7 (K12 with the pdf)."""
    _need_wavelengths(mode, wavelengths)
    if mode == "spectral":
        if plain:
            rad, pdf = _hit_spec_plain(state, d, wavelengths)
        else:
            batch = d.shape[:-1]
            rad, pdf = _kernels().sunsky_hit_spec(
                state, d.reshape(-1, 3).contiguous(),
                _flat_wavelengths(wavelengths, batch),
                pdf_detached=pdf_detached)
            rad = rad.reshape(batch + rad.shape[-1:])
            pdf = pdf.reshape(batch)
    elif plain:
        rad, pdf = _hit_rgb_plain(state, d)
    else:
        rad, pdf = _kernels().sunsky_hit_rgb(
            state, d.reshape(-1, 3).contiguous(), pdf_detached=pdf_detached)
        rad = rad.reshape(d.shape[:-1] + (3,))
        pdf = pdf.reshape(d.shape[:-1])
    return rad, (pdf.detach() if pdf_detached else pdf)


def sample_eval(state: SunskyState, u2, mode: str = "rgb",
                pdf_detached: bool = False, plain: bool = False,
                wavelengths=None):
    """Importance-sample a direction and evaluate its radiance + pdf (the
    NEE block): kernel K3 for CUDA tensors, K6 backward with the pdf
    detached, K8 with it attached; in spectral mode kernel K11, K13
    backward (without or with the pdf). Returns (d_local (..., 3),
    detached; radiance (..., 3) or (..., W); pdf (...,))."""
    _need_wavelengths(mode, wavelengths)
    if mode == "spectral":
        if plain:
            d, rad, pdf = _sample_eval_spec_plain(state, u2, wavelengths)
        else:
            batch = u2.shape[:-1]
            d, rad, pdf = _kernels().sunsky_nee_spec(
                state, u2.reshape(-1, 2).contiguous(),
                _flat_wavelengths(wavelengths, batch),
                pdf_detached=pdf_detached)
            d = d.reshape(batch + (3,))
            rad = rad.reshape(batch + rad.shape[-1:])
            pdf = pdf.reshape(batch)
    elif plain:
        d, rad, pdf = _sample_eval_rgb_plain(state, u2)
    else:
        batch = u2.shape[:-1]
        d, rad, pdf = _kernels().sunsky_nee_rgb(
            state, u2.reshape(-1, 2).contiguous(), pdf_detached=pdf_detached)
        d = d.reshape(batch + (3,))
        rad = rad.reshape(batch + (3,))
        pdf = pdf.reshape(batch)
    return d, rad, (pdf.detach() if pdf_detached else pdf)


def sample_wavelengths(state: SunskyState, u, n: int = 4):
    """Importance-sample n hero wavelengths from the precomputed spectral
    distribution: u (...,) uniform -> (wavelengths (..., n), pdf (..., n))."""
    return continuous_sample_pdf(state.spectral_distr, sample_shifted(u, n))


# ---------------------------------------------------------------------------
# Sky/sun luminance ratio (Gauss-Legendre quadrature)
# ---------------------------------------------------------------------------


def _estimate_sky_sun_ratio(state: SunskyState, mode: str = "rgb",
                            n_quad: int = 64):
    """Integrated sky vs sun luminance -> (sky sampling weight, spectral
    distribution over [360, 720] nm or None in RGB mode).

    64 Gauss-Legendre points per axis, as in the reference package (the
    weight only balances the two sampling strategies; any value is
    unbiased)."""
    p = state.params
    dev = state.sky_params.device
    xq, wq = gauss_legendre(n_quad)
    xq = torch.tensor(xq, dtype=_F32, device=dev)
    wq = torch.tensor(wq, dtype=_F32, device=dev)

    # sky: [-1,1]^2 -> phi in [0,2pi], cos_theta in [0,1]
    phi = PI * (xq + 1.0)
    cos_theta = 0.5 * (xq + 1.0)
    phi_g, ct_g = torch.meshgrid(phi, cos_theta, indexing="xy")
    w_g = torch.outer(wq, wq).T
    st_g = safe_sqrt(1.0 - ct_g * ct_g)
    wo = torch.stack([st_g * torch.cos(phi_g), st_g * torch.sin(phi_g),
                      ct_g], -1)
    gamma = unit_angle(state.sun_frame_n, wo)
    sky_spec = _sky_formula(state.sky_params, state.sky_radiance,
                            ct_g[..., None], gamma[..., None])
    sky_int = (sky_spec * w_g[..., None]).sum((0, 1)) * (0.5 * PI)

    # sun: cone around the sun direction, cos_gamma in [cos_cutoff, 1]
    cos_cutoff = torch.cos(p.sun_half_aperture)
    jac = 0.5 * PI * (1.0 - cos_cutoff)
    cg = 0.5 * ((1.0 - cos_cutoff) * xq + (1.0 + cos_cutoff))
    phi_g, cg_g = torch.meshgrid(phi, cg, indexing="xy")
    sg_g = safe_sqrt(1.0 - cg_g * cg_g)
    local = torch.stack([sg_g * torch.cos(phi_g), sg_g * torch.sin(phi_g),
                         cg_g], -1)
    gamma_sun = unit_angle_z(local)
    wo_sun = (local[..., 0:1] * state.sun_frame_s
              + local[..., 1:2] * state.sun_frame_t
              + local[..., 2:3] * state.sun_frame_n)
    ct_sun = wo_sun[..., 2]
    if mode == "rgb":
        pos, x = _sun_segment(ct_sun)
        sun_spec = _sun_rgb_from_flat(state.sun_radiance[pos], x,
                                      _cos_psi(gamma_sun,
                                               p.sun_half_aperture))
    else:
        sun_spec = (_eval_sun_all_channels(state, ct_sun)
                    * _eval_sun_ld_all(state, gamma_sun))
    sun_spec = torch.where((ct_sun >= 0.0)[..., None], sun_spec, 0.0)
    sun_int = (sun_spec * w_g[..., None]).sum((0, 1)) * jac

    spectral_distr = None
    if mode == "rgb":
        sky_lum = p.sky_scale * luminance_rgb(sky_int)
        sun_lum = (p.sun_scale * luminance_rgb(sun_int)
                   * area_ratio(p.sun_half_aperture)
                   * C.SPEC_TO_RGB_SUN_CONV)
    else:
        cie_y = cie1931_y(torch.tensor(C.WAVELENGTHS, dtype=_F32, device=dev))
        sky_lum = p.sky_scale * (cie_y * sky_int).mean()
        sun_lum = (p.sun_scale * (cie_y * sun_int).mean()
                   * area_ratio(p.sun_half_aperture))
        # wavelength distribution over [360, 720] (channel 0, 320 nm, left
        # out, as the reference package does)
        spec = (sky_int + sun_int)[1:]
        spec = torch.where((spec == 0.0).all(), torch.ones_like(spec), spec)
        spectral_distr = make_continuous(spec, float(C.WAVELENGTHS[1]),
                                         float(C.WAVELENGTHS[-1]))
    ratio = sky_lum / (sky_lum + sun_lum)
    return torch.where(torch.isnan(ratio), 0.0, ratio), spectral_distr
