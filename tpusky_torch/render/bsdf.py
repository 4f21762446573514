"""Material table: the diffuse, conductor and smooth dielectric kinds of
`tpusky/render/bsdf.py`.

Kinds (the reference package's numbering):

  0 diffuse         smooth Lambertian (`diffuse.cpp`)
  1 roughconductor  GGX microfacet + complex-IOR Fresnel
                    (`roughconductor.cpp`, `microfacet.h`)
  2 conductor       smooth mirror + complex-IOR Fresnel (delta lobe)
  3 dielectric      smooth glass, reflect or refract by Fresnel (delta)
  7 thindielectric  thin glass sheet: delta reflection or straight-through
                    transmission, reflectance R* = 2F/(1+F)
                    (`thindielectric.cpp`)

Kinds 0-2 sit behind the `twosided.cpp` adapter; the dielectrics are
two-sided by construction. Materials live in one struct-of-arrays table;
`eval_pdf` and `sample` evaluate the lobes the table holds and select
per lane by kind. The delta lobes evaluate to zero in `eval_pdf` (their
throughput arrives only through `sample`, with is_delta set). In
spectral mode (`wavelengths` given, (..., W) in nm) reflectance is the
11-channel spectrum lerped at the hero wavelengths, and a conductor's
Fresnel term is the mean over its three RGB channels, as in the
reference package. Tables holding other kinds (plastic, rough
dielectric, principled, ...; masks, textures) raise.

Directions are in the local shading frame (+z = geometric normal).
`sample` returns weight = value / pdf with the cosine included; a delta
lobe's pdf is its discrete probability.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops import warp
from ..ops.math import PI, safe_sqrt

DIFFUSE, ROUGH_CONDUCTOR, CONDUCTOR, DIELECTRIC = 0, 1, 2, 3
THIN_DIELECTRIC = 7
KINDS = (DIFFUSE, ROUGH_CONDUCTOR, CONDUCTOR, DIELECTRIC, THIN_DIELECTRIC)


class MaterialTable(NamedTuple):
    kind: torch.Tensor        # (M,) int64
    albedo: torch.Tensor      # (M, 3) diffuse reflectance / conductor tint
    twosided: torch.Tensor    # (M,) bool
    albedo_spec: torch.Tensor  # (M, 11) reflectance at 320..720 nm step 40
    alpha: torch.Tensor       # (M,) GGX roughness
    eta: torch.Tensor         # (M, 3) conductor IOR, real part
    k: torch.Tensor           # (M, 3) conductor IOR, imaginary part
    ior: torch.Tensor         # (M,) dielectric relative IOR (int/ext)
    # `kind` on the host, a tuple of Python ints, so that reading the lobe
    # descriptor (`table_kinds`) never waits for the device
    host_kind: Optional[tuple] = None


def make_material_table(kinds=None, albedos=((0.5, 0.5, 0.5),),
                        twosided=None, spectral_albedos=None, alphas=None,
                        etas=None, ks=None, iors=None,
                        device="cuda") -> MaterialTable:
    """Host-side description -> table, with the reference package's
    defaults: the spectral albedo repeats the RGB mean, alpha 0.1, a
    gold-like conductor IOR, a dielectric IOR of 1.5046."""
    a = np.atleast_2d(np.asarray(albedos, np.float32))
    m = a.shape[0]
    kinds = (np.zeros((m,), np.int64) if kinds is None
             else np.asarray(kinds, np.int64))
    if not np.isin(kinds, KINDS).all():
        raise NotImplementedError(f"material kinds {sorted(set(kinds))}")
    ts = (np.zeros((m,), bool) if twosided is None
          else np.asarray(twosided, bool))
    if spectral_albedos is None:
        spectral_albedos = np.repeat(a.mean(-1, keepdims=True), 11, axis=-1)
    alphas = (np.full((m,), 0.1, np.float32) if alphas is None
              else np.asarray(alphas, np.float32))
    etas = (np.tile(np.array([0.143, 0.375, 1.442], np.float32), (m, 1))
            if etas is None else np.atleast_2d(np.asarray(etas, np.float32)))
    ks = (np.tile(np.array([3.983, 2.386, 1.603], np.float32), (m, 1))
          if ks is None else np.atleast_2d(np.asarray(ks, np.float32)))
    iors = (np.full((m,), 1.5046, np.float32) if iors is None
            else np.asarray(iors, np.float32))

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return MaterialTable(torch.tensor(kinds, device=device), f32(a),
                         torch.tensor(ts, device=device),
                         f32(spectral_albedos), f32(alphas), f32(etas),
                         f32(ks), f32(iors), tuple(int(k) for k in kinds))


def make_diffuse_table(albedos, twosided=None,
                       device="cuda") -> MaterialTable:
    return make_material_table(albedos=albedos, twosided=twosided,
                               device=device)


def table_kinds(table: MaterialTable):
    """Static lobe descriptor: (sorted kind tuple, any_mask flag), the
    reference package's format, from the table's host copy of its kinds
    (or from `kind` itself where it lies on the CPU). This port has no
    mask wrapper."""
    ks = table.host_kind
    if ks is None:
        if table.kind.device.type != "cpu":
            raise ValueError("table_kinds: the table has no host copy of "
                             "its kinds (build it with make_material_table "
                             "or pass host_kind)")
        ks = table.kind.numpy().tolist()
    return tuple(sorted(set(int(k) for k in ks))), False


def _reflectance(table: MaterialTable, mat_idx, wavelengths):
    """Per-lane reflectance: (..., 3) RGB, or (..., W) at the hero
    wavelengths, the 11-channel spectrum lerped and clamped to its ends."""
    if wavelengths is None:
        return table.albedo[mat_idx]
    spec = table.albedo_spec[mat_idx]                       # (..., 11)
    norm = ((wavelengths - 320.0) / 40.0).clamp(0.0, 10.0)
    lo = torch.floor(norm).long().clamp(0, 9)
    t = norm - lo
    batch = torch.broadcast_shapes(spec.shape[:-1], lo.shape[:-1])
    spec = spec.expand(batch + spec.shape[-1:])
    lo = lo.expand(batch + lo.shape[-1:])
    return ((1.0 - t) * torch.gather(spec, -1, lo)
            + t * torch.gather(spec, -1, lo + 1))


# ---------------------------------------------------------------------------
# Microfacet (GGX / Trowbridge-Reitz) helpers, reference `microfacet.h`
# ---------------------------------------------------------------------------


def _ggx_ndf(m, alpha):
    """GGX normal distribution D(m), alpha isotropic."""
    a2 = alpha * alpha
    c2 = m[..., 2] ** 2
    denom = c2 * (a2 - 1.0) + 1.0
    return torch.where(m[..., 2] > 0.0, a2 / (PI * denom * denom), 0.0)


def _ggx_g1(v, alpha):
    """Smith masking G1 for GGX."""
    c = v[..., 2].abs()
    t2 = (1.0 - c * c).clamp(min=0.0) / (c * c).clamp(min=1e-12)
    return 2.0 / (1.0 + torch.sqrt(1.0 + alpha * alpha * t2))


def _ggx_sample(alpha, u):
    """Sample the GGX NDF (pdf D(m) cos(m)) -> microfacet normal."""
    cos2 = (1.0 - u[..., 0]) / (u[..., 0] * (alpha * alpha - 1.0) + 1.0)
    cos_t = torch.sqrt(cos2.clamp(min=0.0))
    sin_t = safe_sqrt(1.0 - cos2)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], -1)


def _fresnel_conductor(cos_i, eta, k):
    """Exact unpolarised Fresnel reflectance of a conductor; cos_i (...,)
    broadcast against eta, k (..., C)."""
    c = cos_i.clamp(0.0, 1.0)[..., None]
    c2 = c * c
    s2 = 1.0 - c2
    e2 = eta * eta
    k2 = k * k
    t0 = e2 - k2 - s2
    a2b2 = safe_sqrt(t0 * t0 + 4.0 * e2 * k2)
    t1 = a2b2 + c2
    a = safe_sqrt(0.5 * (a2b2 + t0))
    t2 = 2.0 * a * c
    rs = (t1 - t2) / (t1 + t2)
    t3 = c2 * a2b2 + s2 * s2
    t4 = t2 * s2
    rp = rs * (t3 - t4) / (t3 + t4)
    return 0.5 * (rs + rp)


def _conductor_fresnel(table, mat_idx, cos_i, wavelengths):
    """Fresnel term (..., 3) in RGB; spectral: the mean over the three IOR
    channels, broadcast to the W hero wavelengths."""
    f = _fresnel_conductor(cos_i, table.eta[mat_idx], table.k[mat_idx])
    if wavelengths is None:
        return f
    return f.mean(-1, keepdim=True).expand(cos_i.shape
                                           + wavelengths.shape[-1:])


def fresnel_dielectric(cos_i, eta):
    """Fresnel reflectance of a dielectric interface -> (F, cos_t signed
    against cos_i, eta_rel): eta_rel is eta entering (cos_i >= 0), 1/eta
    leaving; F = 1 under total internal reflection."""
    entering = cos_i >= 0.0
    eta_rel = torch.where(entering, eta, 1.0 / eta)
    c = cos_i.abs()
    s2_t = (1.0 - c * c) / (eta_rel * eta_rel).clamp(min=1e-12)
    tir = s2_t >= 1.0
    cos_t = safe_sqrt(1.0 - s2_t)
    rs = (c - eta_rel * cos_t) / (c + eta_rel * cos_t).clamp(min=1e-12)
    rp = (eta_rel * c - cos_t) / (eta_rel * c + cos_t).clamp(min=1e-12)
    f = torch.where(tir, 1.0, 0.5 * (rs * rs + rp * rp))
    return f, torch.where(entering, -cos_t, cos_t), eta_rel


def _reflect(wi, m):
    return 2.0 * (wi * m).sum(-1, keepdim=True) * m - wi


def _lobes(kinds):
    """The kinds whose lobes to evaluate (all ported ones for None)."""
    present = KINDS if kinds is None else kinds[0]
    if kinds is not None and kinds[1]:
        raise NotImplementedError("opacity masks")
    if any(k not in KINDS for k in present):
        raise NotImplementedError(f"material kinds {present}")
    return present


def _n_chan(wavelengths):
    return 3 if wavelengths is None else wavelengths.shape[-1]


def _flip(table, mat_idx, wi):
    """Two-sided adapter: the (..., 3) z-flip that mirrors the frame for
    lanes arriving from below."""
    sign = torch.where(table.twosided[mat_idx] & (wi[..., 2] < 0.0),
                       -1.0, 1.0)
    return torch.stack([torch.ones_like(sign)] * 2 + [sign], -1)


def eval_pdf(table: MaterialTable, mat_idx, wi, wo, wavelengths=None,
             kinds=None):
    """(f * cos(theta_o) (..., C), pdf (...,)) of the lanes' materials, C
    = 3 or W (`_eval_pdf_core` of the reference package); 0 for the
    delta lobes."""
    present = _lobes(kinds)
    kind = table.kind[mat_idx]
    sign3 = _flip(table, mat_idx, wi)
    wi_l = wi * sign3
    wo_l = wo * sign3
    cos_i = wi_l[..., 2]
    cos_o = wo_l[..., 2]
    refl_active = (cos_i > 0.0) & (cos_o > 0.0)
    value = torch.zeros(cos_i.shape + (_n_chan(wavelengths),),
                        device=wi.device)
    pdf = torch.zeros(cos_i.shape, device=wi.device)
    refl = _reflectance(table, mat_idx, wavelengths)

    if DIFFUSE in present:
        diff_pdf = warp.INV_PI * cos_o.clamp(min=0.0)
        is_diff = kind == DIFFUSE
        value = torch.where(is_diff[..., None], refl * diff_pdf[..., None],
                            value)
        pdf = torch.where(is_diff, diff_pdf, pdf)

    if ROUGH_CONDUCTOR in present:
        alpha = table.alpha[mat_idx]
        m = wi_l + wo_l
        m = m / torch.sqrt((m * m).sum(-1, keepdim=True)).clamp(min=1e-12)
        d_ndf = _ggx_ndf(m, alpha)
        g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_l, alpha)
        mi_dot = (wi_l * m).sum(-1)
        f_c = _conductor_fresnel(table, mat_idx, mi_dot, wavelengths)
        denom = 4.0 * cos_i.clamp(min=1e-6)
        rough_val = refl * f_c * (d_ndf * g / denom)[..., None]
        rough_pdf = (d_ndf * m[..., 2]
                     / (4.0 * mi_dot.abs()).clamp(min=1e-6))
        is_rough = kind == ROUGH_CONDUCTOR
        value = torch.where(is_rough[..., None], rough_val, value)
        pdf = torch.where(is_rough, rough_pdf, pdf)

    return (torch.where(refl_active[..., None], value, 0.0),
            torch.where(refl_active, pdf, 0.0))


def sample(table: MaterialTable, mat_idx, wi, sample2, sample1,
           wavelengths=None, kinds=None):
    """Sample an outgoing direction -> (wo, weight = f cos / pdf, pdf,
    is_delta) (`_sample_core` of the reference package). `sample1` picks
    the dielectrics' reflection or transmission. The two-sided adapter's
    lobes are sampled in the flipped frame and flipped back; the
    dielectrics work in the geometric frame."""
    present = _lobes(kinds)
    kind = table.kind[mat_idx]
    sign3 = _flip(table, mat_idx, wi)
    wi_l = wi * sign3
    cos_i = wi_l[..., 2]
    active = cos_i > 0.0
    nc = _n_chan(wavelengths)
    wo = torch.zeros_like(wi)
    weight = torch.zeros(cos_i.shape + (nc,), device=wi.device)
    pdf = torch.zeros(cos_i.shape, device=wi.device)
    is_delta = torch.zeros(cos_i.shape, dtype=torch.bool, device=wi.device)
    geom_frame = torch.zeros(cos_i.shape, dtype=torch.bool, device=wi.device)
    refl = _reflectance(table, mat_idx, wavelengths)

    if DIFFUSE in present:
        wo_diff = warp.square_to_cosine_hemisphere(sample2)
        is_diff = kind == DIFFUSE
        wo = torch.where(is_diff[..., None], wo_diff, wo)
        weight = torch.where(is_diff[..., None], refl, weight)
        pdf = torch.where(is_diff,
                          warp.square_to_cosine_hemisphere_pdf(wo_diff), pdf)

    if ROUGH_CONDUCTOR in present:
        alpha = table.alpha[mat_idx]
        m = _ggx_sample(alpha, sample2)
        wo_rough = _reflect(wi_l, m)
        mi_dot = (wi_l * m).sum(-1)
        pdf_rough = (_ggx_ndf(m, alpha) * m[..., 2]
                     / (4.0 * mi_dot.abs()).clamp(min=1e-6))
        g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_rough, alpha)
        f_c = _conductor_fresnel(table, mat_idx, mi_dot, wavelengths)
        # weight = f cos / pdf = tint * F * G * mi_dot / (cos_m * cos_i)
        w_rough = refl * f_c * (
            g * mi_dot.abs()
            / (m[..., 2] * cos_i.clamp(min=1e-6)).clamp(min=1e-6))[..., None]
        rough_ok = (wo_rough[..., 2] > 0.0) & (mi_dot > 0.0)
        is_rough = kind == ROUGH_CONDUCTOR
        wo = torch.where(is_rough[..., None], wo_rough, wo)
        weight = torch.where(is_rough[..., None],
                             torch.where(rough_ok[..., None], w_rough, 0.0),
                             weight)
        pdf = torch.where(is_rough, pdf_rough, pdf)

    if CONDUCTOR in present:
        wo_mirr = torch.stack([-wi_l[..., 0], -wi_l[..., 1], wi_l[..., 2]],
                              -1)
        f_m = _conductor_fresnel(table, mat_idx, cos_i, wavelengths)
        is_mirr = kind == CONDUCTOR
        wo = torch.where(is_mirr[..., None], wo_mirr, wo)
        weight = torch.where(is_mirr[..., None], refl * f_m, weight)
        pdf = torch.where(is_mirr, 1.0, pdf)
        is_delta = is_delta | is_mirr

    if DIELECTRIC in present or THIN_DIELECTRIC in present:
        ior = table.ior[mat_idx]
        wo_refl = torch.stack([-wi[..., 0], -wi[..., 1], wi[..., 2]], -1)

    if DIELECTRIC in present:
        # two-sided by construction: the unflipped wi
        f_d, cos_t, eta_rel = fresnel_dielectric(wi[..., 2], ior)
        do_reflect = sample1 < f_d
        scale_xy = -1.0 / eta_rel
        wo_refr = torch.stack([wi[..., 0] * scale_xy, wi[..., 1] * scale_xy,
                               cos_t], -1)
        wo_diel = torch.where(do_reflect[..., None], wo_refl, wo_refr)
        # refraction carries the 1/eta_rel^2 solid-angle compression
        w_diel = torch.where(do_reflect, 1.0, 1.0 / (eta_rel * eta_rel))
        is_diel = kind == DIELECTRIC
        wo = torch.where(is_diel[..., None], wo_diel, wo)
        weight = torch.where(is_diel[..., None],
                             w_diel[..., None].expand(weight.shape), weight)
        pdf = torch.where(is_diel, torch.where(do_reflect, f_d, 1.0 - f_d),
                          pdf)
        is_delta = is_delta | is_diel
        geom_frame = geom_frame | is_diel

    # back from the two-sided local frame to the geometric one
    wo = torch.where(geom_frame[..., None], wo, wo * sign3)
    ok = geom_frame | active
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(ok, pdf, 0.0)

    if THIN_DIELECTRIC in present:
        f_td, _, _ = fresnel_dielectric(wi[..., 2].abs(), ior)
        r_star = torch.where(f_td < 1.0, 2.0 * f_td / (1.0 + f_td), 1.0)
        td_reflect = sample1 < r_star
        wo_td = torch.where(td_reflect[..., None], wo_refl, -wi)
        is_td = kind == THIN_DIELECTRIC
        wo = torch.where(is_td[..., None], wo_td, wo)
        weight = torch.where(is_td[..., None], 1.0, weight)
        pdf = torch.where(is_td, torch.where(td_reflect, r_star,
                                             1.0 - r_star), pdf)
        is_delta = is_delta | is_td
    return wo, weight, pdf, is_delta
