"""Material table: every kind of `tpusky/render/bsdf.py`.

Kinds (the reference package's numbering):

  0 diffuse         smooth Lambertian (`diffuse.cpp`)
  1 roughconductor  GGX microfacet + complex-IOR Fresnel
                    (`roughconductor.cpp`, `microfacet.h`)
  2 conductor       smooth mirror + complex-IOR Fresnel (delta lobe)
  3 dielectric      smooth glass, reflect or refract by Fresnel (delta)
  4 plastic         smooth dielectric coat (delta) over a Lambertian base
                    with internal-scattering compensation (`plastic.cpp`)
  5 roughdielectric GGX microfacet glass, reflect and refract
                    (`roughdielectric.cpp`)
  6 null            invisible pass-through (`null.cpp`; delta)
  7 thindielectric  thin glass sheet: delta reflection or straight-through
                    transmission, reflectance R* = 2F/(1+F)
                    (`thindielectric.cpp`)
  8 roughplastic    GGX dielectric coat over a Lambertian base
                    (`roughplastic.cpp`)
  9 principled      Disney BSDF (`principled.cpp`): retro-reflective
                    diffuse, Schlick-Fresnel GGX specular, sheen and GTR1
                    clearcoat; the `extra` column holds [metallic,
                    specular, sheen, sheen_tint, clearcoat,
                    clearcoat_gloss, spec_tint, -]
 10 blend           `blend_w` of row `blend_b` and 1 - `blend_w` of row
                    `blend_a` (`blendbsdf.cpp`), children not blends
 11 pplastic        polarized plastic (`pplastic.cpp`): a GGX dielectric
                    coat plus a Lambertian base attenuated by both
                    refractions, the coat picked with 1 / (1 + mean albedo)
 12 polarizer       linear polarizer (`polarizer.cpp`): straight through,
                    delta, half the transmittance (`albedo`) unpolarized;
                    `extra` [theta deg, -, -, ...]
 13 retarder        linear retarder (`retarder.cpp`): straight through,
                    delta, the transmittance; `extra` [theta deg, delta
                    deg, -, ...]
 14 circular        circular polarizer (`circular.cpp`): straight through,
                    delta, half the transmittance; `extra` [-, -,
                    left-handed (> 0.5), ...]
 15 principledthin  thin Disney BSDF (`principledthin.cpp`); `extra` holds
                    [spec_trans, diff_trans, sheen, sheen_tint, flatness,
                    spec_tint, -, -]
 16 hair            Chiang et al. 2016 fiber (`hair.cpp`) in the fiber frame
                    (+y the tangent, +z the normal across the fiber): R,
                    TT, TRT and a residual lobe; `albedo` is sigma_a,
                    `alpha` beta_m, `ior` eta, `extra` [beta_n, tilt deg,
                    -, ...]
 17 measured        RGL measured BRDF (`measured.cpp`), the table's
                    `measured` dataset (`render/measured.py`)
 18 measured_pol    polarized measured pBRDF (`measured_polarized.cpp`),
                    the table's `measured_pol` dataset; its scalar M00 here,
                    its Mueller matrices in `render/polarized.py`

Every row also carries an `opacity`: a lane passes through unscattered
with probability 1 - opacity (the flattened `mask.cpp`), and may carry a
reflectance texture (`tex_idx`) and a normal map (`normal_tex_idx`) into
the scene's `render/texture.py` table (-1: none). The integrator
evaluates the texture once a vertex and hands it to every query there as
`refl_tex`, which replaces the reflectance of the Lambertian lobe of
kinds 0, 4, 8, 9, 11 and 15 and the filters' transmittance (the
reference's `_apply_tex`), not a conductor's tint. Kinds 11-14 carry
here their scalar radiometry, which the scalar path renders as the
reference's does; their Mueller matrices are in `render/polarized.py`.
A table with a kind-17 or kind-18 row holds the dataset those rows read
(one each a table); without it the table is refused (ValueError), where
the reference skips the lobe, since Mitsuba's plugins need a file.

Kinds 0-2, 4, 8, 9, 11, 17 and 18 sit behind the `twosided.cpp`
adapter; the dielectrics, null, the filters, principledthin and hair are
two-sided by construction and work in the geometric frame. Materials
live in one struct-of-arrays table; `eval_pdf` and `sample` evaluate
the lobes the table holds (its `table_kinds`) and select per lane by
kind. The delta lobes evaluate to zero in `eval_pdf` (their throughput
arrives only through `sample`, with is_delta set). In spectral mode
(`wavelengths` given, (..., W) in nm) reflectance is the 11-channel
spectrum lerped at the hero wavelengths, and a conductor's Fresnel term
is the mean over its three RGB channels, as in the reference package.

Directions are in the local shading frame (+z = geometric normal).
`sample` returns weight = value / pdf with the cosine included; a delta
lobe's pdf is its discrete probability.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..ops import warp
from ..ops.math import PI, safe_acos, safe_asin, safe_sqrt
from ..ops.math import unit as _unit
from . import measured as measured_mod

DIFFUSE, ROUGH_CONDUCTOR, CONDUCTOR, DIELECTRIC = 0, 1, 2, 3
PLASTIC, ROUGH_DIELECTRIC, NULL_BSDF = 4, 5, 6
THIN_DIELECTRIC, ROUGH_PLASTIC, PRINCIPLED = 7, 8, 9
BLEND = 10
PPLASTIC, POLARIZER, RETARDER, CIRCULAR = 11, 12, 13, 14
PRINCIPLED_THIN = 15
HAIR, MEASURED, MEASURED_POL = 16, 17, 18
KINDS = (DIFFUSE, ROUGH_CONDUCTOR, CONDUCTOR, DIELECTRIC, PLASTIC,
         ROUGH_DIELECTRIC, NULL_BSDF, THIN_DIELECTRIC, ROUGH_PLASTIC,
         PRINCIPLED, BLEND, PPLASTIC, POLARIZER, RETARDER, CIRCULAR,
         PRINCIPLED_THIN, HAIR, MEASURED, MEASURED_POL)
# the kinds whose lobes start from the Lambertian sample and reflectance
_BASE = (DIFFUSE, PLASTIC, ROUGH_PLASTIC, PRINCIPLED, PPLASTIC)


class MaterialTable(NamedTuple):
    kind: torch.Tensor        # (M,) int64
    albedo: torch.Tensor      # (M, 3) diffuse reflectance / conductor tint
    twosided: torch.Tensor    # (M,) bool
    albedo_spec: torch.Tensor  # (M, 11) reflectance at 320..720 nm step 40
    alpha: torch.Tensor       # (M,) GGX roughness
    eta: torch.Tensor         # (M, 3) conductor IOR, real part
    k: torch.Tensor           # (M, 3) conductor IOR, imaginary part
    ior: torch.Tensor         # (M,) dielectric relative IOR (int/ext)
    opacity: torch.Tensor     # (M,) mask opacity (1 = opaque)
    extra: torch.Tensor       # (M, 8) principled parameters (kinds 9, 15)
    blend_a: torch.Tensor     # (M,) int64 first child row (kind 10)
    blend_b: torch.Tensor     # (M,) int64 second child row (kind 10)
    blend_w: torch.Tensor     # (M,) weight of child b (`blendbsdf.cpp`)
    # `kind` on the host, a tuple of Python ints, and whether any row's
    # opacity is below 1, so that reading the lobe descriptor
    # (`table_kinds`) never waits for the device
    host_kind: Optional[tuple] = None
    host_mask: Optional[bool] = None
    tex_idx: Optional[torch.Tensor] = None         # (M,) int64, -1: none
    normal_tex_idx: Optional[torch.Tensor] = None  # (M,) int64, -1: none
    # whether any row has a normal map, on the host (`table_normal_maps`)
    host_normal_maps: Optional[bool] = None
    # the datasets the kind-17 and kind-18 rows read (one each a table;
    # `render/measured.py`)
    measured: Any = None        # measured.MeasuredBRDF
    measured_pol: Any = None    # measured.MeasuredPolarized


def check_kinds(kinds):
    """Raise NotImplementedError for kinds the reference does not have."""
    bad = sorted(set(int(k) for k in kinds) - set(KINDS))
    if bad:
        raise NotImplementedError(f"material kinds {bad}: no kind of the "
                                  "reference")


def check_datasets(kinds, measured, measured_pol):
    """Raise ValueError where a kind-17 or kind-18 row has no dataset to
    read (the reference skips its lobe; Mitsuba's plugin needs a
    file)."""
    kinds = set(int(k) for k in kinds)
    for kind, data, name in ((MEASURED, measured, "measured"),
                             (MEASURED_POL, measured_pol, "measured_pol")):
        if kind in kinds and data is None:
            raise ValueError(f"a kind-{kind} row needs the table's {name} "
                             "dataset")


def make_material_table(kinds=None, albedos=((0.5, 0.5, 0.5),),
                        twosided=None, spectral_albedos=None, alphas=None,
                        etas=None, ks=None, iors=None, opacities=None,
                        extras=None, blend_children=None, blend_weights=None,
                        tex_indices=None, normal_tex_indices=None,
                        measured=None, measured_pol=None,
                        device="cuda") -> MaterialTable:
    """Host-side description -> table, with the reference package's
    defaults: the spectral albedo repeats the RGB mean, alpha 0.1, a
    gold-like conductor IOR, a dielectric IOR of 1.5046, opacity 1,
    `extra` [0, 0.5, 0, 0, 0, 0, 0, 0], blend children (0, 0) of weight
    0, no texture and no normal map (-1). `measured` and `measured_pol`
    are the datasets of the kind-17 and kind-18 rows
    (`measured.load_measured`, `load_measured_polarized`), on `device`."""
    a = np.atleast_2d(np.asarray(albedos, np.float32))
    m = a.shape[0]
    kinds = (np.zeros((m,), np.int64) if kinds is None
             else np.asarray(kinds, np.int64))
    check_kinds(kinds)
    check_datasets(kinds, measured, measured_pol)
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
    opacities = (np.ones((m,), np.float32) if opacities is None
                 else np.asarray(opacities, np.float32))
    extras = (np.tile(np.array([0, 0.5, 0, 0, 0, 0, 0, 0], np.float32),
                      (m, 1)) if extras is None
              else np.asarray(extras, np.float32).reshape(m, 8))
    blend_children = (np.zeros((m, 2), np.int64) if blend_children is None
                      else np.asarray(blend_children, np.int64).reshape(m, 2))
    blend_weights = (np.zeros((m,), np.float32) if blend_weights is None
                     else np.asarray(blend_weights, np.float32))
    tex_indices = (np.full((m,), -1, np.int64) if tex_indices is None
                   else np.asarray(tex_indices, np.int64))
    normal_tex_indices = (np.full((m,), -1, np.int64)
                          if normal_tex_indices is None
                          else np.asarray(normal_tex_indices, np.int64))

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    def i64(x):
        return torch.tensor(np.asarray(x, np.int64), device=device)
    return MaterialTable(i64(kinds), f32(a), torch.tensor(ts, device=device),
                         f32(spectral_albedos), f32(alphas), f32(etas),
                         f32(ks), f32(iors), f32(opacities), f32(extras),
                         i64(blend_children[:, 0]), i64(blend_children[:, 1]),
                         f32(blend_weights), tuple(int(k) for k in kinds),
                         bool((opacities < 1.0).any()), i64(tex_indices),
                         i64(normal_tex_indices),
                         bool((normal_tex_indices >= 0).any()), measured,
                         measured_pol)


def make_diffuse_table(albedos, twosided=None,
                       device="cuda") -> MaterialTable:
    return make_material_table(albedos=albedos, twosided=twosided,
                               device=device)


def table_kinds(table: MaterialTable):
    """Static lobe descriptor: (sorted kind tuple, any_mask flag), the
    reference package's format, from the table's host copies of its kinds
    and mask flag (or from `kind` and `opacity` themselves where they lie
    on the CPU)."""
    ks, mask = table.host_kind, table.host_mask
    if ks is None or mask is None:
        if table.kind.device.type != "cpu":
            raise ValueError("table_kinds: the table has no host copy of "
                             "its kinds (build it with make_material_table "
                             "or pass host_kind and host_mask)")
        ks = table.kind.numpy().tolist() if ks is None else ks
        mask = bool((table.opacity < 1.0).any()) if mask is None else mask
    return tuple(sorted(set(int(k) for k in ks))), mask


def table_normal_maps(table: MaterialTable) -> bool:
    """Whether any row carries a normal map, from the table's host flag
    (or from `normal_tex_idx` itself where it lies on the CPU)."""
    if table.host_normal_maps is not None:
        return table.host_normal_maps
    if table.normal_tex_idx is None:
        return False
    if table.normal_tex_idx.device.type != "cpu":
        raise ValueError("table_normal_maps: the table has no host flag "
                         "(build it with make_material_table or pass "
                         "host_normal_maps)")
    return bool((table.normal_tex_idx >= 0).any())


def _apply_tex(albedo, refl_tex):
    """The textured reflectance where a lane has a texture: refl_tex is
    None or (value (..., C), has (...,)) from `texture.eval_texture`."""
    if refl_tex is None:
        return albedo
    val, has = refl_tex
    return torch.where(has[..., None], val, albedo)


def spec_lerp(spec, wavelengths):
    """Spectra (..., 11) on the 320..720 nm grid at (..., W) wavelengths
    -> (..., W), lerped and clamped to the grid's ends."""
    norm = ((wavelengths - 320.0) / 40.0).clamp(0.0, 10.0)
    lo = torch.floor(norm).long().clamp(0, 9)
    t = norm - lo
    batch = torch.broadcast_shapes(spec.shape[:-1], lo.shape[:-1])
    spec = spec.expand(batch + spec.shape[-1:])
    lo = lo.expand(batch + lo.shape[-1:])
    return ((1.0 - t) * torch.gather(spec, -1, lo)
            + t * torch.gather(spec, -1, lo + 1))


def _reflectance(table: MaterialTable, mat_idx, wavelengths):
    """Per-lane reflectance: (..., 3) RGB, or (..., W) at the hero
    wavelengths, the 11-channel spectrum lerped (`spec_lerp`)."""
    if wavelengths is None:
        return table.albedo[mat_idx]
    return spec_lerp(table.albedo_spec[mat_idx], wavelengths)


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


def fresnel_diffuse_reflectance(inv_eta):
    """Hemispherically averaged Fresnel reflectance for a relative IOR
    < 1, the Egan & Hilgeman (1973) fit of the reference's `fresnel.h`,
    at 1/eta for the plastics' internal scattering."""
    return (-1.4399 * inv_eta * inv_eta + 0.7099 * inv_eta + 0.6681
            + 0.0636 / inv_eta.clamp(min=1e-4))


def _plastic_base(albedo, ior, f_o):
    """The plastics' Lambertian base under the coat, internally scattered
    (`plastic.cpp` with nonlinear=True), times (1 - F_o) / eta^2."""
    fdr = fresnel_diffuse_reflectance(1.0 / ior.clamp(min=1.0 + 1e-4))
    inv_eta2 = 1.0 / (ior * ior)
    return (albedo / (1.0 - albedo * fdr[..., None]).clamp(min=1e-3)
            * ((1.0 - f_o) * inv_eta2)[..., None])


def _rough_plastic_eval(albedo, alpha, ior, wi_l, wo_l):
    """Rough plastic (a GGX dielectric coat over the internally scattered
    Lambertian base, `roughplastic.cpp`) -> (value = f cos_o (..., C),
    pdf), in the two-sided local frame."""
    cos_i = wi_l[..., 2].clamp(min=0.0)
    cos_o = wo_l[..., 2].clamp(min=0.0)
    alpha = alpha.clamp(min=1e-3)
    m = _unit(wi_l + wo_l)
    d_ndf = _ggx_ndf(m, alpha)
    g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_l, alpha)
    wim = (wi_l * m).sum(-1)
    f_spec, _, _ = fresnel_dielectric(wim.clamp(min=0.0), ior)
    spec = f_spec * d_ndf * g / (4.0 * cos_i.clamp(min=1e-6))
    f_i, _, _ = fresnel_dielectric(cos_i, ior)
    f_o, _, _ = fresnel_dielectric(cos_o, ior)
    diff = _plastic_base(albedo, ior, f_o) * (
        (1.0 - f_i) * warp.INV_PI * cos_o)[..., None]
    # `sample` picks the coat with probability F(cos_i)
    pdf_spec = d_ndf * m[..., 2] / (4.0 * wim.abs()).clamp(min=1e-6)
    pdf = f_i * pdf_spec + (1.0 - f_i) * warp.INV_PI * cos_o
    return spec[..., None] + diff, pdf


def _pplastic_eval(albedo, alpha, ior, wi_l, wo_l, prob_spec):
    """Polarized plastic's scalar radiometry (`pplastic.cpp:312-401`, its
    unpolarized path; `tpusky/render/bsdf.py:323-355`): a GGX dielectric
    coat plus a Lambertian base attenuated by both refractions, (1 - F_i)
    (1 - F_o), without the internal-scattering series of roughplastic ->
    (value = f cos_o (..., C), pdf). `prob_spec` picks the coat
    (`pplastic.cpp:202-212`)."""
    cos_i = wi_l[..., 2].clamp(min=0.0)
    cos_o = wo_l[..., 2].clamp(min=0.0)
    alpha = alpha.clamp(min=1e-3)
    m = _unit(wi_l + wo_l)
    d_ndf = _ggx_ndf(m, alpha)
    g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_l, alpha)
    wim = (wi_l * m).sum(-1)
    f_spec, _, _ = fresnel_dielectric(wim.clamp(min=0.0), ior)
    spec = f_spec * d_ndf * g / (4.0 * cos_i.clamp(min=1e-6))
    f_i, _, _ = fresnel_dielectric(cos_i, ior)
    f_o, _, _ = fresnel_dielectric(cos_o, ior)
    diff = albedo * ((1.0 - f_i) * (1.0 - f_o) * warp.INV_PI
                     * cos_o)[..., None]
    pdf_spec = d_ndf * m[..., 2] / (4.0 * wim.abs()).clamp(min=1e-6)
    pdf = prob_spec * pdf_spec + (1.0 - prob_spec) * warp.INV_PI * cos_o
    return spec[..., None] + diff, pdf


def _pplastic_prob_spec(table, mat_idx):
    """The pplastic coat's selection probability 1 / (1 + mean RGB
    albedo), untextured in both modes (`tpusky/render/bsdf.py:1038`)."""
    return 1.0 / (1.0 + table.albedo[mat_idx].mean(-1))


def _schlick5(c):
    m = (1.0 - c).clamp(0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


def _luminance_rgb(c):
    """Rec.709 luminance (mitsuba's `luminance()` of an RGB spectrum)."""
    return (0.212671 * c[..., 0] + 0.715160 * c[..., 1]
            + 0.072169 * c[..., 2])


def _principledthin_eval(base, rough, ior, extra, wi_g, wo_g):
    """Thin Disney BSDF (`principledthin.cpp:418-650`): GGX reflection with
    the `thin_fresnel` tint blend, GGX transmission at the IOR-scaled
    roughness, diffuse + retro (+ fake subsurface + sheen) reflection and
    Lambertian transmission -> (value = f |cos_o| (..., C), pdf), in the
    geometric frame (both directions flipped to wi's side)."""
    spec_trans, diff_trans = extra[..., 0], extra[..., 1]
    sheen, sheen_tint = extra[..., 2], extra[..., 3]
    flatness, spec_tint = extra[..., 4], extra[..., 5]

    sign = torch.sign(torch.where(wi_g[..., 2] == 0.0, 1.0, wi_g[..., 2]))
    wi = wi_g * sign[..., None]
    wo_t = wo_g * sign[..., None]
    ci = wi[..., 2].abs()
    co = wo_t[..., 2]
    reflect = co > 0.0
    refract = co < 0.0

    wo_r = torch.stack([wo_t[..., 0], wo_t[..., 1], co.abs()], -1)
    wh = _unit(wi + wo_r)
    wi_wh = (wi * wh).sum(-1)
    cos_d = (wh * wo_t).sum(-1)
    alpha = (rough * rough).clamp(min=1e-4)
    alpha_s = (((0.65 * ior - 0.35) * rough) ** 2).clamp(min=1e-4)
    f_diel, _, _ = fresnel_dielectric(wi_wh, ior)
    # macro-micro compatibility (`principledhelpers.h:199-211`)
    compat_r = (wi_wh > 0.0) & ((wo_t * wh).sum(-1) > 0.0)
    compat_t = (wi_wh > 0.0) & ((wo_t * -wh).sum(-1) > 0.0)
    value = torch.zeros(ci.shape + (base.shape[-1],), device=base.device)

    # specular reflection with the thin_fresnel tint blend
    lum = _luminance_rgb(base) if base.shape[-1] == 3 else base.mean(-1)
    c_tint = torch.where((lum > 0.0)[..., None],
                         base / lum.clamp(min=1e-8)[..., None], 1.0)
    r0 = ((ior - 1.0) / (ior + 1.0)) ** 2
    f0_tint = c_tint * r0[..., None]
    f_schlick = f0_tint + (1.0 - f0_tint) * _schlick5(wi_wh.abs())[..., None]
    f_thin = ((1.0 - spec_tint)[..., None] * f_diel[..., None]
              + spec_tint[..., None] * f_schlick)
    d_r = _ggx_ndf(wh, alpha)
    g_r = _ggx_g1(wi, alpha) * _ggx_g1(wo_r, alpha)
    spec_r = (spec_trans[..., None] * f_thin
              * (d_r * g_r / (4.0 * ci.clamp(min=1e-6)))[..., None])
    value = value + torch.where(
        (reflect & compat_r & (spec_trans > 0.0))[..., None], spec_r, 0.0)

    # specular transmission at the scaled roughness
    d_t = _ggx_ndf(wh, alpha_s)
    g_t = _ggx_g1(wi, alpha_s) * _ggx_g1(wo_r, alpha_s)
    spec_t = ((spec_trans * (1.0 - f_diel) * d_t * g_t
               / (4.0 * ci.clamp(min=1e-6)))[..., None] * base)
    value = value + torch.where(
        (refract & compat_t & (spec_trans > 0.0))[..., None], spec_t, 0.0)

    # diffuse + retro + fake subsurface + sheen, on the reflection side
    f_i = _schlick5(ci)
    f_o = _schlick5(co.abs())
    f_diff = (1.0 - 0.5 * f_i) * (1.0 - 0.5 * f_o)
    rr = 2.0 * rough * cos_d * cos_d
    f_retro = rr * (f_o + f_i + f_o * f_i * (rr - 1.0))
    fss90 = 0.5 * rr
    fss = (1.0 + (fss90 - 1.0) * f_o) * (1.0 + (fss90 - 1.0) * f_i)
    f_ss = 1.25 * (fss * (1.0 / (co.abs() + ci).clamp(min=1e-6) - 0.5)
                   + 0.5)
    diff_term = (1.0 - flatness) * (f_diff + f_retro) + flatness * f_ss
    diff = ((1.0 - spec_trans) * (1.0 - diff_trans) * warp.INV_PI
            * co.clamp(min=0.0) * diff_term)[..., None] * base
    f_d = _schlick5(cos_d.abs())
    c_sheen = (1.0 - sheen_tint)[..., None] + sheen_tint[..., None] * c_tint
    sheen_v = (sheen * (1.0 - spec_trans) * (1.0 - diff_trans) * f_d
               * co.abs())[..., None] * c_sheen
    value = value + torch.where(reflect[..., None], diff + sheen_v, 0.0)

    # Lambertian diffuse transmission
    dtrans = ((1.0 - spec_trans) * diff_trans * warp.INV_PI
              * co.abs())[..., None] * base
    value = value + torch.where(refract[..., None], dtrans, 0.0)

    # the pdf over the same four lobes (`principledthin.cpp:576-650`)
    p_sr = 0.5 * spec_trans
    p_st = 0.5 * spec_trans
    p_cr = (1.0 - spec_trans) * (1.0 - diff_trans)
    p_ct = (1.0 - spec_trans) * diff_trans
    total = (p_sr + p_st + p_cr + p_ct).clamp(min=1e-8)
    jac = (4.0 * wi_wh.abs()).clamp(min=1e-6)
    pdf_sr = torch.where(reflect & compat_r, d_r * wh[..., 2] / jac, 0.0)
    pdf_st = torch.where(refract & compat_t, d_t * wh[..., 2] / jac, 0.0)
    pdf_cr = torch.where(reflect, warp.INV_PI * co.clamp(min=0.0), 0.0)
    pdf_ct = torch.where(refract, warp.INV_PI * co.abs(), 0.0)
    pdf = (p_sr * pdf_sr + p_st * pdf_st + p_cr * pdf_cr
           + p_ct * pdf_ct) / total
    ok = wi_g[..., 2].abs() > 0.0
    return (torch.where(ok[..., None], value, 0.0),
            torch.where(ok, pdf, 0.0))


def _gtr1_ndf(cos_m, alpha):
    """GTR1 NDF (the Disney clearcoat's)."""
    a2 = alpha * alpha
    denom = PI * torch.log(a2.clamp(min=1e-6)) * (
        1.0 + (a2 - 1.0) * cos_m * cos_m)
    return torch.where(cos_m > 0.0, (a2 - 1.0) / denom, 0.0)


def _gtr1_sample(alpha, u):
    a2 = (alpha * alpha).clamp(min=1e-6)
    cos2 = (1.0 - torch.pow(a2, 1.0 - u[..., 0])) / (1.0 - a2)
    cos_t = torch.sqrt(cos2.clamp(0.0, 1.0))
    sin_t = safe_sqrt(1.0 - cos2)
    phi = 2.0 * PI * u[..., 1]
    return torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi),
                        cos_t], -1)


def _principled_weights(extra):
    """The principled lobes' selection weights (diffuse, GGX, clearcoat)."""
    metallic = extra[..., 0]
    return 1.0 - metallic, torch.ones_like(metallic), 0.25 * extra[..., 4]


def _principled_eval(base, rough, extra, wi_l, wo_l):
    """Disney principled reflection lobes (`principled.cpp`, Burley 2012)
    -> (value = f cos_o (..., C), pdf), in the two-sided local frame."""
    metallic, specular = extra[..., 0], extra[..., 1]
    sheen, sheen_tint = extra[..., 2], extra[..., 3]
    clearcoat, cc_gloss = extra[..., 4], extra[..., 5]
    spec_tint = extra[..., 6]

    cos_i = wi_l[..., 2].clamp(min=1e-6)
    cos_o = wo_l[..., 2].clamp(min=0.0)
    m = _unit(wi_l + wo_l)
    cos_d = (wi_l * m).sum(-1)                  # the half-vector angle
    lum = base.mean(-1, keepdim=True)
    c_tint = torch.where(lum > 0.0, base / lum.clamp(min=1e-6), 1.0)

    # retro-reflective diffuse (Burley)
    fd90 = 0.5 + 2.0 * rough * cos_d * cos_d
    fd_i = 1.0 + (fd90 - 1.0) * _schlick5(cos_i)
    fd_o = 1.0 + (fd90 - 1.0) * _schlick5(cos_o)
    diff = base * warp.INV_PI * (fd_i * fd_o * (1.0 - metallic)
                                 * cos_o)[..., None]
    # sheen, a grazing retro lobe
    c_sheen = 1.0 + (c_tint - 1.0) * sheen_tint[..., None]
    sheen_val = c_sheen * (sheen * (1.0 - metallic) * _schlick5(cos_d)
                           * cos_o)[..., None]
    # GGX specular with Schlick's Fresnel
    alpha = (rough * rough).clamp(min=1e-4)
    d_ndf = _ggx_ndf(m, alpha)
    g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_l, alpha)
    f0_diel = (0.08 * specular)[..., None] * (
        1.0 + (c_tint - 1.0) * spec_tint[..., None])
    c_spec0 = f0_diel + (base - f0_diel) * metallic[..., None]
    f_spec = c_spec0 + (1.0 - c_spec0) * _schlick5(cos_d)[..., None]
    spec = f_spec * (d_ndf * g / (4.0 * cos_i))[..., None]
    # clearcoat: GTR1 D, F0 0.04, GGX G at alpha 0.25
    alpha_cc = 0.1 + (0.001 - 0.1) * cc_gloss
    d_cc = _gtr1_ndf(m[..., 2], alpha_cc)
    g_cc = _ggx_g1(wi_l, 0.25) * _ggx_g1(wo_l, 0.25)
    f_cc = 0.04 + 0.96 * _schlick5(cos_d)
    cc = (0.25 * clearcoat * d_cc * g_cc * f_cc * cos_o)[..., None]
    value = diff + sheen_val + spec + cc

    # the pdf of `sample`'s lobe choice
    jac = (4.0 * cos_d.abs()).clamp(min=1e-6)
    w_diff, w_spec, w_cc = _principled_weights(extra)
    pdf = (w_diff * warp.INV_PI * cos_o + w_spec * d_ndf * m[..., 2] / jac
           + w_cc * d_cc * m[..., 2] / jac) / (w_diff + w_spec + w_cc)
    ok = (wi_l[..., 2] > 0.0) & (wo_l[..., 2] > 0.0)
    return (torch.where(ok[..., None], value, 0.0),
            torch.where(ok, pdf, 0.0))


# ---------------------------------------------------------------------------
# hair (Chiang et al. 2016; `hair.cpp`, `tpusky/render/bsdf.py:355-616`)
# ---------------------------------------------------------------------------
#
# The fiber frame (`hair.cpp:140-149`): local +y is the tangent (sin_theta
# = w.y), (x, z) the cross-section with +z the outward normal at the hit.
# Three modes (R, TT, TRT) and a residual lobe.

_HAIR_PMAX = 3
# the direction a non-hair lane's fiber math runs on: no inf or NaN there
# to turn a zero cotangent into NaN in the shared wi / wo
_HAIR_SAFE_D = (0.6, 0.48, 0.64)


def _bessel_i0(x):
    """10-term series of the modified Bessel function I0 (`warp.h:
    748-758`)."""
    result = torch.ones_like(x)
    x2 = x * x
    xi = x2
    denom = 4.0
    for i in range(1, 11):
        factor = i + 1.0
        result = result + xi / denom
        xi = xi * x2
        denom = denom * 4.0 * factor * factor
    return result


def _log_bessel_i0(x):
    """log I0(x), the large-argument asymptote above 12 (`warp.h:
    761-766`)."""
    safe = x.clamp(max=12.0)
    xc = x.clamp(min=1e-6)
    return torch.where(
        x > 12.0, x + 0.5 * (-torch.log(2.0 * PI * xc) + 1.0 / (8.0 * xc)),
        torch.log(_bessel_i0(safe).clamp(min=1e-30)))


def _rough_fiber_pdf(v_dir, wi, kappa):
    """d'Eon et al. 2011's longitudinal density M_p (`warp.h:772-792`,
    tangent +y)."""
    sin_ti = wi[..., 1]
    sin_to = v_dir[..., 1]
    cos_ti = safe_sqrt(1.0 - sin_ti * sin_ti)
    cos_to = safe_sqrt(1.0 - sin_to * sin_to)
    c = cos_ti * cos_to * kappa
    s = sin_ti * sin_to * kappa
    inv_2pi = 0.15915494309189535
    big = torch.exp(-s + _log_bessel_i0(c) - kappa + 0.6931
                    + torch.log(0.5 * kappa.clamp(min=1e-6))) * inv_2pi
    kp = kappa.clamp(max=10.0)
    small = (torch.exp(-s) * _bessel_i0(c) * kp
             / (2.0 * torch.sinh(kp)) * inv_2pi)
    return torch.where(kappa > 10.0, big, small)


def _hair_gamma(w):
    """The azimuthal offset of w from the cross-section's normal +z
    (`hair.cpp:528-536`); h = sin(gamma) is the chord's offset."""
    proj = safe_sqrt(w[..., 0] ** 2 + w[..., 2] ** 2)
    g = safe_acos((w[..., 2] / proj.clamp(min=1e-12)).clamp(-1.0, 1.0))
    g = torch.where(proj == 0.0, 0.0, g)
    return torch.where(w[..., 0] < 0.0, g, -g)


def _hair_derived(beta_m, beta_n, tilt_deg):
    """Roughness -> the lobes' variances v[0..3], the logistic scale s and
    the scale tilt's double-angle tables (`hair.cpp:496-527`)."""
    v0 = (0.726 * beta_m + 0.812 * beta_m ** 2 + 3.7 * beta_m ** 20) ** 2
    v = [v0, 0.25 * v0, 4.0 * v0, 4.0 * v0]
    s = math.sqrt(PI / 8.0) * (0.265 * beta_n + 1.194 * beta_n ** 2
                               + 5.372 * beta_n ** 22)
    sin0 = torch.sin(torch.deg2rad(tilt_deg))
    cos0 = safe_sqrt(1.0 - sin0 * sin0)
    sin1 = 2.0 * cos0 * sin0
    cos1 = cos0 * cos0 - sin0 * sin0
    sin2 = 2.0 * cos1 * sin1
    cos2 = cos1 * cos1 - sin1 * sin1
    return v, s, (sin0, sin1, sin2), (cos0, cos1, cos2)


def _hair_reframe(sin_ti, cos_ti, p, sin2k, cos2k):
    """The incident angle tilted for lobe p (`hair.cpp:543-575`)."""
    if p == 0:
        s = sin_ti * cos2k[1] - cos_ti * sin2k[1]
        c = cos_ti * cos2k[1] + sin_ti * sin2k[1]
    elif p == 1:
        s = sin_ti * cos2k[0] + cos_ti * sin2k[0]
        c = cos_ti * cos2k[0] - sin_ti * sin2k[0]
    elif p == 2:
        s = sin_ti * cos2k[2] + cos_ti * sin2k[2]
        c = cos_ti * cos2k[2] - sin_ti * sin2k[2]
    else:
        s, c = sin_ti, cos_ti
    return s, c.abs()


def _hair_attenuation(cos_theta_i, eta, h, transmittance):
    """Each mode's attenuation a_p (`hair.cpp:577-592`): Fresnel at the
    entry, absorption along the chords, the residual series."""
    cos_gamma_i = safe_sqrt(1.0 - h * h)
    f, _, _ = fresnel_dielectric(cos_theta_i * cos_gamma_i, eta)
    f = f[..., None]
    t = transmittance
    a0 = f.expand(t.shape)
    a1 = (1.0 - f) ** 2 * t
    a2 = a1 * t * f
    a3 = a2 * f * t / (1.0 - t * f).clamp(min=1e-4)
    return [a0, a1, a2, a3]


def _hair_logistic(x, s):
    # a non-hair row has beta_n = 0, so s = 0: floored, or its masked
    # lanes' NaN would turn zero cotangents into NaN in the shared wi / wo
    s = s.clamp(min=1e-6)
    x = x.abs()
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _hair_logistic_cdf(x, s):
    return 1.0 / (1.0 + torch.exp(-(x / s.clamp(min=1e-6)).clamp(-60.0,
                                                                  60.0)))


def _hair_azimuthal(delta_phi, p, s, gamma_i, gamma_t):
    """The trimmed logistic N_p (`hair.cpp:630-645`)."""
    perfect = 2.0 * p * gamma_t - 2.0 * gamma_i + p * PI
    phi = torch.remainder(delta_phi - perfect, 2.0 * PI)
    phi = torch.where(phi < PI, phi + 2.0 * PI, phi)
    phi = torch.where(phi > PI, phi - 2.0 * PI, phi)
    pi_t = torch.full_like(s, PI)
    norm_ = _hair_logistic_cdf(pi_t, s) - _hair_logistic_cdf(-pi_t, s)
    return _hair_logistic(phi, s) / norm_.clamp(min=1e-9)


def _hair_geometry(wi, eta):
    """The fiber-frame geometry shared by eval, pdf and sample."""
    # a non-hair row has eta = 0: sin_ti / eta would be inf
    eta = eta.clamp(min=1e-3)
    gamma_i = _hair_gamma(wi)
    h = torch.sin(gamma_i)
    sin_ti = wi[..., 1]
    cos_ti = safe_sqrt(1.0 - sin_ti * sin_ti)
    sin_tt = sin_ti / eta
    cos_tt = safe_sqrt(1.0 - sin_tt * sin_tt)
    eta_p = safe_sqrt(eta * eta - sin_ti * sin_ti) / cos_ti.clamp(min=1e-6)
    sin_gt = h / eta_p.clamp(min=1e-6)
    cos_gt = safe_sqrt(1.0 - sin_gt * sin_gt)
    gamma_t = safe_asin(sin_gt)
    return gamma_i, h, sin_ti, cos_ti, cos_tt, cos_gt, gamma_t


def _hair_lobes(sigma_a, beta_m, beta_n, tilt_deg, eta, wi):
    """(v, s, sin2k, cos2k, geometry, a_p, lum, lum_sum) of a lane."""
    v, s, sin2k, cos2k = _hair_derived(beta_m, beta_n, tilt_deg)
    geo = _hair_geometry(wi, eta)
    cos_tt, cos_gt = geo[4], geo[5]
    transmittance = torch.exp(-sigma_a * (2.0 * cos_gt
                                          / cos_tt.clamp(min=1e-6))[..., None])
    a_p = _hair_attenuation(geo[3], eta, geo[1], transmittance)
    lum = [a.mean(-1) for a in a_p]
    lum_sum = sum(lum).clamp(min=1e-12)
    return v, s, sin2k, cos2k, geo, a_p, lum, lum_sum


def _hair_eval_pdf(sigma_a, beta_m, beta_n, tilt_deg, eta, wi, wo):
    """(f (..., C), pdf) of the hair BCSDF in the fiber frame
    (`hair.cpp:420-477`); the model folds the projected cosine into f."""
    v, s, sin2k, cos2k, geo, a_p, lum, lum_sum = _hair_lobes(
        sigma_a, beta_m, beta_n, tilt_deg, eta, wi)
    gamma_i, _, sin_ti, cos_ti, _, _, gamma_t = geo
    phi_i = torch.atan2(wi[..., 2], wi[..., 0])
    phi_o = torch.atan2(wo[..., 2], wo[..., 0])
    delta_phi = phi_o - phi_i
    sin_pi, cos_pi = torch.sin(phi_i), torch.cos(phi_i)
    value = torch.zeros_like(a_p[0])
    pdf = torch.zeros_like(lum_sum)
    for p in range(_HAIR_PMAX):
        s_ip, c_ip = _hair_reframe(sin_ti, cos_ti, p, sin2k, cos2k)
        wi_p = torch.stack([c_ip * cos_pi, s_ip, c_ip * sin_pi], -1)
        m_p = _rough_fiber_pdf(wo, wi_p, 1.0 / v[p].clamp(min=1e-7))
        n_p = _hair_azimuthal(delta_phi, p, s, gamma_i, gamma_t)
        value = value + (m_p * 2.0 * PI * n_p)[..., None] * a_p[p]
        pdf = pdf + m_p * 2.0 * PI * (lum[p] / lum_sum) * n_p
    m_res = _rough_fiber_pdf(wo, wi, 1.0 / v[3].clamp(min=1e-7))
    value = value + m_res[..., None] * a_p[3]
    pdf = pdf + m_res * (lum[3] / lum_sum)
    return (torch.where(torch.isfinite(value), value, 0.0),
            torch.where(torch.isfinite(pdf), pdf, 0.0))


def _hair_sample(sigma_a, beta_m, beta_n, tilt_deg, eta, wi, u2, u1):
    """An outgoing direction of the hair BCSDF (`hair.cpp:215-322`): a
    lobe by u1, the longitudinal and azimuthal inverse CDFs by u2."""
    v, s, sin2k, cos2k, geo, a_p, lum, lum_sum = _hair_lobes(
        sigma_a, beta_m, beta_n, tilt_deg, eta, wi)
    gamma_i, _, sin_ti, cos_ti, _, _, gamma_t = geo
    ap_pdf = torch.stack([l / lum_sum for l in lum], -1)      # (..., 4)
    # the lobe, and u1's remainder rescaled to it (`hair.cpp:233-243`)
    cdf = torch.cumsum(ap_pdf, -1)
    p_sel = (3 - (u1 < cdf[..., 2]).long() - (u1 < cdf[..., 1]).long()
             - (u1 < cdf[..., 0]).long())
    cdf_prev = torch.cat([torch.zeros_like(cdf[..., :1]), cdf[..., :-1]], -1)
    sel = torch.nn.functional.one_hot(p_sel, 4).to(cdf.dtype)
    u_rem = ((u1 - (sel * cdf_prev).sum(-1))
             / (sel * ap_pdf).sum(-1).clamp(min=1e-9)).clamp(0.0, 1.0 - 1e-6)

    # the longitudinal sample about the tilted incident angle
    s_ip = torch.zeros_like(sin_ti)
    c_ip = torch.zeros_like(cos_ti)
    v_sel = torch.zeros_like(sin_ti)
    for p in range(4):
        sp, cp = _hair_reframe(sin_ti, cos_ti, p, sin2k, cos2k)
        is_p = p_sel == p
        s_ip = torch.where(is_p, sp, s_ip)
        c_ip = torch.where(is_p, cp, c_ip)
        v_sel = torch.where(is_p, v[p], v_sel)
    v_sel = v_sel.clamp(min=1e-7)
    u20 = u2[..., 0].clamp(1e-6, 1.0 - 1e-6)
    cos_theta = 1.0 + v_sel * torch.log(
        u20 + (1.0 - u20) * torch.exp(-2.0 / v_sel))
    sin_theta = safe_sqrt(1.0 - cos_theta ** 2)
    cos_phi_l = torch.cos(2.0 * PI * u2[..., 1])
    sin_to = -cos_theta * s_ip + sin_theta * cos_phi_l * c_ip
    cos_to = safe_sqrt(1.0 - sin_to ** 2)

    # the azimuthal sample: the trimmed logistic about the perfect
    # deflection for p < 3, uniform for the residual (`hair.cpp:268-280`)
    p_f = p_sel.to(sin_ti.dtype)
    perfect = 2.0 * p_f * gamma_t - 2.0 * gamma_i + p_f * PI
    pi_t = torch.full_like(s, PI)
    cdf_lo = _hair_logistic_cdf(-pi_t, s)
    k_log = _hair_logistic_cdf(pi_t, s) - cdf_lo
    # the log's argument reaches <= 0 at u_rem ~ 1 (and where s = 0):
    # floored, or its NaN would turn zero cotangents into NaN downstream
    x_log = -s * torch.log((1.0 / (u_rem * k_log + cdf_lo).clamp(min=1e-9)
                            - 1.0).clamp(min=1e-12))
    x_log = x_log.clamp(-PI, PI)
    delta_phi = torch.where(p_sel < 3, perfect + x_log, 2.0 * PI * u_rem)
    phi_o = torch.atan2(wi[..., 2], wi[..., 0]) + delta_phi
    wo = torch.stack([cos_to * torch.cos(phi_o), sin_to,
                      cos_to * torch.sin(phi_o)], -1)
    return _unit(wo)


def _hair_args(table, mat_idx, albedo, wi):
    """The hair lobe's arguments: (sigma_a, beta_m, beta_n, tilt, eta,
    is_hair, wi with a fixed safe direction on the other lanes), the
    input guard of `tpusky/render/bsdf.py:1152-1160`."""
    extra = table.extra[mat_idx]
    is_h = table.kind[mat_idx] == HAIR
    # filled on the device: a copy from the host would wait for it
    safe_d = torch.stack([torch.full((), v, dtype=wi.dtype, device=wi.device)
                          for v in _HAIR_SAFE_D])
    return ((albedo, table.alpha[mat_idx], extra[..., 0], extra[..., 1],
             table.ior[mat_idx]), is_h,
            torch.where(is_h[..., None], wi, safe_d))


def _n_chan(wavelengths):
    return 3 if wavelengths is None else wavelengths.shape[-1]


def _flip(table, mat_idx, wi):
    """Two-sided adapter: the (..., 3) z-flip that mirrors the frame for
    lanes arriving from below."""
    sign = torch.where(table.twosided[mat_idx] & (wi[..., 2] < 0.0),
                       -1.0, 1.0)
    return torch.stack([torch.ones_like(sign)] * 2 + [sign], -1)


def _select(is_k, new, old):
    """Per lane `new` where is_k, else `old` (is_k broadcast over C)."""
    return torch.where(is_k[..., None] if new.dim() > is_k.dim() else is_k,
                       new, old)


def _blend(table, mat_idx):
    """(is_blend, clipped weight of child b, child a, child b) a lane."""
    is_blend = table.kind[mat_idx] == BLEND
    w = torch.where(is_blend, table.blend_w[mat_idx].clamp(0.0, 1.0), 0.0)
    idx_a = torch.where(is_blend, table.blend_a[mat_idx], mat_idx)
    idx_b = torch.where(is_blend, table.blend_b[mat_idx], mat_idx)
    return is_blend, w, idx_a, idx_b


def eval_pdf(table: MaterialTable, mat_idx, wi, wo, wavelengths=None,
             kinds=None, refl_tex=None):
    """(f * cos(theta_o) (..., C), pdf (...,)) of the lanes' materials, C
    = 3 or W; 0 for the delta lobes. `kinds` is `table_kinds(table)`
    (read here when None). A blend row evaluates both children and lerps
    them by `blend_w` (`tpusky/render/bsdf.py:892-915`), both with the
    vertex's `refl_tex`."""
    present, any_mask = table_kinds(table) if kinds is None else kinds
    check_kinds(present)
    check_datasets(present, table.measured, table.measured_pol)
    if BLEND not in present:
        return _eval_pdf_core(table, mat_idx, wi, wo, wavelengths, present,
                              any_mask, refl_tex)
    _, w, idx_a, idx_b = _blend(table, mat_idx)
    va, pa = _eval_pdf_core(table, idx_a, wi, wo, wavelengths, present,
                            any_mask, refl_tex)
    vb, pb = _eval_pdf_core(table, idx_b, wi, wo, wavelengths, present,
                            any_mask, refl_tex)
    return ((1.0 - w)[..., None] * va + w[..., None] * vb,
            (1.0 - w) * pa + w * pb)


def sample(table: MaterialTable, mat_idx, wi, sample2, sample1,
           wavelengths=None, kinds=None, refl_tex=None):
    """Sample an outgoing direction -> (wo, weight = f cos / pdf, pdf,
    is_delta). `sample1` picks among discrete lobes and the mask's
    pass-through. A blend row samples child b with probability `blend_w`
    on the re-folded `sample1` and, for a non-delta sample, returns the
    blended value over the blended pdf at that direction (one-sample MIS,
    `blendbsdf.cpp::sample`; `tpusky/render/bsdf.py:918-962`)."""
    present, any_mask = table_kinds(table) if kinds is None else kinds
    check_kinds(present)
    check_datasets(present, table.measured, table.measured_pol)
    if BLEND not in present:
        return _sample_core(table, mat_idx, wi, sample2, sample1,
                            wavelengths, present, any_mask, refl_tex)
    is_blend, w, idx_a, idx_b = _blend(table, mat_idx)
    pick_b = is_blend & (sample1 < w)
    s1 = torch.where(pick_b, sample1 / w.clamp(min=1e-6),
                     (sample1 - w) / (1.0 - w).clamp(min=1e-6))
    s1 = torch.where(is_blend, s1, sample1).clamp(0.0, 1.0 - 1e-7)
    idx_sel = torch.where(pick_b, idx_b, idx_a)
    idx_oth = torch.where(pick_b, idx_a, idx_b)
    wo, wt, pdf, is_delta = _sample_core(table, idx_sel, wi, sample2, s1,
                                         wavelengths, present, any_mask,
                                         refl_tex)
    v_oth, p_oth = _eval_pdf_core(table, idx_oth, wi, wo, wavelengths,
                                  present, any_mask, refl_tex)
    w_sel = torch.where(pick_b, w, 1.0 - w)
    w_oth = 1.0 - w_sel
    num = w_sel[..., None] * wt * pdf[..., None] + w_oth[..., None] * v_oth
    den = w_sel * pdf + w_oth * p_oth
    wt_mix = torch.where((den > 1e-12)[..., None],
                         num / den.clamp(min=1e-12)[..., None], 0.0)
    return (wo, torch.where(is_delta[..., None], wt, wt_mix),
            torch.where(is_delta, w_sel * pdf, den), is_delta)


def _eval_pdf_core(table: MaterialTable, mat_idx, wi, wo, wavelengths,
                   present, any_mask, refl_tex):
    """`eval_pdf` of non-blend rows (`_eval_pdf_core` of the reference
    package): the lobes of the kinds in `present`, each selected per lane
    by kind, then the mask's opacity."""
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
    # the Lambertian reflectance, textured; a conductor's tint is not
    albedo = _apply_tex(refl, refl_tex)
    if any(k in present for k in (PLASTIC, ROUGH_DIELECTRIC,
                                  ROUGH_PLASTIC, PPLASTIC)):
        ior = table.ior[mat_idx]

    if DIFFUSE in present:
        diff_pdf = warp.INV_PI * cos_o.clamp(min=0.0)
        is_diff = kind == DIFFUSE
        value = _select(is_diff, albedo * diff_pdf[..., None], value)
        pdf = _select(is_diff, diff_pdf, pdf)

    if ROUGH_CONDUCTOR in present:
        alpha = table.alpha[mat_idx]
        m = _unit(wi_l + wo_l)
        d_ndf = _ggx_ndf(m, alpha)
        g = _ggx_g1(wi_l, alpha) * _ggx_g1(wo_l, alpha)
        mi_dot = (wi_l * m).sum(-1)
        f_c = _conductor_fresnel(table, mat_idx, mi_dot, wavelengths)
        denom = 4.0 * cos_i.clamp(min=1e-6)
        rough_val = refl * f_c * (d_ndf * g / denom)[..., None]
        rough_pdf = (d_ndf * m[..., 2]
                     / (4.0 * mi_dot.abs()).clamp(min=1e-6))
        is_rough = kind == ROUGH_CONDUCTOR
        value = _select(is_rough, rough_val, value)
        pdf = _select(is_rough, rough_pdf, pdf)

    if PPLASTIC in present:
        pp_val, pp_pdf = _pplastic_eval(albedo, table.alpha[mat_idx], ior,
                                        wi_l, wo_l,
                                        _pplastic_prob_spec(table, mat_idx))
        is_pp = kind == PPLASTIC
        value = _select(is_pp, pp_val, value)
        pdf = _select(is_pp, pp_pdf, pdf)

    if ROUGH_PLASTIC in present:
        rp_val, rp_pdf = _rough_plastic_eval(albedo, table.alpha[mat_idx],
                                             ior, wi_l, wo_l)
        is_rp = kind == ROUGH_PLASTIC
        value = _select(is_rp, rp_val, value)
        pdf = _select(is_rp, rp_pdf, pdf)

    if PRINCIPLED in present:
        pr_val, pr_pdf = _principled_eval(albedo, table.alpha[mat_idx],
                                          table.extra[mat_idx], wi_l, wo_l)
        is_pr = kind == PRINCIPLED
        value = _select(is_pr, pr_val, value)
        pdf = _select(is_pr, pr_pdf, pdf)

    if PLASTIC in present:
        # the coat is a delta lobe: only the base, with the lobe choice
        # of `sample` (the coat with probability F(cos_i))
        f_i, _, _ = fresnel_dielectric(cos_i.clamp(min=0.0), ior)
        f_o, _, _ = fresnel_dielectric(cos_o.clamp(min=0.0), ior)
        pl_pdf = (1.0 - f_i) * warp.INV_PI * cos_o.clamp(min=0.0)
        is_pl = kind == PLASTIC
        value = _select(is_pl, _plastic_base(albedo, ior, f_o)
                        * pl_pdf[..., None], value)
        pdf = _select(is_pl, pl_pdf, pdf)

    value = torch.where(refl_active[..., None], value, 0.0)
    pdf = torch.where(refl_active, pdf, 0.0)

    if ROUGH_DIELECTRIC in present:
        # Walter et al. 2007 (`roughdielectric.cpp`), in the geometric
        # frame, past the reflection gate above
        alpha = table.alpha[mat_idx].clamp(min=1e-3)
        gi, go = wi[..., 2], wo[..., 2]
        reflecting = gi * go > 0.0
        eta_rel = torch.where(gi >= 0.0, ior, 1.0 / ior)
        # half vector: wi + wo on reflection, -(wi + eta wo) on refraction
        m = torch.where(reflecting[..., None], wi + wo,
                        -(wi + wo * eta_rel[..., None]))
        m = _unit(m)
        m = m * torch.sign(m[..., 2:3])          # the upper hemisphere
        d_rd = _ggx_ndf(m, alpha)
        g_rd = (_ggx_g1(wi * torch.sign(gi)[..., None], alpha)
                * _ggx_g1(wo * torch.sign(go)[..., None], alpha))
        wim = (wi * m).sum(-1)
        wom = (wo * m).sum(-1)
        f_rd, _, _ = fresnel_dielectric(wim, ior)
        val_refl = f_rd * d_rd * g_rd / (4.0 * gi.abs().clamp(min=1e-6))
        jac_refl = 1.0 / (4.0 * wom.abs()).clamp(min=1e-6)
        sqrt_dn = wim + eta_rel * wom
        jac_refr = (eta_rel * eta_rel * wom.abs()
                    / (sqrt_dn * sqrt_dn).clamp(min=1e-8))
        val_refr = ((1.0 - f_rd) * d_rd * g_rd * wim.abs() * jac_refr
                    / gi.abs().clamp(min=1e-6) / (eta_rel * eta_rel))
        rd_ok = torch.where(reflecting, wim * gi > 0.0,
                            (wim * gi > 0.0) & (wom * go > 0.0))
        rd_val = torch.where(rd_ok, torch.where(reflecting, val_refl,
                                                val_refr), 0.0)
        rd_pdf = d_rd * m[..., 2].abs() * torch.where(
            reflecting, f_rd * jac_refl, (1.0 - f_rd) * jac_refr)
        is_rd = kind == ROUGH_DIELECTRIC
        value = _select(is_rd, rd_val[..., None].expand(value.shape), value)
        pdf = _select(is_rd, torch.where(rd_ok, rd_pdf, 0.0), pdf)

    if PRINCIPLED_THIN in present:
        pt_val, pt_pdf = _principledthin_eval(
            albedo, table.alpha[mat_idx], table.ior[mat_idx],
            table.extra[mat_idx], wi, wo)
        is_pt = kind == PRINCIPLED_THIN
        value = _select(is_pt, pt_val, value)
        pdf = _select(is_pt, pt_pdf, pdf)

    if HAIR in present:
        # the fiber frame, the full sphere (:1148-1165)
        args, is_h, wi_h = _hair_args(table, mat_idx, albedo, wi)
        wo_h = torch.where(is_h[..., None], wo, wi_h)
        h_val, h_pdf = _hair_eval_pdf(*args, wi_h, wo_h)
        value = _select(is_h, h_val, value)
        pdf = _select(is_h, h_pdf, pdf)

    if MEASURED in present:
        # the two-sided local frame, upper-hemisphere reflection
        # (:1167-1174)
        md_val, md_pdf = measured_mod.measured_eval_pdf(
            table.measured, wi_l, wo_l, wavelengths)
        is_md = kind == MEASURED
        value = _select(is_md, md_val, value)
        pdf = _select(is_md, md_pdf, pdf)

    if MEASURED_POL in present:
        # the scalar M00 (:1176-1183); the Mueller matrices are
        # `render/polarized.py`'s
        mp_val, mp_pdf = measured_mod.mp_eval_pdf(
            table.measured_pol, wi_l, wo_l, wavelengths)
        is_mp = kind == MEASURED_POL
        value = _select(is_mp, mp_val, value)
        pdf = _select(is_mp, mp_pdf, pdf)

    if any_mask:
        # the mask: the lane's chance to interact at all
        opac = table.opacity[mat_idx]
        value = value * opac[..., None]
        pdf = pdf * opac
    return value, pdf


def _sample_core(table: MaterialTable, mat_idx, wi, sample2, sample1,
                 wavelengths, present, any_mask, refl_tex):
    """`sample` of non-blend rows (`_sample_core` of the reference
    package). The two-sided adapter's lobes are sampled in the flipped
    frame and flipped back; the dielectrics, null and principledthin
    work in the geometric frame, after that flip."""
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
    albedo = _apply_tex(refl, refl_tex)
    if any_mask:
        # the mask (`mask.cpp`): pass through with probability 1 -
        # opacity; the lanes that interact reuse sample1 renormalised
        opac = table.opacity[mat_idx]
        passthrough = sample1 >= opac
        sample1 = (sample1 / opac.clamp(min=1e-6)).clamp(0.0, 1.0 - 1e-7)
    if any(k in present for k in _BASE + (PRINCIPLED_THIN,)):
        wo_diff = warp.square_to_cosine_hemisphere(sample2)
        pdf_diff = warp.square_to_cosine_hemisphere_pdf(wo_diff)
    if any(k in present for k in (DIELECTRIC, PLASTIC, ROUGH_DIELECTRIC,
                                  THIN_DIELECTRIC, ROUGH_PLASTIC, PPLASTIC)):
        ior = table.ior[mat_idx]

    def through_eval(is_k, wo_k, val, pdf_k, valid):
        """Select a lobe sampled by direction whose weight is its eval
        over its pdf."""
        ok = valid & (pdf_k > 1e-12)
        w_k = torch.where(ok[..., None],
                          val / pdf_k.clamp(min=1e-12)[..., None], 0.0)
        return (_select(is_k, wo_k, wo), _select(is_k, w_k, weight),
                _select(is_k, pdf_k, pdf))

    if DIFFUSE in present:
        is_diff = kind == DIFFUSE
        wo = _select(is_diff, wo_diff, wo)
        weight = _select(is_diff, albedo, weight)
        pdf = _select(is_diff, pdf_diff, pdf)

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
        wo = _select(is_rough, wo_rough, wo)
        weight = _select(is_rough,
                         torch.where(rough_ok[..., None], w_rough, 0.0),
                         weight)
        pdf = _select(is_rough, pdf_rough, pdf)

    if CONDUCTOR in present or PLASTIC in present:
        wo_mirr = torch.stack([-wi_l[..., 0], -wi_l[..., 1], wi_l[..., 2]],
                              -1)
    if CONDUCTOR in present:
        f_m = _conductor_fresnel(table, mat_idx, cos_i, wavelengths)
        is_mirr = kind == CONDUCTOR
        wo = _select(is_mirr, wo_mirr, wo)
        weight = _select(is_mirr, refl * f_m, weight)
        pdf = _select(is_mirr, torch.ones_like(pdf), pdf)
        is_delta = is_delta | is_mirr

    if PRINCIPLED in present:
        # a three-way lobe choice (diffuse, GGX, clearcoat)
        rough = table.alpha[mat_idx]
        extra = table.extra[mat_idx]
        w_diff, w_spec, w_cc = _principled_weights(extra)
        w_sum = w_diff + w_spec + w_cc
        t1 = w_diff / w_sum
        t2 = (w_diff + w_spec) / w_sum
        m_sp = _ggx_sample((rough * rough).clamp(min=1e-4), sample2)
        m_cc = _gtr1_sample(0.1 + (0.001 - 0.1) * extra[..., 5], sample2)
        wo_pr = torch.where(
            (sample1 < t1)[..., None], wo_diff,
            torch.where((sample1 < t2)[..., None], _reflect(wi_l, m_sp),
                        _reflect(wi_l, m_cc)))
        pr_val, pr_pdf = _principled_eval(albedo, rough, extra, wi_l, wo_pr)
        wo, weight, pdf = through_eval(kind == PRINCIPLED, wo_pr, pr_val,
                                       pr_pdf, wo_pr[..., 2] > 0.0)

    if PPLASTIC in present:
        # the coat or the base by the reflectance-balanced probability
        # (`pplastic.cpp:216-262`)
        alpha_pp = table.alpha[mat_idx]
        prob_pp = _pplastic_prob_spec(table, mat_idx)
        m_pp = _ggx_sample(alpha_pp.clamp(min=1e-3), sample2)
        wo_pp = torch.where((sample1 < prob_pp)[..., None],
                            _reflect(wi_l, m_pp), wo_diff)
        pp_val, pp_pdf = _pplastic_eval(albedo, alpha_pp, ior, wi_l, wo_pp,
                                        prob_pp)
        wo, weight, pdf = through_eval(kind == PPLASTIC, wo_pp, pp_val,
                                       pp_pdf, wo_pp[..., 2] > 0.0)

    if ROUGH_PLASTIC in present:
        # the coat with probability F(cos_i), else the base
        alpha_rp = table.alpha[mat_idx]
        f_i_rp, _, _ = fresnel_dielectric(cos_i, ior)
        m_rp = _ggx_sample(alpha_rp.clamp(min=1e-3), sample2)
        wo_rp = torch.where((sample1 < f_i_rp)[..., None],
                            _reflect(wi_l, m_rp), wo_diff)
        rp_val, rp_pdf = _rough_plastic_eval(albedo, alpha_rp, ior, wi_l,
                                             wo_rp)
        wo, weight, pdf = through_eval(kind == ROUGH_PLASTIC, wo_rp, rp_val,
                                       rp_pdf, wo_rp[..., 2] > 0.0)

    if DIELECTRIC in present or THIN_DIELECTRIC in present:
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
        wo = _select(is_diel, wo_diel, wo)
        weight = _select(is_diel, w_diel[..., None].expand(weight.shape),
                         weight)
        pdf = _select(is_diel, torch.where(do_reflect, f_d, 1.0 - f_d), pdf)
        is_delta = is_delta | is_diel
        geom_frame = geom_frame | is_diel

    if PLASTIC in present:
        # the delta coat with probability F(cos_i) over the base
        f_i_pl, _, _ = fresnel_dielectric(cos_i.clamp(min=0.0), ior)
        pl_spec = sample1 < f_i_pl
        f_o_pl, _, _ = fresnel_dielectric(wo_diff[..., 2].clamp(min=0.0),
                                          ior)
        is_pl = kind == PLASTIC
        wo = _select(is_pl, torch.where(pl_spec[..., None], wo_mirr,
                                        wo_diff), wo)
        weight = _select(is_pl, torch.where(
            pl_spec[..., None], 1.0, _plastic_base(albedo, ior, f_o_pl)),
            weight)
        pdf = _select(is_pl, torch.where(pl_spec, f_i_pl,
                                         (1.0 - f_i_pl) * pdf_diff), pdf)
        is_delta = is_delta | (is_pl & pl_spec)

    if MEASURED in present:
        # the luminance, then the VNDF warp (:1424-1432)
        wo_md, w_md, pdf_md = measured_mod.measured_sample(
            table.measured, wi_l, sample2, wavelengths)
        is_md = kind == MEASURED
        wo = _select(is_md, wo_md, wo)
        weight = _select(is_md, w_md, weight)
        pdf = _select(is_md, pdf_md, pdf)

    if MEASURED_POL in present:
        # the cosine and GGX mixture, weight = M00 cos / pdf (:1434-1445)
        wo_mp = measured_mod.mp_sample(table.measured_pol, wi_l, sample2,
                                       sample1)
        mp_val, mp_pdf = measured_mod.mp_eval_pdf(table.measured_pol, wi_l,
                                                  wo_mp, wavelengths)
        wo, weight, pdf = through_eval(kind == MEASURED_POL, wo_mp, mp_val,
                                       mp_pdf, torch.ones_like(active))

    # back from the two-sided local frame to the geometric one
    wo = torch.where(geom_frame[..., None], wo, wo * sign3)
    ok = geom_frame | active
    weight = torch.where(ok[..., None], weight, 0.0)
    pdf = torch.where(ok, pdf, 0.0)

    if ROUGH_DIELECTRIC in present:
        # a GGX half vector, then reflect or refract by its Fresnel term
        # (geometric frame)
        alpha_rd = table.alpha[mat_idx].clamp(min=1e-3)
        m = _ggx_sample(alpha_rd, sample2)          # upper hemisphere
        wim = (wi * m).sum(-1)
        f_rd, cos_t_rd, eta_rel = fresnel_dielectric(wim, ior)
        rd_reflect = sample1 < f_rd
        inv_eta = 1.0 / eta_rel
        wo_rd = torch.where(
            rd_reflect[..., None], _reflect(wi, m),
            m * (wim * inv_eta + cos_t_rd)[..., None]
            - wi * inv_eta[..., None])
        g_rd = (_ggx_g1(wi * torch.sign(wi[..., 2:3]), alpha_rd)
                * _ggx_g1(wo_rd * torch.sign(wo_rd[..., 2:3]), alpha_rd))
        # the D-sampling weight (Walter eq. 41): G |wi.m| / (|cos_i| m_z)
        w_rd = (g_rd * wim.abs()
                / (wi[..., 2].abs() * m[..., 2].clamp(min=1e-6))
                .clamp(min=1e-6))
        w_rd = torch.where(rd_reflect, w_rd, w_rd / (eta_rel * eta_rel))
        # a reflection stays on wi's side, a refraction crosses
        rd_ok = torch.where(rd_reflect, wo_rd[..., 2] * wi[..., 2] > 0.0,
                            wo_rd[..., 2] * wi[..., 2] < 0.0)
        w_rd = torch.where(rd_ok & (wim.abs() > 1e-6), w_rd, 0.0)
        wom = (wo_rd * m).sum(-1)
        jac = torch.where(
            rd_reflect, 1.0 / (4.0 * wom.abs()).clamp(min=1e-6),
            eta_rel ** 2 * wom.abs()
            / ((wim + eta_rel * wom) ** 2).clamp(min=1e-8))
        pdf_rd = (_ggx_ndf(m, alpha_rd) * m[..., 2]
                  * torch.where(rd_reflect, f_rd, 1.0 - f_rd) * jac)
        is_rd = kind == ROUGH_DIELECTRIC
        wo = _select(is_rd, wo_rd, wo)
        weight = _select(is_rd, w_rd[..., None].expand(weight.shape), weight)
        pdf = _select(is_rd, pdf_rd, pdf)

    if THIN_DIELECTRIC in present:
        f_td, _, _ = fresnel_dielectric(wi[..., 2].abs(), ior)
        r_star = torch.where(f_td < 1.0, 2.0 * f_td / (1.0 + f_td), 1.0)
        td_reflect = sample1 < r_star
        wo_td = torch.where(td_reflect[..., None], wo_refl, -wi)
        is_td = kind == THIN_DIELECTRIC
        wo = _select(is_td, wo_td, wo)
        weight = _select(is_td, torch.ones_like(weight), weight)
        pdf = _select(is_td, torch.where(td_reflect, r_star, 1.0 - r_star),
                      pdf)
        is_delta = is_delta | is_td

    if PRINCIPLED_THIN in present:
        # a four-way lobe choice in wi's upper frame (geometric frame,
        # not flipped back above)
        extra = table.extra[mat_idx]
        rough = table.alpha[mat_idx]
        ior_pt = table.ior[mat_idx]
        st_, dt_ = extra[..., 0], extra[..., 1]
        p_sr = 0.5 * st_
        p_st = 0.5 * st_
        p_cr = (1.0 - st_) * (1.0 - dt_)
        tot = (p_sr + p_st + p_cr + (1.0 - st_) * dt_).clamp(min=1e-8)
        t1 = p_sr / tot
        t2 = (p_sr + p_st) / tot
        t3 = (p_sr + p_st + p_cr) / tot
        sgn = torch.sign(torch.where(wi[..., 2] == 0.0, 1.0, wi[..., 2]))
        wi_up = wi * sgn[..., None]
        m_sr = _ggx_sample((rough * rough).clamp(min=1e-4), sample2)
        m_st = _ggx_sample((((0.65 * ior_pt - 0.35) * rough) ** 2)
                           .clamp(min=1e-4), sample2)
        wo_sr = _reflect(wi_up, m_sr)
        wo_st = _reflect(wi_up, m_st) * torch.tensor([1.0, 1.0, -1.0],
                                                     device=wi.device)
        chose_sr = sample1 < t1
        chose_st = (sample1 >= t1) & (sample1 < t2)
        wo_pt = torch.where(
            chose_sr[..., None], wo_sr,
            torch.where((sample1 < t2)[..., None], wo_st,
                        torch.where((sample1 < t3)[..., None], wo_diff,
                                    -wo_diff))) * sgn[..., None]
        pt_val, pt_pdf = _principledthin_eval(albedo, rough, ior_pt, extra,
                                              wi, wo_pt)
        # a specular sample on the wrong side of its microfacet is
        # rejected, as the reference's (`principledthin.cpp:345-352,
        # 385-390`), rather than aliased into another lobe
        ok_sr = ((wo_sr[..., 2] > 0.0) & ((wi_up * m_sr).sum(-1) > 0.0)
                 & ((wo_sr * m_sr).sum(-1) > 0.0))
        ok_st = ((wo_st[..., 2] < 0.0) & ((wi_up * m_st).sum(-1) > 0.0)
                 & ((wo_st * -m_st).sum(-1) > 0.0))
        valid = torch.where(chose_sr, ok_sr,
                            torch.where(chose_st, ok_st, True))
        pt_pdf = torch.where(valid, pt_pdf, 0.0)
        wo, weight, pdf = through_eval(kind == PRINCIPLED_THIN, wo_pt, pt_val,
                                       pt_pdf, valid)

    if HAIR in present:
        # the lobe cascade and the two inverse CDFs, weight f / pdf by the
        # shared eval (fiber frame, the full sphere; :1572-1590)
        args, is_h, wi_h = _hair_args(table, mat_idx, albedo, wi)
        wo_h = _hair_sample(*args, wi_h, sample2, sample1)
        h_val, h_pdf = _hair_eval_pdf(*args, wi_h, wo_h)
        wo, weight, pdf = through_eval(is_h, wo_h, h_val, h_pdf,
                                       torch.ones_like(is_h))

    if NULL_BSDF in present:
        is_null = kind == NULL_BSDF
        wo = _select(is_null, -wi, wo)
        weight = _select(is_null, torch.ones_like(weight), weight)
        pdf = _select(is_null, torch.ones_like(pdf), pdf)
        is_delta = is_delta | is_null

    # the polarization filters: straight through, delta, with their
    # unpolarized transmission (`polarizer.cpp:148`, `retarder.cpp:137`,
    # `circular.cpp:111`); `render/polarized.py` holds their Mueller
    # matrices (`tpusky/render/bsdf.py:1600-1617`)
    for k, fac in ((POLARIZER, 0.5), (RETARDER, 1.0), (CIRCULAR, 0.5)):
        if k in present:
            is_k = kind == k
            wo = _select(is_k, -wi, wo)
            weight = _select(is_k, fac * albedo, weight)
            pdf = _select(is_k, torch.ones_like(pdf), pdf)
            is_delta = is_delta | is_k

    if any_mask:
        # the mask's pass-through overrides every lobe
        wo = _select(passthrough, -wi, wo)
        weight = _select(passthrough, torch.ones_like(weight), weight)
        pdf = torch.where(passthrough, 1.0 - opac, pdf * opac)
        is_delta = is_delta | passthrough
    return wo, weight, pdf, is_delta
