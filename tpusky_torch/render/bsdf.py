"""Diffuse BSDF table (the `diffuse` kind of `tpusky/render/bsdf.py`,
reference `src/bsdfs/diffuse.cpp`, with the `twosided.cpp` adapter).

Directions are in the local shading frame (+z = geometric normal). The
other material kinds are not ported yet: tables that hold them raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import warp

DIFFUSE = 0


class MaterialTable(NamedTuple):
    kind: torch.Tensor        # (M,) int64, all DIFFUSE
    albedo: torch.Tensor      # (M, 3) diffuse reflectance
    twosided: torch.Tensor    # (M,) bool


def make_material_table(kinds=None, albedos=((0.5, 0.5, 0.5),),
                        twosided=None, device="cuda") -> MaterialTable:
    a = np.atleast_2d(np.asarray(albedos, np.float32))
    m = a.shape[0]
    kinds = (np.zeros((m,), np.int64) if kinds is None
             else np.asarray(kinds, np.int64))
    if (kinds != DIFFUSE).any():
        raise NotImplementedError(f"material kinds {sorted(set(kinds))}")
    ts = (np.zeros((m,), bool) if twosided is None
          else np.asarray(twosided, bool))
    return MaterialTable(torch.tensor(kinds, device=device),
                         torch.tensor(a, device=device),
                         torch.tensor(ts, device=device))


def make_diffuse_table(albedos, twosided=None,
                       device="cuda") -> MaterialTable:
    return make_material_table(albedos=albedos, twosided=twosided,
                               device=device)


def table_kinds(table: MaterialTable):
    """Static lobe descriptor: (sorted kind tuple, any_mask flag), the
    reference package's format. This port has no mask wrapper."""
    ks = table.kind.cpu().numpy()
    return tuple(sorted(int(k) for k in np.unique(ks))), False


def _flip_sign(table: MaterialTable, mat_idx, wi):
    """Two-sided adapter: mirror the frame when arriving from below."""
    return torch.where(table.twosided[mat_idx] & (wi[..., 2] < 0.0),
                       -1.0, 1.0)


def diffuse_eval_pdf(table: MaterialTable, mat_idx, wi, wo):
    """(f * cos(theta_o) (..., 3), pdf (...,)) of the diffuse lobe."""
    sign = _flip_sign(table, mat_idx, wi)
    cos_i = wi[..., 2] * sign
    cos_o = wo[..., 2] * sign
    refl_active = (cos_i > 0.0) & (cos_o > 0.0)
    pdf = warp.INV_PI * cos_o.clamp(min=0.0)
    value = table.albedo[mat_idx] * pdf[..., None]
    return (torch.where(refl_active[..., None], value, 0.0),
            torch.where(refl_active, pdf, 0.0))


def diffuse_sample(table: MaterialTable, mat_idx, wi, sample2):
    """Cosine-hemisphere sample -> (wo, weight = f cos / pdf, pdf)."""
    sign = _flip_sign(table, mat_idx, wi)
    active = wi[..., 2] * sign > 0.0
    wo = warp.square_to_cosine_hemisphere(sample2)
    pdf = warp.square_to_cosine_hemisphere_pdf(wo)
    wo = wo * torch.stack([torch.ones_like(sign)] * 2 + [sign], -1)
    weight = torch.where(active[..., None], table.albedo[mat_idx], 0.0)
    return wo, weight, torch.where(active, pdf, 0.0)
