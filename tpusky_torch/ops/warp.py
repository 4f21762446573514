"""Warps mapping the unit square to sampling domains, with pdfs.

The subset of `tpusky/ops/warp.py` that the sunsky model, the diffuse
BSDF and the constant environments use. `sample` arguments are uniform
in [0, 1)^2 with a trailing axis of size 2; all functions broadcast over
leading batch dims.
"""

from __future__ import annotations

import math

import torch

from .math import safe_sqrt

INV_PI = 1.0 / math.pi
INV_TWO_PI = 1.0 / (2.0 * math.pi)


def square_to_uniform_disk_concentric(sample):
    """Concentric (Shirley-Chiu) square-to-disk mapping."""
    x = 2.0 * sample[..., 0] - 1.0
    y = 2.0 * sample[..., 1] - 1.0
    is_zero = (x == 0.0) & (y == 0.0)
    quadrant_1_or_3 = x.abs() < y.abs()
    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)
    phi = 0.25 * math.pi * rp / torch.where(is_zero, 1.0, r)
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, 0.0, phi)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], -1)


def square_to_uniform_cone(sample, cos_cutoff):
    """Uniform direction in a cone around +z with cos(angle) >= cos_cutoff
    (the low-distortion concentric-disk variant, reference `warp.h:543`)."""
    one_minus = 1.0 - cos_cutoff
    p = square_to_uniform_disk_concentric(sample)
    pn = (p * p).sum(-1)
    z = cos_cutoff + one_minus * (1.0 - pn)
    scale = safe_sqrt(one_minus * (2.0 - one_minus * pn))
    return torch.stack([p[..., 0] * scale, p[..., 1] * scale, z], -1)


def square_to_uniform_cone_pdf(cos_cutoff):
    """Solid-angle pdf of `square_to_uniform_cone` (constant inside)."""
    return INV_TWO_PI / (1.0 - cos_cutoff)


def square_to_cosine_hemisphere(sample):
    """Cosine-weighted hemisphere direction around +z (Malley's method)."""
    p = square_to_uniform_disk_concentric(sample)
    z = safe_sqrt(1.0 - (p * p).sum(-1))
    return torch.stack([p[..., 0], p[..., 1], z], -1)


def square_to_cosine_hemisphere_pdf(v):
    return INV_PI * v[..., 2].clamp(min=0.0)


def square_to_std_normal_pdf(p):
    """Pdf of a 2D standard normal at p (trailing axis 2)."""
    return INV_TWO_PI * torch.exp(-0.5 * (p * p).sum(-1))


INV_FOUR_PI = 1.0 / (4.0 * math.pi)


def square_to_uniform_sphere(sample):
    """Uniform direction on the unit sphere."""
    z = 1.0 - 2.0 * sample[..., 1]
    r = safe_sqrt(1.0 - z * z)
    phi = 2.0 * math.pi * sample[..., 0]
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], -1)
