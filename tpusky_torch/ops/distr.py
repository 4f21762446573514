"""Sampling distributions (`tpusky/ops/distr.py`; reference
`include/mitsuba/core/distr_1d.h`): the discrete one of the sunsky TGMM
sampler, the piecewise-linear continuous one of the spectral sunsky's
wavelength sampler, and the irregular one of tabulated spectra."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .math import safe_sqrt


class DiscreteDistribution(NamedTuple):
    pmf: torch.Tensor      # (n,) unnormalised weights
    cdf: torch.Tensor      # (n,) inclusive prefix sums
    total: torch.Tensor    # () sum of weights


def make_discrete(pmf) -> DiscreteDistribution:
    cdf = torch.cumsum(pmf, -1)
    return DiscreteDistribution(pmf, cdf, cdf[..., -1])


def discrete_sample_reuse(d: DiscreteDistribution, u):
    """Sample an index; return (index, uniform rescaled to [0, 1) within
    the chosen bin), like the reference's `sample_reuse` (`distr_1d.h:173`).
    """
    scaled = u * d.total
    n = d.pmf.shape[-1]
    idx = torch.searchsorted(d.cdf, scaled, right=True).clamp(0, n - 1)
    cdf_prev = torch.where(idx > 0, d.cdf[(idx - 1).clamp(min=0)], 0.0)
    pmf_i = d.pmf[idx].clamp(min=1e-37)
    reused = ((scaled - cdf_prev) / pmf_i).clamp(0.0, 1.0)
    return idx, reused


# ---------------------------------------------------------------------------
# Piecewise-linear continuous distribution on a uniform grid
# ---------------------------------------------------------------------------


class ContinuousDistribution(NamedTuple):
    pdf: torch.Tensor        # (n,) node values (unnormalised density)
    cdf: torch.Tensor        # (n-1,) trapezoid integral at nodes 1..n-1
    x_min: torch.Tensor      # ()
    interval: torch.Tensor   # () node spacing
    integral: torch.Tensor   # ()


def make_continuous(values, x_min: float,
                    x_max: float) -> ContinuousDistribution:
    n = values.shape[-1]
    interval = (x_max - x_min) / (n - 1)
    cdf = interval * torch.cumsum(0.5 * (values[..., 1:] + values[..., :-1]),
                                  -1)

    def scalar(v):
        return torch.tensor(v, dtype=values.dtype, device=values.device)
    return ContinuousDistribution(values, cdf, scalar(x_min),
                                  scalar(interval), cdf[..., -1])


def continuous_sample_pdf(d: ContinuousDistribution, u):
    """Warp u ~ U[0, 1) to the distribution -> (position, normalised pdf),
    inverting the piecewise-quadratic CDF per segment (`distr_1d.h:468`)."""
    scaled = u * d.integral
    idx = torch.searchsorted(d.cdf, scaled.contiguous()).clamp(
        0, d.pdf.shape[-1] - 2)
    c0 = torch.where(idx > 0, d.cdf[(idx - 1).clamp(min=0)], 0.0)
    y0 = d.pdf[idx]
    y1 = d.pdf[idx + 1]
    s = (scaled - c0) / d.interval
    dy = y1 - y0
    t_linear = (y0 - safe_sqrt(y0 * y0 + 2.0 * s * dy)) / torch.where(
        dy == 0, 1.0, -dy)
    t_const = s / y0.clamp(min=1e-37)
    t = torch.where(dy == 0, t_const, t_linear).clamp(0.0, 1.0)
    position = d.x_min + (idx + t) * d.interval
    return position, (y0 + t * dy) / d.integral


def continuous_pdf(d: ContinuousDistribution, x):
    """Normalised density at x (0 outside the support)."""
    n = d.pdf.shape[-1]
    rel = (x - d.x_min) / d.interval
    inside = (rel >= 0) & (rel <= n - 1)
    idx = torch.floor(rel).long().clamp(0, n - 2)
    t = rel - idx
    val = (1.0 - t) * d.pdf[idx] + t * d.pdf[idx + 1]
    return torch.where(inside, val / d.integral, 0.0)


# ---------------------------------------------------------------------------
# Piecewise-linear distribution on an irregular grid (spectra)
# ---------------------------------------------------------------------------


class IrregularContinuousDistribution(NamedTuple):
    nodes: torch.Tensor      # (n,)
    pdf: torch.Tensor        # (n,)
    cdf: torch.Tensor        # (n-1,)
    integral: torch.Tensor   # ()


def make_irregular(nodes, values) -> IrregularContinuousDistribution:
    seg = 0.5 * (values[..., 1:] + values[..., :-1]) * torch.diff(nodes)
    cdf = torch.cumsum(seg, -1)
    return IrregularContinuousDistribution(nodes, values, cdf, cdf[..., -1])


def irregular_eval(d: IrregularContinuousDistribution, x):
    """Piecewise-linear interpolation of the stored values at x (0
    outside the nodes)."""
    n = d.nodes.shape[-1]
    idx = (torch.searchsorted(d.nodes, x.contiguous(), right=True) - 1).clamp(
        0, n - 2)
    x0, x1 = d.nodes[idx], d.nodes[idx + 1]
    t = (x - x0) / (x1 - x0)
    inside = (x >= d.nodes[0]) & (x <= d.nodes[-1])
    return torch.where(inside, (1 - t) * d.pdf[idx] + t * d.pdf[idx + 1], 0.0)
