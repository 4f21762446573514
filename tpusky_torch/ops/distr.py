"""Discrete sampling distribution (the part of `tpusky/ops/distr.py` the
sunsky TGMM sampler uses; reference `include/mitsuba/core/distr_1d.h`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


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
