"""Boundary-sample guiding for the projective estimators
(`tpusky/ad/guiding.py`).

Every discontinuity-curve family of `ad/projective.py` is parameterised by
one scalar t in [0, t_len), so the guiding domain is 1D: a seed pass
scores |jump| * |tau| at stratified t, the scores are binned into a
histogram (`build_curve_guide`), and the main pass draws t from it mixed
with a uniform floor, so that no bin has zero density, dividing each
sample by the guided density (`sample_curve_guide`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CurveGuide(NamedTuple):
    """Histogram density over a curve parameter t in [0, t_len)."""
    pdf_bins: torch.Tensor   # (bins,) density per unit t (integrates to 1)
    cdf: torch.Tensor        # (bins,) inclusive bin CDF
    t_len: torch.Tensor      # ()


def build_curve_guide(scores, t_samples, t_len, n_bins: int = 64,
                      uniform_mix: float = 0.1) -> CurveGuide:
    """Bin the nonnegative scores (K,) of seed samples at t_samples (K,) in
    [0, t_len) into a guide density; `uniform_mix` of the mass is spread
    uniformly (the reference's defensive mixture)."""
    dev = scores.device
    t_len = torch.as_tensor(t_len, dtype=torch.float32, device=dev)
    scores = scores.to(torch.float32).clamp(min=0.0)
    scores = torch.where(torch.isfinite(scores), scores, 0.0)
    bins = (t_samples / t_len * n_bins).to(torch.int32).clamp(0, n_bins - 1)
    hist = torch.zeros(n_bins, device=dev).index_add_(0, bins.long(), scores)
    total = hist.sum()
    # a seed pass that found no discontinuity: uniform
    hist = torch.where(total > 0, hist / total.clamp(min=1e-30),
                       torch.full((n_bins,), 1.0 / n_bins, device=dev))
    mass = (1.0 - uniform_mix) * hist + uniform_mix / n_bins   # sums to 1
    width = t_len / n_bins
    return CurveGuide(mass / width, torch.cumsum(mass, 0), t_len)


def sample_curve_guide(guide: CurveGuide, u):
    """Inverse-CDF sample of the guide: uniforms u (K,) -> (t (K,), pdf
    (K,)); one uniform picks the bin and places t in it."""
    n_bins = guide.cdf.shape[0]
    b = torch.searchsorted(guide.cdf, u, right=True).clamp(0, n_bins - 1)
    lo = torch.where(b > 0, guide.cdf[(b - 1).clamp(min=0)], 0.0)
    mass_b = (guide.cdf[b] - lo).clamp(min=1e-12)
    frac = ((u - lo) / mass_b).clamp(0.0, 1.0)
    width = guide.t_len / n_bins
    return (b.to(torch.float32) + frac) * width, guide.pdf_bins[b]
