"""Chi-square goodness-of-fit harness for sampling routines.

The PyTorch port's counterpart of `tpusky/utils/chi2.py::chi2_test`
(reference `mi.chi2`, `src/python/python/chi2.py`): it checks that a
`sample` routine and its claimed `pdf` agree, by histogramming N samples
over a spherical domain and comparing the counts with the pdf integrated
over each cell (Pearson chi-square with pooling of cells whose
expectation is below 5).

Domain parameterisation: (phi in [-pi, pi], cos_theta in [cos_lo,
cos_hi]); the area element in these coordinates is constant, so the
integrand is the solid-angle pdf alone.

The samples are binned on their own device (`torch.bincount`) and only
the counts come back to the host; the pdf is integrated on the same
device. The p-value is the regularised upper incomplete gamma function
(`torch.special.gammaincc`), the chi-square survival function.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def spherical_to_point(d):
    """direction (..., 3) -> (phi, cos_theta) (..., 2)."""
    return torch.stack([torch.atan2(d[..., 1], d[..., 0]), d[..., 2]], -1)


def _cell_index(d, res_phi, res_cos, cos_lo, cos_hi):
    """Flat cell index of each direction; res_phi * res_cos for one
    outside the cos range (the overflow bin)."""
    phi = torch.atan2(d[:, 1], d[:, 0])
    ct = d[:, 2]
    ix = (((phi + math.pi) / (2 * math.pi) * res_phi).to(torch.int64)
          .clamp(0, res_phi - 1))
    iy = (((ct - cos_lo) / (cos_hi - cos_lo) * res_cos).to(torch.int64)
          .clamp(0, res_cos - 1))
    inside = (ct >= cos_lo) & (ct <= cos_hi)
    return torch.where(inside, iy * res_phi + ix, res_cos * res_phi)


def _expected(pdf_fn, device, res_phi, res_cos, cos_lo, cos_hi, ires):
    """pdf integrated over each cell, (res_cos, res_phi) float64: the
    midpoint rule at `ires` x `ires` points a cell (the midpoints keep
    the solid-angle pdf's 1/sin(theta) spike at the cropped pole off the
    domain's boundary), in chunks of cell rows of <= 4M directions."""
    n_sub_p = res_phi * ires
    dphi = 2 * math.pi / n_sub_p
    dcos = (cos_hi - cos_lo) / (res_cos * ires)
    phi = -math.pi + (torch.arange(n_sub_p, dtype=torch.float64,
                                   device=device) + 0.5) * dphi
    cp, sp = torch.cos(phi), torch.sin(phi)
    rows = max(1, (1 << 22) // (ires * n_sub_p))
    out = []
    for r0 in range(0, res_cos, rows):
        r1 = min(r0 + rows, res_cos)
        sub = torch.arange(r0 * ires, r1 * ires, dtype=torch.float64,
                           device=device)
        cg = (cos_lo + (sub + 0.5) * dcos)[:, None]
        st = torch.sqrt((1.0 - cg * cg).clamp(min=0.0))
        dirs = torch.stack([cp[None, :] * st, sp[None, :] * st,
                            cg.expand(-1, n_sub_p)], -1)
        pv = pdf_fn(dirs.reshape(-1, 3).to(torch.float32).contiguous())
        out.append(pv.to(torch.float64).reshape(r1 - r0, ires, res_phi,
                                                ires).sum((1, 3)))
    return torch.cat(out, 0).cpu().numpy() * (dphi * dcos)


def _pooled(obs, exp):
    """Cells sorted by expectation and merged until each pool expects at
    least 5; a remainder joins the last pool."""
    order = np.argsort(exp)
    obs, exp = obs[order], exp[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs, exp):
        acc_o += o
        acc_e += e
        if acc_e >= 5.0:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0:
        if pooled_exp:
            pooled_obs[-1] += acc_o
            pooled_exp[-1] += acc_e
        else:
            pooled_obs, pooled_exp = [acc_o], [acc_e]
    return np.asarray(pooled_obs), np.asarray(pooled_exp)


def chi2_sf(stat: float, dof: int) -> float:
    """Chi-square survival function: P(X >= stat) for dof degrees of
    freedom."""
    return float(torch.special.gammaincc(
        torch.tensor(dof / 2.0, dtype=torch.float64),
        torch.tensor(stat / 2.0, dtype=torch.float64)))


def chi2_test(sample_fn, pdf_fn, *, seed=0, sample_count=4_000_000,
              res_phi=128, res_cos=64, cos_range=(-1.0, 1.0), ires=8,
              batch=1_000_000, significance=0.01):
    """Run the chi-square test -> (p_value, passed, info dict).

    sample_fn(batch_seed, n) -> directions (n, 3) on any device, drawn
    from uniforms seeded by the integer `batch_seed` (`seed * 65536 + i`
    for batch i); pdf_fn(directions (m, 3) float32) -> (m,) solid-angle
    pdf on the samples' device. The histogram, the integration and the
    pooling are those of the reference's `chi2.py:100-239`.
    """
    cos_lo, cos_hi = cos_range
    n_cells = res_cos * res_phi
    counts = None
    n_done = bi = 0
    while n_done < sample_count:
        n = min(batch, sample_count - n_done)
        d = sample_fn(seed * 65536 + bi, n)
        flat = _cell_index(d, res_phi, res_cos, cos_lo, cos_hi)
        c = torch.bincount(flat, minlength=n_cells + 1)
        counts = c if counts is None else counts + c
        n_done += n
        bi += 1
    device = counts.device
    hist = counts.cpu().numpy()[:n_cells].reshape(res_cos, res_phi)
    n_outside = sample_count - int(hist.sum())

    expected = _expected(pdf_fn, device, res_phi, res_cos, cos_lo, cos_hi,
                         ires) * sample_count
    pooled_obs, pooled_exp = _pooled(hist.ravel().astype(np.float64),
                                     expected.ravel())
    stat = float(np.sum((pooled_obs - pooled_exp) ** 2 / pooled_exp))
    dof = len(pooled_exp) - 1
    p_value = chi2_sf(stat, dof)
    info = dict(stat=stat, dof=dof, cells=len(pooled_exp),
                integral=float(pooled_exp.sum()) / sample_count,
                miss_frac=n_outside / sample_count)
    return p_value, p_value >= significance, info
