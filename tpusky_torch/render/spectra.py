"""Sensor response functions (SRFs) for the spectral film
(`tpusky/render/spectra.py`; reference `src/films/specfilm.cpp`).

Each SRF is one output channel. The film samples wavelengths from the
combined (summed) SRF (`compute_srf_sampling`, specfilm.cpp:201-241) and
weights every hero-wavelength sample by each channel's SRF over that
density (`prepare_sample`, :290-313):

    channel_j = E[ srf_j(lambda) * L(lambda) / p(lambda) ],
    p(lambda) proportional to sum_k srf_k(lambda)

An SRF is a static (hashable) regular spectrum `(lambda_min,
lambda_max, values_tuple)`, so it lives in the Film NamedTuple; its
table and the combined distribution are copied to a device once.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.distr import (ContinuousDistribution, continuous_sample_pdf,
                         make_continuous)
from ..ops.spectrum import sample_shifted


def parse_srf(desc):
    """Spectrum description -> static SRF tuple (lmin, lmax, values).

    Accepts the reference's `regular` and `irregular` spectrum dicts
    (`src/spectra/{regular,irregular}.cpp`) and a plain list of values
    over [360, 830] nm.
    """
    if isinstance(desc, (list, tuple)):
        return (360.0, 830.0, tuple(float(v) for v in desc))
    if not isinstance(desc, dict):
        raise ValueError(f"cannot parse SRF {desc!r}")

    def floats(v):
        if isinstance(v, str):
            v = v.replace(",", " ").split()
        return [float(x) for x in v]
    t = desc.get("type")
    if t == "regular":
        lo = float(desc.get("lambda_min", desc.get("wavelength_min", 360.0)))
        hi = float(desc.get("lambda_max", desc.get("wavelength_max", 830.0)))
        return (lo, hi, tuple(floats(desc["values"])))
    if t == "irregular":
        w = np.asarray(floats(desc["wavelengths"]), np.float64)
        v = np.asarray(floats(desc["values"]), np.float64)
        # resampled to a regular grid at the native resolution
        grid = np.linspace(w[0], w[-1], max(len(w), 2))
        return (float(w[0]), float(w[-1]),
                tuple(np.interp(grid, w, v).tolist()))
    raise ValueError(f"cannot parse SRF {desc!r}")


@lru_cache(maxsize=None)
def _values(srf: tuple, device: torch.device):
    return torch.tensor(np.asarray(srf[2], np.float32), device=device)


def srf_eval(srf, wavelengths):
    """A static SRF tuple at (...,) wavelengths (nm); zero outside its
    support (regular.cpp)."""
    lo, hi, vals = srf
    v = _values(srf, wavelengths.device)
    n = len(vals)
    x = (wavelengths - lo) / (hi - lo) * (n - 1)
    idx = torch.floor(x).to(torch.int64).clamp(0, n - 2)
    f = (x - idx).clamp(0.0, 1.0)
    val = v[idx] * (1.0 - f) + v[idx + 1] * f
    inside = (wavelengths >= lo) & (wavelengths <= hi)
    return torch.where(inside, val, 0.0)


def srf_range(srfs):
    """(lambda_min, lambda_max) of the union support."""
    return (min(s[0] for s in srfs), max(s[1] for s in srfs))


@lru_cache(maxsize=None)
def _combined(srfs: tuple, n_points: int,
              device: torch.device) -> ContinuousDistribution:
    lo, hi = srf_range(srfs)
    grid = torch.tensor(np.linspace(lo, hi, n_points, dtype=np.float32),
                        device=device)
    total = sum(srf_eval(s, grid) for s in srfs)
    # kept positive so the cdf stays invertible
    return make_continuous(total.clamp(min=1e-9), lo, hi)


def srf_combined_distribution(srfs, n_points: int = 256,
                              device="cuda") -> ContinuousDistribution:
    """ContinuousDistribution over the summed SRF (the film's wavelength
    importance distribution, `compute_srf_sampling`), on `device`."""
    return _combined(tuple(srfs), n_points, torch.device(device))


def srf_sample_wavelengths(srfs, u, n_hero: int = 4):
    """Hero wavelengths from the combined SRF for uniforms u (...,) ->
    (wavelengths, pdf), each (..., n_hero)."""
    return continuous_sample_pdf(
        srf_combined_distribution(srfs, device=u.device),
        sample_shifted(u, n_hero))


def srf_accumulate(srfs, wavelengths, values_over_pdf):
    """Per-channel SRF weighting (`prepare_sample`): values_over_pdf
    (..., W) spectral samples already divided by the sampling pdf ->
    (..., n_channels) channel means."""
    return torch.stack([(srf_eval(s, wavelengths) * values_over_pdf).mean(-1)
                        for s in srfs], -1)
