"""Colour and spectral pipeline (`tpusky/ops/spectrum.py`): CIE 1931
tables, luminance, XYZ and sRGB conversion, hero-wavelength sampling.

The CIE tables (360..830 nm in 5 nm steps) are read from the committed
``data/cie1931.npz`` by this module's own loader. A lookup indexes the
table rows of each lane directly: the reference package fetches them with
a one-hot matrix product, a TPU workaround for per-lane gathers, which
selects the same rows.
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

CIE_MIN = 360.0
CIE_MAX = 830.0
CIE_SAMPLES = 95
# Normalisation so that a unit-valued spectrum has luminance 1.
CIE_Y_NORMALIZATION = 1.0 / 106.7502593994140625
CIE_D65_NORMALIZATION = 1.0 / 98.99741751876255

_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                          "cie1931.npz")

# ITU-R Rec. BT.709 matrices
XYZ_TO_SRGB = ((3.240479, -1.537150, -0.498535),
               (-0.969256, 1.875991, 0.041556),
               (0.055648, -0.204043, 1.057311))
SRGB_TO_XYZ = ((0.412453, 0.357580, 0.180423),
               (0.212671, 0.715160, 0.072169),
               (0.019334, 0.119193, 0.950227))
LUMINANCE_WEIGHTS_RGB = (0.212671, 0.715160, 0.072169)


@lru_cache(maxsize=None)
def _cie_on(device: torch.device):
    """(95, 4) float32 columns x, y, z, d65 on a device (one copy each)."""
    with np.load(_DATA_PATH) as z:
        cols = np.stack([z["x"], z["y"], z["z"], z["d65"]], -1)
    return torch.tensor(cols.astype(np.float32), device=device)


def _cie_table(cols, like):
    return _cie_on(like.device)[:, cols]


def _cie_interp(table, wavelengths):
    """Lerp the (95, F) table's rows at the wavelengths -> (..., F); 0
    outside [360, 830] nm."""
    t = (wavelengths - CIE_MIN) * ((CIE_SAMPLES - 1) / (CIE_MAX - CIE_MIN))
    active = (wavelengths >= CIE_MIN) & (wavelengths <= CIE_MAX)
    # truncation toward zero, as the reference's astype(int32)
    i0 = t.to(torch.int64).clamp(0, CIE_SAMPLES - 2)
    w1 = (t - i0)[..., None]
    val = (1.0 - w1) * table[i0] + w1 * table[i0 + 1]
    return torch.where(active[..., None], val, 0.0)


def cie1931_xyz(wavelengths):
    """CIE XYZ colour-matching values at the wavelengths -> (..., 3)."""
    return _cie_interp(_cie_table(slice(0, 3), wavelengths), wavelengths)


def cie1931_y(wavelengths):
    return _cie_interp(_cie_table(slice(1, 2), wavelengths),
                       wavelengths)[..., 0]


def cie_d65(wavelengths):
    return (_cie_interp(_cie_table(slice(3, 4), wavelengths),
                        wavelengths)[..., 0] * CIE_D65_NORMALIZATION)


def _mat3(m, v):
    """Constant 3x3 matrix m (nested tuples) times (..., 3) vectors,
    written out so the summation order is fixed."""
    return torch.stack([v[..., 0] * r[0] + v[..., 1] * r[1] + v[..., 2] * r[2]
                        for r in m], -1)


def luminance_rgb(rgb):
    w = torch.tensor(LUMINANCE_WEIGHTS_RGB, dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb * w).sum(-1)


def luminance_spectral(values, wavelengths):
    """Mean over hero wavelengths of CIE-Y-weighted spectral values."""
    return (cie1931_y(wavelengths) * values).mean(-1)


def spectrum_to_xyz(values, wavelengths):
    """Monte-Carlo spectral samples (already divided by their pdf) -> XYZ."""
    xyz = cie1931_xyz(wavelengths)
    return (xyz * values[..., None]).mean(-2) * CIE_Y_NORMALIZATION


def xyz_to_srgb(xyz):
    return _mat3(XYZ_TO_SRGB, xyz)


def srgb_to_xyz(rgb):
    return _mat3(SRGB_TO_XYZ, rgb)


def spectrum_to_srgb(values, wavelengths):
    return xyz_to_srgb(spectrum_to_xyz(values, wavelengths))


def sample_shifted(sample, n: int = 4):
    """One uniform per lane -> n stratified ones, frac(u + k / n) (the
    reference's `sample_shifted`, `include/mitsuba/core/math.h`)."""
    shifts = torch.arange(n, device=sample.device) / n
    return torch.remainder(sample[..., None] + shifts, 1.0)


def sample_rgb_spectrum(sample):
    """Wavelengths importance-sampled where RGB sensors respond
    (Radziszewski, Boryczko & Alda; the reference's `spectrum.h:445-455`)
    -> (wavelength in nm, 1 / pdf)."""
    wavelengths = (538.0 - torch.atanh(0.8569106254698279
                                       - 1.8275019724092267 * sample)
                   * 138.88888888888889)
    tmp = torch.cosh(0.0072 * (wavelengths - 538.0))
    return wavelengths, 253.82 * tmp * tmp


def pdf_rgb_spectrum(wavelengths):
    """Pdf of `sample_rgb_spectrum` per wavelength."""
    tmp = 1.0 / torch.cosh(0.0072 * (wavelengths - 538.0))
    return torch.where((wavelengths >= CIE_MIN) & (wavelengths <= CIE_MAX),
                       0.003939804229326285 * tmp * tmp, 0.0)


def srgb_gamma(x):
    """Linear -> sRGB gamma encoding."""
    x = x.clamp(0.0, 1.0)
    return torch.where(x <= 0.0031308, 12.92 * x,
                       1.055 * torch.pow(x.clamp(min=1e-8), 1 / 2.4) - 0.055)
