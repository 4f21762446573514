"""Film: deterministic sample accumulation and development
(`tpusky/render/film.py`; reference `src/films/hdrfilm.cpp`,
`src/films/specfilm.cpp`, `src/rfilters/`).

Reconstruction filters: `box`, `gaussian`, `tent`, `mitchell`
(B = C = 1/3), `catmullrom` (B = 0, C = 1/2) and `lanczos` (3-lobe
sinc), evaluated separably per axis as the reference's ImageBlock does.
The gaussian is Mitsuba 3's (`src/rfilters/gaussian.cpp`: stddev 0.5,
radius 2, the value at the radius subtracted), so it splats into 4x4
pixels; the reference package stops it at radius 1 (R10).

A splat adds no atomics, so an image is bitwise the same on every run:
the lanes' tap weights toward the pixels at offsets -r..r of each lane's
own pixel are reduced per pixel (over its samples in order), and the
(2r+1)^2 planes so made are added into the image one shifted plane at a
time, the parts outside the film dropped. The lanes come in the
renderer's layout (lane i in pixel i // spp), so no sort is needed.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

FILTERS = ("box", "gaussian", "tent", "mitchell", "catmullrom", "lanczos")
_RADIUS = {"gaussian": 2, "tent": 1, "mitchell": 2, "catmullrom": 2,
           "lanczos": 3}
_GAUSS_STDDEV = 0.5


class Film(NamedTuple):
    height: int
    width: int
    n_channels: int
    rfilter: str = "box"       # one of FILTERS
    bands: tuple = None        # specfilm band edges (nm), len = channels+1
    # crop window (`hdrfilm.cpp:46,137`): rays are generated for crop
    # pixels only and RNG stays keyed on full-film pixel ids
    crop_offset: tuple = None  # (x0, y0) in full-film pixels
    crop_size: tuple = None    # (crop_width, crop_height)
    # specfilm sensor response functions (`specfilm.cpp`): a tuple of
    # (lambda_min, lambda_max, values-tuple) regular spectra, one a
    # channel; used instead of the band edges when set
    srfs: tuple = None


def crop_extent(film: Film):
    """(x0, y0, width, height) of the render window."""
    if film.crop_size is None:
        return 0, 0, film.width, film.height
    x0, y0 = film.crop_offset or (0, 0)
    cw, ch = film.crop_size
    return int(x0), int(y0), int(cw), int(ch)


def splat_ordered(film: Film, values, spp: int):
    """Box-filter accumulation for pixel-ordered lanes (lane i belongs to
    pixel i // spp) -> (H, W, C+1) [sum, weight]: a dense reduction."""
    h, w, c = film.height, film.width, film.n_channels
    accum = values.reshape(h * w, spp, c).sum(1)
    weight = torch.full((h * w, 1), float(spp), dtype=values.dtype,
                        device=values.device)
    return torch.cat([accum, weight], -1).reshape(h, w, c + 1)


def filter_weight(rfilter: str, r):
    """The filter's value at |offset| r (pixels) -> like r."""
    r = r.abs()
    if rfilter == "gaussian":
        alpha = -1.0 / (2.0 * _GAUSS_STDDEV * _GAUSS_STDDEV)
        bias = math.exp(alpha * _RADIUS["gaussian"] ** 2)
        return (torch.exp(alpha * r * r) - bias).clamp(min=0.0)
    if rfilter == "tent":
        return (1.0 - r).clamp(min=0.0)
    if rfilter in ("mitchell", "catmullrom"):
        b, cc = (1.0 / 3.0, 1.0 / 3.0) if rfilter == "mitchell" else (0.0,
                                                                       0.5)
        r2, r3 = r * r, r * r * r
        inner = ((12 - 9 * b - 6 * cc) * r3 + (-18 + 12 * b + 6 * cc) * r2
                 + (6 - 2 * b)) / 6.0
        outer = ((-b - 6 * cc) * r3 + (6 * b + 30 * cc) * r2
                 + (-12 * b - 48 * cc) * r + (8 * b + 24 * cc)) / 6.0
        return torch.where(r < 1.0, inner, torch.where(r < 2.0, outer, 0.0))
    if rfilter == "lanczos":
        x = math.pi * r.clamp(min=1e-6)
        val = (torch.sin(x) / x) * (torch.sin(x / 3.0) / (x / 3.0))
        return torch.where(r < 1e-6, 1.0, torch.where(r < 3.0, val, 0.0))
    raise ValueError(f"unknown rfilter {rfilter!r}")


def _axis_weights(rfilter, radius, x, own):
    """(N, 2r+1) weights of lanes at coordinate x toward the pixels at
    offsets -r..r of their own pixel `own` (float): the reference's 2r
    taps from floor(x - 0.5) - (r - 1), zero at the offset they skip."""
    first = torch.floor(x - 0.5) - (radius - 1) - own      # -r or 1 - r
    cols = []
    for k in range(2 * radius + 1):
        off = k - radius
        wk = filter_weight(rfilter, own + off + 0.5 - x)
        cols.append(torch.where((off >= first) & (off < first + 2 * radius),
                                wk, 0.0))
    return torch.stack(cols, -1)


def splat(film: Film, pixel_uv, values, spp: int):
    """Accumulate per-sample values into (H, W, C+1) [weighted sum,
    weight] with the film's filter.

    pixel_uv: (N, 2) continuous film coordinates in pixels, within
    [0, W] x [0, H]; values: (N, C). The lanes are in the renderer's
    layout, lane i in pixel i // spp (row-major); the reference's `splat`
    takes them in any order and has no `spp`.
    """
    h, w, c = film.height, film.width, film.n_channels
    values = torch.cat([values, torch.ones_like(values[..., :1])], -1)
    pixel = torch.arange(h * w, device=values.device).repeat_interleave(spp)
    if film.rfilter == "box":
        weights = None
    else:
        radius = _RADIUS.get(film.rfilter)
        if radius is None:
            raise ValueError(f"unknown rfilter {film.rfilter!r}")
        wx = _axis_weights(film.rfilter, radius, pixel_uv[..., 0],
                           (pixel % w).float())
        wy = _axis_weights(film.rfilter, radius, pixel_uv[..., 1],
                           torch.div(pixel, w, rounding_mode="floor").float())
        weights = (wx, wy)
    planes = _reduce_ordered(values, weights, h * w, spp)
    if weights is None:
        return planes.reshape(h, w, c + 1)
    return _add_planes(planes.reshape(h, w, *planes.shape[1:]), radius)


def _reduce_ordered(values, weights, n_pix, spp):
    """Sum of each pixel's spp consecutive lanes' planes -> (n_pix, ...):
    one y offset at a time, to bound the temporary."""
    if weights is None:
        return values.reshape(n_pix, spp, -1).sum(1)
    wx, wy = weights
    k = wx.shape[-1]
    vx = (wx[:, :, None] * values[:, None, :]).reshape(n_pix, spp, k, -1)
    return torch.stack([(wy[:, ky].reshape(n_pix, spp, 1, 1) * vx).sum(1)
                        for ky in range(k)], 1)


def _add_planes(planes, radius):
    """(H, W, K, K, C+1) planes of offsets (dy, dx) in -r..r -> the image
    (H, W, C+1): each plane shifted by its offset and added, in a fixed
    order; what falls outside the film is dropped."""
    h, w, k = planes.shape[0], planes.shape[1], planes.shape[2]
    canvas = planes.new_zeros((h + 2 * radius, w + 2 * radius,
                               planes.shape[-1]))
    for ky in range(k):
        for kx in range(k):
            canvas[ky:ky + h, kx:kx + w] += planes[:, :, ky, kx]
    return canvas[radius:radius + h, radius:radius + w]


@lru_cache(maxsize=None)
def _band_edges(bands: tuple, device: torch.device):
    return torch.tensor(np.asarray(bands, np.float32), device=device)


def band_edges(bands, device):
    """The band edges as a float32 tensor on a device (one copy each)."""
    return _band_edges(tuple(float(b) for b in bands), torch.device(device))


def spectral_band_accumulate(wavelengths, values_over_pdf, bands):
    """SpecFilm band accumulation (`specfilm.cpp`): each hero-wavelength
    sample lands in its band -> (..., n_bands), the mean over the hero
    samples of the in-band contributions. bands: the (n_bands + 1,) band
    edges in nm; values_over_pdf (..., W): spectral radiance samples
    already divided by their wavelength pdf."""
    edges = band_edges(bands, wavelengths.device)
    n_bands = edges.shape[0] - 1
    idx = (torch.searchsorted(edges, wavelengths.contiguous(), right=True)
           - 1).clamp(0, n_bands - 1)
    inside = (wavelengths >= edges[0]) & (wavelengths <= edges[-1])
    contrib = torch.where(inside, values_over_pdf, 0.0)
    onehot = idx[..., None] == torch.arange(n_bands, device=idx.device)
    return (contrib[..., None] * onehot).mean(-2)


def develop(accum):
    """Weighted division -> (H, W, C) image."""
    return accum[..., :-1] / accum[..., -1:].clamp(min=1e-12)
