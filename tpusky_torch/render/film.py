"""Film: box-filter accumulation and development (the box path of
`tpusky/render/film.py`; reference `src/films/hdrfilm.cpp`)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Film(NamedTuple):
    height: int
    width: int
    n_channels: int
    rfilter: str = "box"       # only the box filter is ported
    # crop window (`hdrfilm.cpp:46,137`): rays are generated for crop
    # pixels only and RNG stays keyed on full-film pixel ids
    crop_offset: tuple = None  # (x0, y0) in full-film pixels
    crop_size: tuple = None    # (crop_width, crop_height)


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


def develop(accum):
    """Weighted division -> (H, W, C) image."""
    return accum[..., :-1] / accum[..., -1:].clamp(min=1e-12)
