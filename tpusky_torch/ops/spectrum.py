"""Colour helpers (the RGB luminance of `tpusky/ops/spectrum.py`)."""

from __future__ import annotations

import torch

LUMINANCE_WEIGHTS_RGB = (0.212671, 0.715160, 0.072169)


def luminance_rgb(rgb):
    w = torch.tensor(LUMINANCE_WEIGHTS_RGB, dtype=rgb.dtype,
                     device=rgb.device)
    return (rgb * w).sum(-1)
