"""Variant configuration: the one config object for {rgb, spectral, mono}
x {float32, float64} x {scalar, polarized} (`tpusky/config.py`), with
torch dtypes.

Mitsuba variant names parse as the reference's do::

    v = Variant.from_name("cuda_ad_spectral_polarized")
    v.mode        # "spectral"
    v.dtype       # torch.float32
    v.polarized   # True
    v.n_channels  # 11  (dataset channels; hero-wavelength transport uses 4)

`resolve` accepts every variant. The port renders in float32 and in RGB
or spectral mode only: `check_renders` refuses a float64 variant (ROADMAP
Queue 1 item 3) and a mono one with NotImplementedError, which a loaded
scene's `render` raises. The reference renders neither: it renders a
float64 variant in float32, and a mono scene fails at its sunsky
(ValueError: unknown color mode) or renders as RGB, three channels.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .models.sunsky import constants as C

_MODES = ("rgb", "spectral", "mono")


@dataclass(frozen=True)
class Variant:
    mode: str = "rgb"
    dtype: Any = torch.float32
    polarized: bool = False

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"mode must be one of {_MODES}, "
                             f"got {self.mode!r}")
        if self.dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        if self.polarized and self.mode == "mono":
            raise ValueError("polarized mono variants are not built "
                             "(match the reference's default matrix)")

    @property
    def n_channels(self) -> int:
        """Dataset channel count (3 RGB, 11 spectral, 1 mono)."""
        return {"rgb": 3, "spectral": C.N_WAVELENGTHS, "mono": 1}[self.mode]

    @property
    def n_hero(self) -> int:
        """Transported wavelengths per path in spectral mode
        (`Spectrum<Float, 4>` in Mitsuba)."""
        return 4 if self.mode == "spectral" else self.n_channels

    @property
    def name(self) -> str:
        """Mitsuba-style variant name (the CUDA backend)."""
        parts = ["cuda", "ad", self.mode]
        if self.polarized:
            parts.append("polarized")
        if self.dtype == torch.float64:
            parts.append("double")
        return "_".join(parts)

    @classmethod
    def from_name(cls, name: str) -> "Variant":
        """Parse a Mitsuba variant name (`mitsuba.conf` style). The backend
        prefix (scalar/llvm/cuda/tpu) and the `ad` tag are accepted and
        ignored."""
        parts = [p for p in name.split("_")
                 if p not in {"scalar", "llvm", "cuda", "tpu", "ad"}]
        mode = None
        polarized = False
        double = False
        for p in parts:
            if p in _MODES:
                mode = p
            elif p == "polarized":
                polarized = True
            elif p == "double":
                double = True
            else:
                raise ValueError(f"unknown variant component {p!r} "
                                 f"in {name!r}")
        if mode is None:
            raise ValueError(f"variant {name!r} names no color mode")
        return cls(mode=mode,
                   dtype=torch.float64 if double else torch.float32,
                   polarized=polarized)

    def check_renders(self) -> None:
        """Raise NotImplementedError for a variant the port cannot render:
        float64 or mono."""
        if self.dtype == torch.float64:
            raise NotImplementedError(
                f"variant {self.name}: the port renders in float32 only "
                "(float64 variants: ROADMAP Queue 1 item 3)")
        if self.mode == "mono":
            raise NotImplementedError(
                f"variant {self.name}: mono rendering is not ported "
                "(ROADMAP Queue 1 item 3; the reference renders no mono "
                "image either)")


def resolve(variant) -> Variant:
    """Coerce a mode string / variant name / Variant to a Variant."""
    if isinstance(variant, Variant):
        return variant
    if isinstance(variant, str):
        if variant in _MODES:
            return Variant(mode=variant)
        return Variant.from_name(variant)
    raise TypeError(f"cannot interpret {variant!r} as a Variant")
