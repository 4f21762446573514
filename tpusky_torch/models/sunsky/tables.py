"""Sunsky model dataset tables (RGB and spectral).

Loads the Hosek-Wilkie sky/sun coefficient tables and the TGMM sampling
tables from the committed ``data/sunsky/datasets.npz`` bundle as float32
tensors on a given device. Axis layouts, as in the reference package's
`tpusky/models/sunsky/tables.py`:

  sky_params: (turbidity=10, albedo=2, ctrl_pt=6, channel, param=9)
  sky_rad:    (10, 2, 6, channel)
  sun_rad:    RGB (10, segment=45, 3, ctrl_pt=4, ld=6);
              spectral (10, 45, wavelength=11, ctrl_pt=4)
  sun_ld:     (wavelength=11, ld=6), spectral only
  tgmm:       (turbidity=9, eta=30, gaussian=5, param=5)

with channel 3 (RGB) or 11 (spectral, 320..720 nm in steps of 40).
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "data", "sunsky", "datasets.npz")


class SunskyTables(NamedTuple):
    sky_params: torch.Tensor
    sky_rad: torch.Tensor
    sun_rad: torch.Tensor
    sun_ld: Optional[torch.Tensor]   # None in RGB mode (baked into sun_rad)
    tgmm: torch.Tensor


_KEYS = {"rgb": ("sky_params_rgb", "sky_rad_rgb", "sun_rad_rgb", None),
         "spectral": ("sky_params_spec", "sky_rad_spec", "sun_rad_spec",
                      "sun_ld_spec")}


@lru_cache(maxsize=None)
def _load_numpy(mode: str):
    with np.load(_DATA_PATH) as z:
        # float64 -> float32 on the host, exactly as jnp.asarray(a, f32)
        return tuple(None if k is None else np.asarray(z[k], np.float32)
                     for k in _KEYS[mode] + ("tgmm",))


def load_tables(mode: str = "rgb", device="cuda") -> SunskyTables:
    """Load the tables of a colour mode ("rgb" or "spectral") as float32
    tensors on `device`."""
    if mode not in _KEYS:
        raise ValueError(f"unknown color mode {mode!r}")
    return SunskyTables(*(None if a is None else torch.tensor(a, device=device)
                          for a in _load_numpy(mode)))


def n_channels(mode: str) -> int:
    return 3 if mode == "rgb" else 11
