"""Sunsky model dataset tables (RGB).

Loads the Hosek-Wilkie sky/sun coefficient tables and the TGMM sampling
tables from the committed ``data/sunsky/datasets.npz`` bundle as float32
tensors on a given device. Axis layouts, as in the reference package's
`tpusky/models/sunsky/tables.py`:

  sky_params: (turbidity=10, albedo=2, ctrl_pt=6, channel=3, param=9)
  sky_rad:    (10, 2, 6, 3)
  sun_rad:    (10, segment=45, 3, ctrl_pt=4, ld=6)
  tgmm:       (turbidity=9, eta=30, gaussian=5, param=5)
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


@lru_cache(maxsize=None)
def _load_numpy():
    with np.load(_DATA_PATH) as z:
        # float64 -> float32 on the host, exactly as jnp.asarray(a, f32)
        return tuple(np.asarray(z[k], np.float32) for k in
                     ("sky_params_rgb", "sky_rad_rgb", "sun_rad_rgb",
                      "tgmm"))


def load_tables(mode: str = "rgb", device="cuda") -> SunskyTables:
    """Load the RGB tables as float32 tensors on `device`."""
    if mode != "rgb":
        raise NotImplementedError(f"sunsky tables for mode {mode!r}")
    sky_p, sky_r, sun_r, tgmm = (torch.tensor(a, device=device)
                                 for a in _load_numpy())
    return SunskyTables(sky_p, sky_r, sun_r, None, tgmm)


def n_channels(mode: str) -> int:
    return 3 if mode == "rgb" else 11
