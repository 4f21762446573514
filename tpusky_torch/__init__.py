"""tpusky_torch — the PyTorch/CUDA port of tpusky, a differentiable
renderer built around a Hosek-Wilkie sun+sky environment emitter.

The JAX package `tpusky` is the reference; each module here has its
counterpart at the same relative path. Plain tensor code runs on any
device; on a CUDA device the sunsky lookups (RGB and spectral) and the
direct-illumination frame run hand-written kernels (`ops/cuda`, sources
in `csrc`), built with nvcc at first use.

Quick start (sky-dome evaluation)::

    import tpusky_torch as tt
    params = tt.make_params(turbidity=3.0, albedo=0.3,
                            sun_direction=[0.3, 0.2, 0.93], device="cuda")
    state = tt.sunsky_precompute(params)
    rgb = tt.sunsky_eval(state, directions)        # (..., 3) radiance

Spectral mode precomputes from the 11-channel tables and evaluates at
wavelengths in nm::

    params = tt.make_params(turbidity=3.0, albedo=0.3, mode="spectral",
                            device="cuda")
    state = tt.sunsky_precompute(params, mode="spectral")
    spec = tt.sunsky_eval(state, directions, mode="spectral",
                          wavelengths=wl)              # (..., W) radiance

See `tpusky_torch.render.integrator.render` for the scene renderer.
"""

from .models.sunsky import constants as sunsky_constants
from .models.sunsky import model as _sunsky_model
from .models.sunsky.model import (SunskyParams, SunskyState, make_params,
                                  pdf_direction, precompute,
                                  sample_direction, sample_wavelengths)
from .models.sunsky.tables import load_tables

__version__ = "0.1.0"


def sunsky_precompute(params: SunskyParams, mode: str = None) -> SunskyState:
    """Derive the evaluation state (tables interpolated at the parameters)
    on the parameters' device. `mode` defaults to the mode the params were
    built for (an 11-channel albedo means spectral), as in the reference
    package."""
    if mode is None:
        mode = ("spectral"
                if params.albedo.shape[-1] == sunsky_constants.N_WAVELENGTHS
                else "rgb")
    tables = load_tables(mode, device=params.turbidity.device)
    return precompute(tables, params, mode)


def sunsky_eval(state: SunskyState, directions, wavelengths=None,
                mode: str = "rgb"):
    """Radiance toward `directions` (unit vectors, +z up, pointing at the
    sky) -> (..., 3), kernel K1 on a CUDA device; in spectral mode
    (..., W) at `wavelengths` (..., W) in nm, kernel K9."""
    return _sunsky_model.eval(state, directions, wavelengths=wavelengths,
                              mode=mode)


__all__ = [
    "SunskyParams", "SunskyState", "load_tables", "make_params",
    "pdf_direction", "precompute", "sample_direction", "sample_wavelengths",
    "sunsky_constants", "sunsky_eval", "sunsky_precompute",
]
