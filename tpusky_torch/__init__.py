"""tpusky_torch — the PyTorch/CUDA port of tpusky, a differentiable
renderer built around a Hosek-Wilkie sun+sky environment emitter.

The JAX package `tpusky` is the reference; each module here has its
counterpart at the same relative path. Plain tensor code runs on any
device; on a CUDA device the sunsky lookups (RGB and spectral) and the
direct-illumination frame run hand-written kernels (`ops/cuda`, sources
in `csrc`), built with nvcc at first use.

Quick start (sky-dome evaluation)::

    import tpusky_torch as tt
    params = tt.sunsky_params(turbidity=3.0, albedo=0.3, hour=15.0)
    # or an explicit direction: tt.make_params(turbidity=3.0, albedo=0.3,
    #                               sun_direction=[0.3, 0.2, 0.93])
    state = tt.sunsky_precompute(params)
    rgb = tt.sunsky_eval(state, directions)        # (..., 3) radiance

Spectral mode precomputes from the 11-channel tables and evaluates at
wavelengths in nm::

    params = tt.make_params(turbidity=3.0, albedo=0.3, mode="spectral",
                            device="cuda")
    state = tt.sunsky_precompute(params, mode="spectral")
    spec = tt.sunsky_eval(state, directions, mode="spectral",
                          wavelengths=wl)              # (..., W) radiance

Scenes load from Mitsuba-style dicts, Mitsuba XML or JSON files, their
tensors on the card unless the caller names another device::

    bundle = tt.load_file("scene.xml")             # or tt.load_dict(d)
    img = bundle.render(seed=0)                     # (H, W, 3) on the card
    tt.write_exr("out.exr", img.cpu().numpy(), ["R", "G", "B"])

and from the command line: `python -m tpusky_torch render scene.xml`.

See `tpusky_torch.render.integrator.render` for the scene renderer and
`tpusky_torch.render.polarized.render_stokes` for its Stokes-vector
(polarized) counterpart.
"""

from .models.sunsky import constants as sunsky_constants
from .models.sunsky import model as _sunsky_model
from .models.sunsky.astronomy import (DateTimeRecord, LocationRecord,
                                      sun_direction)
from .models.sunsky.model import (SunskyParams, SunskyState, make_params,
                                  pdf_direction, precompute,
                                  sample_direction, sample_wavelengths)
from .models.sunsky.tables import load_tables
from .utils.io import read_exr, write_exr

__version__ = "0.1.0"


def load_dict(d, mode="rgb", device="cuda"):
    """``mi.load_dict`` equivalent: `render.loader.load_dict`, imported on
    first use."""
    from .render.loader import load_dict as _ld
    return _ld(d, mode=mode, device=device)


def load_file(path, mode="rgb", parameters=None, device="cuda"):
    """``mi.load_file`` equivalent: `render.xml_loader.load_file`, imported
    on first use."""
    from .render.xml_loader import load_file as _lf
    return _lf(path, mode=mode, parameters=parameters, device=device)


def sunsky_params(turbidity=3.0, albedo=0.3, sun_direction_xyz=None,
                  hour=None, minute=0.0, second=0.0, year=2010, month=7,
                  day=10, latitude=35.6894, longitude=139.6917, timezone=9.0,
                  sky_scale=1.0, sun_scale=1.0,
                  sun_aperture_deg=sunsky_constants.SUN_APERTURE_DEG,
                  mode="rgb", device="cuda") -> SunskyParams:
    """Build sunsky parameters on `device` from either an explicit sun
    direction or a date/time + location (the reference plugin's property
    set, reference `sunsky.cpp:21-103`; defaults: Tokyo, 2010-07-10
    15:00). The solar position is computed on the host in float64."""
    if sun_direction_xyz is not None and hour is not None:
        raise ValueError("give either sun_direction_xyz or time/location, "
                         "not both")
    if sun_direction_xyz is None:
        dt = DateTimeRecord(year=year, month=month, day=day,
                            hour=15.0 if hour is None else hour,
                            minute=minute, second=second)
        loc = LocationRecord(latitude=latitude, longitude=longitude,
                             timezone=timezone)
        sun_direction_xyz = sun_direction(dt, loc)
    return make_params(turbidity=turbidity, albedo=albedo,
                       sun_direction=sun_direction_xyz, sky_scale=sky_scale,
                       sun_scale=sun_scale,
                       sun_aperture_deg=sun_aperture_deg, mode=mode,
                       device=device)


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
    "DateTimeRecord", "LocationRecord", "SunskyParams", "SunskyState",
    "load_dict", "load_file", "load_tables", "make_params", "pdf_direction",
    "precompute", "read_exr", "sample_direction", "sample_wavelengths",
    "sun_direction", "sunsky_constants", "sunsky_eval", "sunsky_params",
    "sunsky_precompute", "write_exr",
]
