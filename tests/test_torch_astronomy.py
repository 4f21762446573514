"""The port's solar astronomy and `sunsky_params` against the JAX package.

`tpusky_torch.models.sunsky.astronomy` evaluates the PSA algorithm in
float64 on the host; the reference forms the Julian date in float32
(`tpusky/models/sunsky/astronomy.py:54`), whose spacing near 2.45e6 is a
quarter day, and evaluates the ecliptic and sidereal-time arithmetic in
float32. So the two agree on the Julian date exactly where it is a whole
quarter day of UT (0, 6, 12 or 18 h), and elsewhere the reference's sun
is off by up to ~0.03 degrees (ROADMAP.md, Queue 3, R7).
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import astronomy as JA

import tpusky_torch as tt
from tpusky_torch.models.sunsky import astronomy as TA

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

_PLACES = {
    "tokyo": (35.6894, 139.6917, 9.0),
    "sydney": (-33.8688, 151.2093, 10.0),
    "new_york": (40.7128, -74.0060, -5.0),
    "buenos_aires": (-34.6037, -58.3816, -3.0),
    "reykjavik": (64.1466, -21.9426, 0.0),
}
# (place, year, month, day, hour, minute): both hemispheres, negative
# timezones, January and December, hours on the quarter-day steps of UT
# and between them
_CASES = [
    ("tokyo", 2010, 7, 10, 15.0, 0.0),      # the defaults: UT 6 h
    ("tokyo", 2010, 7, 10, 9.5, 0.0),
    ("tokyo", 2010, 7, 10, 12.25, 0.0),
    ("tokyo", 2010, 7, 10, 18.3, 0.0),
    ("tokyo", 2021, 1, 15, 9.0, 0.0),       # UT 0 h
    ("tokyo", 1999, 12, 21, 21.0, 0.0),     # UT 12 h
    ("sydney", 2010, 7, 10, 16.0, 0.0),     # UT 6 h
    ("sydney", 2021, 1, 15, 7.7, 0.0),
    ("sydney", 1999, 12, 21, 13.0, 30.0),
    ("new_york", 2010, 7, 10, 13.0, 0.0),   # UT 18 h
    ("new_york", 2021, 1, 15, 7.0, 0.0),    # UT 12 h
    ("new_york", 1999, 12, 21, 9.5, 15.0),
    ("new_york", 2021, 12, 31, 15.2, 0.0),
    ("buenos_aires", 2010, 7, 10, 9.0, 0.0),    # UT 12 h
    ("buenos_aires", 2021, 1, 15, 17.6, 0.0),
    ("buenos_aires", 1999, 12, 21, 15.0, 0.0),  # UT 18 h
    ("reykjavik", 2010, 7, 10, 12.0, 0.0),  # UT 12 h
    ("reykjavik", 2021, 1, 15, 12.5, 0.0),
    ("reykjavik", 2010, 7, 10, 23.9, 0.0),
    ("tokyo", 2024, 2, 29, 11.0, 45.0),
]


def _records(case, mod):
    place, year, month, day, hour, minute = case
    lat, lon, tz = _PLACES[place]
    return (mod.DateTimeRecord(year=year, month=month, day=day, hour=hour,
                               minute=minute),
            mod.LocationRecord(latitude=lat, longitude=lon, timezone=tz))


def _on_step(case):
    """Whether the case's UT is a whole quarter day (its Julian date is
    exact in float32)."""
    place, _, _, _, hour, minute = case
    ut = hour + minute / 60.0 - _PLACES[place][2]
    return abs(ut / 6.0 - round(ut / 6.0)) < 1e-12


def _angle_deg(a, b):
    a = np.asarray(a, np.float64) / np.linalg.norm(a)
    b = np.asarray(b, np.float64) / np.linalg.norm(b)
    return float(np.degrees(np.arccos(np.clip(a @ b, -1.0, 1.0))))


@pytest.mark.parametrize("case", _CASES, ids=lambda c: "-".join(map(str, c)))
def test_sun_direction_matches_reference(case):
    """On the quarter-day steps the Julian date and UT hours equal the
    reference's exactly and the direction agrees within 5e-5 a component
    (the reference's float32 ecliptic and sidereal arithmetic: angles of
    ~70 rad and ~4,000 degrees round by ~1e-5); between them the
    reference's date is rounded to the step and its sun moves, and the
    bar is 0.05 degrees."""
    dt_j, loc_j = _records(case, JA)
    dt_t, loc_t = _records(case, TA)
    d_ref = np.asarray(JA.sun_direction(dt_j, loc_j), np.float64)
    d = TA.sun_direction(dt_t, loc_t)
    assert d.dtype == torch.float32 and d.shape == (3,)
    assert abs(float(torch.linalg.norm(d.double())) - 1.0) < 1e-6
    d = d.numpy().astype(np.float64)
    if _on_step(case):
        elapsed, hours = TA.julian_days_since_j2000(dt_t, loc_t.timezone)
        e_ref, h_ref = JA.julian_days_since_j2000(dt_j, loc_j.timezone)
        assert elapsed == float(e_ref) and hours == float(h_ref)
        assert np.abs(d - d_ref).max() <= 5e-5
    else:
        assert _angle_deg(d, d_ref) <= 0.05


def test_julian_day_truncates_as_c():
    """The Fliegel & Van Flandern day number divides toward zero: the
    reference's day numbers at the turn of a year, in January and
    February (month - 14 < 0) and on a leap day, at noon UT."""
    for y, m, d in ((2000, 1, 1), (1999, 12, 31), (2024, 2, 29),
                    (2010, 7, 10), (1987, 1, 27), (1600, 3, 1)):
        dt = TA.DateTimeRecord(year=y, month=m, day=d, hour=12.0)
        e, _ = TA.julian_days_since_j2000(dt, 0.0)
        e_ref, _ = JA.julian_days_since_j2000(JA.DateTimeRecord(*dt), 0.0)
        assert e == float(e_ref)
    assert TA.julian_days_since_j2000(
        TA.DateTimeRecord(2000, 1, 1, 12.0), 0.0) == (0.0, 12.0)


def test_sunsky_params_binds_as_the_reference():
    """`sunsky_params` takes the reference's parameters in its order, the
    port's `device` in the place of JAX's `dtype`."""
    ref = list(inspect.signature(ts.sunsky_params).parameters.values())
    port = list(inspect.signature(tt.sunsky_params).parameters.values())
    assert len(port) == len(ref)
    for r, p in zip(ref[:-1], port[:-1]):
        assert (p.name, p.kind, p.default) == (r.name, r.kind, r.default)
    assert (ref[-1].name, port[-1].name) == ("dtype", "device")
    assert port[-1].default == "cuda"


def test_sunsky_params_state():
    """An explicit direction gives `make_params`'s parameters; a time gives
    the astronomy's direction, within the reference's at a quarter-day
    step; both inputs raise, as the reference's does."""
    kw = dict(turbidity=4.0, albedo=0.25, sky_scale=1.5, sun_scale=0.5,
              sun_aperture_deg=1.0)
    p = tt.sunsky_params(sun_direction_xyz=[0.3, 0.2, 0.93], device="cpu",
                         **kw)
    q = tt.make_params(sun_direction=[0.3, 0.2, 0.93], device="cpu", **kw)
    for a, b in zip(p, q):
        assert torch.equal(a, b)
    p = tt.sunsky_params(hour=9.0, day=11, device="cpu", **kw)
    sd = TA.sun_direction(TA.DateTimeRecord(day=11, hour=9.0),
                          TA.LocationRecord())
    assert torch.equal(p.sun_direction, sd / torch.sqrt((sd ** 2).sum()))
    ref = ts.sunsky_params(hour=9.0, day=11, **kw)
    assert np.abs(p.sun_direction.numpy()
                  - np.asarray(ref.sun_direction)).max() <= 5e-5
    for f in ("turbidity", "albedo", "sky_scale", "sun_scale",
              "sun_half_aperture"):
        assert np.allclose(getattr(p, f).numpy(),
                           np.asarray(getattr(ref, f)), rtol=1e-6), f
    # the defaults: Tokyo, 2010-07-10 15:00
    assert torch.equal(tt.sunsky_params(device="cpu").sun_direction,
                       tt.sunsky_params(hour=15.0, device="cpu")
                       .sun_direction)
    spec = tt.sunsky_params(hour=10.0, mode="spectral", device="cpu")
    assert spec.albedo.shape == (11,)
    with pytest.raises(ValueError, match="not both"):
        tt.sunsky_params(sun_direction_xyz=[0, 0, 1], hour=10.0,
                         device="cpu")
    with pytest.raises(ValueError, match="not both"):
        ts.sunsky_params(sun_direction_xyz=[0, 0, 1], hour=10.0)
    assert jax.default_backend() == "cpu"
