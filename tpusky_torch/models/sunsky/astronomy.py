"""Solar position astronomy.

The PyTorch port's counterpart of `tpusky/models/sunsky/astronomy.py`:
the sun's direction in the local east-north-up frame from a date/time
and a geographic location, by the PSA algorithm of Blanco-Muriel et al.
2001 ("Computing the Solar Vector", Solar Energy 70(5)), the algorithm
of the reference plugin (`sunsky.h:283-374`), parallax correction
included.

The arithmetic is scalar and runs on the host in float64 (Python floats),
as the PSA algorithm is written: the Julian date near 2.45e6 needs more
than float32's 0.25-day spacing. Only the final direction is float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .constants import ASTRONOMICAL_UNIT, EARTH_MEAN_RADIUS

TWO_PI = 2.0 * math.pi


class DateTimeRecord(NamedTuple):
    year: int = 2010
    month: int = 7
    day: int = 10
    hour: float = 15.0
    minute: float = 0.0
    second: float = 0.0


class LocationRecord(NamedTuple):
    latitude: float = 35.6894    # Tokyo
    longitude: float = 139.6917
    timezone: float = 9.0


def _cdiv(a: int, b: int) -> int:
    """Integer division truncating toward zero, as in C (b > 0)."""
    q = abs(a) // b
    return -q if a < 0 else q


def julian_days_since_j2000(dt: DateTimeRecord, timezone):
    """(days elapsed since JD 2451545.0 (noon 2000-01-01 UT), decimal UT
    hours), both float64."""
    dec_hours = (float(dt.hour) - float(timezone)
                 + (float(dt.minute) + float(dt.second) / 60.0) / 60.0)
    # integer Julian-day-number arithmetic (Fliegel & Van Flandern form)
    year, month, day = int(dt.year), int(dt.month), int(dt.day)
    aux1 = _cdiv(month - 14, 12)
    aux2 = (_cdiv(1461 * (year + 4800 + aux1), 4)
            + _cdiv(367 * (month - 2 - 12 * aux1), 12)
            - _cdiv(3 * _cdiv(year + 4900 + aux1, 100), 4)
            + day - 32075)
    julian_date = aux2 - 0.5 + dec_hours / 24.0
    return julian_date - 2451545.0, dec_hours


def sun_elevation_azimuth(dt: DateTimeRecord, loc: LocationRecord):
    """(zenith, azimuth) of the sun in radians, float64.

    The zenith angle is measured from the vertical, parallax-corrected;
    the azimuth from north, eastwards (the PSA convention).
    """
    elapsed, dec_hours = julian_days_since_j2000(dt, loc.timezone)

    # ecliptic coordinates
    omega = 2.1429 - 0.0010394594 * elapsed
    mean_longitude = 4.8950630 + 0.017202791698 * elapsed
    anomaly = 6.2400600 + 0.0172019699 * elapsed
    ecliptic_longitude = (mean_longitude + 0.03341607 * math.sin(anomaly)
                          + 0.00034894 * math.sin(2 * anomaly) - 0.0001134
                          - 0.0000203 * math.sin(omega))
    ecliptic_obliquity = (0.4090928 - 6.2140e-9 * elapsed
                          + 0.0000396 * math.cos(omega))

    # celestial coordinates
    sin_el = math.sin(ecliptic_longitude)
    dy = math.cos(ecliptic_obliquity) * sin_el
    dx = math.cos(ecliptic_longitude)
    right_ascension = math.atan2(dy, dx)
    if right_ascension < 0:
        right_ascension += TWO_PI
    declination = math.asin(math.sin(ecliptic_obliquity) * sin_el)

    # local horizontal coordinates
    gmst = 6.6974243242 + 0.0657098283 * elapsed + dec_hours
    lmst = math.radians(gmst * 15.0 + float(loc.longitude))
    lat = math.radians(float(loc.latitude))
    hour_angle = lmst - right_ascension
    zenith = math.acos(math.cos(lat) * math.cos(hour_angle)
                       * math.cos(declination)
                       + math.sin(declination) * math.sin(lat))
    dy = -math.sin(hour_angle)
    dx = (math.tan(declination) * math.cos(lat)
          - math.sin(lat) * math.cos(hour_angle))
    azimuth = math.atan2(dy, dx)
    if azimuth < 0:
        azimuth += TWO_PI

    # parallax correction (an observer on the surface, not the geocentre);
    # the PSA paper corrects the zenith angle
    zenith += (EARTH_MEAN_RADIUS / ASTRONOMICAL_UNIT) * math.sin(zenith)
    return zenith, azimuth


def sun_direction(dt: DateTimeRecord, loc: LocationRecord) -> torch.Tensor:
    """Sun direction as a float32 unit vector (3,) on the host, in the
    local z-up frame of the reference's `sphdir(zenith, azimuth - pi)`
    (`sunsky.h:373`): x points south, y east, z up."""
    zenith, azimuth = sun_elevation_azimuth(dt, loc)
    phi = azimuth - math.pi
    st, ct = math.sin(zenith), math.cos(zenith)
    return torch.tensor([math.cos(phi) * st, math.sin(phi) * st, ct],
                        dtype=torch.float32)
