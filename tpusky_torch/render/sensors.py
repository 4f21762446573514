"""Sensors: ray generation from film-plane samples
(`tpusky/render/sensors.py`).

Perspective (`src/sensors/perspective.cpp`), the fork's equal-area
spherical sensor (`sunsky-testing/rendering/spherical_sensor.py:6-31`),
thin lens (`thinlens.cpp`), orthographic, distant (`distant.cpp`),
radiance meter (`radiancemeter.cpp`), irradiance meter
(`irradiancemeter.cpp`) and batch (`batch.cpp`). A sensor is a
NamedTuple of tensors, and `sample_ray(sensor, uv, lens_uv)` maps film
coordinates in [0, 1]^2 (and, for the thin lens and the irradiance
meter, aperture samples) to world rays. The host constructors build
their frames in float32 numpy, as the reference's do.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import mat3_apply, norm, normalize
from ..ops.warp import (square_to_cosine_hemisphere,
                        square_to_uniform_disk_concentric)


def _f32(v, device):
    return torch.as_tensor(np.asarray(v, np.float32), dtype=torch.float32,
                           device=device)


class Perspective(NamedTuple):
    to_world: torch.Tensor     # (4, 4) camera-to-world
    fov_x_deg: torch.Tensor    # () horizontal field of view
    aspect: torch.Tensor       # () width / height
    near: torch.Tensor         # ()


def make_perspective(origin, target, up=(0, 0, 1), fov_x_deg=45.0,
                     aspect=1.0, device="cuda") -> Perspective:
    """Look-at constructor (Mitsuba's convention: the camera looks down +z
    in camera space, x right, y up-ish)."""
    origin = np.asarray(origin, np.float32)
    fwd = np.asarray(target, np.float32) - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float32), fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, fwd, origin
    return Perspective(_f32(m, device), _f32(fov_x_deg, device),
                       _f32(aspect, device), _f32(1e-2, device))


def _film_plane(sensor, uv):
    """Camera-space x, y of film coordinates on the plane z = 1."""
    tan_half = torch.tan(0.5 * torch.deg2rad(sensor.fov_x_deg))
    x = (2.0 * uv[..., 0] - 1.0) * tan_half
    y = (1.0 - 2.0 * uv[..., 1]) * tan_half / sensor.aspect
    return x, y


def perspective_ray(sensor: Perspective, uv):
    """uv (..., 2) in [0,1]^2 -> (origin (..., 3), direction (..., 3))."""
    x, y = _film_plane(sensor, uv)
    d_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    d = normalize(mat3_apply(sensor.to_world[:3, :3], d_cam))
    o = sensor.to_world[:3, 3].expand(d.shape)
    return o, d


class Spherical(NamedTuple):
    """Full-sphere lat-long sensor at a point (validation renders)."""
    origin: torch.Tensor       # (3,)


def make_spherical(origin=(0.0, 0.0, 0.0), device="cuda") -> Spherical:
    return Spherical(_f32(origin, device))


def spherical_ray(sensor: Spherical, uv):
    """Equirectangular: u -> phi in [0, 2pi), v -> theta in [0, pi]; row
    v = 0 is the zenith (+z)."""
    phi = 2.0 * math.pi * uv[..., 0]
    theta = math.pi * uv[..., 1]
    st, ct = torch.sin(theta), torch.cos(theta)
    d = torch.stack([torch.cos(phi) * st, torch.sin(phi) * st, ct], -1)
    return sensor.origin.expand(d.shape), d


class ThinLens(NamedTuple):
    """Perspective camera with a finite aperture (depth of field)."""
    to_world: torch.Tensor
    fov_x_deg: torch.Tensor
    aspect: torch.Tensor
    aperture_radius: torch.Tensor
    focus_distance: torch.Tensor


def thinlens_ray(sensor: ThinLens, uv, lens_uv):
    """uv: film coordinates; lens_uv: aperture samples (..., 2)."""
    x, y = _film_plane(sensor, uv)
    # the point on the focal plane (camera space, +z forward)
    focus = torch.stack([x, y, torch.ones_like(x)], -1) * \
        sensor.focus_distance
    lens = square_to_uniform_disk_concentric(lens_uv) * \
        sensor.aperture_radius
    o_cam = torch.stack([lens[..., 0], lens[..., 1],
                         torch.zeros_like(lens[..., 0])], -1)
    rot = sensor.to_world[:3, :3]
    d = normalize(mat3_apply(rot, focus - o_cam))
    return mat3_apply(rot, o_cam) + sensor.to_world[:3, 3], d


class Orthographic(NamedTuple):
    to_world: torch.Tensor     # (4, 4)
    scale: torch.Tensor        # () half-extent of the film in world units


def orthographic_ray(sensor: Orthographic, uv):
    x = (2.0 * uv[..., 0] - 1.0) * sensor.scale
    y = (1.0 - 2.0 * uv[..., 1]) * sensor.scale
    o_cam = torch.stack([x, y, torch.zeros_like(x)], -1)
    o = mat3_apply(sensor.to_world[:3, :3], o_cam) + sensor.to_world[:3, 3]
    return o, sensor.to_world[:3, 2].expand(o.shape)


class Distant(NamedTuple):
    """Parallel rays from outside the scene along a fixed direction: film
    coordinates map to a square of half-extent `extent` perpendicular to
    the direction, pushed back beyond the scene's bounding sphere."""
    direction: torch.Tensor    # (3,) unit, pointing into the scene
    frame_x: torch.Tensor      # (3,) film-plane basis
    frame_y: torch.Tensor      # (3,)
    center: torch.Tensor       # (3,) bounding-sphere centre
    radius: torch.Tensor       # () its radius (ray origins 2r back)
    extent: torch.Tensor       # () half-extent of the film square


def _frame_about(n):
    """Unit n and the (x, y) frame the reference builds about it."""
    n = n / np.linalg.norm(n)
    up = (np.array([0.0, 0.0, 1.0], np.float32)
          if abs(n[2]) < 0.999 else np.array([1.0, 0.0, 0.0], np.float32))
    fx = np.cross(up, n)
    fx = fx / np.linalg.norm(fx)
    return n, fx, np.cross(n, fx)


def make_distant(direction, center=(0.0, 0.0, 0.0), radius=1.0,
                 extent=None, device="cuda") -> Distant:
    d, fx, fy = _frame_about(np.asarray(direction, np.float32))
    if extent is None:
        extent = float(radius)
    return Distant(*(_f32(v, device)
                     for v in (d, fx, fy, center, radius, extent)))


def distant_ray(sensor: Distant, uv):
    x = (2.0 * uv[..., 0] - 1.0) * sensor.extent
    y = (1.0 - 2.0 * uv[..., 1]) * sensor.extent
    base = sensor.center - 2.0 * sensor.radius * sensor.direction
    o = base + x[..., None] * sensor.frame_x + y[..., None] * sensor.frame_y
    return o, sensor.direction.expand(o.shape)


class RadianceMeter(NamedTuple):
    """Single-ray radiance probe: every film sample traces the same ray."""
    origin: torch.Tensor       # (3,)
    direction: torch.Tensor    # (3,) unit


def radiancemeter_ray(sensor: RadianceMeter, uv):
    shape = uv.shape[:-1] + (3,)
    return sensor.origin.expand(shape), sensor.direction.expand(shape)


class IrradianceMeter(NamedTuple):
    """Surface irradiance probe: film u, v pick a point on a rectangle
    patch, the lens sample a cosine-weighted direction about its normal
    (the pi of the estimate is the caller's)."""
    origin: torch.Tensor       # (3,) patch centre
    frame_x: torch.Tensor      # (3,) patch basis (half-extent included)
    frame_y: torch.Tensor      # (3,)
    normal: torch.Tensor       # (3,) unit


def make_irradiancemeter(origin, normal, half_extent=1.0,
                         device="cuda") -> IrradianceMeter:
    n, fx, fy = _frame_about(np.asarray(normal, np.float32))
    return IrradianceMeter(*(_f32(v, device) for v in (
        origin, fx * half_extent, fy * half_extent, n)))


def irradiancemeter_ray(sensor: IrradianceMeter, uv, lens_uv):
    x = 2.0 * uv[..., 0] - 1.0
    y = 2.0 * uv[..., 1] - 1.0
    o = (sensor.origin + x[..., None] * sensor.frame_x
         + y[..., None] * sensor.frame_y)
    d_local = square_to_cosine_hemisphere(lens_uv)
    fx = sensor.frame_x / norm(sensor.frame_x)
    fy = sensor.frame_y / norm(sensor.frame_y)
    d = (d_local[..., 0:1] * fx + d_local[..., 1:2] * fy
         + d_local[..., 2:3] * sensor.normal)
    return o, d


class Batch(NamedTuple):
    """Side-by-side sub-sensors over the film's width: film column block
    i is rendered by sub-sensor i (any mix of kinds)."""
    sensors: tuple


def batch_ray(sensor: Batch, uv, lens_uv=None):
    k = len(sensor.sensors)
    seg = (uv[..., 0] * k).to(torch.int64).clamp(0, k - 1)
    uv_local = torch.stack([uv[..., 0] * k - seg.to(uv.dtype), uv[..., 1]],
                           -1)
    o = torch.zeros(uv.shape[:-1] + (3,), device=uv.device)
    d = torch.zeros_like(o)
    for i, sub in enumerate(sensor.sensors):
        oi, di = sample_ray(sub, uv_local, lens_uv)
        sel = (seg == i)[..., None]
        o = torch.where(sel, oi, o)
        d = torch.where(sel, di, d)
    return o, d


def takes_lens_sample(sensor) -> bool:
    """Whether `sample_ray` reads `lens_uv` for this sensor: the thin lens,
    the irradiance meter, or a batch holding one."""
    if isinstance(sensor, Batch):
        return any(takes_lens_sample(s) for s in sensor.sensors)
    return isinstance(sensor, (ThinLens, IrradianceMeter))


def sample_ray(sensor, uv, lens_uv=None):
    """Rays of a sensor of any kind; the thin lens and the irradiance
    meter take the lens centre (0.5, 0.5) without `lens_uv`."""
    if isinstance(sensor, (ThinLens, IrradianceMeter)) and lens_uv is None:
        lens_uv = torch.full_like(uv, 0.5)
    if isinstance(sensor, ThinLens):
        return thinlens_ray(sensor, uv, lens_uv)
    if isinstance(sensor, Perspective):
        return perspective_ray(sensor, uv)
    if isinstance(sensor, Spherical):
        return spherical_ray(sensor, uv)
    if isinstance(sensor, Orthographic):
        return orthographic_ray(sensor, uv)
    if isinstance(sensor, Distant):
        return distant_ray(sensor, uv)
    if isinstance(sensor, RadianceMeter):
        return radiancemeter_ray(sensor, uv)
    if isinstance(sensor, IrradianceMeter):
        return irradiancemeter_ray(sensor, uv, lens_uv)
    if isinstance(sensor, Batch):
        return batch_ray(sensor, uv, lens_uv)
    raise TypeError(f"unknown sensor {type(sensor).__name__}")
