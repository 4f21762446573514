"""Perspective sensor: ray generation from film-plane samples.

The perspective camera of `tpusky/render/sensors.py` (reference
`src/sensors/perspective.cpp`). The other sensor kinds are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.math import mat3_apply, normalize


class Perspective(NamedTuple):
    to_world: torch.Tensor     # (4, 4) camera-to-world
    fov_x_deg: torch.Tensor    # () horizontal field of view
    aspect: torch.Tensor       # () width / height
    near: torch.Tensor         # ()


def make_perspective(origin, target, up=(0, 0, 1), fov_x_deg=45.0,
                     aspect=1.0, device=None) -> Perspective:
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

    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=device)
    return Perspective(f32(m), f32(fov_x_deg), f32(aspect), f32(1e-2))


def perspective_ray(sensor: Perspective, uv):
    """uv (..., 2) in [0,1]^2 -> (origin (..., 3), direction (..., 3))."""
    tan_half = torch.tan(0.5 * torch.deg2rad(sensor.fov_x_deg))
    x = (2.0 * uv[..., 0] - 1.0) * tan_half
    y = (1.0 - 2.0 * uv[..., 1]) * tan_half / sensor.aspect
    d_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    d = normalize(mat3_apply(sensor.to_world[:3, :3], d_cam))
    o = sensor.to_world[:3, 3].expand(d.shape)
    return o, d


def sample_ray(sensor, uv, lens_uv=None):
    """Dispatch on the sensor type (perspective only in this port)."""
    if isinstance(sensor, Perspective):
        return perspective_ray(sensor, uv)
    raise NotImplementedError(f"sensor {type(sensor).__name__}")
