"""Affine transform helpers, a copy of the reference package's
`tpusky/utils/transform.py` (host-side numpy, mirroring Mitsuba's
`ScalarTransform4f` constructors: translate/rotate/scale/look_at,
`include/mitsuba/core/transform.h`)."""

from __future__ import annotations

import numpy as np


def translate(v) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[:3, 3] = v
    return m


def scale(v) -> np.ndarray:
    v = np.broadcast_to(np.asarray(v, np.float32), (3,))
    return np.diag([v[0], v[1], v[2], 1.0]).astype(np.float32)


def rotate(axis, angle_deg) -> np.ndarray:
    """Rotation about an axis (degrees), Rodrigues form."""
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    x, y, z = axis
    r = np.array([
        [c + x * x * (1 - c), x * y * (1 - c) - z * s, x * z * (1 - c) + y * s],
        [y * x * (1 - c) + z * s, c + y * y * (1 - c), y * z * (1 - c) - x * s],
        [z * x * (1 - c) - y * s, z * y * (1 - c) + x * s, c + z * z * (1 - c)],
    ])
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = r
    return m


def look_at(origin, target, up=(0, 0, 1)) -> np.ndarray:
    """Camera-to-world: camera looks down +z, x right, y up (the
    reference's convention, `transform.h` `look_at`)."""
    origin = np.asarray(origin, np.float64)
    fwd = np.asarray(target, np.float64) - origin
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.asarray(up, np.float64), fwd)
    right = right / np.linalg.norm(right)
    new_up = np.cross(fwd, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, new_up, fwd, origin
    return m


def compose(*ms) -> np.ndarray:
    """compose(A, B, C) == A @ B @ C (applied right-to-left)."""
    out = np.eye(4, dtype=np.float32)
    for m in ms:
        out = out @ np.asarray(m, np.float32)
    return out
