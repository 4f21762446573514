"""Numerically-stable geometric/math primitives shared across the renderer.

Plain functions on float32 tensors that broadcast over leading batch
dimensions. Conventions (as in `tpusky/ops/math.py`): directions are unit
3-vectors with a trailing axis of size 3; the local "up" axis is +z;
spherical angles are (phi, theta) with theta measured from +z.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def safe_sqrt(x):
    """sqrt clamped to zero below; the double-where keeps x <= 0 out of
    the sqrt so its gradient stays finite on masked lanes."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_acos(x):
    """arccos clamped to [-1, 1] with a finite gradient at the clamp."""
    ok = x.abs() < 1.0
    xs = torch.where(ok, x, 0.0)
    return torch.where(ok, torch.acos(xs),
                       torch.where(x >= 1.0, 0.0, PI))


def safe_asin(x):
    """arcsin with the same double-where guard as `safe_acos`."""
    ok = x.abs() < 1.0
    xs = torch.where(ok, x, 0.0)
    return torch.where(ok, torch.asin(xs),
                       torch.where(x >= 1.0, 0.5 * PI, -0.5 * PI))


def cbrt(x):
    """Real cube root (torch has no cbrt; pow of a negative base is NaN)."""
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def dot(a, b, keepdim: bool = False):
    return (a * b).sum(-1, keepdim=keepdim)


def norm(v, keepdim: bool = False):
    return torch.sqrt((v * v).sum(-1, keepdim=keepdim))


def normalize(v):
    return v / norm(v, keepdim=True)


def unit(v):
    """v normalised, its length floored at 1e-12; `linalg.vector_norm`
    rounds as the reference's `jnp.linalg.norm` does, where a sum of
    squares need not."""
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp(
        min=1e-12)


def sph_dir(theta, phi):
    """Spherical angles -> unit vector (theta from +z)."""
    st, ct = torch.sin(theta), torch.cos(theta)
    sp, cp = torch.sin(phi), torch.cos(phi)
    return torch.stack([cp * st, sp * st, ct], -1)


def dir_to_sph(v):
    """Unit vector -> (phi, theta), theta via the stable unit-angle form."""
    return torch.atan2(v[..., 1], v[..., 0]), unit_angle_z(v)


def unit_angle(a, b):
    """Angle between two unit vectors, accurate near 0 and pi:
    2*asin(|b - a| / 2), mirrored past 90 degrees."""
    dot_ab = dot(a, b)
    temp = 2.0 * safe_asin(
        0.5 * norm(b - torch.where(dot_ab[..., None] >= 0, a, -a)))
    return torch.where(dot_ab >= 0, temp, PI - temp)


def unit_angle_z(v):
    """Angle between a unit vector and +z (stable near the poles)."""
    temp = 2.0 * safe_asin(
        0.5 * torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2
                         + (v[..., 2].abs() - 1.0) ** 2))
    return torch.where(v[..., 2] >= 0, temp, PI - temp)


def coordinate_system(n):
    """Orthonormal basis (s, t) around unit normal n (Duff et al. 2017)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    s = torch.stack([n[..., 0] ** 2 * a * sign + 1.0, b * sign,
                     -n[..., 0] * sign], -1)
    t = torch.stack([b, n[..., 1] ** 2 * a + sign, -n[..., 1]], -1)
    return s, t


def mat3_apply(m, v):
    """(3, 3) matrix times (..., 3) vectors, written out elementwise so the
    summation order matches the reference package."""
    return torch.stack([v[..., 0] * m[0, 0] + v[..., 1] * m[0, 1]
                        + v[..., 2] * m[0, 2],
                        v[..., 0] * m[1, 0] + v[..., 1] * m[1, 1]
                        + v[..., 2] * m[1, 2],
                        v[..., 0] * m[2, 0] + v[..., 1] * m[2, 1]
                        + v[..., 2] * m[2, 2]], -1)


def mat3_apply_t(m, v):
    """Transpose apply: m^T @ v for (3, 3) m, (..., 3) v."""
    return torch.stack([v[..., 0] * m[0, 0] + v[..., 1] * m[1, 0]
                        + v[..., 2] * m[2, 0],
                        v[..., 0] * m[0, 1] + v[..., 1] * m[1, 1]
                        + v[..., 2] * m[2, 1],
                        v[..., 0] * m[0, 2] + v[..., 1] * m[1, 2]
                        + v[..., 2] * m[2, 2]], -1)


class Frame:
    """Orthonormal frame around a normal; to_local/to_world helpers."""

    def __init__(self, n):
        self.n = n
        self.s, self.t = coordinate_system(n)

    def to_local(self, v):
        return torch.stack([dot(v, self.s), dot(v, self.t),
                            dot(v, self.n)], -1)

    def to_world(self, v):
        return (v[..., 0:1] * self.s + v[..., 1:2] * self.t
                + v[..., 2:3] * self.n)


def erfinv(x):
    """Inverse error function with one Newton polish step against erf
    (y -= (erf(y) - x) * sqrt(pi)/2 * exp(y^2)), the same polish as the
    reference package, so both agree to ~1e-6 where the mass lives."""
    y0 = torch.erfinv(x)
    yc = y0.clamp(-5.9, 5.9)              # exp(y^2) stays finite in f32
    y = yc - (torch.erf(yc) - x) * (math.sqrt(PI) / 2.0) * torch.exp(yc * yc)
    return torch.where(torch.isfinite(y0) & (y0.abs() < 5.9), y, y0)


def gaussian_cdf(mu, sigma, x):
    """CDF of a normal distribution N(mu, sigma) at x."""
    return 0.5 * (1.0 + torch.erf(0.7071067811865475 * (x - mu) / sigma))


def lerp(a, b, t):
    return (1.0 - t) * a + t * b


def poly_powers(x, n: int):
    """[1, x, x^2, ..., x^(n-1)] along a new trailing axis (cumprod, so
    the gradient at x == 0 stays finite)."""
    xs = x[..., None].expand(*x.shape, n - 1)
    return torch.cat([torch.ones_like(x)[..., None],
                      torch.cumprod(xs, -1)], -1)
