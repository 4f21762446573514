"""Wrappers of the sunsky CUDA kernels K1-K3 (`csrc/sunsky_kernels.cu`).

The PyTorch counterparts of the TPU kernels in
`tpusky/ops/pallas/sunsky_kernel.py`:

* `sunsky_eval_rgb(state, d)`: K1, radiance (N, 3) -> (N, 3);
* `sunsky_hit_rgb(state, d)`: K2, radiance + mixture pdf (the emitter-hit
  MIS block);
* `sunsky_nee_rgb(state, u2)`: K3, sky/sun sample + radiance + pdf (the
  NEE block).

A CPU tensor goes to the kernel's plain version in `models/sunsky/model.py`;
a CUDA tensor launches the kernel or raises. The wrappers are forward only
for now: they raise on inputs that require grad.

`_misc_row` and `_gauss_rows` pack the state into the tables the kernels
read, in the reference package's layout: a (16,) row of scalars and
(14, 20) per-gaussian constants with the cdf normalised and the
truncation CDFs precomputed.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...models.sunsky import constants as C
from ...models.sunsky import model as M
from ...ops.math import gaussian_cdf
from . import build


def _misc_row(state) -> torch.Tensor:
    """(16,) scalars: sun direction, half aperture, scales (the sun's with
    area ratio and RGB conversion folded in), sun phi, sky sampling
    weight, cos(half aperture), sun frame s and t, disc softness."""
    p = state.params
    n, s, t = state.sun_frame_n, state.sun_frame_s, state.sun_frame_t
    return torch.stack([
        n[0], n[1], n[2], p.sun_half_aperture, p.sky_scale,
        p.sun_scale * M.area_ratio(p.sun_half_aperture)
        * C.SPEC_TO_RGB_SUN_CONV,
        state.sun_angles[0], state.sky_sampling_w,
        torch.cos(p.sun_half_aperture),
        s[0], s[1], s[2], t[0], t[1], t[2], p.disc_softness])


def _gauss_rows(state) -> torch.Tensor:
    """(14, 20) per-gaussian constants: mu (2), sigma (2), 1/sigma (2),
    mixture amplitude w / (2 pi volume), normalised cdf and pmf, the
    truncation CDFs at the bounds of (phi, theta), and the previous cdf."""
    g = state.gaussians                           # (20, 5)
    mu, sigma, w = g[:, 0:2], g[:, 2:4], g[:, 4]
    lo = torch.zeros(2, dtype=g.dtype, device=g.device)
    hi = torch.tensor([2.0 * math.pi, 0.5 * math.pi], dtype=g.dtype,
                      device=g.device)
    cdf_a = gaussian_cdf(mu, sigma, lo)
    cdf_b = gaussian_cdf(mu, sigma, hi)
    vol = ((cdf_b[:, 0] - cdf_a[:, 0]) * (cdf_b[:, 1] - cdf_a[:, 1])
           * sigma[:, 0] * sigma[:, 1])
    amp = w / (2.0 * math.pi * vol.clamp(min=1e-30))
    pmf = w / w.sum().clamp(min=1e-30)
    cdf = torch.cumsum(pmf, 0)
    cdf_prev = torch.cat([torch.zeros_like(cdf[:1]), cdf[:-1]])
    return torch.stack([
        mu[:, 0], mu[:, 1], sigma[:, 0], sigma[:, 1],
        1.0 / sigma[:, 0], 1.0 / sigma[:, 1], amp, cdf, pmf,
        cdf_a[:, 0], cdf_b[:, 0], cdf_a[:, 1], cdf_b[:, 1], cdf_prev])


class Tables(NamedTuple):
    """The state as the kernels read it (contiguous float32, one device)."""
    skyp: torch.Tensor     # (3, 9)
    skyr: torch.Tensor     # (3,)
    sun: torch.Tensor      # (45, 72)
    misc: torch.Tensor     # (16,)
    gauss: torch.Tensor    # (14, 20)

    def pointers(self):
        return [t.data_ptr() for t in self]


def pack_tables(state, device) -> Tables:
    tables = Tables(state.sky_params, state.sky_radiance,
                    state.sun_radiance, _misc_row(state), _gauss_rows(state))
    tables = Tables(*(t.to(torch.float32).contiguous() for t in tables))
    for t in tables:
        if t.device != device:
            raise ValueError(f"sunsky state on {t.device}, lanes on {device}")
        if t.requires_grad:
            raise NotImplementedError("the sunsky kernels are forward only")
    return tables


def check_lanes(x, cols: int, name: str):
    """Validate a (N, cols) float32 CUDA tensor the kernels can take."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != cols:
        raise ValueError(f"{name}: expected shape (N, {cols}), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if x.requires_grad:
        raise NotImplementedError(f"{name}: forward only")
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: at most 2^31 - 1 lanes")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def launch_eval(tables: Tables, d):
    out = torch.empty_like(d)
    sk = tables.pointers()
    err = build.library().tsk_sunsky_eval_rgb(
        d.data_ptr(), d.shape[0], sk[0], sk[1], sk[2], sk[3],
        out.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_eval_rgb")
    return out


def launch_hit(tables: Tables, d):
    rad = torch.empty_like(d)
    pdf = torch.empty(d.shape[0], dtype=torch.float32, device=d.device)
    err = build.library().tsk_sunsky_hit_rgb(
        d.data_ptr(), d.shape[0], *tables.pointers(), rad.data_ptr(),
        pdf.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_hit_rgb")
    return rad, pdf


def launch_nee(tables: Tables, u2):
    n = u2.shape[0]
    d = torch.empty((n, 3), dtype=torch.float32, device=u2.device)
    rad = torch.empty((n, 3), dtype=torch.float32, device=u2.device)
    pdf = torch.empty(n, dtype=torch.float32, device=u2.device)
    err = build.library().tsk_sunsky_nee_rgb(
        u2.data_ptr(), n, *tables.pointers(), d.data_ptr(), rad.data_ptr(),
        pdf.data_ptr(), _stream(u2.device))
    build.check(err, "sunsky_nee_rgb")
    return d, rad, pdf


def sunsky_eval_rgb(state, d):
    """K1: RGB radiance toward local directions d (N, 3) -> (N, 3)."""
    if d.device.type == "cpu":
        return M._eval_rgb_plain(state, d)
    check_lanes(d, 3, "sunsky_eval_rgb")
    out = launch_eval(pack_tables(state, d.device), d)
    build.launches["sunsky_eval_rgb"] += 1
    return out


def sunsky_hit_rgb(state, d):
    """K2: (radiance (N, 3), pdf (N,)) toward local directions d (N, 3)."""
    if d.device.type == "cpu":
        return M._hit_rgb_plain(state, d)
    check_lanes(d, 3, "sunsky_hit_rgb")
    out = launch_hit(pack_tables(state, d.device), d)
    build.launches["sunsky_hit_rgb"] += 1
    return out


def sunsky_nee_rgb(state, u2):
    """K3: uniforms u2 (N, 2) -> (direction (N, 3), radiance (N, 3),
    pdf (N,))."""
    if u2.device.type == "cpu":
        return M._sample_eval_rgb_plain(state, u2)
    check_lanes(u2, 2, "sunsky_nee_rgb")
    out = launch_nee(pack_tables(state, u2.device), u2)
    build.launches["sunsky_nee_rgb"] += 1
    return out
