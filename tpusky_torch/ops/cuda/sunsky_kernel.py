"""Wrappers of the sunsky CUDA kernels K1-K3 (`csrc/sunsky_kernels.cu`),
their adjoints K5, K6 (`csrc/sunsky_adjoint.cu`) and the spectral
kernels K9-K11 (`csrc/sunsky_spectral.cu`).

The PyTorch counterparts of the TPU kernels in
`tpusky/ops/pallas/sunsky_kernel.py`:

* `sunsky_eval_rgb(state, d)`: K1, radiance (N, 3) -> (N, 3);
* `sunsky_hit_rgb(state, d)`: K2, radiance + mixture pdf (the emitter-hit
  MIS block);
* `sunsky_nee_rgb(state, u2)`: K3, sky/sun sample + radiance + pdf (the
  NEE block);
* `sunsky_eval_spec`, `sunsky_hit_spec`, `sunsky_nee_spec`: K9-K11, the
  same three blocks in spectral mode at per-lane wavelengths (N, W).

A CPU tensor goes to the kernel's plain version in `models/sunsky/model.py`
(torch autograd differentiates it); a CUDA tensor launches the kernel or
raises. On the card each forward kernel runs inside a
`torch.autograd.Function` whose tensor inputs are the packed tables, so
autograd pulls the table cotangents back into the state and the
parameters (what the reference package's `jax.vjp(_derived_rgb, state)`
does): K1 and K2 transpose into K5, K3 into K6. That holds for the
render's contract, the pdf detached; the attached-pdf adjoints K7 and K8
are not ported, so `sunsky_hit_rgb` / `sunsky_nee_rgb` with
`pdf_detached=False` raise when a gradient is asked for on the card.
K9-K11 run forward only: their adjoints K12 and K13 are not ported, so
any gradient request on the card raises.

`_misc_row` (`_misc_row_spec` in spectral mode) and `_gauss_rows` pack
the state into the tables the kernels read, in the reference package's
layout: a (16,) row of scalars and (14, 20) per-gaussian constants with
the cdf normalised and the truncation CDFs precomputed.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ...models.sunsky import constants as C
from ...models.sunsky import model as M
from ...ops.math import gaussian_cdf
from . import build


def _misc_row(state, sun_conv: float = C.SPEC_TO_RGB_SUN_CONV
              ) -> torch.Tensor:
    """(16,) scalars: sun direction, half aperture, scales (the sun's with
    area ratio and `sun_conv` folded in), sun phi, sky sampling weight,
    cos(half aperture), sun frame s and t, disc softness."""
    p = state.params
    n, s, t = state.sun_frame_n, state.sun_frame_s, state.sun_frame_t
    return torch.stack([
        n[0], n[1], n[2], p.sun_half_aperture, p.sky_scale,
        p.sun_scale * M.area_ratio(p.sun_half_aperture) * sun_conv,
        state.sun_angles[0], state.sky_sampling_w,
        torch.cos(p.sun_half_aperture),
        s[0], s[1], s[2], t[0], t[1], t[2], p.disc_softness])


def _misc_row_spec(state) -> torch.Tensor:
    """The spectral misc row: the sun scale carries neither the RGB
    conversion constant nor a CIE normalisation (`model.eval_spectral`)."""
    return _misc_row(state, sun_conv=1.0)


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
    gauss: Optional[torch.Tensor]    # (14, 20); None for K1 and K5

    def pointers(self):
        return [None if t is None else t.data_ptr() for t in self]


def pack_tables(state, device) -> Tables:
    """The kernels' tables, differentiable in the state. The gaussian table
    only places samples and weighs the detached pdf, so it is built
    outside autograd."""
    with torch.no_grad():
        gauss = _gauss_rows(state)
    tables = Tables(state.sky_params, state.sky_radiance,
                    state.sun_radiance, _misc_row(state), gauss)
    tables = Tables(*(t.to(torch.float32).contiguous() for t in tables))
    for t in tables:
        if t.device != torch.device(device):
            raise ValueError(f"sunsky state on {t.device}, lanes on {device}")
    return tables


class SpecTables(NamedTuple):
    """The spectral state as K9-K11 read it (contiguous float32)."""
    skyp: torch.Tensor     # (11, 9)
    skyr: torch.Tensor     # (11,)
    sun: torch.Tensor      # (45, 44)
    ld: torch.Tensor       # (11, 6)
    misc: torch.Tensor     # (16,), `_misc_row_spec`
    gauss: torch.Tensor    # (14, 20)

    def pointers(self):
        return [t.data_ptr() for t in self]


def pack_tables_spec(state, device) -> SpecTables:
    """K9-K11's tables from a spectral state."""
    if state.sun_ld is None:
        raise ValueError("the spectral kernels need a state precomputed in "
                         "spectral mode")
    with torch.no_grad():
        gauss = _gauss_rows(state)
    tables = SpecTables(state.sky_params, state.sky_radiance,
                        state.sun_radiance, state.sun_ld,
                        _misc_row_spec(state), gauss)
    tables = SpecTables(*(t.to(torch.float32).contiguous() for t in tables))
    for t in tables:
        if t.device != torch.device(device):
            raise ValueError(f"sunsky state on {t.device}, lanes on {device}")
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
    if x.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: at most 2^31 - 1 lanes")


def _check_wavelengths(wl, n: int, name: str):
    """Validate (N, W) float32 wavelengths on the lanes' CUDA device."""
    if wl.dim() != 2:
        raise ValueError(f"{name}: expected wavelengths (N, W), got "
                         f"{tuple(wl.shape)}")
    check_lanes(wl, wl.shape[1], name)
    if wl.shape[0] != n:
        raise ValueError(f"{name}: {wl.shape[0]} wavelength rows for {n} "
                         "lanes")


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


# the adjoints' output row (csrc/sunsky_adjoint.cu): sun (45, 72), then
# skyp (3, 9), skyr (3,) and misc (16,) cotangents
_N_SUN = C.N_SUN_SEGMENTS * 72
_ROW = _N_SUN + 27 + 3 + 16


def _split_cotangents(row):
    """(3286,) [sun | skyp | skyr | misc] -> (dskyp, dskyr, dsun, dmisc)."""
    return (row[_N_SUN:_N_SUN + 27].view(3, 9),
            row[_N_SUN + 27:_N_SUN + 30],
            row[:_N_SUN].view(C.N_SUN_SEGMENTS, 72), row[_N_SUN + 30:])


def _adjoint_scratch(n, device):
    rows = build.library().tsk_adjoint_rows(n)
    partial = torch.empty((rows, _ROW), dtype=torch.float32, device=device)
    return partial, torch.empty(_ROW, dtype=torch.float32, device=device)


def launch_eval_bwd(tables: Tables, d, g_rad):
    """K5: -> (dd (N, 3), dskyp, dskyr, dsun, dmisc)."""
    n = d.shape[0]
    dd = torch.empty_like(d)
    partial, row = _adjoint_scratch(n, d.device)
    sk = tables.pointers()
    err = build.library().tsk_sunsky_eval_rgb_bwd(
        d.data_ptr(), g_rad.data_ptr(), n, sk[0], sk[1], sk[2], sk[3],
        dd.data_ptr(), partial.data_ptr(), row.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_eval_rgb_bwd")
    return (dd, *_split_cotangents(row))


def launch_nee_bwd(tables: Tables, u2, g_rad):
    """K6: -> (dskyp, dskyr, dsun, dmisc)."""
    n = u2.shape[0]
    partial, row = _adjoint_scratch(n, u2.device)
    err = build.library().tsk_sunsky_nee_rgb_bwd(
        u2.data_ptr(), g_rad.data_ptr(), n, *tables.pointers(),
        partial.data_ptr(), row.data_ptr(), _stream(u2.device))
    build.check(err, "sunsky_nee_rgb_bwd")
    return _split_cotangents(row)


def _eval_adjoint(ctx, g_rad):
    """K5 from a Function's saved (d, skyp, skyr, sun, misc)."""
    d, *small = ctx.saved_tensors
    g_rad = g_rad.to(torch.float32).contiguous()
    dd, *dtables = launch_eval_bwd(Tables(*small, None), d, g_rad)
    build.launches["sunsky_eval_rgb_bwd"] += 1
    return (dd if ctx.needs_input_grad[0] else None, *dtables)


class _Eval(torch.autograd.Function):
    """K1 forward, K5 backward."""

    @staticmethod
    def forward(ctx, d, skyp, skyr, sun, misc):
        ctx.save_for_backward(d, skyp, skyr, sun, misc)
        return launch_eval(Tables(skyp, skyr, sun, misc, None), d)

    @staticmethod
    def backward(ctx, g_rad):
        return _eval_adjoint(ctx, g_rad)


class _Hit(torch.autograd.Function):
    """K2 forward; backward K5 (the pdf output is detached)."""

    @staticmethod
    def forward(ctx, d, skyp, skyr, sun, misc, gauss):
        rad, pdf = launch_hit(Tables(skyp, skyr, sun, misc, gauss), d)
        ctx.mark_non_differentiable(pdf)
        ctx.save_for_backward(d, skyp, skyr, sun, misc)
        return rad, pdf

    @staticmethod
    def backward(ctx, g_rad, _g_pdf):
        return (*_eval_adjoint(ctx, g_rad), None)


class _Nee(torch.autograd.Function):
    """K3 forward; backward K6 (direction and pdf detached)."""

    @staticmethod
    def forward(ctx, u2, skyp, skyr, sun, misc, gauss):
        tables = Tables(skyp, skyr, sun, misc, gauss)
        d, rad, pdf = launch_nee(tables, u2)
        ctx.mark_non_differentiable(d, pdf)
        ctx.save_for_backward(u2, skyp, skyr, sun, misc, gauss)
        return d, rad, pdf

    @staticmethod
    def backward(ctx, _g_d, g_rad, _g_pdf):
        u2, *tables = ctx.saved_tensors
        g_rad = g_rad.to(torch.float32).contiguous()
        dtables = launch_nee_bwd(Tables(*tables), u2, g_rad)
        build.launches["sunsky_nee_rgb_bwd"] += 1
        return (None, *dtables, None)


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def sunsky_eval_rgb(state, d):
    """K1: RGB radiance toward local directions d (N, 3) -> (N, 3)."""
    if d.device.type == "cpu":
        return M._eval_rgb_plain(state, d)
    check_lanes(d, 3, "sunsky_eval_rgb")
    out = _Eval.apply(d, *pack_tables(state, d.device)[:4])
    build.launches["sunsky_eval_rgb"] += 1
    return out


def sunsky_hit_rgb(state, d, pdf_detached: bool = False):
    """K2: (radiance (N, 3), pdf (N,)) toward local directions d (N, 3).
    On the card the pdf carries no gradient: with pdf_detached=False a
    gradient request raises (its adjoint, K7, is not ported)."""
    if d.device.type == "cpu":
        return M._hit_rgb_plain(state, d)
    check_lanes(d, 3, "sunsky_hit_rgb")
    tables = pack_tables(state, d.device)
    if not pdf_detached and _wants_grad(d, *tables):
        raise NotImplementedError(
            "sunsky_hit_rgb: the gradient of the attached pdf needs K7 "
            "(sunsky_hit_rgb_bwd_pallas), not ported; pass "
            "pdf_detached=True")
    out = _Hit.apply(d, *tables)
    build.launches["sunsky_hit_rgb"] += 1
    return out


def sunsky_nee_rgb(state, u2, pdf_detached: bool = False):
    """K3: uniforms u2 (N, 2) -> (direction (N, 3), radiance (N, 3),
    pdf (N,)). On the card only the radiance carries a gradient: with
    pdf_detached=False a gradient request raises (its adjoint, K8, is not
    ported)."""
    if u2.device.type == "cpu":
        return M._sample_eval_rgb_plain(state, u2)
    check_lanes(u2, 2, "sunsky_nee_rgb")
    tables = pack_tables(state, u2.device)
    if not pdf_detached and _wants_grad(u2, *tables):
        raise NotImplementedError(
            "sunsky_nee_rgb: the gradient of the attached pdf needs K8 "
            "(sunsky_nee_rgb_bwd_pallas), not ported; pass "
            "pdf_detached=True")
    out = _Nee.apply(u2, *tables)
    build.launches["sunsky_nee_rgb"] += 1
    return out


# ---------------------------------------------------------------------------
# Spectral kernels K9-K11 (forward only)
# ---------------------------------------------------------------------------


def launch_eval_spec(tables: SpecTables, d, wl):
    n, nw = wl.shape
    out = torch.empty((n, nw), dtype=torch.float32, device=d.device)
    sk = tables.pointers()
    err = build.library().tsk_sunsky_eval_spec(
        d.data_ptr(), wl.data_ptr(), n, nw, *sk[:5], out.data_ptr(),
        _stream(d.device))
    build.check(err, "sunsky_eval_spec")
    return out


def launch_hit_spec(tables: SpecTables, d, wl):
    n, nw = wl.shape
    rad = torch.empty((n, nw), dtype=torch.float32, device=d.device)
    pdf = torch.empty(n, dtype=torch.float32, device=d.device)
    err = build.library().tsk_sunsky_hit_spec(
        d.data_ptr(), wl.data_ptr(), n, nw, *tables.pointers(),
        rad.data_ptr(), pdf.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_hit_spec")
    return rad, pdf


def launch_nee_spec(tables: SpecTables, u2, wl):
    n, nw = wl.shape
    d = torch.empty((n, 3), dtype=torch.float32, device=u2.device)
    rad = torch.empty((n, nw), dtype=torch.float32, device=u2.device)
    pdf = torch.empty(n, dtype=torch.float32, device=u2.device)
    err = build.library().tsk_sunsky_nee_spec(
        u2.data_ptr(), wl.data_ptr(), n, nw, *tables.pointers(),
        d.data_ptr(), rad.data_ptr(), pdf.data_ptr(), _stream(u2.device))
    build.check(err, "sunsky_nee_spec")
    return d, rad, pdf


def _spec_tables(state, lanes, cols, wl, name, adjoint):
    """Validate the lanes and wavelengths, pack the tables, and refuse a
    gradient request: the spectral adjoints are not ported."""
    check_lanes(lanes, cols, name)
    _check_wavelengths(wl, lanes.shape[0], name)
    tables = pack_tables_spec(state, lanes.device)
    if _wants_grad(lanes, wl, *tables):
        raise NotImplementedError(
            f"{name}: spectral gradients on the card need {adjoint}, not "
            "ported")
    return tables


def sunsky_eval_spec(state, d, wl):
    """K9: spectral radiance toward local directions d (N, 3) at
    wavelengths wl (N, W) in nm -> (N, W)."""
    if d.device.type == "cpu":
        return M._eval_spec_plain(state, d, wl)
    tables = _spec_tables(state, d, 3, wl, "sunsky_eval_spec",
                          "K12 (sunsky_hit_spec_bwd_pallas, with_pdf=False)")
    out = launch_eval_spec(tables, d, wl)
    build.launches["sunsky_eval_spec"] += 1
    return out


def sunsky_hit_spec(state, d, wl):
    """K10: (spectral radiance (N, W), pdf (N,)) toward local directions
    d (N, 3) at wavelengths wl (N, W). On the card neither output carries
    a gradient."""
    if d.device.type == "cpu":
        return M._hit_spec_plain(state, d, wl)
    tables = _spec_tables(state, d, 3, wl, "sunsky_hit_spec",
                          "K12 (sunsky_hit_spec_bwd_pallas)")
    out = launch_hit_spec(tables, d, wl)
    build.launches["sunsky_hit_spec"] += 1
    return out


def sunsky_nee_spec(state, u2, wl):
    """K11: uniforms u2 (N, 2), wavelengths wl (N, W) -> (direction
    (N, 3), spectral radiance (N, W), pdf (N,)). On the card no output
    carries a gradient."""
    if u2.device.type == "cpu":
        return M._sample_eval_spec_plain(state, u2, wl)
    tables = _spec_tables(state, u2, 2, wl, "sunsky_nee_spec",
                          "K13 (sunsky_nee_spec_bwd_pallas)")
    out = launch_nee_spec(tables, u2, wl)
    build.launches["sunsky_nee_spec"] += 1
    return out
