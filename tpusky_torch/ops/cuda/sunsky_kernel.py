"""Wrappers of the sunsky CUDA kernels K1-K3 (`csrc/sunsky_kernels.cu`),
their adjoints K5-K8 (`csrc/sunsky_adjoint.cu`), the spectral kernels
K9-K11 (`csrc/sunsky_spectral.cu`) and their adjoints K12, K13
(`csrc/sunsky_spectral_adjoint.cu`).

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
does). The backward kernel follows the pdf's contract, `pdf_detached`:

| forward | pdf detached (the render's contract) | pdf attached |
|---|---|---|
| K1 eval | K5 | - |
| K2 hit | K5 | K7 |
| K3 NEE | K6 | K8 |
| K9 eval | K12, without the pdf | - |
| K10 hit | K12, without the pdf | K12 with the pdf |
| K11 NEE | K13, without the pdf | K13 with the pdf |

With the pdf detached, the pdf output is non-differentiable and the
gaussian table is packed outside autograd (it only places samples); with
it attached, the table is packed under autograd, so the adjoint's
cotangent of it reaches `state.gaussians` through `_gauss_rows`. The
spectral adjoints also give the wavelengths' cotangent.

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


def _gauss_table(state, attached: bool) -> torch.Tensor:
    """The gaussian table, under autograd only when the pdf's gradient is
    asked for (otherwise it only places samples and weighs a detached
    pdf)."""
    if attached:
        return _gauss_rows(state)
    with torch.no_grad():
        return _gauss_rows(state)


def _on_device(tables, device):
    tables = type(tables)(*(t.to(torch.float32).contiguous()
                            for t in tables))
    for t in tables:
        if t.device != torch.device(device):
            raise ValueError(f"sunsky state on {t.device}, lanes on {device}")
    return tables


class Tables(NamedTuple):
    """The state as the kernels read it (contiguous float32, one device)."""
    skyp: torch.Tensor     # (3, 9)
    skyr: torch.Tensor     # (3,)
    sun: torch.Tensor      # (45, 72)
    misc: torch.Tensor     # (16,)
    gauss: Optional[torch.Tensor]    # (14, 20); None for K1 and K5

    def pointers(self):
        return [None if t is None else t.data_ptr() for t in self]


def pack_tables(state, device, pdf_attached: bool = False) -> Tables:
    """The kernels' tables, differentiable in the state; the gaussian
    table too when `pdf_attached`."""
    return _on_device(Tables(state.sky_params, state.sky_radiance,
                             state.sun_radiance, _misc_row(state),
                             _gauss_table(state, pdf_attached)), device)


class SpecTables(NamedTuple):
    """The spectral state as K9-K13 read it (contiguous float32)."""
    skyp: torch.Tensor     # (11, 9)
    skyr: torch.Tensor     # (11,)
    sun: torch.Tensor      # (45, 44)
    ld: torch.Tensor       # (11, 6)
    misc: torch.Tensor     # (16,), `_misc_row_spec`
    gauss: torch.Tensor    # (14, 20)

    def pointers(self):
        return [t.data_ptr() for t in self]


def pack_tables_spec(state, device, pdf_attached: bool = False
                     ) -> SpecTables:
    """K9-K13's tables from a spectral state, as `pack_tables`."""
    if state.sun_ld is None:
        raise ValueError("the spectral kernels need a state precomputed in "
                         "spectral mode")
    return _on_device(SpecTables(state.sky_params, state.sky_radiance,
                                 state.sun_radiance, state.sun_ld,
                                 _misc_row_spec(state),
                                 _gauss_table(state, pdf_attached)), device)


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


def _ptr(t):
    return None if t is None else t.data_ptr()


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


# the RGB adjoints' output row (csrc/sunsky_adjoint.cu): sun (45, 72), then
# skyp (3, 9), skyr (3,) and misc (16,) cotangents; K7 and K8 add the
# gaussian table (14, 20)
_N_SUN = C.N_SUN_SEGMENTS * 72
_ROW = _N_SUN + 27 + 3 + 16
_GAUSS = 14 * 20
_ROW_PDF = _ROW + _GAUSS


def _split_cotangents(row):
    """[sun | skyp | skyr | misc (| gauss)] -> (dskyp, dskyr, dsun, dmisc
    (, dgauss)), in the order of `Tables`."""
    out = (row[_N_SUN:_N_SUN + 27].view(3, 9),
           row[_N_SUN + 27:_N_SUN + 30],
           row[:_N_SUN].view(C.N_SUN_SEGMENTS, 72),
           row[_N_SUN + 30:_ROW])
    return out if row.shape[0] == _ROW else (*out, row[_ROW:].view(14, 20))


def _adjoint_scratch(n, cols, device, rgb_kernel=None):
    """(partial rows, output row) of an adjoint's launch over n lanes: K12
    and K13 run a fixed grid, K5-K8 (rgb_kernel 5-8) as many blocks as
    the card holds at once."""
    lib = build.library()
    rows = (lib.tsk_adjoint_rows(n) if rgb_kernel is None
            else lib.tsk_adjoint_rgb_rows(n, rgb_kernel))
    partial = torch.empty((rows, cols), dtype=torch.float32, device=device)
    return partial, torch.empty(cols, dtype=torch.float32, device=device)


def launch_eval_bwd(tables: Tables, d, g_rad):
    """K5: -> (dd (N, 3), dskyp, dskyr, dsun, dmisc)."""
    n = d.shape[0]
    dd = torch.empty_like(d)
    partial, row = _adjoint_scratch(n, _ROW, d.device, 5)
    sk = tables.pointers()
    err = build.library().tsk_sunsky_eval_rgb_bwd(
        d.data_ptr(), g_rad.data_ptr(), n, sk[0], sk[1], sk[2], sk[3],
        dd.data_ptr(), partial.data_ptr(), row.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_eval_rgb_bwd")
    return (dd, *_split_cotangents(row))


def launch_nee_bwd(tables: Tables, u2, g_rad):
    """K6: -> (dskyp, dskyr, dsun, dmisc)."""
    n = u2.shape[0]
    partial, row = _adjoint_scratch(n, _ROW, u2.device, 6)
    err = build.library().tsk_sunsky_nee_rgb_bwd(
        u2.data_ptr(), g_rad.data_ptr(), n, *tables.pointers(),
        partial.data_ptr(), row.data_ptr(), _stream(u2.device))
    build.check(err, "sunsky_nee_rgb_bwd")
    return _split_cotangents(row)


def launch_hit_bwd(tables: Tables, d, g_rad, g_pdf):
    """K7: -> (dd (N, 3), dskyp, dskyr, dsun, dmisc, dgauss)."""
    n = d.shape[0]
    dd = torch.empty_like(d)
    partial, row = _adjoint_scratch(n, _ROW_PDF, d.device, 7)
    err = build.library().tsk_sunsky_hit_rgb_bwd(
        d.data_ptr(), g_rad.data_ptr(), g_pdf.data_ptr(), n,
        *tables.pointers(), dd.data_ptr(), partial.data_ptr(),
        row.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_hit_rgb_bwd")
    return (dd, *_split_cotangents(row))


def launch_nee_pdf_bwd(tables: Tables, u2, g_rad, g_pdf):
    """K8: -> (dskyp, dskyr, dsun, dmisc, dgauss)."""
    n = u2.shape[0]
    partial, row = _adjoint_scratch(n, _ROW_PDF, u2.device, 8)
    err = build.library().tsk_sunsky_nee_rgb_pdf_bwd(
        u2.data_ptr(), g_rad.data_ptr(), g_pdf.data_ptr(), n,
        *tables.pointers(), partial.data_ptr(), row.data_ptr(),
        _stream(u2.device))
    build.check(err, "sunsky_nee_rgb_pdf_bwd")
    return _split_cotangents(row)


def _f32(g):
    return g.to(torch.float32).contiguous()


def _eval_adjoint(ctx, g_rad, want_dd):
    """K5 from a Function's saved (d, skyp, skyr, sun, misc, ...)."""
    d, *small = ctx.saved_tensors[:5]
    dd, *dtables = launch_eval_bwd(Tables(*small, None), d, _f32(g_rad))
    build.launches["sunsky_eval_rgb_bwd"] += 1
    return (dd if want_dd else None, *dtables)


class _Eval(torch.autograd.Function):
    """K1 forward, K5 backward."""

    @staticmethod
    def forward(ctx, d, skyp, skyr, sun, misc):
        ctx.save_for_backward(d, skyp, skyr, sun, misc)
        return launch_eval(Tables(skyp, skyr, sun, misc, None), d)

    @staticmethod
    def backward(ctx, g_rad):
        return _eval_adjoint(ctx, g_rad, ctx.needs_input_grad[0])


class _Hit(torch.autograd.Function):
    """K2 forward; backward K5 with the pdf detached (its output is then
    non-differentiable), K7 with it attached."""

    @staticmethod
    def forward(ctx, pdf_detached, d, skyp, skyr, sun, misc, gauss):
        rad, pdf = launch_hit(Tables(skyp, skyr, sun, misc, gauss), d)
        if pdf_detached:
            ctx.mark_non_differentiable(pdf)
        ctx.pdf_detached = pdf_detached
        ctx.save_for_backward(d, skyp, skyr, sun, misc, gauss)
        return rad, pdf

    @staticmethod
    def backward(ctx, g_rad, g_pdf):
        if ctx.pdf_detached:
            return (None, *_eval_adjoint(ctx, g_rad,
                                         ctx.needs_input_grad[1]), None)
        d, *tables = ctx.saved_tensors
        dd, *dtables = launch_hit_bwd(Tables(*tables), d, _f32(g_rad),
                                      _f32(g_pdf))
        build.launches["sunsky_hit_rgb_bwd"] += 1
        return (None, dd if ctx.needs_input_grad[1] else None, *dtables)


class _Nee(torch.autograd.Function):
    """K3 forward (the direction non-differentiable: sample placement);
    backward K6 with the pdf detached (non-differentiable), K8 with it
    attached."""

    @staticmethod
    def forward(ctx, pdf_detached, u2, skyp, skyr, sun, misc, gauss):
        tables = Tables(skyp, skyr, sun, misc, gauss)
        d, rad, pdf = launch_nee(tables, u2)
        ctx.mark_non_differentiable(*((d, pdf) if pdf_detached else (d,)))
        ctx.pdf_detached = pdf_detached
        ctx.save_for_backward(u2, skyp, skyr, sun, misc, gauss)
        return d, rad, pdf

    @staticmethod
    def backward(ctx, _g_d, g_rad, g_pdf):
        u2, *tables = ctx.saved_tensors
        if ctx.pdf_detached:
            dtables = launch_nee_bwd(Tables(*tables), u2, _f32(g_rad))
            build.launches["sunsky_nee_rgb_bwd"] += 1
            return (None, None, *dtables, None)
        dtables = launch_nee_pdf_bwd(Tables(*tables), u2, _f32(g_rad),
                                     _f32(g_pdf))
        build.launches["sunsky_nee_rgb_pdf_bwd"] += 1
        return (None, None, *dtables)


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
    """K2: (radiance (N, 3), pdf (N,)) toward local directions d (N, 3);
    under autograd K5 (pdf_detached) or K7 backward."""
    if d.device.type == "cpu":
        return M._hit_rgb_plain(state, d)
    check_lanes(d, 3, "sunsky_hit_rgb")
    out = _Hit.apply(pdf_detached, d,
                     *pack_tables(state, d.device, not pdf_detached))
    build.launches["sunsky_hit_rgb"] += 1
    return out


def sunsky_nee_rgb(state, u2, pdf_detached: bool = False):
    """K3: uniforms u2 (N, 2) -> (direction (N, 3), radiance (N, 3),
    pdf (N,)); under autograd K6 (pdf_detached) or K8 backward. The
    direction is sample placement and carries no gradient."""
    if u2.device.type == "cpu":
        return M._sample_eval_rgb_plain(state, u2)
    check_lanes(u2, 2, "sunsky_nee_rgb")
    out = _Nee.apply(pdf_detached, u2,
                     *pack_tables(state, u2.device, not pdf_detached))
    build.launches["sunsky_nee_rgb"] += 1
    return out


# ---------------------------------------------------------------------------
# Spectral kernels K9-K11 and their adjoints K12, K13
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


# the spectral adjoints' output row (csrc/sunsky_spectral_adjoint.cu):
# sun (45, 44), skyp (11, 9), skyr (11,), ld (11, 6), misc (16,),
# gauss (14, 20)
_SPEC_COLS = ((C.N_SUN_SEGMENTS, 44), (11, 9), (11,), (11, 6), (16,),
              (14, 20))
_SPEC_ROW = sum(math.prod(s) for s in _SPEC_COLS)


def _split_spec_cotangents(row):
    """The spectral row -> cotangents in the order of `SpecTables`."""
    parts, at = [], 0
    for shape in _SPEC_COLS:
        size = math.prod(shape)
        parts.append(row[at:at + size].view(shape))
        at += size
    dsun, dskyp, dskyr, dld, dmisc, dgauss = parts
    return dskyp, dskyr, dsun, dld, dmisc, dgauss


def launch_hit_spec_bwd(tables: SpecTables, d, wl, g_rad, g_pdf=None,
                        want_dd=True, want_dwl=True):
    """K12, with the pdf when g_pdf is given: -> (dd (N, 3) or None,
    dwl (N, W) or None, dskyp, dskyr, dsun, dld, dmisc, dgauss)."""
    n, nw = wl.shape
    dd = torch.empty_like(d) if want_dd else None
    dwl = torch.empty_like(wl) if want_dwl else None
    partial, row = _adjoint_scratch(n, _SPEC_ROW, d.device)
    err = build.library().tsk_sunsky_hit_spec_bwd(
        d.data_ptr(), wl.data_ptr(), g_rad.data_ptr(), _ptr(g_pdf), n, nw,
        *tables.pointers(), _ptr(dd), _ptr(dwl), partial.data_ptr(),
        row.data_ptr(), _stream(d.device))
    build.check(err, "sunsky_hit_spec_bwd")
    return (dd, dwl, *_split_spec_cotangents(row))


def launch_nee_spec_bwd(tables: SpecTables, u2, wl, g_rad, g_pdf=None,
                        want_dwl=True):
    """K13, with the pdf when g_pdf is given: -> (dwl (N, W) or None,
    dskyp, dskyr, dsun, dld, dmisc, dgauss)."""
    n, nw = wl.shape
    dwl = torch.empty_like(wl) if want_dwl else None
    partial, row = _adjoint_scratch(n, _SPEC_ROW, u2.device)
    err = build.library().tsk_sunsky_nee_spec_bwd(
        u2.data_ptr(), wl.data_ptr(), g_rad.data_ptr(), _ptr(g_pdf), n, nw,
        *tables.pointers(), _ptr(dwl), partial.data_ptr(), row.data_ptr(),
        _stream(u2.device))
    build.check(err, "sunsky_nee_spec_bwd")
    return (dwl, *_split_spec_cotangents(row))


def _hit_spec_adjoint(ctx, g_rad, g_pdf, want_dd, want_dwl):
    """K12 from a Function's saved (d, wl, *SpecTables); g_pdf None for
    the variant without the pdf. -> (dd, dwl, table cotangents)."""
    d, wl, *tables = ctx.saved_tensors
    out = launch_hit_spec_bwd(
        SpecTables(*tables), d, wl, _f32(g_rad),
        None if g_pdf is None else _f32(g_pdf), want_dd, want_dwl)
    build.launches["sunsky_hit_spec_bwd"] += 1
    return out


class _EvalSpec(torch.autograd.Function):
    """K9 forward, K12 without the pdf backward."""

    @staticmethod
    def forward(ctx, d, wl, skyp, skyr, sun, ld, misc, gauss):
        ctx.save_for_backward(d, wl, skyp, skyr, sun, ld, misc, gauss)
        return launch_eval_spec(SpecTables(skyp, skyr, sun, ld, misc, gauss),
                                d, wl)

    @staticmethod
    def backward(ctx, g_rad):
        dd, dwl, *dtables = _hit_spec_adjoint(ctx, g_rad, None,
                                              *ctx.needs_input_grad[:2])
        return (dd, dwl, *dtables[:5], None)


class _HitSpec(torch.autograd.Function):
    """K10 forward; backward K12, with the pdf unless it is detached (its
    output is then non-differentiable)."""

    @staticmethod
    def forward(ctx, pdf_detached, d, wl, skyp, skyr, sun, ld, misc, gauss):
        rad, pdf = launch_hit_spec(
            SpecTables(skyp, skyr, sun, ld, misc, gauss), d, wl)
        if pdf_detached:
            ctx.mark_non_differentiable(pdf)
        ctx.pdf_detached = pdf_detached
        ctx.save_for_backward(d, wl, skyp, skyr, sun, ld, misc, gauss)
        return rad, pdf

    @staticmethod
    def backward(ctx, g_rad, g_pdf):
        dd, dwl, *dtables = _hit_spec_adjoint(
            ctx, g_rad, None if ctx.pdf_detached else g_pdf,
            *ctx.needs_input_grad[1:3])
        if ctx.pdf_detached:
            dtables[5] = None
        return (None, dd, dwl, *dtables)


class _NeeSpec(torch.autograd.Function):
    """K11 forward (the direction non-differentiable: sample placement);
    backward K13, with the pdf unless it is detached (non-differentiable)."""

    @staticmethod
    def forward(ctx, pdf_detached, u2, wl, skyp, skyr, sun, ld, misc, gauss):
        d, rad, pdf = launch_nee_spec(
            SpecTables(skyp, skyr, sun, ld, misc, gauss), u2, wl)
        ctx.mark_non_differentiable(*((d, pdf) if pdf_detached else (d,)))
        ctx.pdf_detached = pdf_detached
        ctx.save_for_backward(u2, wl, skyp, skyr, sun, ld, misc, gauss)
        return d, rad, pdf

    @staticmethod
    def backward(ctx, _g_d, g_rad, g_pdf):
        u2, wl, *tables = ctx.saved_tensors
        dwl, *dtables = launch_nee_spec_bwd(
            SpecTables(*tables), u2, wl, _f32(g_rad),
            None if ctx.pdf_detached else _f32(g_pdf),
            want_dwl=ctx.needs_input_grad[2])
        build.launches["sunsky_nee_spec_bwd"] += 1
        if ctx.pdf_detached:
            dtables[5] = None
        return (None, None, dwl, *dtables)


def _spec_tables(state, lanes, cols, wl, name, pdf_attached=False):
    """Validate the lanes and wavelengths; pack the tables."""
    check_lanes(lanes, cols, name)
    _check_wavelengths(wl, lanes.shape[0], name)
    return pack_tables_spec(state, lanes.device, pdf_attached)


def sunsky_eval_spec(state, d, wl):
    """K9: spectral radiance toward local directions d (N, 3) at
    wavelengths wl (N, W) in nm -> (N, W); under autograd K12 (without
    the pdf) backward."""
    if d.device.type == "cpu":
        return M._eval_spec_plain(state, d, wl)
    tables = _spec_tables(state, d, 3, wl, "sunsky_eval_spec")
    out = _EvalSpec.apply(d, wl, *tables)
    build.launches["sunsky_eval_spec"] += 1
    return out


def sunsky_hit_spec(state, d, wl, pdf_detached: bool = False):
    """K10: (spectral radiance (N, W), pdf (N,)) toward local directions
    d (N, 3) at wavelengths wl (N, W); under autograd K12, with the pdf
    unless pdf_detached."""
    if d.device.type == "cpu":
        return M._hit_spec_plain(state, d, wl)
    tables = _spec_tables(state, d, 3, wl, "sunsky_hit_spec",
                          not pdf_detached)
    out = _HitSpec.apply(pdf_detached, d, wl, *tables)
    build.launches["sunsky_hit_spec"] += 1
    return out


def sunsky_nee_spec(state, u2, wl, pdf_detached: bool = False):
    """K11: uniforms u2 (N, 2), wavelengths wl (N, W) -> (direction
    (N, 3), spectral radiance (N, W), pdf (N,)); under autograd K13, with
    the pdf unless pdf_detached. The direction carries no gradient."""
    if u2.device.type == "cpu":
        return M._sample_eval_spec_plain(state, u2, wl)
    tables = _spec_tables(state, u2, 2, wl, "sunsky_nee_spec",
                          not pdf_detached)
    out = _NeeSpec.apply(pdf_detached, u2, wl, *tables)
    build.launches["sunsky_nee_spec"] += 1
    return out
