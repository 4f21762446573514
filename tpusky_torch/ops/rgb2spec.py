"""RGB -> smooth spectrum upsampling (Jakob & Hanika 2019;
`tpusky/ops/rgb2spec.py`, reference `src/render/srgb.cpp:14-38`).

The spectrum is a sigmoid over a quadratic polynomial in wavelength:

    S(lambda) = s(c0 x^2 + c1 x + c2),   s(t) = 1/2 + t / (2 sqrt(1 + t^2))

with x the wavelength normalised to [0, 1] over 360..830 nm. The three
coefficients are fitted so that S under D65 integrates (CIE 1931) back
to the RGB: on the host in float64 numpy (`fit_sigmoid_coeffs`, a
Levenberg-Marquardt solve, for bitmaps and materials at build time), or
on tensors (`fit_sigmoid_coeffs_torch`, for emitter rows inside a
render: 48 Levenberg-Marquardt iterations without autograd, then one
differentiable Newton step, so gradients reach the RGB). The device fit
makes no host-device synchronisation: a fixed iteration count, and
`torch.linalg.solve_ex`, which does not check for errors.

An emitter's coefficients are (c0, c1, c2, scale): the chroma fitted on
rgb / scale, scale = max(rgb, 1) (0 for a black row), and its spectrum
carries the normalised D65 illuminant (`eval_emitter_coeff_spectrum`).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np
import torch

from . import spectrum

_LAM_MIN, _LAM_MAX = 360.0, 830.0
_DATA_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "data",
                          "cie1931.npz")


@lru_cache(maxsize=None)
def _solver_tables():
    """(A, basis, lam), float64: rgb = A @ S(lam) for a reflectance S
    under D65; basis (N, 3) the polynomial's columns x^2, x, 1."""
    with np.load(_DATA_PATH) as z:
        wl = z["wavelengths"].astype(np.float64)
        xyz = np.stack([z["x"], z["y"], z["z"]], 0).astype(np.float64)
        d65 = z["d65"].astype(np.float64)
    lam = np.arange(_LAM_MIN, _LAM_MAX + 1e-6, 5.0)
    cmf = np.stack([np.interp(lam, wl, xyz[i]) for i in range(3)], 0)
    ill = np.interp(lam, wl, d65)
    # XYZ of a reflectance under D65, normalised so S = 1 gives Y = 1
    w = cmf * ill
    w /= (cmf[1] * ill).sum()
    m = np.array(spectrum.XYZ_TO_SRGB)
    x = (lam - _LAM_MIN) / (_LAM_MAX - _LAM_MIN)
    return m @ w, np.stack([x * x, x, np.ones_like(x)], -1), lam


def _sigmoid(t):
    return 0.5 + 0.5 * t / np.sqrt(1.0 + t * t)


def _dsigmoid(t):
    return 0.5 / (1.0 + t * t) ** 1.5


def fit_sigmoid_coeffs(rgb, iters: int = 64):
    """Fit (c0, c1, c2) per colour on the host (float64) so the sigmoid
    spectrum integrates (CMF x D65) back to `rgb` (..., 3) in [0, 1] ->
    (M, 3)."""
    a, basis, _ = _solver_tables()
    rgb = np.atleast_2d(np.asarray(rgb, np.float64))     # (M, 3)
    m = np.clip(rgb.mean(-1), 1e-4, 1.0 - 1e-4)
    t0 = (2.0 * m - 1.0) / np.sqrt(np.clip(1.0 - (2.0 * m - 1.0) ** 2,
                                           1e-12, None))
    c = np.zeros((rgb.shape[0], 3))
    c[:, 2] = t0                                         # a flat spectrum
    lm = np.full(rgb.shape[0], 1e-4)                     # the LM damping
    for _ in range(iters):
        p = c @ basis.T                                  # (M, N)
        r = _sigmoid(p) @ a.T - rgb                      # (M, 3) residual
        err = (r * r).sum(-1)
        jac = (a[None, :, :] * _dsigmoid(p)[:, None, :]) @ basis  # (M,3,3)
        jtj = np.einsum('mij,mik->mjk', jac, jac)
        jtr = np.einsum('mij,mi->mj', jac, r)
        jtj += lm[:, None, None] * np.eye(3)
        try:
            delta = np.linalg.solve(jtj, jtr[..., None])[..., 0]
        except np.linalg.LinAlgError:
            delta = np.linalg.lstsq(jtj.reshape(-1, 3),
                                    jtr.reshape(-1, 1), rcond=None)[0].T
        c_new = c - delta
        r_new = _sigmoid(c_new @ basis.T) @ a.T - rgb
        err_new = (r_new * r_new).sum(-1)
        improved = err_new <= err
        c = np.where(improved[:, None], c_new, c)
        lm = np.where(improved, lm * 0.5, lm * 4.0)
        if err_new.max() < 1e-16:
            break
    return c


def fit_sigmoid_coeffs_f64(rgb, iters: int = 64, chunk: int = 1 << 20):
    """`fit_sigmoid_coeffs` on a float64 tensor (M, 3) on its device ->
    (M, 3) float64: the host fit's rule step for step (a flat start,
    per-row Levenberg-Marquardt damping and accept test, `iters`
    iterations, the stop once every row's error is below 1e-16), over
    chunks of `chunk` rows, each with its own stop. For texture tables at
    build time: it reads the stop on the host once an iteration."""
    a_np, basis_np, _ = _solver_tables()
    a = torch.tensor(a_np, dtype=torch.float64, device=rgb.device)
    basis = torch.tensor(basis_np, dtype=torch.float64, device=rgb.device)
    eye = torch.eye(3, dtype=torch.float64, device=rgb.device)
    out = []
    for target in rgb.reshape(-1, 3).split(chunk):
        m = target.mean(-1).clamp(1e-4, 1.0 - 1e-4)
        t0 = (2.0 * m - 1.0) / torch.sqrt(
            (1.0 - (2.0 * m - 1.0) ** 2).clamp(min=1e-12))
        c = torch.cat([torch.zeros_like(target[:, :2]), t0[:, None]], -1)
        lm = torch.full_like(m, 1e-4)
        for _ in range(iters):
            p = c @ basis.T
            r = _sig(p) @ a.T - target
            err = (r * r).sum(-1)
            jac = (a[None] * _dsig(p)[:, None, :]) @ basis
            jtj = jac.transpose(1, 2) @ jac + lm[:, None, None] * eye
            jtr = (jac * r[..., None]).sum(1)
            c_new = c - torch.linalg.solve_ex(jtj, jtr[..., None])[0][..., 0]
            r_new = _sig(c_new @ basis.T) @ a.T - target
            err_new = (r_new * r_new).sum(-1)
            improved = err_new <= err
            c = torch.where(improved[:, None], c_new, c)
            lm = torch.where(improved, lm * 0.5, lm * 4.0)
            if bool(err_new.max() < 1e-16):
                break
        out.append(c)
    return torch.cat(out, 0) if out else rgb.new_zeros((0, 3))


def eval_sigmoid_spectrum(coeffs, wavelengths):
    """Fitted spectra (M, 3) at `wavelengths` (nm), on the host ->
    (M, W)."""
    coeffs = np.atleast_2d(coeffs)
    x = (np.asarray(wavelengths, np.float64) - _LAM_MIN) \
        / (_LAM_MAX - _LAM_MIN)
    return _sigmoid(coeffs @ np.stack([x * x, x, np.ones_like(x)], -1).T)


def upsample_rgb(rgb, wavelengths):
    """RGB (..., 3) -> spectrum at `wavelengths`, on the host. Values
    above 1 (emitters) fit their chroma on rgb / scale, scale =
    max(rgb, 1), and are scaled back."""
    rgb = np.atleast_2d(np.asarray(rgb, np.float64))
    scale = np.maximum(rgb.max(-1), 1.0)
    coeffs = fit_sigmoid_coeffs(rgb / scale[:, None])
    return eval_sigmoid_spectrum(coeffs, wavelengths) * scale[:, None]


def rgb_of_spectrum(spectrum_values, wavelengths):
    """Integrate a spectrum back to linear sRGB, on the host."""
    a, _, lam = _solver_tables()
    s = np.interp(lam, np.asarray(wavelengths, np.float64),
                  np.atleast_1d(np.asarray(spectrum_values, np.float64)))
    return a @ s


def emitter_coeffs(rgb):
    """Host fit of emitter rows (..., 3) -> (..., 4) float64 (c0, c1, c2,
    scale), as `fit_sigmoid_coeffs_torch` lays them out."""
    rgb = np.asarray(rgb, np.float64)
    flat = rgb.reshape(-1, 3)
    peak = flat.max(-1)
    scale = np.where(peak <= 0.0, 0.0, np.maximum(peak, 1.0))
    c3 = fit_sigmoid_coeffs(flat / np.where(scale > 0, scale, 1.0)[:, None])
    return np.concatenate([c3, scale[:, None]], -1).reshape(
        rgb.shape[:-1] + (4,))


def eval_coeff_spectrum(coeffs, wavelengths):
    """Sigmoid spectra of coefficients (..., 4) = (c0, c1, c2, scale) at
    wavelengths (..., W) nm -> (..., W)."""
    x = (wavelengths - _LAM_MIN) / (_LAM_MAX - _LAM_MIN)
    t = coeffs[..., 0:1] * x * x + coeffs[..., 1:2] * x + coeffs[..., 2:3]
    return (0.5 + 0.5 * t / torch.sqrt(1.0 + t * t)) * coeffs[..., 3:4]


def eval_emitter_coeff_spectrum(coeffs, wavelengths):
    """An emitter's spectrum: the reflectance fit times the normalised
    D65 illuminant (the reference's `srgb_d65` emitter convention), so
    that the spectrum integrates against the bare CMFs back to its
    RGB."""
    return eval_coeff_spectrum(coeffs, wavelengths) * spectrum.cie_d65(
        wavelengths)


@lru_cache(maxsize=None)
def _tables_on(device: torch.device):
    """(A (3, N), basis (N, 3)) float32 on a device (one copy each)."""
    a, basis, _ = _solver_tables()
    return (torch.tensor(a, dtype=torch.float32, device=device),
            torch.tensor(basis, dtype=torch.float32, device=device))


def _sig(t):
    return 0.5 + 0.5 * t / torch.sqrt(1.0 + t * t)


def _dsig(t):
    return 0.5 / (1.0 + t * t) ** 1.5


def _normal_equations(c, target, a, basis):
    """(J^T J, J^T r) of the residual sig(c basis^T) a^T - target."""
    p = c @ basis.T                                       # (M, N)
    r = _sig(p) @ a.T - target                            # (M, 3)
    jac = (a[None] * _dsig(p)[:, None, :]) @ basis        # (M, 3, 3)
    return jac.transpose(1, 2) @ jac, (jac * r[..., None]).sum(1)


def _solve3(m, v):
    """m^-1 v for (M, 3, 3) m and (M, 3) v, without an error check."""
    return torch.linalg.solve_ex(m, v[..., None])[0][..., 0]


def fit_sigmoid_coeffs_torch(rgb, iters: int = 48):
    """Fit emitter coefficients to RGB rows (..., 3) -> (..., 4) (c0, c1,
    c2, scale) for `eval_coeff_spectrum`, on the rows' device (the
    reference's `fit_sigmoid_coeffs_jnp`). Each row runs its own
    Levenberg-Marquardt damping and accept test; gradients reach `rgb`
    through one Newton step at the solution (implicit differentiation)."""
    a, basis = _tables_on(rgb.device)
    rgb2 = rgb.reshape(-1, 3).float()
    peak = rgb2.amax(-1)
    scale = torch.where(peak <= 0.0, 0.0, peak.clamp(min=1.0))
    tgt = rgb2 / torch.where(scale > 0.0, scale, 1.0)[:, None]
    eye = torch.eye(3, device=rgb.device)
    with torch.no_grad():
        target = tgt.detach()

        def err(cc):
            return ((_sig(cc @ basis.T) @ a.T - target) ** 2).sum(-1)
        m0 = target.mean(-1).clamp(1e-4, 1.0 - 1e-4)
        t0 = (2.0 * m0 - 1.0) / torch.sqrt(
            (1.0 - (2.0 * m0 - 1.0) ** 2).clamp(min=1e-12))
        c = torch.cat([torch.zeros_like(target[:, :2]), t0[:, None]], -1)
        lam = torch.full_like(m0, 1e-4)
        err_c = err(c)      # carried: err of the kept c, as recomputed
        for _ in range(iters):
            jtj, jtr = _normal_equations(c, target, a, basis)
            c_new = c - _solve3(jtj + lam[:, None, None] * eye, jtr)
            err_new = err(c_new)
            improved = err_new <= err_c
            c = torch.where(improved[:, None], c_new, c)
            err_c = torch.where(improved, err_new, err_c)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
    # one differentiable Newton step (the target attached)
    jtj, jtr = _normal_equations(c, tgt, a, basis)
    c = c - _solve3(jtj + 1e-9 * eye, jtr)
    return torch.cat([c, scale[:, None]], -1).reshape(rgb.shape[:-1] + (4,))


def upsample_rgb_torch(rgb, wavelengths, iters: int = 48):
    """`upsample_rgb` on tensors: RGB (..., 3) -> the emitter-fit
    spectrum (without the illuminant) at `wavelengths`."""
    return eval_coeff_spectrum(fit_sigmoid_coeffs_torch(rgb, iters),
                               wavelengths)
