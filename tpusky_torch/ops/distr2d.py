"""2-D sampling distributions over the unit square (`tpusky/ops/distr2d.py`;
reference `include/mitsuba/core/distr_2d.h`).

- `Marginal2D` (`distr_2d.h:838`): the row marginal, then the row's
  conditional, each an inverse CDF over patch-constant cells.
- `Hierarchical2D` (`distr_2d.h:344`): a mip pyramid descended one level
  a step, picking one of four children by mass and reusing the uniform.
- `Bilinear2D`: a density bilinear between the vertices of an
  (H+1, W+1) grid, sampled in closed form (the envmap's warp).

Each has `*_sample(d, u) -> (xy, pdf)` and `*_pdf(d, xy)`.

The reference picks a column by counting, over a whole row, the CDF
entries below the uniform; for `Bilinear2D` it materialises the lerp of
two rows' CDFs as an (N, W+1) array, in chunks of 8,192 lanes. Here a
column is found by bisection instead, log2(W) steps of two gathers each,
with no chunks: it compares the same values, and on a monotone row a
bisection returns exactly the count. The rows are monotone: a CDF is a
running sum of non-negative terms, and `(1 - t) * a0 + t * a1` with t
and `1 - t` in [0, 1] rounds monotonically in a0 and a1 (each product
and the sum are correctly rounded, so an order between inputs survives
them), so the lerped row is monotone too.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["Marginal2D", "make_marginal_2d", "marginal_sample",
           "marginal_pdf", "Hierarchical2D", "make_hierarchical_2d",
           "hierarchical_sample", "hierarchical_pdf", "Bilinear2D",
           "make_bilinear_2d", "bilinear_sample", "bilinear_pdf"]


def _bisect(at, n, below, x):
    """The number of k in [0, n) with at(k) below x (`below(a, x)` a
    strict or non-strict comparison), for rows at(k) that are monotone
    in k, by bisection: ceil(log2(n + 1)) steps of one `at` each."""
    lo = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    hi = torch.full(x.shape, n, dtype=torch.int64, device=x.device)
    for _ in range(int(n).bit_length()):
        mid = (lo + hi) >> 1
        active = lo < hi
        pred = below(at(mid.clamp(max=n - 1)), x)
        lo = torch.where(active & pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    return lo


def _cell(xy, h, w):
    """The (row, col) cell of points xy (..., 2) on an (h, w) grid."""
    col = (xy[..., 0] * w).to(torch.int64).clamp(0, w - 1)
    row = (xy[..., 1] * h).to(torch.int64).clamp(0, h - 1)
    return row, col


# ---------------------------------------------------------------------------
# Marginal2D
# ---------------------------------------------------------------------------

class Marginal2D(NamedTuple):
    density: torch.Tensor   # (H, W) nonnegative cell densities (normalized)
    row_cdf: torch.Tensor   # (H,) inclusive prefix of row masses
    cond_cdf: torch.Tensor  # (H, W) per-row inclusive prefix


def make_marginal_2d(values, device="cuda") -> Marginal2D:
    """values: (H, W) nonnegative on the host, normalised so the pdf
    integrates to 1 over [0, 1]^2."""
    v = torch.tensor(np.asarray(values, np.float32), device=device)
    h, w = v.shape
    density = v * (h * w / v.sum().clamp(min=1e-30))
    cond = torch.cumsum(v, 1)
    rows = torch.cumsum(cond[:, -1], 0)
    return Marginal2D(density, rows / rows[-1].clamp(min=1e-30),
                      cond / cond[:, -1:].clamp(min=1e-30))


def marginal_sample(d: Marginal2D, u):
    """u: (..., 2) uniforms -> (xy in [0, 1]^2, pdf): the row marginal's
    inverse CDF, then the row's conditional's."""
    h, w = d.density.shape
    u1, u2 = u[..., 0], u[..., 1]
    row = torch.searchsorted(d.row_cdf, u1.contiguous(),
                             right=True).clamp(0, h - 1)
    row_lo = torch.where(row > 0, d.row_cdf[(row - 1).clamp(min=0)], 0.0)
    row_mass = (d.row_cdf[row] - row_lo).clamp(min=1e-30)
    y = (row + ((u1 - row_lo) / row_mass).clamp(0.0, 1.0)) / h

    flat = d.cond_cdf.reshape(-1)
    base = row * w
    col = _bisect(lambda k: flat[base + k], w, torch.lt, u2).clamp(0, w - 1)
    col_lo = torch.where(col > 0, flat[base + (col - 1).clamp(min=0)], 0.0)
    col_mass = (flat[base + col] - col_lo).clamp(min=1e-30)
    x = (col + ((u2 - col_lo) / col_mass).clamp(0.0, 1.0)) / w
    xy = torch.stack([x, y], -1)
    return xy, marginal_pdf(d, xy)


def marginal_pdf(d: Marginal2D, xy):
    row, col = _cell(xy, *d.density.shape)
    return d.density[row, col]


# ---------------------------------------------------------------------------
# Hierarchical2D
# ---------------------------------------------------------------------------

class Hierarchical2D(NamedTuple):
    # pyramid[0] is the full-resolution mass, pyramid[k] sums the 2x2
    # blocks of pyramid[k-1], down to 1x1
    pyramid: tuple          # (h_k, w_k) tensors, fine -> coarse
    density: torch.Tensor   # (H, W) normalized pdf over [0, 1]^2


def make_hierarchical_2d(values, device="cuda") -> Hierarchical2D:
    """values: (H, W) with H and W powers of two (`distr_2d.h:344` pads
    to them too); the pyramid is summed in float64 on the host."""
    v = np.asarray(values, np.float64)
    h, w = v.shape
    if h & (h - 1) or w & (w - 1):
        raise ValueError("Hierarchical2D needs power-of-two dimensions")

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    density = f32(v * (h * w / max(v.sum(), 1e-30)))
    levels = [f32(v)]
    cur = v
    while cur.shape[0] > 1 or cur.shape[1] > 1:
        hh = max(cur.shape[0] // 2, 1)
        ww = max(cur.shape[1] // 2, 1)
        cur = cur.reshape(hh, cur.shape[0] // hh, ww,
                          cur.shape[1] // ww).sum(axis=(1, 3))
        levels.append(f32(cur))
    return Hierarchical2D(tuple(levels), density)


def hierarchical_sample(h2d: Hierarchical2D, u):
    """Descend the pyramid from 1x1 to full resolution: at each level pick
    a row half, then a column half, proportionally to their mass, and
    rescale the uniform (sample reuse, `distr_2d.h:430-520`)."""
    u1, u2 = u[..., 0], u[..., 1]
    row = torch.zeros(u1.shape, dtype=torch.int64, device=u.device)
    col = torch.zeros_like(row)
    for level in h2d.pyramid[-2::-1]:
        hh, ww = level.shape
        row = row * (2 if hh > 1 else 1)
        col = col * (2 if ww > 1 else 1)
        r1 = (row + (1 if hh > 1 else 0)).clamp(max=hh - 1)
        c1 = (col + (1 if ww > 1 else 0)).clamp(max=ww - 1)
        v00, v01 = level[row, col], level[row, c1]
        v10, v11 = level[r1, col], level[r1, c1]
        top = v00 + v01
        bot = v10 + v11
        p_top = top / (top + bot).clamp(min=1e-30)
        go_bot = u1 >= p_top
        u1 = torch.where(go_bot, (u1 - p_top) / (1.0 - p_top).clamp(min=1e-30),
                         u1 / p_top.clamp(min=1e-30)).clamp(0.0, 1.0 - 1e-7)
        row = torch.where(go_bot, r1, row)
        left = torch.where(go_bot, v10, v00)
        right = torch.where(go_bot, v11, v01)
        p_left = left / (left + right).clamp(min=1e-30)
        go_right = u2 >= p_left
        u2 = torch.where(go_right,
                         (u2 - p_left) / (1.0 - p_left).clamp(min=1e-30),
                         u2 / p_left.clamp(min=1e-30)).clamp(0.0, 1.0 - 1e-7)
        col = torch.where(go_right, c1, col)
    h, w = h2d.density.shape
    xy = torch.stack([(col + u2) / w, (row + u1) / h], -1)
    return xy, hierarchical_pdf(h2d, xy)


def hierarchical_pdf(h2d: Hierarchical2D, xy):
    row, col = _cell(xy, *h2d.density.shape)
    return h2d.density[row, col]


# ---------------------------------------------------------------------------
# Bilinear2D: a density bilinear between grid vertices (the envmap's warp,
# the counterpart of the reference's bilinear Hierarchical2D<0>,
# `envmap.cpp:103,:233`)
# ---------------------------------------------------------------------------


class Bilinear2D(NamedTuple):
    """Continuous density over [0, 1]^2, bilinear between the vertices of
    an (H+1, W+1) grid. The band of rows i..i+1 is linear in v, so its
    marginal inverts as a quadratic; the conditional CDF in u of a lerp of
    two vertex rows is the lerp of their CDFs, so it needs only the two
    bounding rows' prefix tables."""
    vtx: torch.Tensor       # (H+1, W+1) vertex densities (>= 0)
    colcdf: torch.Tensor    # (H+1, W+1) per-row trapezoid prefix over u
    row_edge: torch.Tensor  # (H+1,) = colcdf[:, -1]
    row_cdf: torch.Tensor   # (H,) inclusive prefix of band masses


def make_bilinear_2d(vertices, device="cuda") -> Bilinear2D:
    """vertices: (H+1, W+1) densities; a tensor stays on its own device."""
    if isinstance(vertices, torch.Tensor):
        v = vertices.float()
    else:
        v = torch.tensor(np.asarray(vertices, np.float32), device=device)
    v = v.clamp(min=1e-12)
    seg = 0.5 * (v[:, :-1] + v[:, 1:])                  # (H+1, W)
    colcdf = torch.cat([torch.zeros_like(v[:, :1]), torch.cumsum(seg, 1)], 1)
    row_edge = colcdf[:, -1]
    band = 0.5 * (row_edge[:-1] + row_edge[1:])         # (H,)
    return Bilinear2D(v, colcdf, row_edge, torch.cumsum(band, 0))


def _inv_linear_cdf(b, slope2, rho):
    """Solve b t + slope2 t^2 = rho for t in [0, 1] (b >= 0, stable)."""
    disc = (b * b + 4.0 * slope2 * rho).clamp(min=0.0)
    denom = b + torch.sqrt(disc)
    return (2.0 * rho / denom.clamp(min=1e-30)).clamp(0.0, 1.0)


def _bilinear_cells(d: Bilinear2D, u2):
    """The lanes' band i and its fraction t, and column j of the lerped
    conditional CDF, for uniforms u2 (N, 2) -> (i, t, j, xi2, rt):
    `j` is the reference's count of lerped CDF entries <= xi2, minus 1,
    clipped to [0, W-1]."""
    h = d.row_cdf.shape[0]
    w = d.vtx.shape[1] - 1
    total = d.row_cdf[-1]
    xi1 = u2[:, 0] * total
    i = torch.searchsorted(d.row_cdf, xi1.contiguous(),
                           right=True).clamp(0, h - 1)
    lo = torch.where(i > 0, d.row_cdf[(i - 1).clamp(min=0)], 0.0)
    rho = (xi1 - lo).clamp(min=0.0)
    r0 = d.row_edge[i]
    r1 = d.row_edge[i + 1]
    t = _inv_linear_cdf(r0, 0.5 * (r1 - r0), rho)
    rt = ((1.0 - t) * r0 + t * r1).clamp(min=1e-30)
    xi2 = u2[:, 1] * rt
    flat = d.colcdf.reshape(-1)
    base0, base1 = i * (w + 1), (i + 1) * (w + 1)

    def lerped(k):
        return (1.0 - t) * flat[base0 + k] + t * flat[base1 + k]
    j = (_bisect(lerped, w + 1, torch.le, xi2) - 1).clamp(0, w - 1)
    return i, t, j, xi2, lerped(j)


def bilinear_sample(d: Bilinear2D, u2):
    """u2 (..., 2) uniform -> (xy (..., 2), pdf_uv (...,)). The reference's
    `chunk` argument bounds its (chunk, W+1) scan; the bisection here
    holds a few values a lane and needs none."""
    batch = u2.shape[:-1]
    flat_u = u2.reshape(-1, 2)
    h = d.row_cdf.shape[0]
    w = d.vtx.shape[1] - 1
    i, t, j, xi2, a_lo = _bilinear_cells(d, flat_u)
    v_out = (i.float() + t) / h
    rho2 = (xi2 - a_lo).clamp(min=0.0)
    vflat = d.vtx.reshape(-1)
    v00 = vflat[i * (w + 1) + j]
    v01 = vflat[i * (w + 1) + j + 1]
    v10 = vflat[(i + 1) * (w + 1) + j]
    v11 = vflat[(i + 1) * (w + 1) + j + 1]
    d0 = (1.0 - t) * v00 + t * v10
    d1 = (1.0 - t) * v01 + t * v11
    s = _inv_linear_cdf(d0, 0.5 * (d1 - d0), rho2)
    u_out = (j.float() + s) / w
    dens = (1.0 - s) * d0 + s * d1
    pdf = dens * (h * w) / d.row_cdf[-1].clamp(min=1e-30)
    return (torch.stack([u_out, v_out], -1).reshape(batch + (2,)),
            pdf.reshape(batch))


def bilinear_pdf(d: Bilinear2D, xy):
    """Continuous pdf over [0, 1]^2 at xy (..., 2)."""
    h = d.row_cdf.shape[0]
    w = d.vtx.shape[1] - 1
    x = xy[..., 0].clamp(0.0, 1.0) * w
    y = xy[..., 1].clamp(0.0, 1.0) * h
    j = x.to(torch.int64).clamp(0, w - 1)
    i = y.to(torch.int64).clamp(0, h - 1)
    s = x - j
    t = y - i
    flat = d.vtx.reshape(-1)
    v00 = flat[i * (w + 1) + j]
    v01 = flat[i * (w + 1) + j + 1]
    v10 = flat[(i + 1) * (w + 1) + j]
    v11 = flat[(i + 1) * (w + 1) + j + 1]
    dens = ((1 - t) * ((1 - s) * v00 + s * v01)
            + t * ((1 - s) * v10 + s * v11))
    return dens * (h * w) / d.row_cdf[-1].clamp(min=1e-30)
