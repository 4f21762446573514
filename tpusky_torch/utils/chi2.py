"""Chi-square goodness-of-fit harness for sampling routines.

The PyTorch port's counterpart of `tpusky/utils/chi2.py` (reference
`mi.chi2`, `src/python/python/chi2.py`): `chi2_test` checks that a
`sample` routine and its claimed `pdf` agree, by histogramming N samples
over a spherical domain and comparing the counts with the pdf integrated
over each cell (Pearson chi-square with pooling of cells whose
expectation is below 5); `chi2_test_2d` does the same over the unit
square, and `EmitterAdapter` and `BSDFAdapter` wrap an environment's or
a material's sampling for `chi2_test`.

Domain parameterisation: (phi in [-pi, pi], cos_theta in [cos_lo,
cos_hi]); the area element in these coordinates is constant, so the
integrand is the solid-angle pdf alone.

The samples are binned on their own device (`torch.bincount`) and only
the counts come back to the host; the pdf is integrated on the same
device. The p-value is the regularised upper incomplete gamma function
(`torch.special.gammaincc`), the chi-square survival function.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def spherical_to_point(d):
    """direction (..., 3) -> (phi, cos_theta) (..., 2)."""
    return torch.stack([torch.atan2(d[..., 1], d[..., 0]), d[..., 2]], -1)


def _cell_index(d, res_phi, res_cos, cos_lo, cos_hi):
    """Flat cell index of each direction; res_phi * res_cos for one
    outside the cos range (the overflow bin)."""
    phi = torch.atan2(d[:, 1], d[:, 0])
    ct = d[:, 2]
    ix = (((phi + math.pi) / (2 * math.pi) * res_phi).to(torch.int64)
          .clamp(0, res_phi - 1))
    iy = (((ct - cos_lo) / (cos_hi - cos_lo) * res_cos).to(torch.int64)
          .clamp(0, res_cos - 1))
    inside = (ct >= cos_lo) & (ct <= cos_hi)
    return torch.where(inside, iy * res_phi + ix, res_cos * res_phi)


def _expected(pdf_fn, device, res_phi, res_cos, cos_lo, cos_hi, ires):
    """pdf integrated over each cell, (res_cos, res_phi) float64: the
    midpoint rule at `ires` x `ires` points a cell (the midpoints keep
    the solid-angle pdf's 1/sin(theta) spike at the cropped pole off the
    domain's boundary), in chunks of cell rows of <= 4M directions."""
    n_sub_p = res_phi * ires
    dphi = 2 * math.pi / n_sub_p
    dcos = (cos_hi - cos_lo) / (res_cos * ires)
    phi = -math.pi + (torch.arange(n_sub_p, dtype=torch.float64,
                                   device=device) + 0.5) * dphi
    cp, sp = torch.cos(phi), torch.sin(phi)
    rows = max(1, (1 << 22) // (ires * n_sub_p))
    out = []
    for r0 in range(0, res_cos, rows):
        r1 = min(r0 + rows, res_cos)
        sub = torch.arange(r0 * ires, r1 * ires, dtype=torch.float64,
                           device=device)
        cg = (cos_lo + (sub + 0.5) * dcos)[:, None]
        st = torch.sqrt((1.0 - cg * cg).clamp(min=0.0))
        dirs = torch.stack([cp[None, :] * st, sp[None, :] * st,
                            cg.expand(-1, n_sub_p)], -1)
        pv = pdf_fn(dirs.reshape(-1, 3).to(torch.float32).contiguous())
        out.append(pv.to(torch.float64).reshape(r1 - r0, ires, res_phi,
                                                ires).sum((1, 3)))
    return torch.cat(out, 0).cpu().numpy() * (dphi * dcos)


def _pooled(obs, exp):
    """Cells sorted by expectation and merged until each pool expects at
    least 5; a remainder joins the last pool."""
    order = np.argsort(exp)
    obs, exp = obs[order], exp[order]
    pooled_obs, pooled_exp = [], []
    acc_o = acc_e = 0.0
    for o, e in zip(obs, exp):
        acc_o += o
        acc_e += e
        if acc_e >= 5.0:
            pooled_obs.append(acc_o)
            pooled_exp.append(acc_e)
            acc_o = acc_e = 0.0
    if acc_e > 0:
        if pooled_exp:
            pooled_obs[-1] += acc_o
            pooled_exp[-1] += acc_e
        else:
            pooled_obs, pooled_exp = [acc_o], [acc_e]
    return np.asarray(pooled_obs), np.asarray(pooled_exp)


def chi2_sf(stat: float, dof: int) -> float:
    """Chi-square survival function: P(X >= stat) for dof degrees of
    freedom."""
    return float(torch.special.gammaincc(
        torch.tensor(dof / 2.0, dtype=torch.float64),
        torch.tensor(stat / 2.0, dtype=torch.float64)))


def chi2_test(sample_fn, pdf_fn, *, seed=0, sample_count=4_000_000,
              res_phi=128, res_cos=64, cos_range=(-1.0, 1.0), ires=8,
              batch=1_000_000, significance=0.01):
    """Run the chi-square test -> (p_value, passed, info dict).

    sample_fn(batch_seed, n) -> directions (n, 3) on any device, drawn
    from uniforms seeded by the integer `batch_seed` (`seed * 65536 + i`
    for batch i); pdf_fn(directions (m, 3) float32) -> (m,) solid-angle
    pdf on the samples' device. The histogram, the integration and the
    pooling are those of the reference's `chi2.py:100-239`.
    """
    cos_lo, cos_hi = cos_range
    n_cells = res_cos * res_phi
    counts = None
    n_done = bi = 0
    while n_done < sample_count:
        n = min(batch, sample_count - n_done)
        d = sample_fn(seed * 65536 + bi, n)
        flat = _cell_index(d, res_phi, res_cos, cos_lo, cos_hi)
        c = torch.bincount(flat, minlength=n_cells + 1)
        counts = c if counts is None else counts + c
        n_done += n
        bi += 1
    device = counts.device
    hist = counts.cpu().numpy()[:n_cells].reshape(res_cos, res_phi)
    n_outside = sample_count - int(hist.sum())

    expected = _expected(pdf_fn, device, res_phi, res_cos, cos_lo, cos_hi,
                         ires) * sample_count
    pooled_obs, pooled_exp = _pooled(hist.ravel().astype(np.float64),
                                     expected.ravel())
    stat = float(np.sum((pooled_obs - pooled_exp) ** 2 / pooled_exp))
    dof = len(pooled_exp) - 1
    p_value = chi2_sf(stat, dof)
    info = dict(stat=stat, dof=dof, cells=len(pooled_exp),
                integral=float(pooled_exp.sum()) / sample_count,
                miss_frac=n_outside / sample_count)
    return p_value, p_value >= significance, info


def chi2_test_2d(sample_fn, pdf_fn, *, seed=0, sample_count=2_000_000,
                 res_x=64, res_y=64, ires=8, batch=1_000_000,
                 significance=0.01):
    """Chi-square test of a distribution over the unit square (the
    reference's PlanarDomain path, `chi2.py:411-430`) -> (p_value,
    passed, info). sample_fn(batch_seed, n) -> points (n, 2) on any
    device, seeded as in `chi2_test`; pdf_fn(xy (m, 2) float32) -> (m,)
    density on the samples' device, integrated over each cell at ires x
    ires midpoints (`tpusky/utils/chi2.py:174-221`)."""
    n_cells = res_x * res_y
    counts = None
    n_done = bi = 0
    while n_done < sample_count:
        n = min(batch, sample_count - n_done)
        p = sample_fn(seed * 65536 + bi, n)
        ix = (p[:, 0] * res_x).to(torch.int64).clamp(0, res_x - 1)
        iy = (p[:, 1] * res_y).to(torch.int64).clamp(0, res_y - 1)
        c = torch.bincount(iy * res_x + ix, minlength=n_cells)
        counts = c if counts is None else counts + c
        n_done += n
        bi += 1
    device = counts.device
    fx = (torch.arange(res_x * ires, dtype=torch.float64, device=device)
          + 0.5) / (res_x * ires)
    fy = (torch.arange(res_y * ires, dtype=torch.float64, device=device)
          + 0.5) / (res_y * ires)
    pts = torch.stack([fx[None, :].expand(fy.shape[0], -1),
                       fy[:, None].expand(-1, fx.shape[0])], -1)
    dens = pdf_fn(pts.reshape(-1, 2).to(torch.float32)).cpu().numpy()
    # the cell means in float32, as the reference's numpy takes them
    cell = dens.reshape(res_y, ires, res_x, ires).mean(axis=(1, 3))
    expected = cell * (1.0 / (res_x * res_y)) * sample_count
    obs, exp = _pooled(counts.cpu().numpy().astype(np.float64),
                       expected.ravel())
    stat = float(np.sum((obs - exp) ** 2 / np.maximum(exp, 1e-9)))
    dof = len(exp) - 1
    p_value = chi2_sf(stat, max(dof, 1))
    return p_value, p_value >= significance, dict(stat=stat, dof=dof)


def _device_of(obj):
    """The device of the first tensor in a (nested) NamedTuple."""
    for v in obj:
        if isinstance(v, torch.Tensor):
            return v.device
        if isinstance(v, tuple):
            dev = _device_of(v)
            if dev is not None:
                return dev
    return None


def _uniforms(batch_seed, n, cols, device):
    return torch.rand(n, cols, device=device, generator=torch.Generator(
        device=device).manual_seed(batch_seed))


class EmitterAdapter:
    """`mi.chi2.EmitterAdapter` (`chi2.py:530`; `tpusky/utils/chi2.py:
    224-248`): an environment's (sample_direction, pdf_direction) pair
    for `chi2_test`, on the environment's device.

    Seeds: where the reference draws batch i from `fold_in(key, i)` of a
    JAX key, this draws it from a torch generator seeded with the integer
    `seed * 65536 + i` (`chi2_test`'s convention); `run(seed)` takes the
    reference's `run(key)` place."""

    def __init__(self, env, env_to_world=None):
        from ..render import emitters as em
        self._em = em
        self.env = env
        self.device = _device_of(env)
        self.env_to_world = (torch.eye(3, device=self.device)
                             if env_to_world is None else torch.as_tensor(
                                 env_to_world, dtype=torch.float32,
                                 device=self.device))

    def sample(self, batch_seed, n):
        u = _uniforms(batch_seed, n, 2, self.device)
        d, _, _ = self._em.env_sample_eval(self.env, self.env_to_world, u)
        return d

    def pdf(self, d):
        return self._em.env_pdf_direction(self.env, self.env_to_world, d)

    def run(self, seed=0, **kw):
        return chi2_test(self.sample, self.pdf, seed=seed, **kw)


class BSDFAdapter:
    """`mi.chi2.BSDFAdapter` (`chi2.py:477`; `tpusky/utils/chi2.py:
    250-282`): a fixed local wi and one material row's (sample, pdf) for
    `chi2_test`, on the table's device.

    Seeds as in `EmitterAdapter`: the batch's sample2 and sample1 are the
    columns of one (n, 3) draw, where the reference draws sample1 from
    `fold_in(key, 7)`. A sample of weight 0 (a microfacet sample the
    lobe rejects) or of a delta lobe (a mask's pass-through, the
    plastic's coat) comes back as NaN, which `chi2_test` counts outside
    the domain, so the histogram holds what `eval_pdf` describes and the
    pdf integrates to its share. Mitsuba's adapter drops the zero-weight
    samples the same way (its histogram weighs each sample by whether
    its weight is nonzero); the reference's keeps them, so its chi-square
    of a rough dielectric fails (p = 0 at N = 1e6)."""

    def __init__(self, bsdfs, mat_idx, wi, kinds=None):
        from ..render import bsdf as bsdf_mod
        self._bsdf = bsdf_mod
        self.bsdfs = bsdfs
        self.mat_idx = int(mat_idx)
        self.device = bsdfs.albedo.device
        self.wi = torch.as_tensor(wi, dtype=torch.float32,
                                  device=self.device)
        self.kinds = kinds or bsdf_mod.table_kinds(bsdfs)

    def _lanes(self, n):
        return (self.wi.expand(n, 3),
                torch.full((n,), self.mat_idx, dtype=torch.int64,
                           device=self.device))

    def sample(self, batch_seed, n):
        u = _uniforms(batch_seed, n, 3, self.device)
        wi, idx = self._lanes(n)
        wo, weight, _, is_delta = self._bsdf.sample(
            self.bsdfs, idx, wi, u[:, :2], u[:, 2], None, kinds=self.kinds)
        dropped = is_delta | (weight == 0.0).all(-1)
        return torch.where(dropped[:, None], torch.nan, wo)

    def pdf(self, wo):
        wi, idx = self._lanes(wo.shape[0])
        _, pdf = self._bsdf.eval_pdf(self.bsdfs, idx, wi, wo, None,
                                     kinds=self.kinds)
        return pdf

    def run(self, seed=0, cos_range=(0.0, 1.0), **kw):
        return chi2_test(self.sample, self.pdf, seed=seed,
                         cos_range=cos_range, **kw)
