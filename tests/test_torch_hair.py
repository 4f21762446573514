"""The port's hair BCSDF (kind 16, `tpusky_torch/render/bsdf.py`'s
`_hair_*`) against the JAX package on the CPU: `eval_pdf` and `sample`
lane by lane in both modes, the white furnace, and the chi-square test of
hair's and the measured BRDF's sampling against their pdfs.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.render import bsdf as JB
from tpusky.render import measured as JM

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import measured as TM
from tpusky_torch.utils.chi2 import BSDFAdapter

import torch_geometry_case as G

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
KINDS = [16, 0, 16, 17, 16]


def _table():
    """Hair rows of varied sigma_a, beta_m, beta_n, tilt and eta beside a
    diffuse and a measured row (so the hair lobe runs on other kinds'
    lanes too, through its input guard)."""
    rng = np.random.default_rng(5)
    m = len(KINDS)
    extras = np.zeros((m, 8), np.float32)
    extras[:, 0] = rng.uniform(0.2, 0.5, m)         # beta_n
    extras[:, 1] = rng.uniform(-4.0, 4.0, m)        # tilt, degrees
    return JB.make_material_table(
        kinds=KINDS, albedos=rng.uniform(0.0, 1.5, (m, 3)),
        spectral_albedos=rng.uniform(0.0, 1.5, (m, 11)),
        alphas=rng.uniform(0.2, 0.5, m), iors=rng.uniform(1.5, 1.6, m),
        extras=extras, twosided=[False, True, False, True, False],
        measured=JM.load_measured(G._synthetic_fields()))


def _rel(a, b, floor=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    r = np.abs(a - b) / np.maximum(np.abs(b), floor)
    return r.reshape(r.shape[0], -1).max(-1)


def test_hair_matches_jax():
    """`eval_pdf`'s value and pdf within 1e-4 relative (floor 1e-3) of the
    reference's, RGB and spectral, over the whole sphere, but on 0.1% of
    the lanes (within 1e-3 there: a direction grazing the cross-section,
    |w.z| ~ 1e-4, whose azimuth's atan2 rounds apart);
    `sample`'s direction, weight and pdf within 1e-4 but on at most 0.2%
    of the lanes: a residual-lobe lane draws its azimuth from u1's
    remainder over the lobe's small share, 2 pi (u1 - cdf) / a_3, which
    turns the cdf's last-bit differences into 1e-4 of azimuth. Those
    lanes' weight and pdf are held to the port's own `eval_pdf` at the
    port's direction instead (1e-4)."""
    jt = _table()
    tt = convert.material_table(jax.tree.map(np.asarray, jt), "cpu")
    rng = np.random.default_rng(6)

    def sphere():
        d = rng.normal(size=(N, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)
    wi, wo = sphere(), sphere()
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random((N,), dtype=np.float32)
    idx = np.arange(N) % len(KINDS)
    hair = np.asarray(KINDS)[idx] == 16
    kinds = JB.table_kinds(jt)
    for wl in (None, rng.uniform(380, 780, (N, 4)).astype(np.float32)):
        jwl = None if wl is None else jnp.asarray(wl)
        twl = None if wl is None else torch.tensor(wl)
        jv, jp = JB.eval_pdf(jt, jnp.asarray(idx), jnp.asarray(wi),
                             jnp.asarray(wo), jwl, kinds)
        tv, tp = TB.eval_pdf(tt, torch.tensor(idx), torch.tensor(wi),
                             torch.tensor(wo), twl)
        ev = np.maximum(_rel(tv, jv), _rel(tp, jp))
        assert ev.max() <= 1e-3 and (ev > 1e-4).mean() <= 1e-3, ev.max()
        assert float(np.asarray(jp)[hair].mean()) > 0.05
        jr = JB.sample(jt, jnp.asarray(idx), jnp.asarray(wi),
                       jnp.asarray(u2), jnp.asarray(u1), jwl, kinds)
        tr = TB.sample(tt, torch.tensor(idx), torch.tensor(wi),
                       torch.tensor(u2), torch.tensor(u1), twl)
        off = ((np.abs(tr[0].numpy() - np.asarray(jr[0])).max(-1) > 1e-4)
               | (_rel(tr[1], jr[1]) > 1e-4) | (_rel(tr[2], jr[2]) > 1e-4))
        assert off.mean() <= 2e-3 and hair[off].all(), off.sum()
        v2, p2 = TB.eval_pdf(tt, torch.tensor(idx), torch.tensor(wi), tr[0],
                             twl)
        live = tr[2].numpy() > 1e-3
        assert _rel(p2.numpy()[off & live], tr[2].numpy()[off & live],
                    ).max(initial=0.0) <= 1e-4
        w2 = (v2 / p2.clamp(min=1e-12)[..., None]).numpy()
        assert _rel(w2[off & live], tr[1].numpy()[off & live]).max(
            initial=0.0) <= 1e-4
        assert not tr[3].any()


def test_hair_white_furnace():
    """sigma_a = 0: the attenuation series sums to 1, so every sampled
    weight is 1 and their mean is 1 within 5e-3 (d'Eon's energy
    conservation; tests/test_hair.py)."""
    ex = np.zeros((1, 8), np.float32)
    ex[0, :2] = (0.3, 2.0)
    tt = TB.make_material_table(kinds=[16], albedos=[[0.0] * 3],
                                alphas=[0.3], iors=[1.55], extras=ex,
                                device="cpu")
    n = 200_000
    g = torch.Generator().manual_seed(0)
    u = torch.rand((n, 3), generator=g)
    wi = torch.tensor([0.4, 0.3, 0.866]).expand(n, 3)
    wi = wi / wi.norm(dim=-1, keepdim=True)
    _, w, pdf, _ = TB.sample(tt, torch.zeros(n, dtype=torch.long), wi,
                             u[:, :2], u[:, 2])
    live = pdf > 1e-9
    assert float(live.float().mean()) > 0.999
    assert abs(float(torch.where(live, w[:, 0], 0.0).mean()) - 1.0) <= 5e-3


def test_hair_and_measured_chi2():
    """The port's chi-square harness (`utils/chi2.py`, the reference's
    binning) on hair's sampling over the whole sphere and the measured
    BRDF's over the upper hemisphere, 200,000 samples each in 32x16
    cells: both pass at the 1% level (chip_smoke phase 23 runs both at
    N = 1e7 in the reference's 128x64 cells)."""
    ex = np.zeros((2, 8), np.float32)
    ex[0, :2] = (0.3, 2.0)
    tt = TB.make_material_table(
        kinds=[16, 17], albedos=[[0.2, 0.4, 0.8], [1.0] * 3],
        alphas=[0.3, 0.1], iors=[1.55, 1.5], extras=ex,
        measured=TM.load_measured(G._synthetic_fields(), device="cpu"),
        device="cpu")
    wi = np.asarray([0.4, 0.3, 0.866], np.float32)
    for row, cos_range in ((0, (-1.0, 1.0)), (1, (0.0, 1.0))):
        wi_r = wi if row == 0 else np.asarray([0.3, -0.1, 0.95], np.float32)
        p, ok, info = BSDFAdapter(tt, row, wi_r / np.linalg.norm(wi_r)).run(
            seed=row, cos_range=cos_range, sample_count=200_000,
            res_phi=32, res_cos=16)
        assert ok, (row, p, info)
