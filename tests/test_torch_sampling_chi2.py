"""The port's chi-square harness (`tpusky_torch.utils.chi2`) on the
sunsky's plain sampler, on the CPU.

`sample_direction` against `pdf_direction` at N = 1e6 over 64 x 128 cells
of the cropped sphere (the reference's `CroppedSphericalDomain`,
SIN_OFFSET = 0.00775), for a sky-only state and a sun+sky state with the
reference's widened 30-degree aperture (`tests/test_sampling.py`); the
same harness must reject a pdf skewed by (1 + 0.2 cos(theta)); and the
harness against the reference's `tpusky.utils.chi2.chi2_test` on the same
direction batches and an analytic pdf. The reference-scale runs (N = 1e8, 430 x 215 cells) go through kernels K3
and K2 on the card, in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tpusky_torch as tt
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.utils.chi2 import chi2_sf, chi2_test, spherical_to_point

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SIN_OFFSET = 0.00775
COS_RANGE = (0.0, float(np.sqrt(1 - SIN_OFFSET ** 2)))


def _state(turb, sun_theta_deg, sun_scale, aperture_deg=None):
    th, ph = np.deg2rad(sun_theta_deg), -4 * np.pi / 5
    kw = {} if aperture_deg is None else {"sun_aperture_deg": aperture_deg}
    return tt.sunsky_precompute(tt.make_params(
        turbidity=turb, albedo=0.5,
        sun_direction=[np.cos(ph) * np.sin(th), np.sin(ph) * np.sin(th),
                       np.cos(th)], sun_scale=sun_scale, device="cpu", **kw))


_STATES = {
    "sky_t2.2_theta50": lambda: _state(2.2, 50, 0.0),
    "sunsky_t6.0_aperture30": lambda: _state(6.0, 50, 1.0, 30.0),
}
# (state, {batch seed: directions}) by name: the sampler runs once for the
# sampler's test and the skewed pdf's
_CACHE = {}


def _run(name, skew=0.0):
    if name not in _CACHE:
        _CACHE[name] = (_STATES[name](), {})
    state, dirs = _CACHE[name]

    def sample_fn(batch_seed, n):
        if batch_seed not in dirs:
            u = torch.rand(n, 2, generator=torch.Generator().manual_seed(
                batch_seed))
            dirs[batch_seed] = TM.sample_direction(state, u)[0]
        return dirs[batch_seed]

    def pdf_fn(d):
        return TM.pdf_direction(state, d) * (1.0 + skew * d[..., 2])

    return chi2_test(sample_fn, pdf_fn, seed=0, sample_count=1_000_000,
                     res_phi=128, res_cos=64, cos_range=COS_RANGE, ires=8,
                     batch=250_000)


@pytest.mark.parametrize("name", sorted(_STATES))
def test_plain_sampler_passes_chi2(name):
    p, ok, info = _run(name)
    assert ok and p >= 0.01, f"p={p:.4g} {info}"
    assert abs(info["integral"] + info["miss_frac"] - 1.0) < 2e-3, info


@pytest.mark.parametrize("name", sorted(_STATES))
def test_chi2_rejects_a_skewed_pdf(name):
    """The harness has power: a pdf off by (1 + 0.2 cos(theta)) fails."""
    p, ok, info = _run(name, skew=0.2)
    assert not ok and p < 0.01, f"p={p:.4g} {info}"


def _lobe_batches(n_batches, n, seed):
    """Float32 directions: 90% from a cosine lobe modulated by
    (1 + 0.5 cos(phi)), 10% uniform over the sphere (below the domain
    too), with the binning's edge cases at the head of batch 0: phi at
    +pi and -pi, the cos range's ends, the cropped pole."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        m = int((rng.random(n) < 0.9).sum())
        phi = np.empty(0)
        while phi.size < m:
            p = rng.uniform(-np.pi, np.pi, 2 * m)
            keep = rng.random(2 * m) * 1.5 < 1.0 + 0.5 * np.cos(p)
            phi = np.concatenate([phi, p[keep]])
        ct = np.concatenate([np.sqrt(rng.random(m)),
                             rng.uniform(-1.0, 1.0, n - m)])
        phi = np.concatenate([phi[:m], rng.uniform(-np.pi, np.pi, n - m)])
        st = np.sqrt(1.0 - ct * ct)
        d = np.stack([np.cos(phi) * st, np.sin(phi) * st, ct], -1)
        out.append(d[rng.permutation(n)].astype(np.float32))
    hi = np.float32(COS_RANGE[1])
    s = np.float32(np.sqrt(1.0 - hi * hi))
    out[0][:6] = [[-1, 0, 0], [-1, -0.0, 0], [1, 0, 0], [s, 0, hi],
                  [0, s, hi], [0, 0, 1]]
    return out


def _lobe_pdf(d, xp):
    """The batches' solid-angle pdf, in jnp or torch (the same float32
    operations)."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    cphi = x / xp.sqrt(x * x + y * y)
    lobe = xp.where(z > 0, z * (1 + 0.5 * cphi) / np.float32(np.pi), 0)
    return np.float32(0.9) * lobe + np.float32(0.1 / (4 * np.pi))


def test_chi2_matches_the_reference_harness():
    """The port's harness and `tpusky.utils.chi2.chi2_test` on the same
    four batches of 5,000 directions and the same analytic pdf, over
    16 x 32 cells (those near the horizon expect fewer than 5 and are
    pooled): the pooled cell count, dof and outside count exactly, the
    statistic and the integral within 1e-9 relative, p within 1e-8."""
    pytest.importorskip("scipy")
    from tpusky.utils.chi2 import chi2_test as chi2_ref
    nb, n = 4, 5000
    batches = _lobe_batches(nb, n, seed=7)
    calls = []

    def sample_ref(key, m):         # the reference folds the batch index
        calls.append(key)           # into a key: count the calls instead
        return jnp.asarray(batches[len(calls) - 1][:m])

    kw = dict(sample_count=nb * n, res_phi=32, res_cos=16,
              cos_range=COS_RANGE, ires=4, batch=n)
    # eager jnp: op by op, the same float32 roundings as torch's (a jit
    # may fuse the pdf's arithmetic differently)
    p_ref, ok_ref, ref = chi2_ref(sample_ref, lambda d: _lobe_pdf(d, jnp),
                                  key=jax.random.PRNGKey(0), **kw)
    p, ok, got = chi2_test(
        lambda s, m: torch.from_numpy(batches[s % 65536][:m]),
        lambda d: _lobe_pdf(d, torch), seed=0, **kw)
    assert len(calls) == nb
    assert ref["cells"] < 16 * 32 and ref["miss_frac"] > 0.0
    assert (got["cells"], got["dof"]) == (ref["cells"], ref["dof"])
    assert got["miss_frac"] == ref["miss_frac"]
    assert abs(got["stat"] - ref["stat"]) <= 1e-9 * ref["stat"]
    assert abs(got["integral"] - ref["integral"]) <= 1e-9 * ref["integral"]
    assert abs(p - p_ref) <= 1e-8 and ok == ok_ref


def test_p_value_matches_scipy():
    """The survival function through `torch.special.gammaincc` against
    scipy's, from one degree of freedom to the reference scale's ~90,000
    cells, in the tails and about the mean."""
    chi2 = pytest.importorskip("scipy.stats").chi2
    for dof in (1, 7, 60, 900, 8191, 92449):
        for q in (0.5, 0.9, 1.0, 1.01, 1.05, 1.2):
            stat = dof * q
            ref = chi2.sf(stat, dof)
            assert abs(chi2_sf(stat, dof) - ref) <= 1e-8 * max(ref, 1e-12)


def test_spherical_to_point():
    d = torch.tensor([[1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.6, 0.0, 0.8]])
    pt = spherical_to_point(d)
    assert torch.allclose(pt, torch.tensor([[0.0, 0.0],
                                            [-np.pi / 2, 0.0],
                                            [0.0, 0.8]]))
