"""The port's spectral distributions (ops/distr.py: continuous and
irregular) and the spectral state's wavelength sampling against the
JAX package's.

Both run on the CPU from the same numpy-seeded inputs (split from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).
At most 3 items, so that pytest-xdist's `--dist loadfile` hands this file
out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky_torch as tt
from tpusky.models.sunsky import model as JM
from tpusky.ops import distr as JD

from tpusky_torch.ops import distr as TD

from torch_spectral_case import (  # noqa: F401 (shared names, fixtures)
    _rel, jax_precompute, states)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_continuous_distribution_matches_jax():
    values = np.random.default_rng(2).uniform(0.2, 3.0, 10).astype(
        np.float32)
    values[4] = values[5]                      # a flat segment (dy == 0)
    jd = JD.make_continuous(jnp.asarray(values), 360.0, 720.0)
    td = TD.make_continuous(torch.tensor(values), 360.0, 720.0)
    for f in TD.ContinuousDistribution._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6)
    u = np.random.default_rng(3).random(4096, dtype=np.float32)
    pos_j, pdf_j = jax.jit(JD.continuous_sample_pdf)(jd, u)
    pos_t, pdf_t = TD.continuous_sample_pdf(td, torch.tensor(u))
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-5)
    x = np.linspace(340.0, 740.0, 801, dtype=np.float32)
    np.testing.assert_allclose(
        TD.continuous_pdf(td, torch.tensor(x)).numpy(),
        np.asarray(jax.jit(JD.continuous_pdf)(jd, x)), rtol=1e-5, atol=1e-9)
    # the sampled positions follow the density
    assert _rel(pdf_t, TD.continuous_pdf(td, pos_t).numpy(), 1e-6).max() \
        <= 1e-4


def test_irregular_distribution_matches_jax():
    nodes = np.array([360.0, 380.0, 430.0, 500.0, 520.0, 610.0, 700.0,
                      830.0], np.float32)
    values = np.random.default_rng(4).uniform(0.0, 2.0, 8).astype(np.float32)
    jd = JD.make_irregular(jnp.asarray(nodes), jnp.asarray(values))
    td = TD.make_irregular(torch.tensor(nodes), torch.tensor(values))
    for f in TD.IrregularContinuousDistribution._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6)
    x = np.linspace(340.0, 850.0, 1021, dtype=np.float32)
    np.testing.assert_allclose(
        TD.irregular_eval(td, torch.tensor(x)).numpy(),
        np.asarray(jax.jit(JD.irregular_eval)(jd, x)), rtol=1e-6, atol=1e-7)


def test_sample_wavelengths_matches_jax(states):
    js, st = states
    u = np.random.default_rng(5).random(4096, dtype=np.float32)
    wl_j, pdf_j = jax.jit(JM.sample_wavelengths)(js, u)
    wl_t, pdf_t = tt.sample_wavelengths(st, torch.tensor(u))
    np.testing.assert_allclose(wl_t.numpy(), np.asarray(wl_j), rtol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-4)
