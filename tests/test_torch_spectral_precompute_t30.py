"""The port's spectral precompute against the JAX package's at turbidity
3.0.

Both run on the CPU from the same numpy-seeded inputs (split from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).
At most 3 items, so that pytest-xdist's `--dist loadfile` hands this file
out after tests/test_multihost.py.
"""

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.ops import distr as TD

from torch_spectral_case import (  # noqa: F401 (shared names, fixtures)
    SUN, _STATE_FIELDS, jax_precompute)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.mark.parametrize("sun", [SUN, [0.8, -0.3, 0.2]])
@pytest.mark.parametrize("turbidity", [3.0])
def test_precompute_spectral_matches_jax(jax_precompute, turbidity, sun):
    """Every array of the spectral state, the sky/sun weight and the
    wavelength distribution within 1e-4 of JAX's, relative to the array's
    largest magnitude. Turbidity 3.0 sits on the lerp's kink. The state
    converted from JAX and the one the port precomputes agree."""
    albedo = np.linspace(0.1, 0.6, 11).astype(np.float32)
    js = jax_precompute(ts.make_params(turbidity=turbidity, albedo=albedo,
                                       sun_direction=sun, mode="spectral"))
    conv = convert.sunsky_state(jax.tree.map(np.asarray, js), device="cpu")
    st = TM.precompute(TT.load_tables("spectral", device="cpu"),
                       TM.make_params(turbidity=turbidity, albedo=albedo,
                                      sun_direction=sun, mode="spectral",
                                      device="cpu"), "spectral")
    assert tuple(st.params.albedo.shape) == (11,)
    pairs = [(getattr(st, f), getattr(conv, f), f) for f in _STATE_FIELDS]
    pairs += [(getattr(st.spectral_distr, f), getattr(conv.spectral_distr, f),
               f) for f in TD.ContinuousDistribution._fields]
    pairs += [(getattr(st.gaussian_distr, f), getattr(conv.gaussian_distr, f),
               f) for f in TD.DiscreteDistribution._fields]
    for a, b, f in pairs:
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), f
