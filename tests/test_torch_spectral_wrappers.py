"""K9-K11's wrappers on devices other than the CPU and the card, and the
spectral radiance's gradient on the CPU.

Both run on the CPU from the same numpy-seeded inputs (split from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).
At most 3 items, so that pytest-xdist's `--dist loadfile` hands this file
out after tests/test_multihost.py.
"""

import numpy as np
import pytest
import torch

from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.ops.cuda import sunsky_kernel as TK

from torch_spectral_case import (  # noqa: F401 (shared names, fixtures)
    _lanes, jax_precompute, states)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_spectral_wrappers_refuse_other_devices(states):
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, never routed to the plain version; a spectral call without
    wavelengths raises."""
    _, st = states
    wl = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_eval_spec(st, torch.empty((8, 3), device="meta"), wl)
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_nee_spec(st, torch.empty((8, 2), device="meta"), wl)
    with pytest.raises(ValueError, match="wavelengths"):
        TM.eval(st, torch.zeros(8, 3), mode="spectral")


def test_spectral_gradients_on_cpu_are_plain_autograd(states):
    """On the CPU the spectral radiance differentiates through its plain
    version (on the card, its adjoint K12; tests/test_torch_spectral_grad.py
    holds the plain adjoints against the JAX package)."""
    _, st = states
    d, wl = (torch.tensor(x) for x in _lanes(np.asarray(st.sun_frame_n), 4,
                                             8))
    skyp = st.sky_params.clone().requires_grad_()
    rad = TK.sunsky_eval_spec(st._replace(sky_params=skyp), d, wl)
    (g,) = torch.autograd.grad(rad.sum(), [skyp])
    assert torch.isfinite(g).all() and g.abs().max() > 0
