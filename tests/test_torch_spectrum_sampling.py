"""The port's ops/spectrum.py against the JAX package's: the hero-
wavelength sampling and its pdf.

Both run on the CPU from the same numpy-seeded inputs (split from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).
At most 3 items, so that pytest-xdist's `--dist loadfile` hands this file
out after tests/test_multihost.py.
"""

import pytest
import torch

from torch_spectral_case import SPECTRUM_GROUPS, spectrum_case

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.mark.parametrize("name", SPECTRUM_GROUPS["sampling"])
def test_spectrum_matches_jax(name):
    """Every function of ops/spectrum.py within 1e-5 of the JAX package's
    (relative to the output's largest magnitude) on wavelengths across
    and outside the CIE range."""
    spectrum_case(name)
