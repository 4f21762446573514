"""K13's plain adjoint (the port's autograd) against the JAX package's jnp
VJP (moved unchanged from tests/test_torch_spectral_grad.py; shared code
in `torch_spectral_grad_case.py`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compile adds nothing
to the wall.
"""

import pytest
import torch

from torch_spectral_grad_case import (  # noqa: F401 (tests, fixtures)
    build_jax_refs, case, jax_tables,
    test_nee_spec_adjoint_plain_matches_jax_vjp)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_refs(case):
    return build_jax_refs(case, "nee", 0)
