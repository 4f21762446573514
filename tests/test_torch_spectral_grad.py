"""Spectral gradients of the port (`tpusky_torch`) against the JAX package:
K12's plain adjoint against jax.vjp of the jnp path.

Both run on the CPU from the same numpy-seeded inputs and cotangents (the
case and the tests in `torch_spectral_grad_case.py`); the port takes
torch autograd through its plain versions, which is what CPU tensors run
and what the CUDA kernels K12 and K13 are held against on the card
(chip_smoke.py). K12 against its Pallas adjoint and K13's tests are in
`test_torch_spectral_grad_{hit_pallas,nee,nee_pallas}.py`.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compile adds nothing
to the wall.
"""

import pytest
import torch

from torch_spectral_grad_case import (  # noqa: F401 (tests, fixtures)
    SUN, _rel_max, build_jax_refs, case, jax_tables,
    test_hit_spec_adjoint_plain_matches_jax_vjp)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_refs(case):
    return build_jax_refs(case, "hit", 0)
