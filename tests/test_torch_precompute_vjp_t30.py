"""The RGB precompute's VJP of the port against jax.vjp at turbidity 3.0
and 3.8 (`torch_grad_case.check_precompute_vjp`; moved unchanged from
tests/test_torch_grad.py). Both turbidities run in this one file, so that
the reference's jitted pullback compiles once and the aperture's
op-by-op path compiles its operations once.

Four items, as many as tests/test_multihost.py, which is collected first:
pytest-xdist's `--dist loadfile` hands this file out right after it, and
its JAX compile adds nothing to the wall.
"""

import pytest
import torch

from torch_grad_case import (  # noqa: F401 (fixtures)
    PRECOMPUTE_SUNS, build_precompute_vjps, check_precompute_vjp, jax_tables,
    torch_tables)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_precompute_vjps(jax_tables):
    return build_precompute_vjps(jax_tables, (3.0, 3.8))


@pytest.mark.parametrize("sun", PRECOMPUTE_SUNS)
@pytest.mark.parametrize("turbidity", [3.0, 3.8])
def test_precompute_vjp_matches_jax(jax_precompute_vjps, torch_tables,
                                    turbidity, sun):
    """`torch_grad_case.check_precompute_vjp`."""
    check_precompute_vjp(jax_precompute_vjps, torch_tables, turbidity, sun)
