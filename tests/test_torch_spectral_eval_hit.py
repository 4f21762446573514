"""K9's and K10's plain versions against the JAX package's jnp path and its
Pallas kernels in interpret mode (moved unchanged from
tests/test_torch_spectral.py; shared code in `torch_spectral_case.py`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compiles add nothing
to the wall.
"""

import torch

from torch_spectral_case import (  # noqa: F401 (tests, fixtures)
    jax_precompute, states, test_eval_and_hit_spec_match_jax)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)
