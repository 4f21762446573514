"""K5's plain adjoint (the port's autograd) against the JAX package's
jnp VJP and its Pallas adjoint in interpret mode (moved unchanged from
tests/test_torch_grad.py; shared code in `torch_grad_case.py`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compile adds nothing
to the wall.
"""

import torch

from torch_grad_case import (  # noqa: F401 (collected tests, fixtures)
    adjoint_case, jax_tables, test_eval_adjoint_plain_matches_jax_vjp,
    test_eval_adjoint_plain_matches_pallas_adjoint)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)
