"""The port's recovery recipe with real renders at 16x16x2 against
`bench.py`'s (moved unchanged from tests/test_torch_recovery.py; shared
code in `torch_recovery_case.py`): the evaluation loss against
`bench.py:363-375`'s formula on JAX's image, and the whole recipe, which
lowers the loss and follows `bench._recover_one` on JAX's own bench_train
machinery.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compiles add nothing
to the wall.
"""

import torch

from torch_recovery_case import (  # noqa: F401 (tests, fixtures)
    jax_bench, machinery, port_recovery,
    test_eval_loss_matches_bench_formula,
    test_recipe_with_renders_follows_the_reference,
    test_recipe_with_renders_lowers_the_loss)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)
