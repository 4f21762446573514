"""The port's training step against the JAX package's for the loss kind
bench_train uses, plain l2 and the tuple form (one JAX compile each,
~10 s here; tests/test_torch_train_losses.py runs rel_l2, log_l2 and
log_l2_nodisc).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its compiles add nothing to
the wall.
"""

import pytest

import torch_train_case as case


@pytest.fixture(scope="module")
def setup():
    return case.make_setup()


@pytest.mark.parametrize("loss", ["log_l2_blur", "l2",
                                  ("log_l2_blur", 2.0, 4.0)], ids=str)
def test_train_step_matches_jax(setup, loss):
    case.check_one_step(setup, loss)
