"""The port's training step against the JAX package's, for the loss
kinds that tests/test_torch_train.py leaves out (one JAX compile each):
relative, log-space and log-space with the sun disc masked."""

import pytest

import torch_train_case as case


@pytest.fixture(scope="module")
def setup():
    return case.make_setup()


@pytest.mark.parametrize("loss", ["rel_l2", "log_l2", "log_l2_nodisc"])
def test_train_step_matches_jax(setup, loss):
    case.check_one_step(setup, loss)
