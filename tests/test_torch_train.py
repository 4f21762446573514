"""The port's optimizers and training step against the JAX package (the
steps themselves, one JAX compile a loss kind, are in
tests/test_torch_train_step.py and tests/test_torch_train_losses.py,
files of 3 items that run beside tests/test_multihost.py).

The optimizers run on numpy-seeded parameters and gradients beside
`tpusky.ad.optimizers`; the training step (`tpusky_torch.parallel.render.
make_train_step_single`) takes one step beside `tpusky.parallel.render.
make_train_step_single` from the same parameters, target image, seed and
optimizer state (carried over with `tpusky_torch.convert.adam_state`).
Both sides run on the CPU: JAX through its jnp wavefront path, the port
through its plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.ad import optimizers as JO

from tpusky_torch import convert
from tpusky_torch.ad import optimizers as TO
from tpusky_torch.parallel import render as TP
from tpusky_torch.render import film as TF

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

_SHAPES = {"alb": (3,), "sun": (3,), "t": ()}


def _tree(rng, zero_share=0.0):
    out = {}
    for k, shape in _SHAPES.items():
        v = rng.normal(size=shape).astype(np.float32)
        if zero_share:
            v = np.where(rng.random(shape) < zero_share, 0.0, v)
        out[k] = v.astype(np.float32)
    return out


_OPTIMIZERS = {
    "adam": lambda m: m.Adam(0.05),
    "adam_mask": lambda m: m.Adam(0.05, mask_updates=True),
    "adam_uniform": lambda m: m.Adam(0.02, beta_1=0.8, uniform=True),
    "sgd": lambda m: m.SGD(0.1),
    "sgd_momentum": lambda m: m.SGD(0.1, momentum=0.9),
}


@pytest.mark.parametrize("name", sorted(_OPTIMIZERS))
def test_optimizer_matches_jax(name):
    """Five steps from the same parameters and gradients (a third of the
    gradient entries zero, for mask_updates), with a per-parameter rate:
    parameters and state within 1e-6 of JAX's. After two steps the port
    takes over JAX's state through `convert`."""
    rng = np.random.default_rng(sorted(_OPTIMIZERS).index(name))
    opt_j, opt_t = _OPTIMIZERS[name](JO), _OPTIMIZERS[name](TO)
    for opt in (opt_j, opt_t):
        opt.set_learning_rate(t=0.2)
    p_j = {k: jnp.asarray(v) for k, v in _tree(rng).items()}
    grads = [_tree(rng, zero_share=1 / 3) for _ in range(5)]
    st_j = opt_j.init(p_j)
    to_state = convert.adam_state if "adam" in name else convert.sgd_state
    p_t = st_t = None
    for i, g in enumerate(grads):
        if i == 2:
            p_t = {k: torch.tensor(np.asarray(v)) for k, v in p_j.items()}
            st_t = to_state(jax.tree.map(np.asarray, st_j), device="cpu")
        if p_t is not None:
            u_t, st_t = opt_t.update({k: torch.tensor(v)
                                      for k, v in g.items()}, st_t, p_t)
            p_t = {k: p_t[k] + u_t[k] for k in p_t}
        u_j, st_j = opt_j.update({k: jnp.asarray(v) for k, v in g.items()},
                                 st_j, p_j)
        p_j = {k: p_j[k] + u_j[k] for k in p_j}
    for k in _SHAPES:
        np.testing.assert_allclose(p_t[k].numpy(), np.asarray(p_j[k]),
                                   rtol=1e-6, atol=1e-6)
    for a, b in zip(jax.tree.leaves(st_t),
                    jax.tree.leaves(jax.tree.map(np.asarray, st_j))):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-6, atol=1e-7)


def test_optimizer_step_and_init_match_jax():
    """`init` and the stateful `step` form, from the port's own init."""
    rng = np.random.default_rng(11)
    p = _tree(rng)
    g = _tree(rng)
    for name in ("adam", "sgd_momentum"):
        opt_j, opt_t = _OPTIMIZERS[name](JO), _OPTIMIZERS[name](TO)
        pj, _ = opt_j.step({k: jnp.asarray(v) for k, v in p.items()},
                           {k: jnp.asarray(v) for k, v in g.items()})
        pt, _ = opt_t.step({k: torch.tensor(v) for k, v in p.items()},
                            {k: torch.tensor(v) for k, v in g.items()})
        for k in _SHAPES:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-7)
    with pytest.raises(TypeError):
        TO.Adam(0.1).init([torch.zeros(3)])


# ---------------------------------------------------------------------------
# the training step (bench.py::bench_train's step, cut to 16x16 at 2 spp)
# ---------------------------------------------------------------------------


def test_train_step_refuses_unknown_losses():
    with pytest.raises(ValueError):
        TP.make_train_step_single(None, None, TF.Film(4, 4, 3), 1,
                                  TO.SGD(0.1), loss="l1")
    with pytest.raises(ValueError):
        TP.image_loss(torch.zeros(4, 4, 3), torch.zeros(4, 4, 3), "huber")
