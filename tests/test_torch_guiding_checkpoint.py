"""The port's boundary-sample guiding (`tpusky_torch.ad.guiding`) against
the JAX package's on the CPU, and its checkpoints
(`tpusky_torch.utils.checkpoint`): a save and load of an Adam state gives
the state back, and a step after the load is bitwise the step without
it.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ad import guiding as JG
from tpusky.utils import checkpoint as JC
from tpusky_torch.ad import guiding as TG
from tpusky_torch.ad.optimizers import Adam
from tpusky_torch.utils import checkpoint as TC

torch.set_num_threads(1)


def test_curve_guide_matches_jax():
    """build_curve_guide on seeded scores (some zero, some negative, one
    NaN) over [0, t_len): pdf and CDF within 1e-6 of the reference's; an
    all-zero seed pass gives the uniform guide; sample_curve_guide at
    stratified uniforms: the same bins (searchsorted to the right) and t
    and pdf within 1e-6 of the reference's scale."""
    rng = np.random.default_rng(7)
    t_len = 2.0 * np.pi
    n = 500
    t_s = ((np.arange(n) + rng.random(n)) / n * t_len).astype(np.float32)
    scores = (rng.random(n) ** 4).astype(np.float32)
    scores[rng.random(n) < 0.3] = 0.0
    scores[:5] = -1.0
    scores[7] = np.nan
    u = ((np.arange(1000) + rng.random(1000)) / 1000).astype(np.float32)
    for sc in (scores, np.zeros_like(scores)):
        for bins, mix in ((64, 0.1), (7, 0.25)):
            g = TG.build_curve_guide(torch.as_tensor(sc),
                                     torch.as_tensor(t_s), t_len, bins, mix)
            gj = JG.build_curve_guide(jnp.asarray(sc), jnp.asarray(t_s),
                                      t_len, bins, mix)
            for a, b in zip(g, gj):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=1e-6, atol=1e-7)
            t, pdf = TG.sample_curve_guide(g, torch.as_tensor(u))
            tj, pdfj = JG.sample_curve_guide(gj, jnp.asarray(u))
            np.testing.assert_allclose(t.numpy(), np.asarray(tj), rtol=0,
                                       atol=1e-6 * t_len)
            np.testing.assert_allclose(pdf.numpy(), np.asarray(pdfj),
                                       rtol=1e-6)
            assert float(t.min()) >= 0.0 and float(t.max()) <= t_len
        if not sc.any():
            np.testing.assert_allclose(g.pdf_bins.numpy(), 1.0 / t_len,
                                       rtol=1e-6)


def test_checkpoint_round_trip(tmp_path):
    """save_checkpoint of a nested state (params, an Adam state of
    tuples, a step count, a NamedTuple-free dict of arrays): the file
    the reference's `load_checkpoint` reads too, the same arrays back;
    no file: None; the write is atomic (no .tmp left)."""
    path = str(tmp_path / "ckpt.pkl")
    assert TC.load_checkpoint(path) is None
    opt = Adam(lr=0.05)
    params = {"x": torch.linspace(-1.0, 1.0, 7), "y": torch.ones(2, 3)}
    state = opt.init(params)
    params, state = opt.step(params, {k: torch.sin(3 * v) for k, v in
                                      params.items()}, state)
    TC.save_checkpoint(path, {"params": params, "opt": state, "step": 1})
    assert not os.path.exists(path + ".tmp")
    for back in (TC.load_checkpoint(path), JC.load_checkpoint(path)):
        assert back["step"] == 1
        for k, v in params.items():
            np.testing.assert_array_equal(back["params"][k], v.numpy())
            for a, b in zip(back["opt"][k], state[k]):
                np.testing.assert_array_equal(a, b.numpy())


def test_step_after_load_is_bitwise(tmp_path):
    """Three Adam steps; a checkpoint after the second; the third step
    from the loaded state (its arrays back as tensors) bitwise the third
    step of the run that never stopped."""
    path = str(tmp_path / "adam.pkl")
    opt = Adam(lr=0.1)
    params = {"w": torch.tensor([0.3, -1.2, 2.5]), "b": torch.tensor(0.7)}
    state = opt.init(params)

    def grads(p):
        return {k: torch.cos(v) * v for k, v in p.items()}
    for _ in range(2):
        params, state = opt.step(params, grads(params), state)
    TC.save_checkpoint(path, {"params": params, "opt": state})
    want, _ = opt.step(params, grads(params), state)
    back = TC.load_checkpoint(path)
    p2 = {k: torch.as_tensor(v) for k, v in back["params"].items()}
    s2 = {k: tuple(torch.as_tensor(a) for a in v)
          for k, v in back["opt"].items()}
    got, _ = opt.step(p2, grads(p2), s2)
    for k in want:
        assert torch.equal(got[k], want[k]), k
