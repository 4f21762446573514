"""The port's smooth delta BSDFs (conductor 2, dielectric 3, thin
dielectric 7; `tpusky_torch.render.bsdf`) against the JAX package on the
CPU, beside a diffuse row they share a table with (the rough conductor's
lobes are held in tests/test_torch_spectral_render.py).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render import bsdf as JB

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

KINDS = [TB.CONDUCTOR, TB.DIELECTRIC, TB.THIN_DIELECTRIC, TB.DIELECTRIC,
         TB.DIFFUSE]


@pytest.mark.parametrize("twosided", [False, True])
def test_delta_bsdfs_match_jax(twosided):
    """8,192 lanes, wi over the whole sphere (hits from either side),
    rows of each kind (a dielectric of IOR 1.5 and one of 1/1.33):
    `eval_pdf` 0 on the delta rows and equal elsewhere within 1e-5;
    `sample` with is_delta equal, wo, weight and pdf within 1e-5."""
    rng = np.random.default_rng(int(twosided))
    m = len(KINDS)
    jt = JB.make_material_table(
        kinds=KINDS, albedos=rng.uniform(0.2, 1.0, (m, 3)),
        twosided=[twosided] * m, iors=[1.5, 1.5, 1.33, 1.0 / 1.33, 1.5])
    tt_ = convert.material_table(jax.tree.map(np.asarray, jt), device="cpu")
    assert TB.table_kinds(tt_) == JB.table_kinds(jt)
    kinds = TB.table_kinds(tt_)
    n = 8192
    mat = rng.integers(0, m, n)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    u2 = rng.random((n, 2), dtype=np.float32)
    u1 = rng.random(n, dtype=np.float32)

    v_j, p_j = (np.asarray(x) for x in jax.jit(
        lambda t, i, a, b: JB.eval_pdf(t, i, a, b, kinds=kinds))(
        jt, mat.astype(np.int32), wi, wo))
    v_t, p_t = (x.numpy() for x in TB.eval_pdf(
        tt_, torch.tensor(mat), torch.tensor(wi), torch.tensor(wo),
        kinds=kinds))
    delta = np.isin(np.asarray(KINDS)[mat], [2, 3, 7])
    assert not v_t[delta].any() and not p_t[delta].any()
    np.testing.assert_allclose(v_t, v_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(p_t, p_j, rtol=1e-5, atol=1e-5)

    ref = [np.asarray(x) for x in jax.jit(
        lambda t, i, a, b, c: JB.sample(t, i, a, b, c, kinds=kinds))(
        jt, mat.astype(np.int32), wi, u2, u1)]
    out = [x.numpy() for x in TB.sample(
        tt_, torch.tensor(mat), torch.tensor(wi), torch.tensor(u2),
        torch.tensor(u1), kinds=kinds)]
    np.testing.assert_array_equal(out[3], ref[3])
    np.testing.assert_array_equal(out[3], delta)
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    # both branches of each dielectric, and transmission through both
    # sides, occur
    for k in (TB.DIELECTRIC, TB.THIN_DIELECTRIC):
        rows = np.asarray(KINDS)[mat] == k
        crossed = out[0][rows, 2] * wi[rows, 2] < 0
        assert 0.3 < crossed.mean() < 0.99
        assert (wi[rows][crossed, 2] < 0).any() and \
            (wi[rows][crossed, 2] > 0).any()
