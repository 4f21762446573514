"""The port's spectral render path against the JAX package: the rough
conductor BSDF. `bench.py`'s spectral scenes rendered lane by lane are in
`test_torch_spectral_render_bench.py` and
`test_torch_spectral_render_grad_scene.py` (one scene a file, each of 3
items, so that pytest-xdist's `--dist loadfile` hands them out after
tests/test_multihost.py: their JAX compiles no longer add to the wall).
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


# ---------------------------------------------------------------------------
# the rough conductor
# ---------------------------------------------------------------------------


def _materials():
    """Four rows: diffuse, rough conductors of two roughnesses and IORs
    (one two-sided), and a spectral albedo that varies by channel."""
    rng = np.random.default_rng(0)
    kw = dict(kinds=[0, 1, 1, 0],
              albedos=rng.uniform(0.1, 0.9, (4, 3)).astype(np.float32),
              twosided=[False, False, True, True],
              spectral_albedos=rng.uniform(0.1, 0.9, (4, 11)).astype(
                  np.float32),
              alphas=[0.1, 0.2, 0.45, 0.3],
              etas=[[0.2, 0.9, 1.1], [0.143, 0.375, 1.442],
                    [1.5, 1.0, 0.6], [1.0, 1.0, 1.0]],
              ks=[[3.9, 2.4, 1.6], [3.983, 2.386, 1.603], [2.0, 3.0, 4.0],
                  [0.0, 0.0, 0.0]])
    jt = JB.make_material_table(**kw)
    return jt, TB.make_material_table(**kw, device="cpu")


def _bsdf_lanes(n=4096):
    rng = np.random.default_rng(1)
    wi = rng.normal(size=(n, 3)).astype(np.float32)
    wo = rng.normal(size=(n, 3)).astype(np.float32)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    # mostly upper hemisphere, some below (two-sided rows flip them)
    wi[:, 2] = np.where(rng.random(n) < 0.8, np.abs(wi[:, 2]), wi[:, 2])
    wo[:, 2] = np.where(rng.random(n) < 0.8, np.abs(wo[:, 2]), wo[:, 2])
    mat = rng.integers(0, 4, n).astype(np.int32)
    u2 = rng.random((n, 2), dtype=np.float32)
    u1 = rng.random(n, dtype=np.float32)
    wl = rng.uniform(300.0, 760.0, (n, 4)).astype(np.float32)
    return wi, wo, mat, u2, u1, wl


def _close(a, b, name, rtol=1e-4, atol=1e-6):
    """Within rtol of each entry plus atol of the array's scale."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    tol = rtol * np.abs(b) + atol * max(np.abs(b).max(), 1.0)
    assert (np.abs(a - b) <= tol).all(), (name, np.abs(a - b).max())


@pytest.mark.parametrize("spectral", [False, True], ids=["rgb", "spectral"])
@pytest.mark.parametrize("kinds", [((1,), False), ((0, 1), False)],
                         ids=["rough", "diffuse+rough"])
def test_bsdf_eval_pdf_and_sample_match_jax(kinds, spectral):
    """eval_pdf and sample of the diffuse and rough-conductor lobes, RGB
    and at hero wavelengths, against tpusky.render.bsdf within 1e-4."""
    jt, tt_ = _materials()
    wi, wo, mat, u2, u1, wl = _bsdf_lanes()
    if kinds[0] == (1,):
        mat = np.where(np.isin(mat, [1, 2]), mat, 1).astype(np.int32)
    wl_j = wl if spectral else None
    wl_t = torch.tensor(wl) if spectral else None

    val_j, pdf_j = jax.jit(lambda *a: JB.eval_pdf(*a, kinds=kinds))(
        jt, mat, wi, wo, wl_j)
    val_t, pdf_t = TB.eval_pdf(tt_, torch.tensor(mat, dtype=torch.long),
                               torch.tensor(wi), torch.tensor(wo), wl_t,
                               kinds=kinds)
    _close(val_t, val_j, "value")
    _close(pdf_t, pdf_j, "pdf")
    assert (np.asarray(pdf_j) > 0).mean() > 0.3

    wo_j, w_j, p_j, delta_j = jax.jit(lambda *a: JB.sample(*a, kinds=kinds))(
        jt, mat, wi, u2, u1, wl_j)
    wo_t, w_t, p_t, delta_t = TB.sample(
        tt_, torch.tensor(mat, dtype=torch.long), torch.tensor(wi),
        torch.tensor(u2), torch.tensor(u1), wl_t, kinds=kinds)
    _close(wo_t, wo_j, "wo", atol=1e-5)
    _close(w_t, w_j, "weight")
    _close(p_t, p_j, "pdf")
    np.testing.assert_array_equal(delta_t.numpy(), np.asarray(delta_j))
    # a sampled direction's eval/pdf gives back its weight
    ok = p_t > 1e-3
    v2, p2 = TB.eval_pdf(tt_, torch.tensor(mat, dtype=torch.long),
                         torch.tensor(wi), wo_t, wl_t, kinds=kinds)
    good = ok & (w_t.abs().sum(-1) > 0)
    _close((v2 / p2[..., None])[good], w_t[good], "weight = f cos / pdf",
           rtol=1e-3)


def test_material_table_kinds_and_defaults():
    """Kinds the reference does not have (19) are refused, the polarized
    kinds 11-14 and hair are carried; the defaults are the reference
    package's."""
    with pytest.raises(NotImplementedError):
        TB.make_material_table(kinds=[19], device="cpu")
    assert TB.make_material_table(kinds=[11, 12, 13, 14, 16], albedos=[
        [0.5] * 3] * 5, device="cpu").host_kind == (11, 12, 13, 14, 16)
    jt = JB.make_material_table(kinds=[1, 0],
                                albedos=[[0.2, 0.4, 0.6], [0.5, 0.5, 0.5]])
    tt_ = TB.make_material_table(kinds=[1, 0],
                                 albedos=[[0.2, 0.4, 0.6], [0.5, 0.5, 0.5]],
                                 device="cpu")
    conv = convert.material_table(jax.tree.map(np.asarray, jt),
                                  device="cpu")
    for f in TB.MaterialTable._fields:
        a, b = getattr(tt_, f), getattr(conv, f)
        assert (a == b if f.startswith("host") or a is None
                else torch.equal(a, b)), f
    assert tt_.host_kind == (1, 0)
    assert TB.table_kinds(tt_) == ((0, 1), False)
    with pytest.raises(NotImplementedError):
        TB.eval_pdf(tt_, torch.zeros(4, dtype=torch.long), torch.ones(4, 3),
                    torch.ones(4, 3), kinds=((0, 19), False))
    v, _ = TB.eval_pdf(tt_, torch.zeros(4, dtype=torch.long),
                       torch.ones(4, 3), torch.ones(4, 3),
                       kinds=((0, 1, 11, 12, 13, 14, 16), False))
    assert bool(torch.isfinite(v).all())
