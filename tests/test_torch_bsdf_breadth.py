"""The port's plastic, rough dielectric, null, rough plastic, principled,
blend and principledthin materials (kinds 4, 5, 6, 8, 9, 10, 15) and
opacity masks against the JAX package on the CPU, lane by lane: a table
of every kind, one-sided and two-sided rows, with and without a mask, in
RGB and spectral mode, on 4,096 lanes whose wi and wo cover both
hemispheres.

The reference runs eagerly: under jit XLA fuses the GGX and GTR1
normalisations and rounds a peaked lobe's pdf apart from eager JAX and
from the port by up to 1.4e-4, where eagerly the two agree within
2e-5 (`_unit` rounds as `jnp.linalg.norm`).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import bsdf as JB

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
KINDS = [0, 1, 4, 5, 6, 8, 9, 10, 15, 4, 8, 9, 15, 5]
TWOSIDED = [False] * 9 + [True] * 3 + [False] * 2


def _columns(mask):
    """make_material_table's keywords of the test table: a blend of rows
    0 and 1 at 0.4, every other row masked at 0.6 with `mask`."""
    m = len(KINDS)
    rng = np.random.default_rng(3)
    children = np.zeros((m, 2), np.int64)
    children[7] = [0, 1]
    weights = np.zeros((m,), np.float32)
    weights[7] = 0.4
    opacities = np.ones((m,), np.float32)
    if mask:
        opacities[::2] = 0.6
    return dict(kinds=KINDS, albedos=rng.uniform(0.1, 0.9, (m, 3)),
                twosided=TWOSIDED, alphas=rng.uniform(0.1, 0.6, m),
                iors=rng.uniform(1.3, 1.7, m),
                extras=rng.uniform(0.0, 1.0, (m, 8)),
                blend_children=children, blend_weights=weights,
                opacities=opacities,
                spectral_albedos=rng.uniform(0.1, 0.9, (m, 11)))


def _lanes(mode):
    rng = np.random.default_rng(7)

    def sphere():
        d = rng.normal(size=(N, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)
    idx = (np.arange(N) % len(KINDS)).astype(np.int64)
    wi, wo = sphere(), sphere()
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random((N,), dtype=np.float32)
    wl = (None if mode == "rgb" else
          rng.uniform(360.0, 830.0, (N, 4)).astype(np.float32))
    return idx, wi, wo, u2, u1, wl


def _rel(a, b, floor=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), floor)).max())


def test_kinds_match_jax():
    """Per mode and mask: `eval_pdf`'s value and pdf and `sample`'s
    weight and pdf within 1e-4 relative (floor 1e-3), its directions
    within 1e-5 and is_delta equal on every lane; each kind's lanes are
    lit somewhere."""
    for mode in ("rgb", "spectral"):
        for mask in (False, True):
            cols = _columns(mask)
            jt = JB.make_material_table(**cols)
            tt = TB.make_material_table(device="cpu", **cols)
            kinds = TB.table_kinds(tt)
            assert kinds == JB.table_kinds(jt) and kinds[1] == mask
            idx, wi, wo, u2, u1, wl = _lanes(mode)
            wl_j = None if wl is None else jnp.asarray(wl)
            wl_t = None if wl is None else torch.tensor(wl)
            v_j, p_j = JB.eval_pdf(jt, jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(wi), jnp.asarray(wo), wl_j,
                                   kinds=kinds)
            v_t, p_t = TB.eval_pdf(tt, torch.tensor(idx), torch.tensor(wi),
                                   torch.tensor(wo), wl_t, kinds=kinds)
            s_j = JB.sample(jt, jnp.asarray(idx, jnp.int32), jnp.asarray(wi),
                            jnp.asarray(u2), jnp.asarray(u1), wl_j,
                            kinds=kinds)
            s_t = TB.sample(tt, torch.tensor(idx), torch.tensor(wi),
                            torch.tensor(u2), torch.tensor(u1), wl_t,
                            kinds=kinds)
            what = f"{mode}, mask {mask}"
            assert _rel(v_t, v_j) <= 1e-4, (what, _rel(v_t, v_j))
            assert _rel(p_t, p_j) <= 1e-4, (what, _rel(p_t, p_j))
            np.testing.assert_array_equal(s_t[3].numpy(), s_j[3], what)
            assert np.abs(s_t[0].numpy() - s_j[0]).max() <= 1e-5, what
            assert _rel(s_t[1], s_j[1]) <= 1e-4, (what, _rel(s_t[1], s_j[1]))
            assert _rel(s_t[2], s_j[2]) <= 1e-4, (what, _rel(s_t[2], s_j[2]))
            kind = np.asarray(KINDS)[idx]
            for k in set(KINDS):
                lit = (np.asarray(s_j[1]).max(-1) > 0)[kind == k]
                assert lit.any(), (what, k)
            if mask:
                assert np.asarray(s_j[3])[kind != 6].any()


def test_parameter_gradients_match_jax():
    """The gradient of sum(value * cotangent) of `eval_pdf` with respect
    to the albedo, alpha and the `extra` column against jax.grad of the
    same loss, within 1e-4 of each column's largest entry, in RGB."""
    cols = _columns(True)
    jt = JB.make_material_table(**cols)
    tt = TB.make_material_table(device="cpu", **cols)
    kinds = TB.table_kinds(tt)
    idx, wi, wo, _, _, _ = _lanes("rgb")
    cot = np.random.default_rng(11).normal(size=(N, 3)).astype(np.float32)
    fields = ("albedo", "alpha", "extra")

    def loss_j(params):
        v, _ = JB.eval_pdf(jt._replace(**params), jnp.asarray(idx, jnp.int32),
                           jnp.asarray(wi), jnp.asarray(wo), kinds=kinds)
        return jnp.sum(v * cot)
    g_j = jax.grad(loss_j)({f: getattr(jt, f) for f in fields})
    leaves = {f: getattr(tt, f).clone().requires_grad_(True)
              for f in fields}
    v_t, _ = TB.eval_pdf(tt._replace(**leaves), torch.tensor(idx),
                         torch.tensor(wi), torch.tensor(wo), kinds=kinds)
    g_t = torch.autograd.grad((v_t * torch.tensor(cot)).sum(),
                              [leaves[f] for f in fields])
    for f, g in zip(fields, g_t):
        ref = np.asarray(g_j[f])
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0, f
        err = np.abs(g.numpy() - ref).max() / np.abs(ref).max()
        assert err <= 1e-4, (f, err)


def test_tables_refusals_and_convert():
    """`convert.material_table` carries every column of the reference's
    table, equal to the port's own `make_material_table` (the host copies
    of the kinds and the mask flag included); kinds 16, 17 and 18 raise,
    naming the module they wait for, and the polarized kinds 11-14 come
    over (render/polarized.py); a textured material carries
    its texture and normal-map columns over (render/texture.py)."""
    cols = _columns(True)
    jt = JB.make_material_table(**cols)
    tt = TB.make_material_table(device="cpu", **cols)
    conv = convert.material_table(jax.tree.map(np.asarray, jt), device="cpu")
    for f in TB.MaterialTable._fields:
        a, b = getattr(tt, f), getattr(conv, f)
        assert a == b if f.startswith("host") else torch.equal(a, b), f
    assert tt.host_mask and not TB.make_material_table(
        kinds=[4], device="cpu").host_mask
    for kind in (11, 12, 13, 14):
        built = TB.make_material_table(kinds=[0, kind],
                                       albedos=[[0.5] * 3] * 2, device="cpu")
        assert built.host_kind == (0, kind)
        moved = convert.material_table(jax.tree.map(np.asarray, jt._replace(
            kind=jt.kind.at[0].set(kind))), device="cpu")
        assert moved.host_kind[0] == kind and int(moved.kind[0]) == kind
    for kind, module in ((16, "curve"), (17, "measured"), (18, "measured")):
        with pytest.raises(NotImplementedError, match=module):
            TB.make_material_table(kinds=[0, kind], albedos=[[0.5] * 3] * 2,
                                   device="cpu")
        with pytest.raises(NotImplementedError, match=module):
            convert.material_table(jax.tree.map(np.asarray, jt._replace(
                kind=jt.kind.at[0].set(kind))), device="cpu")
    m = jt.kind.shape[0]
    tex, nrm = np.full(m, -1), np.full(m, -1)
    tex[0], nrm[-1] = 0, 1
    textured = convert.material_table(jax.tree.map(np.asarray, jt._replace(
        tex_idx=jnp.asarray(tex, jnp.int32),
        normal_tex_idx=jnp.asarray(nrm, jnp.int32))), device="cpu")
    own = TB.make_material_table(device="cpu", tex_indices=tex,
                                 normal_tex_indices=nrm, **cols)
    assert textured.tex_idx.tolist() == own.tex_idx.tolist() == tex.tolist()
    assert (textured.normal_tex_idx.tolist() == own.normal_tex_idx.tolist()
            == nrm.tolist())
    assert textured.host_normal_maps and own.host_normal_maps
    assert not tt.host_normal_maps and TB.table_normal_maps(textured)
