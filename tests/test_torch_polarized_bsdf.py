"""The scalar radiometry of the port's polarized kinds (11 pplastic, 12
polarizer, 13 retarder, 14 circular) against the JAX package on the
CPU: `eval_pdf` and `sample` lane by lane, pplastic's sampling by the
chi-square test, and the scalar path's render of a scene that holds
every one of them.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.render import bsdf as JB

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.utils.chi2 import chi2_test

from torch_breadth_case import jax_lanes, port_lanes, share_outside
from torch_polarized_case import case

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
KINDS = [11, 12, 13, 14, 11, 0, 1, 12]
TWOSIDED = [False, False, False, False, True, False, False, True]


def _columns():
    m = len(KINDS)
    rng = np.random.default_rng(4)
    extras = np.zeros((m, 8), np.float32)
    extras[:, 0] = rng.uniform(0.0, 180.0, m)      # theta
    extras[:, 1] = rng.uniform(0.0, 180.0, m)      # delta
    extras[3, 2] = 1.0                             # left-handed
    return dict(kinds=KINDS, albedos=rng.uniform(0.1, 0.9, (m, 3)),
                twosided=TWOSIDED, alphas=rng.uniform(0.05, 0.6, m),
                iors=rng.uniform(1.3, 1.7, m), extras=extras,
                spectral_albedos=rng.uniform(0.1, 0.9, (m, 11)))


def _rel(a, b, floor=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), floor)).max())


def test_polarized_kinds_match_jax():
    """Per mode, with and without a reflectance texture: `eval_pdf`'s
    value and pdf and `sample`'s weight and pdf within 1e-4 relative
    (floor 1e-3), its directions within 1e-5 and is_delta equal, on 4,096
    lanes over both hemispheres; the filters are delta (zero in
    `eval_pdf`) with their straight-through weights 0.5, 1 and 0.5 of the
    transmittance. `convert.material_table` carries the kinds and their
    `extra` columns, equal to `make_material_table`'s."""
    cols = _columns()
    jt = JB.make_material_table(**cols)
    tt = TB.make_material_table(device="cpu", **cols)
    conv = convert.material_table(jax.tree.map(np.asarray, jt), device="cpu")
    for f in TB.MaterialTable._fields:
        a, b = getattr(tt, f), getattr(conv, f)
        assert a == b if f.startswith("host") else torch.equal(a, b), f
    kinds = TB.table_kinds(tt)
    assert kinds == JB.table_kinds(jt) == ((0, 1, 11, 12, 13, 14), False)
    rng = np.random.default_rng(8)

    def sphere():
        d = rng.normal(size=(N, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)
    idx = (np.arange(N) % len(KINDS)).astype(np.int64)
    wi, wo = sphere(), sphere()
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random((N,), dtype=np.float32)
    kind = np.asarray(KINDS)[idx]
    for mode in ("rgb", "spectral"):
        wl = (None if mode == "rgb" else
              rng.uniform(360.0, 830.0, (N, 4)).astype(np.float32))
        nc = 3 if wl is None else 4
        tex_val = rng.uniform(0.0, 1.0, (N, nc)).astype(np.float32)
        tex_has = rng.random(N) < 0.5
        for textured in (False, True):
            tex_j = (jnp.asarray(tex_val), jnp.asarray(tex_has)) \
                if textured else None
            tex_t = (torch.tensor(tex_val), torch.tensor(tex_has)) \
                if textured else None
            wl_j = None if wl is None else jnp.asarray(wl)
            wl_t = None if wl is None else torch.tensor(wl)
            v_j, p_j = JB.eval_pdf(jt, jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(wi), jnp.asarray(wo), wl_j,
                                   kinds=kinds, refl_tex=tex_j)
            v_t, p_t = TB.eval_pdf(tt, torch.tensor(idx), torch.tensor(wi),
                                   torch.tensor(wo), wl_t, kinds=kinds,
                                   refl_tex=tex_t)
            s_j = JB.sample(jt, jnp.asarray(idx, jnp.int32), jnp.asarray(wi),
                            jnp.asarray(u2), jnp.asarray(u1), wl_j,
                            kinds=kinds, refl_tex=tex_j)
            s_t = TB.sample(tt, torch.tensor(idx), torch.tensor(wi),
                            torch.tensor(u2), torch.tensor(u1), wl_t,
                            kinds=kinds, refl_tex=tex_t)
            what = f"{mode}, textured {textured}"
            assert _rel(v_t, v_j) <= 1e-4, (what, _rel(v_t, v_j))
            assert _rel(p_t, p_j) <= 1e-4, (what, _rel(p_t, p_j))
            np.testing.assert_array_equal(s_t[3].numpy(), s_j[3], what)
            assert np.abs(s_t[0].numpy() - s_j[0]).max() <= 1e-5, what
            assert _rel(s_t[1], s_j[1]) <= 1e-4, (what, _rel(s_t[1], s_j[1]))
            assert _rel(s_t[2], s_j[2]) <= 1e-4, (what, _rel(s_t[2], s_j[2]))
            filt = kind >= 12
            assert (v_t.numpy()[filt] == 0).all() and s_t[3].numpy()[filt].all()
            np.testing.assert_array_equal(s_t[0].numpy()[filt], -wi[filt])
            trans = s_t[1].numpy()[filt] / np.where(
                kind[filt] == 13, 1.0, 0.5)[:, None]
            refl = (tt.albedo[idx].numpy() if wl is None else
                    TB.spec_lerp(tt.albedo_spec[idx], wl_t).numpy())
            if textured:
                refl = np.where(tex_has[:, None], tex_val, refl)
            np.testing.assert_allclose(trans, refl[filt], rtol=1e-6)
            for k in (0, 1, 11):
                assert (s_t[1].numpy().max(-1) > 0)[kind == k].any(), (what,
                                                                       k)


def test_pplastic_sampling_chi2():
    """pplastic's `sample` against its `eval_pdf` by the port's chi-square
    test (`utils/chi2.py`), at the reference's settings
    (tests/test_polarized.py:260-285)."""
    table = TB.make_material_table(kinds=[11], albedos=[[0.5, 0.5, 0.5]],
                                   alphas=[0.35], device="cpu")
    wi = torch.tensor([0.3, -0.2, 0.93])
    wi = wi / torch.linalg.vector_norm(wi)

    def sample_fn(batch_seed, n):
        g = torch.Generator().manual_seed(batch_seed)
        u = torch.rand((n, 3), generator=g)
        wo, _, _, _ = TB.sample(table, torch.zeros(n, dtype=torch.int64),
                                wi.expand(n, 3), u[:, :2], u[:, 2])
        return wo

    def pdf_fn(d):
        n = d.shape[0]
        _, pdf = TB.eval_pdf(table, torch.zeros(n, dtype=torch.int64),
                             wi.expand(n, 3), d)
        return pdf

    p, ok, info = chi2_test(sample_fn, pdf_fn, seed=11,
                            sample_count=1_000_000, res_phi=64, res_cos=32,
                            cos_range=(0.0, 1.0), ires=16)
    assert ok, (p, info)


def test_scalar_render_of_polarized_kinds_matches_jax():
    """The scalar path (`render_rows`'s lanes, its plain path on the CPU)
    renders the Stokes scene, which holds kinds 1, 2, 3, 11-14, an area
    panel, a point light and a mesh, as the reference's scalar path does:
    at most 0.1% of the 16x16x2 lanes outside 1e-3 (floor 1e-3), depth
    4."""
    sc, cam, sc_t, cam_t = case("rgb")
    lanes_j = jax_lanes(sc, cam, 4, 1000)
    lanes = port_lanes(sc_t, cam_t, 4, 1000)
    assert np.isfinite(lanes).all() and lanes.max() > 0
    assert share_outside(lanes, lanes_j) <= 1e-3, (
        share_outside(lanes, lanes_j), np.abs(lanes - lanes_j).max())
