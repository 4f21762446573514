"""The port's measured BRDFs (`tpusky_torch/render/measured.py`, kinds 17
and 18) and its copy of the tensor-file format (`ops/tensorfile.py`)
against the JAX package on the CPU, on the synthetic RGL and pBSDF tables
of tests/test_measured.py (with a spectral and an anisotropic variant,
tests/torch_geometry_case.py).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ops import tensorfile as JTF
from tpusky.render import bsdf as JB
from tpusky.render import measured as JM
from tpusky.render import polarized as JP

from tpusky_torch import convert
from tpusky_torch.ops import tensorfile as TTF
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import measured as TM
from tpusky_torch.render import polarized as TP

import torch_geometry_case as G

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
FILES = {"rgb": lambda: G._synthetic_fields(jacobian=1),
         "spectral": G.spectral_fields, "anisotropic": G.anisotropic_fields}


def _rel(a, b, floor=1e-3):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.maximum(np.abs(b), floor)).max())


def _lane_rel(a, b, floor=1e-3):
    """Each lane's largest error of (N, C, 4, 4) matrices, relative to its
    largest reference entry (floored)."""
    err = np.abs(a - b).reshape(a.shape[0], -1).max(-1)
    scale = np.abs(b).reshape(b.shape[0], -1).max(-1)
    return err / np.maximum(scale, floor)


def _held(err, bar=1e-4, cap=2e-3, worst=1e-3):
    """Every lane within `worst`, all but a `cap` share within `bar`: the
    Stokes basis rotation's angle, 2 asin(|v - u| / 2), rounds apart by
    ~1e-4 in float32 where its two bases nearly oppose (PR 18's
    tests/test_torch_mueller.py counts the same lanes)."""
    return float(err.max()) <= worst and float((err > bar).mean()) <= cap


def _lanes(seed=0):
    """N random (wi, wo) pairs, a fifth of the wi below the surface, and
    the uniforms of a sample."""
    rng = np.random.default_rng(seed)

    def sphere():
        d = rng.normal(size=(N, 3)).astype(np.float32)
        return d / np.linalg.norm(d, axis=-1, keepdims=True)
    wi, wo = sphere(), sphere()
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(np.arange(N) % 5 == 0, -1, 1)
    return (wi, wo, rng.random((N, 2), dtype=np.float32),
            rng.random((N,), dtype=np.float32),
            rng.uniform(380.0, 780.0, (N, 4)).astype(np.float32))


def test_tensorfile_and_warp_tables(tmp_path):
    """A file the port writes reads back bitwise through the reference's
    reader and the other way round; `_build_warp`'s tables are within
    1e-6 of the reference's; `load_measured` of an RGB, a spectral and an
    anisotropic file equals `convert.measured_brdf` of the reference's
    dataset (the tables within 1e-6, the static facts equal)."""
    for name, make in FILES.items():
        fields = make()
        for write, read in ((TTF.write_tensor_file, JTF.read_tensor_file),
                            (JTF.write_tensor_file, TTF.read_tensor_file)):
            path = str(tmp_path / f"{name}.bsdf")
            write(path, fields)
            back = read(path)
            assert set(back) == set(fields)
            for k, v in fields.items():
                assert back[k].dtype == v.dtype
                np.testing.assert_array_equal(back[k], v)
        jm = JM.load_measured(fields)
        tm = TM.load_measured(TTF.read_tensor_file(path), device="cpu")
        conv = convert.measured_brdf(jax.tree.map(np.asarray, jm), "cpu")
        for warp in ("vndf", "luminance"):
            for f in TM.ParamWarp2D._fields:
                a = getattr(getattr(tm, warp), f)
                b = np.asarray(getattr(getattr(jm, warp), f))
                assert float(np.abs(a.numpy() - b).max()) <= 1e-6, (warp, f)
                assert torch.equal(a, getattr(getattr(conv, warp), f))
        for f in ("phi_i", "theta_i", "wavelengths", "ndf", "sigma",
                  "spectra"):
            assert torch.equal(getattr(tm, f), getattr(conv, f)), f
        assert ((tm.isotropic, tm.jacobian, tm.reduction)
                == (conv.isotropic, conv.jacobian, conv.reduction)
                == (jm.isotropic, jm.jacobian, jm.reduction))
    assert (tm.isotropic, tm.reduction) == (False, 4)
    pol = G.pbsdf_fields()
    path = str(tmp_path / "synth.pbsdf")
    TTF.write_tensor_file(path, pol)
    jp = JM.load_measured_polarized(JTF.read_tensor_file(path), 0.2)
    tp = TM.load_measured_polarized(TTF.read_tensor_file(path), 0.2,
                                    device="cpu")
    cp = convert.measured_polarized(jax.tree.map(np.asarray, jp), "cpu")
    for f in TM.MeasuredPolarized._fields:
        a, b = getattr(tp, f), getattr(cp, f)
        assert a == b if isinstance(a, float) else torch.equal(a, b), f


def test_measured_brdf_matches_jax():
    """Kind 17, RGB (jacobian), spectral and anisotropic: `measured_eval_
    pdf`'s value and pdf and `measured_sample`'s direction (1e-4), weight
    and pdf within 1e-4 relative (floor 1e-3) of the reference's on 4,096
    lanes; then through the material table (a one-sided and a two-sided
    row beside diffuse), `eval_pdf` and `sample` in both modes."""
    wi, wo, u2, u1, wl = _lanes()
    t = {k: torch.tensor(v) for k, v in
         dict(wi=wi, wo=wo, u2=u2, u1=u1, wl=wl).items()}
    for name, make in FILES.items():
        fields = make()
        jm, tm = JM.load_measured(fields), TM.load_measured(fields, "cpu")
        jwl, twl = ((None, None) if name != "spectral"
                    else (jnp.asarray(wl), t["wl"]))
        jv, jp = JM.measured_eval_pdf(jm, jnp.asarray(wi), jnp.asarray(wo),
                                      jwl)
        tv, tp = TM.measured_eval_pdf(tm, t["wi"], t["wo"], twl)
        assert _rel(tv, jv) <= 1e-4 and _rel(tp, jp) <= 1e-4, name
        assert float(np.asarray(jp).max()) > 0.1
        jw, jwt, jpd = JM.measured_sample(jm, jnp.asarray(wi),
                                          jnp.asarray(u2), jwl)
        tw, twt, tpd = TM.measured_sample(tm, t["wi"], t["u2"], twl)
        assert float(np.abs(tw.numpy() - np.asarray(jw)).max()) <= 1e-4
        assert _rel(twt, jwt) <= 1e-4 and _rel(tpd, jpd) <= 1e-4, name
    cols = dict(kinds=[0, 17, 17], albedos=[[0.5] * 3] * 3,
                twosided=[False, False, True])
    jt = JB.make_material_table(measured=JM.load_measured(FILES["rgb"]()),
                                **cols)
    tt = convert.material_table(jax.tree.map(np.asarray, jt), "cpu")
    idx = np.arange(N) % 3
    for jwl, twl in ((None, None), (jnp.asarray(wl), t["wl"])):
        jv, jp = JB.eval_pdf(jt, jnp.asarray(idx), jnp.asarray(wi),
                             jnp.asarray(wo), jwl, JB.table_kinds(jt))
        tv, tp = TB.eval_pdf(tt, torch.tensor(idx), t["wi"], t["wo"], twl)
        assert _rel(tv, jv) <= 1e-4 and _rel(tp, jp) <= 1e-4
        jr = JB.sample(jt, jnp.asarray(idx), jnp.asarray(wi),
                       jnp.asarray(u2), jnp.asarray(u1), jwl,
                       JB.table_kinds(jt))
        tr = TB.sample(tt, torch.tensor(idx), t["wi"], t["u2"], t["u1"], twl)
        assert float(np.abs(tr[0].numpy() - np.asarray(jr[0])).max()) <= 1e-4
        assert _rel(tr[1], jr[1]) <= 1e-4 and _rel(tr[2], jr[2]) <= 1e-4
        assert np.array_equal(tr[3].numpy(), np.asarray(jr[3]))


def test_measured_polarized_matches_jax():
    """Kind 18: `mp_eval_mueller` within 1e-4 of the scale of the
    reference's matrices, `mp_eval_pdf` and `mp_sample` within 1e-4; the
    table's `eval_pdf` and `sample` and the Stokes path's Mueller weights
    (`_pol_weight_eval`, `_pol_weight_sample`) of a kind-18 row within
    1e-4 of each lane's largest entry in both modes (but 0.2% of the
    lanes, within 1e-3: see `_held`); a table with a kind-17 or kind-18
    row and no dataset is refused (ValueError), where the reference skips
    the lobe."""
    wi, wo, u2, u1, wl = _lanes(1)
    t = {k: torch.tensor(v) for k, v in
         dict(wi=wi, wo=wo, u2=u2, u1=u1, wl=wl).items()}
    jm = JM.load_measured_polarized(G.pbsdf_fields(), alpha_sample=0.2)
    tm = TM.load_measured_polarized(G.pbsdf_fields(), alpha_sample=0.2,
                                    device="cpu")
    for jwl, twl in ((None, None), (jnp.asarray(wl), t["wl"])):
        jmm = np.asarray(JM.mp_eval_mueller(jm, jnp.asarray(wi),
                                            jnp.asarray(wo), jwl))
        tmm = TM.mp_eval_mueller(tm, t["wi"], t["wo"], twl).numpy()
        assert np.abs(tmm - jmm).max() <= 1e-4 * np.abs(jmm).max()
        jv, jp = JM.mp_eval_pdf(jm, jnp.asarray(wi), jnp.asarray(wo), jwl)
        tv, tp = TM.mp_eval_pdf(tm, t["wi"], t["wo"], twl)
        assert _rel(tv, jv) <= 1e-4 and _rel(tp, jp) <= 1e-4
    jw = JM.mp_sample(jm, jnp.asarray(wi), jnp.asarray(u2), jnp.asarray(u1))
    tw = TM.mp_sample(tm, t["wi"], t["u2"], t["u1"])
    assert float(np.abs(tw.numpy() - np.asarray(jw)).max()) <= 1e-4

    jt = JB.make_material_table(kinds=[0, 18], albedos=[[0.5] * 3] * 2,
                                measured_pol=jm)
    tt = convert.material_table(jax.tree.map(np.asarray, jt), "cpu")
    idx = np.arange(N) % 2
    for jwl, twl in ((None, None), (jnp.asarray(wl), t["wl"])):
        jk = JB.table_kinds(jt)
        jr = JB.sample(jt, jnp.asarray(idx), jnp.asarray(wi),
                       jnp.asarray(u2), jnp.asarray(u1), jwl, jk)
        tr = TB.sample(tt, torch.tensor(idx), t["wi"], t["u2"], t["u1"], twl)
        assert float(np.abs(tr[0].numpy() - np.asarray(jr[0])).max()) <= 1e-4
        assert _rel(tr[1], jr[1]) <= 1e-4 and _rel(tr[2], jr[2]) <= 1e-4
        jv, jp = JB.eval_pdf(jt, jnp.asarray(idx), jnp.asarray(wi),
                             jnp.asarray(wo), jwl, jk)
        tv, tp = TB.eval_pdf(tt, torch.tensor(idx), t["wi"], t["wo"], twl)
        assert _rel(tv, jv) <= 1e-4 and _rel(tp, jp) <= 1e-4
        je = np.asarray(JP._pol_weight_eval(jt, jnp.asarray(idx),
                                            jnp.asarray(wi), jnp.asarray(wo),
                                            jv, jk, wavelengths=jwl))
        te = TP._pol_weight_eval(tt, torch.tensor(idx), t["wi"], t["wo"],
                                 tv, TB.table_kinds(tt),
                                 wavelengths=twl).numpy()
        assert _held(_lane_rel(te, je))
        js = np.asarray(JP._pol_weight_sample(
            jt, jnp.asarray(idx), jnp.asarray(wi), jr[0], jr[1], jr[2], jk,
            wavelengths=jwl))
        ts = TP._pol_weight_sample(tt, torch.tensor(idx), t["wi"],
                                   torch.tensor(np.asarray(jr[0])),
                                   torch.tensor(np.asarray(jr[1])),
                                   torch.tensor(np.asarray(jr[2])),
                                   TB.table_kinds(tt),
                                   wavelengths=twl).numpy()
        assert _held(_lane_rel(ts, js))
    for kind, data in ((17, "measured"), (18, "measured_pol")):
        try:
            TB.make_material_table(kinds=[0, kind], albedos=[[0.5] * 3] * 2,
                                   device="cpu")
        except ValueError as e:
            assert f"{data} dataset" in str(e)
        else:
            raise AssertionError(f"kind {kind} without its dataset")
