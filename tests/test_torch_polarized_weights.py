"""The Mueller weights of the port's Stokes path
(`tpusky_torch/render/polarized.py`) against the JAX package's on the
CPU: `_pol_weight_eval` and `_pol_weight_sample` for every
polarization-aware kind (rough conductor, conductor, dielectric,
pplastic, polarizer, retarder, circular) beside the depolarizing diffuse
kind, one-sided and two-sided, RGB and spectral, textured or not; and
the helpers on their degenerate inputs (normal incidence, a ray along
the sensor's vertical, a zero Fresnel matrix).

Each lane's matrix is held within 1e-4 of its largest entry, the bar of
the scalar BSDF it is built on (tests/test_torch_bsdf_breadth.py). The
lanes that cross a threshold on one side only (the collinear s-axis,
|a|^2 < 1e-18; M00 > 1e-12; pdf > 1e-12; the basis rotations' sign test)
are counted and capped at 0.1%.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ops import mueller as JMU
from tpusky.render import bsdf as JB
from tpusky.render import polarized as JP
from tpusky.render import sensors as JS

from tpusky_torch.ops import mueller as TMU
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import polarized as TP
from tpusky_torch.render import sensors as TS

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096
BAR = 1e-4
FLIP_CAP = 1e-3
KINDS = [1, 2, 3, 11, 12, 13, 14, 0, 1, 2, 11]
TWOSIDED = [False] * 8 + [True] * 3


def _table_cols():
    m = len(KINDS)
    rng = np.random.default_rng(5)
    extras = np.zeros((m, 8), np.float32)
    extras[:, :2] = rng.uniform(0.0, 180.0, (m, 2))
    extras[6, 2] = 1.0
    return dict(kinds=KINDS, albedos=rng.uniform(0.1, 0.9, (m, 3)),
                twosided=TWOSIDED, alphas=rng.uniform(0.05, 0.5, m),
                iors=rng.uniform(1.3, 1.7, m),
                etas=rng.uniform(0.1, 1.5, (m, 3)),
                ks=rng.uniform(0.5, 4.0, (m, 3)),
                spectral_albedos=rng.uniform(0.1, 0.9, (m, 11)))


def _units(rng, n=N):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def _lane_err(port, ref):
    port = np.asarray(port, np.float64)
    ref = np.asarray(ref, np.float64)
    err = np.abs(port - ref).reshape(port.shape[0], -1).max(-1)
    scale = np.abs(ref).reshape(ref.shape[0], -1).max(-1)
    return err / np.maximum(scale, 1e-6)


def _hold(port, ref, what):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    assert np.isfinite(port).all(), what
    out = _lane_err(port, ref) > BAR
    assert out.mean() <= FLIP_CAP, (what, int(out.sum()),
                                    float(_lane_err(port, ref).max()))
    return out


def _inputs(mode, seed):
    rng = np.random.default_rng(seed)
    cols = _table_cols()
    jt = JB.make_material_table(**cols)
    tt = TB.make_material_table(device="cpu", **cols)
    idx = (np.arange(N) % len(KINDS)).astype(np.int64)
    wi, wo = _units(rng), _units(rng)
    # an eighth of the lanes reflect wi into the mirror direction
    wo[: N // 8] = wi[: N // 8] * np.float32([-1, -1, 1])
    wl = (None if mode == "rgb" else
          rng.uniform(360.0, 830.0, (N, 4)).astype(np.float32))
    nc = 3 if wl is None else 4
    tex = (rng.uniform(0.0, 1.0, (N, nc)).astype(np.float32),
           rng.random(N) < 0.5)
    u2 = rng.random((N, 2), dtype=np.float32)
    u1 = rng.random((N,), dtype=np.float32)
    return jt, tt, idx, wi, wo, wl, tex, u2, u1


def test_pol_weight_eval_matches_jax():
    """`_pol_weight_eval` of evaluated direction pairs: polarized Fresnel
    scaled onto the scalar value (rough conductor), pplastic's Mueller
    eval, the depolarizer of every other kind."""
    for mode in ("rgb", "spectral"):
        for textured in (False, True):
            jt, tt, idx, wi, wo, wl, tex, _, _ = _inputs(mode, 1)
            kinds = TB.table_kinds(tt)
            tex_j = (jnp.asarray(tex[0]), jnp.asarray(tex[1])) \
                if textured else None
            tex_t = (torch.tensor(tex[0]), torch.tensor(tex[1])) \
                if textured else None
            wl_j = None if wl is None else jnp.asarray(wl)
            wl_t = None if wl is None else torch.tensor(wl)
            val_j, _ = JB.eval_pdf(jt, jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(wi), jnp.asarray(wo), wl_j,
                                   kinds=kinds, refl_tex=tex_j)
            m_j = JP._pol_weight_eval(jt, jnp.asarray(idx, jnp.int32),
                                      jnp.asarray(wi), jnp.asarray(wo),
                                      val_j, kinds, tex_j, wl_j)
            m_t = TP._pol_weight_eval(tt, torch.tensor(idx),
                                      torch.tensor(wi), torch.tensor(wo),
                                      torch.tensor(np.asarray(val_j)), kinds,
                                      tex_t, wl_t)
            _hold(m_t, m_j, f"eval {mode} textured {textured}")
            kind = np.asarray(KINDS)[idx]
            pol = np.abs(m_t.numpy()[..., 1:, :]).reshape(N, -1).max(-1)
            for k in (1, 11):
                assert (pol[kind == k] > 1e-3).any(), (mode, k)
            assert (pol[kind == 0] == 0).all()


def test_pol_weight_sample_matches_jax():
    """`_pol_weight_sample` of the reference's own samples: the smooth
    conductor's and dielectric's Fresnel matrices (reflection and
    refraction), the filters' (polarizer, quarter- and other-wave
    retarders, both circular polarizers), the eval's matrix over the pdf
    for the rough conductor and pplastic, a depolarizer for diffuse."""
    for mode in ("rgb", "spectral"):
        for textured in (False, True):
            jt, tt, idx, wi, _, wl, tex, u2, u1 = _inputs(mode, 2)
            kinds = TB.table_kinds(tt)
            tex_j = (jnp.asarray(tex[0]), jnp.asarray(tex[1])) \
                if textured else None
            tex_t = (torch.tensor(tex[0]), torch.tensor(tex[1])) \
                if textured else None
            wl_j = None if wl is None else jnp.asarray(wl)
            wl_t = None if wl is None else torch.tensor(wl)
            idx_j = jnp.asarray(idx, jnp.int32)
            wo_j, w_j, pdf_j, _ = JB.sample(jt, idx_j, jnp.asarray(wi),
                                            jnp.asarray(u2),
                                            jnp.asarray(u1), wl_j,
                                            kinds=kinds, refl_tex=tex_j)
            m_j = JP._pol_weight_sample(jt, idx_j, jnp.asarray(wi), wo_j,
                                        w_j, pdf_j, kinds, tex_j, wl_j)
            m_t = TP._pol_weight_sample(
                tt, torch.tensor(idx), torch.tensor(wi),
                torch.tensor(np.asarray(wo_j)), torch.tensor(np.asarray(w_j)),
                torch.tensor(np.asarray(pdf_j)), kinds, tex_t, wl_t)
            _hold(m_t, m_j, f"sample {mode} textured {textured}")
            kind = np.asarray(KINDS)[idx]
            pol = np.abs(m_t.numpy()[..., 1:, :]).reshape(N, -1).max(-1)
            for k in (1, 2, 3, 11, 12, 13, 14):
                assert (pol[kind == k] > 1e-3).any(), (mode, k)
            assert (pol[kind == 0] == 0).all()


def test_helpers_match_jax_on_degenerate_inputs():
    """`_specular_mueller_local` at normal incidence (the collinear
    s-axis fallback) and off it, `_filter_mueller_local` along the normal
    and off it, `_polarize_scaled` of a zero matrix, `_conductor_eta_k` in
    both modes and `sensor_stokes_rotation` for rays along the sensor's
    vertical (the implicit basis kept) and off it."""
    rng = np.random.default_rng(3)
    n = 512
    wi = _units(rng, n)
    wi[:64] = [0.0, 0.0, 1.0]                       # normal incidence
    wi[64:128] = [0.0, 0.0, -1.0]
    wo = wi * np.float32([-1, -1, 1])
    nrm = np.broadcast_to(np.float32([0, 0, 1]), (n, 3)).copy()
    eta = rng.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    k = rng.uniform(0.0, 4.0, (n, 3)).astype(np.float32)
    for args_j, args_t, kw in (
            ((wi, wo, nrm, eta, k), None, {}),
            ((wi, -wi, nrm, eta[:, :1] + 1.0), None,
             dict(transmission=True))):
        args_t = tuple(torch.tensor(a) for a in args_j)
        out = _hold(TP._specular_mueller_local(*args_t, **kw),
                    JP._specular_mueller_local(*args_j, **kw),
                    f"specular {kw}")
        assert not out[:128].any()
    # the filters, each at normal incidence and off it
    cols = _table_cols()
    jt = JB.make_material_table(**cols)
    tt = TB.make_material_table(device="cpu", **cols)
    idx = np.asarray([4, 5, 6] * (n // 3) + [4] * (n % 3), np.int64)
    trans = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    kind = np.asarray(KINDS)[idx]
    m_j = JP._filter_mueller_local(jt, jnp.asarray(idx, jnp.int32),
                                   jnp.asarray(kind), jnp.asarray(wi),
                                   jnp.asarray(trans))
    m_t = TP._filter_mueller_local(tt, torch.tensor(idx), torch.tensor(kind),
                                   torch.tensor(wi), torch.tensor(trans),
                                   (12, 13, 14))
    assert not _hold(m_t, m_j, "filters")[:128].any()
    # a zero Fresnel matrix scales to zero, not to NaN
    zero = torch.zeros((n, 3, 4, 4))
    assert torch.equal(TP._polarize_scaled(zero, torch.ones(n, 3)), zero)
    s = TP._polarize_scaled(torch.tensor(np.asarray(JMU.depolarizer(eta))),
                            torch.tensor(k))
    np.testing.assert_allclose(s.numpy()[..., 0, 0], k, rtol=1e-6)
    for wl in (None, rng.uniform(400, 700, (n, 4)).astype(np.float32)):
        e_j = JP._conductor_eta_k(jt, jnp.asarray(idx, jnp.int32),
                                  None if wl is None else jnp.asarray(wl))
        e_t = TP._conductor_eta_k(tt, torch.tensor(idx),
                                  None if wl is None else torch.tensor(wl))
        for a, b in zip(e_t, e_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    # the sensor rotation, a quarter of the rays along the vertical
    cam_j = JS.make_perspective([4.0, -4.0, 2.2], [0.0, 0.0, 0.8],
                                fov_x_deg=50)
    cam_t = TS.make_perspective([4.0, -4.0, 2.2], [0.0, 0.0, 0.8],
                                fov_x_deg=50, device="cpu")
    d = _units(rng, n)
    up = np.asarray(cam_j.to_world)[:3, 1]
    d[: n // 4] = up * np.where(np.arange(n // 4) % 2, 1, -1)[:, None]
    for sensor_j, sensor_t in ((cam_j, cam_t), (None, None)):
        r_j = JP.sensor_stokes_rotation(sensor_j, jnp.asarray(d))
        r_t = TP.sensor_stokes_rotation(sensor_t, torch.tensor(d))
        _hold(r_t, r_j, f"sensor rotation {sensor_j is None}")
    r_t = TP.sensor_stokes_rotation(cam_t, torch.tensor(d[: n // 4]))
    np.testing.assert_allclose(r_t.numpy(), np.broadcast_to(np.eye(4), (
        n // 4, 4, 4)), atol=1e-6)
    assert TMU.stokes_basis(torch.tensor(d)).shape == (n, 3)
