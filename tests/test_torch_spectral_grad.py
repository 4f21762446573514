"""Spectral gradients of the port (`tpusky_torch`) against the JAX package.

Both run on the CPU from the same numpy-seeded inputs and cotangents. The
JAX side takes `jax.vjp`/`jax.grad` of its jnp path and, at the adjoint
kernels' 3e-2 bar, its Pallas adjoints K12 and K13 in interpret mode; the
port takes torch autograd through its plain versions, which is what CPU
tensors run and what the CUDA kernels K12 and K13 are held against on the
card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops import spectrum as JSP
from tpusky.ops.pallas import sunsky_kernel as JK

from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
# the state fields the spectral radiance reads, and those the pdf adds
_RAD = ("sky_params", "sky_radiance", "sun_radiance", "sun_ld",
        "sun_frame_n", "params.sky_scale", "params.sun_scale",
        "params.sun_half_aperture", "params.disc_softness")
_PDF = ("gaussians", "sun_angles", "sky_sampling_w", "sun_frame_s",
        "sun_frame_t")
# cotangents that sum the disc surrogate's ramp lanes: one ulp of
# cos(gamma) moves a disc-edge lane across the ramp's clamp
# (tests/test_torch_grad.py::_check_fields)
_RAMP = ("sun_frame_n", "params.sun_half_aperture", "params.disc_softness")


def _get(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _leaf_state(state, fields):
    def leaf(t):
        return t.detach().clone().requires_grad_()
    params = state.params._replace(**{
        f.split(".")[1]: leaf(_get(state, f))
        for f in fields if f.startswith("params.")})
    return state._replace(params=params, **{
        f: leaf(getattr(state, f)) for f in fields if "." not in f})


def _torch_grads(outs, st, fields, cts, lanes=()):
    grads = torch.autograd.grad(
        outs, [_get(st, f) for f in fields] + list(lanes),
        [torch.tensor(c) for c in cts], allow_unused=True)
    named = {f: (np.zeros(tuple(_get(st, f).shape), np.float32) if g is None
                 else g.numpy()) for f, g in zip(fields, grads)}
    return named, [g.numpy() for g in grads[len(fields):]]


def _check(named_t, d_state_j, fields, tol, ramp_tol, soft_tol=None):
    for f in fields:
        bar = ramp_tol if f in _RAMP else tol
        if f == "params.disc_softness" and soft_tol is not None:
            bar = soft_tol
        err = _rel_max(named_t[f], np.asarray(_get(d_state_j, f)))
        assert err <= bar, (f, err)


def _lane_err(a, b):
    """Per-lane error over each lane's scale (floor 1e-3)."""
    a, b = np.asarray(a), np.asarray(b)
    return (np.abs(a - b) / (np.abs(b).max(-1, keepdims=True) + 1e-3)).max()


@pytest.fixture(scope="module")
def jax_tables():
    return JT.load_tables("spectral")


@pytest.fixture(scope="module")
def torch_tables():
    return TT.load_tables("spectral", device="cpu")


# ---------------------------------------------------------------------------
# K12 and K13 in their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def case(jax_tables):
    """(JAX state, the port's state, 400 directions: 40 at the disc edge,
    50 below the horizon; uniforms; 4 wavelengths a lane from
    sample_rgb_spectrum with some past 720 nm and one exactly at 720;
    cotangents of the radiance and the pdf)."""
    js = jax.jit(lambda p: JM.precompute(jax_tables, p, "spectral"))(
        ts.make_params(turbidity=4.2, albedo=0.25, sun_direction=SUN,
                       mode="spectral"))
    st = convert.sunsky_state(jax.tree.map(np.asarray, js), device="cpu")
    rng = np.random.default_rng(3)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.asarray(js.sun_frame_n, np.float32)
    d[:40] = sun + 0.002 * rng.normal(size=(40, 3))
    d[:40] /= np.linalg.norm(d[:40], axis=-1, keepdims=True)
    d[40:90, 2] = -np.abs(d[40:90, 2])
    u2 = rng.uniform(size=(400, 2)).astype(np.float32)
    wl = np.asarray(JSP.sample_rgb_spectrum(JSP.sample_shifted(
        jnp.asarray(rng.uniform(size=400).astype(np.float32)), 4))[0])
    wl = wl.copy()
    wl[0, 0] = 720.0
    assert (wl > 720.0).any() and (wl < 720.0).any()
    g_rad = rng.normal(size=(400, 4)).astype(np.float32)
    g_pdf = rng.normal(size=400).astype(np.float32)
    return js, st, d, u2, wl, g_rad, g_pdf


def _hit_jax(js, d, wl, g_rad, g_pdf, with_pdf):
    if with_pdf:
        _, pull = jax.vjp(JM._hit_spec_jnp, js, d, wl)
        return pull((g_rad, g_pdf))
    _, pull = jax.vjp(JM._eval_spec_jnp, js, d, wl)
    return pull(g_rad)


def _nee_jax(js, u2, wl, g_rad, g_pdf, with_pdf):
    if with_pdf:
        _, pull = jax.vjp(
            lambda q, x: JM._sample_eval_spec_jnp(q, u2, x)[1:], js, wl)
        return pull((g_rad, g_pdf))
    _, pull = jax.vjp(
        lambda q, x: JM._sample_eval_spec_jnp_rg(q, u2, x)[1], js, wl)
    return pull(g_rad)


@pytest.fixture(scope="module")
def jax_refs(case):
    """Every JAX reference of the K12 and K13 cases below, traced and
    compiled as one program (one compile, not eight): {(block, with_pdf):
    (jax.vjp of the jnp path, the Pallas adjoint in interpret mode)}."""
    js, _st, d, u2, wl, g_rad, g_pdf = case

    def refs(js, d, u2, wl, g_rad, g_pdf):
        out = {}
        for p in (False, True):
            gp = g_pdf if p else None
            out[f"hit-{p}"] = (
                _hit_jax(js, d, wl, g_rad, g_pdf, p),
                JK.sunsky_hit_spec_bwd_pallas(js, d, wl, g_rad, gp,
                                              with_pdf=p, interpret=True))
            out[f"nee-{p}"] = (
                _nee_jax(js, u2, wl, g_rad, g_pdf, p),
                JK.sunsky_nee_spec_bwd_pallas(js, u2, wl, g_rad, gp,
                                              with_pdf=p, interpret=True))
        return out
    return jax.jit(refs)(js, d, u2, wl, g_rad, g_pdf)


def _hit_torch(st, d, wl, g_rad, g_pdf, with_pdf):
    fields = _RAD + (_PDF if with_pdf else ())
    leaf = _leaf_state(st, fields)
    d_t = torch.tensor(d, requires_grad=True)
    wl_t = torch.tensor(wl, requires_grad=True)
    if with_pdf:
        outs, cts = list(TM._hit_spec_plain(leaf, d_t, wl_t)), [g_rad, g_pdf]
    else:
        outs, cts = [TM._eval_spec_plain(leaf, d_t, wl_t)], [g_rad]
    named, (dd, dwl) = _torch_grads(outs, leaf, fields, cts, [d_t, wl_t])
    return fields, named, dd, dwl


@pytest.mark.parametrize("with_pdf", [False, True], ids=["eval", "hit"])
def test_hit_spec_adjoint_plain_matches_jax_vjp(case, jax_refs, with_pdf):
    """K12's plain version, without the pdf (autograd of
    `_eval_spec_plain`, what K9 transposes into) and with it (of
    `_hit_spec_plain`), against jax.vjp of `_eval_spec_jnp` /
    `_hit_spec_jnp`: state-field cotangents within 1e-4 of their scale
    (the ramp-driven ones 1e-3), dd and dwl within 1e-4 of each lane's
    scale; dwl exactly 0 below the horizon and at or past 720 nm."""
    _js, st, d, _u2, wl, g_rad, g_pdf = case
    ds_j, dd_j, dwl_j = jax_refs[f"hit-{with_pdf}"][0]
    fields, named, dd, dwl = _hit_torch(st, d, wl, g_rad, g_pdf, with_pdf)
    _check(named, ds_j, fields, 1e-4, 1e-3)
    assert _lane_err(dd, dd_j) <= 1e-4
    assert _lane_err(dwl, dwl_j) <= 1e-4
    out = (d[:, 2:] < 0) | (wl >= 720.0)
    assert (dwl[out] == 0).all() and (np.abs(dwl[~out]) > 0).mean() > 0.5
    assert np.abs(named["sun_radiance"]).max() > 0       # disc lanes count


@pytest.mark.parametrize("with_pdf", [False, True], ids=["eval", "hit"])
def test_hit_spec_adjoint_plain_matches_pallas_adjoint(case, jax_refs,
                                                       with_pdf):
    """Against the TPU kernel K12 (`sunsky_hit_spec_bwd_pallas`) in
    interpret mode, whose polynomial trigonometry is loose at the disc
    edge: the Pallas adjoints' 3e-2 bar (tests/test_pallas.py:236)."""
    _js, st, d, _u2, wl, g_rad, g_pdf = case
    ds_p, dd_p, dwl_p = jax_refs[f"hit-{with_pdf}"][1]
    fields, named, dd, dwl = _hit_torch(st, d, wl, g_rad, g_pdf, with_pdf)
    _check(named, ds_p, fields, 3e-2, 3e-2)
    assert _rel_max(dd, dd_p) <= 3e-2 and _rel_max(dwl, dwl_p) <= 3e-2


def _nee_torch(st, u2, wl, g_rad, g_pdf, with_pdf):
    fields = _RAD + (_PDF if with_pdf else ())
    leaf = _leaf_state(st, fields)
    wl_t = torch.tensor(wl, requires_grad=True)
    _, rad, pdf = TM._sample_eval_spec_plain(leaf, torch.tensor(u2), wl_t)
    outs, cts = ([rad, pdf], [g_rad, g_pdf]) if with_pdf else ([rad],
                                                                [g_rad])
    named, (dwl,) = _torch_grads(outs, leaf, fields, cts, [wl_t])
    return fields, named, dwl


@pytest.mark.parametrize("with_pdf", [False, True], ids=["detached", "pdf"])
def test_nee_spec_adjoint_plain_matches_jax_vjp(case, jax_refs, with_pdf):
    """K13's plain version (autograd of `_sample_eval_spec_plain`'s
    radiance, and with it its pdf through the sample's placement) against
    jax.vjp of `_sample_eval_spec_jnp_rg` / `_sample_eval_spec_jnp`. The
    two packages' samples differ by ulps, which moves a ramp lane's
    softness cotangent by ~1e-2 (tests/test_torch_grad.py:218-222) and a
    lane's wavelength cotangent by ~1e-4 of its scale: dwl within 1e-3."""
    _js, st, _d, u2, wl, g_rad, g_pdf = case
    ds_j, dwl_j = jax_refs[f"nee-{with_pdf}"][0]
    fields, named, dwl = _nee_torch(st, u2, wl, g_rad, g_pdf, with_pdf)
    _check(named, ds_j, fields, 1e-4, 1e-3, soft_tol=1e-2)
    assert _lane_err(dwl, dwl_j) <= 1e-3
    assert np.abs(named["sun_radiance"]).max() > 0       # sun-cone samples
    if with_pdf:
        assert np.abs(named["gaussians"]).max() > 0


@pytest.mark.parametrize("with_pdf", [False, True], ids=["detached", "pdf"])
def test_nee_spec_adjoint_plain_matches_pallas_adjoint(case, jax_refs,
                                                       with_pdf):
    """Against the TPU kernel K13 (`sunsky_nee_spec_bwd_pallas`) in
    interpret mode, at the 3e-2 bar of the adjoint kernels. The cone
    samples' frame s and t get cotangents that cancel to ~1e-11 of the
    frame n's, below the noise of the TPU kernel's polynomial sampler; the
    jnp test above holds them at 1e-4."""
    _js, st, _d, u2, wl, g_rad, g_pdf = case
    ds_p, dwl_p = jax_refs[f"nee-{with_pdf}"][1]
    fields, named, dwl = _nee_torch(st, u2, wl, g_rad, g_pdf, with_pdf)
    _check(named, ds_p, [f for f in fields
                         if f not in ("sun_frame_s", "sun_frame_t")],
           3e-2, 3e-2)
    assert _rel_max(dwl, dwl_p) <= 3e-2
