"""Shared parts of the attached pdf's gradient tests (the adjoints K7 and
K8 in their plain versions) against the JAX package: the case, the JAX
references by block and the four adjoint tests, which
tests/test_torch_pdf_grad_{hit,nee}.py collect in files of at most 3
items (pytest-xdist's `--dist loadfile` hands those out after
tests/test_multihost.py); tests/test_torch_pdf_grad.py keeps the
wrappers' routing with the pdf attached.

Both packages run on the CPU from the same numpy-seeded inputs and
cotangents, a cotangent on the pdf as well as on the radiance. The JAX
side takes `jax.vjp` of `_hit_rgb_jnp` / `_sample_eval_rgb_jnp` and, at
the 3e-2 bar of the adjoint kernels, the Pallas kernels K7 and K8 in
interpret mode; the port takes torch autograd through its plain versions,
which is what CPU tensors run and what the CUDA kernels are held against
on the card (chip_smoke.py).
"""

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops.pallas import sunsky_kernel as JK

from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
_FIELDS = ("sky_params", "sky_radiance", "sun_radiance", "sun_frame_n",
           "params.sky_scale", "params.sun_scale",
           "params.sun_half_aperture", "params.disc_softness", "gaussians",
           "sun_angles", "sky_sampling_w", "sun_frame_s", "sun_frame_t")
# cotangents that sum the disc surrogate's ramp lanes
# (tests/torch_grad_case.py::_check_fields)
_RAMP = ("sun_frame_n", "params.sun_half_aperture", "params.disc_softness")


def _get(obj, path):
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def case():
    """(JAX state, the port's state, 400 directions of which 40 at the
    disc edge (tests/torch_grad_case.py::adjoint_case) and 50 below the
    horizon, uniforms, the radiance's and the pdf's cotangents)."""
    tables = JT.load_tables("rgb")
    js = jax.jit(lambda p: JM.precompute(tables, p, "rgb"))(
        ts.make_params(turbidity=4.2, albedo=0.25, sun_direction=SUN))
    st = convert.sunsky_state(jax.tree.map(np.asarray, js), device="cpu")
    rng = np.random.default_rng(3)
    d = rng.normal(size=(400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    sun = np.asarray(js.sun_frame_n, np.float32)
    d[:40] = sun + 0.002 * rng.normal(size=(40, 3))
    d[:40] /= np.linalg.norm(d[:40], axis=-1, keepdims=True)
    d[40:90, 2] = -np.abs(d[40:90, 2])
    u2 = rng.uniform(size=(400, 2)).astype(np.float32)
    g_rad = rng.normal(size=(400, 3)).astype(np.float32)
    g_pdf = rng.normal(size=400).astype(np.float32)
    return js, st, d, u2, g_rad, g_pdf


def build_jax_refs(case, block):
    """The JAX references of one block's case ("hit": K7, "nee": K8),
    traced and compiled as one program: {block: (jax.vjp of the jnp path,
    the Pallas adjoint in interpret mode)}."""
    js, _st, d, u2, g_rad, g_pdf = case

    def refs(js, d, u2, g_rad, g_pdf):
        if block == "hit":
            return (jax.vjp(JM._hit_rgb_jnp, js, d)[1]((g_rad, g_pdf)),
                    JK.sunsky_hit_rgb_bwd_pallas(js, d, g_rad, g_pdf,
                                                 interpret=True))
        return (jax.vjp(lambda q: JM._sample_eval_rgb_jnp(q, u2)[1:],
                        js)[1]((g_rad, g_pdf))[0],
                JK.sunsky_nee_rgb_bwd_pallas(js, u2, g_rad, g_pdf,
                                             interpret=True))
    return {block: jax.jit(refs)(js, d, u2, g_rad, g_pdf)}


def _leaf_state(state):
    def leaf(t):
        return t.detach().clone().requires_grad_()
    params = state.params._replace(**{
        f.split(".")[1]: leaf(_get(state, f))
        for f in _FIELDS if f.startswith("params.")})
    return state._replace(params=params, **{
        f: leaf(getattr(state, f)) for f in _FIELDS if "." not in f})


def _torch_grads(outs, st, cts, lanes=()):
    grads = torch.autograd.grad(
        outs, [_get(st, f) for f in _FIELDS] + list(lanes),
        [torch.tensor(c) for c in cts], allow_unused=True)
    named = {f: (np.zeros(tuple(_get(st, f).shape), np.float32) if g is None
                 else g.numpy()) for f, g in zip(_FIELDS, grads)}
    return named, [g.numpy() for g in grads[len(_FIELDS):]]


def _check(named, d_state, tol, ramp_tol, skip=()):
    for f in _FIELDS:
        if f in skip:
            continue
        err = _rel_max(named[f], np.asarray(_get(d_state, f)))
        assert err <= (ramp_tol if f in _RAMP else tol), (f, err)


def _hit_torch(st, d, g_rad, g_pdf):
    leaf = _leaf_state(st)
    d_t = torch.tensor(d, requires_grad=True)
    named, (dd,) = _torch_grads(list(TM._hit_rgb_plain(leaf, d_t)), leaf,
                                [g_rad, g_pdf], [d_t])
    return named, dd


def _nee_torch(st, u2, g_rad, g_pdf):
    leaf = _leaf_state(st)
    _, rad, pdf = TM._sample_eval_rgb_plain(leaf, torch.tensor(u2))
    return _torch_grads([rad, pdf], leaf, [g_rad, g_pdf])[0]


def test_hit_adjoint_plain_matches_jax_vjp(case, jax_refs):
    """K7's plain version (autograd of `_hit_rgb_plain` with the pdf
    attached) against jax.vjp of `_hit_rgb_jnp`: state-field cotangents
    within 1e-4 of their scale (the ramp-driven ones 1e-3), dd within 1e-4
    of each lane's scale; the gaussians and the mixture weight get one."""
    _js, st, d, _u2, g_rad, g_pdf = case
    ds_j, dd_j = jax_refs["hit"][0]
    named, dd = _hit_torch(st, d, g_rad, g_pdf)
    _check(named, ds_j, 1e-4, 1e-3)
    dd_j = np.asarray(dd_j)
    scale = np.abs(dd_j).max(-1, keepdims=True) + 1e-3
    assert (np.abs(dd - dd_j) / scale).max() <= 1e-4
    assert np.abs(named["gaussians"]).max() > 0
    assert np.abs(named["sky_sampling_w"]).max() > 0


def test_hit_adjoint_plain_matches_pallas_adjoint(case, jax_refs):
    """Against the TPU kernel K7 (`sunsky_hit_rgb_bwd_pallas`) in interpret
    mode, at the 3e-2 bar of the adjoint kernels (tests/test_pallas.py)."""
    _js, st, d, _u2, g_rad, g_pdf = case
    ds_p, dd_p = jax_refs["hit"][1]
    named, dd = _hit_torch(st, d, g_rad, g_pdf)
    _check(named, ds_p, 3e-2, 3e-2)
    assert _rel_max(dd, dd_p) <= 3e-2


def test_nee_adjoint_plain_matches_jax_vjp(case, jax_refs):
    """K8's plain version (autograd of `_sample_eval_rgb_plain`'s radiance
    and of its pdf through the sample's placement, the mixture weight
    detached) against jax.vjp of `_sample_eval_rgb_jnp`: within 1e-4, the
    ramp-driven cotangents 1e-3 and the softness 1e-2 (the two packages'
    samples differ by ulps, tests/torch_grad_case.py's K6 jnp test). The
    sun's phi within 1e-3: at a TGMM sample the pdf reads phi_rel, which
    is the sampled angle whatever the sun's phi, so each sky lane's
    placement and pdf terms cancel up to those ulps and only the cone
    samples' remain."""
    _js, st, _d, u2, g_rad, g_pdf = case
    ds_j = jax_refs["nee"][0]
    named = _nee_torch(st, u2, g_rad, g_pdf)
    _check(named, ds_j, 1e-4, 1e-3,
           skip=("params.disc_softness", "sun_angles"))
    assert _rel_max(named["params.disc_softness"],
                    ds_j.params.disc_softness) <= 1e-2
    assert _rel_max(named["sun_angles"], ds_j.sun_angles) <= 1e-3
    assert np.abs(named["gaussians"]).max() > 0
    assert np.abs(named["sky_sampling_w"]).max() == 0     # detached


def test_nee_adjoint_plain_matches_pallas_adjoint(case, jax_refs):
    """Against the TPU kernel K8 (`sunsky_nee_rgb_bwd_pallas`) in interpret
    mode at the 3e-2 bar. The cone samples' frame s and t get cotangents
    that cancel to ~1e-11 of the frame n's, and the sun's phi one that
    cancels on the sky samples, below the noise of the TPU kernel's
    polynomial sampler; the jnp test above holds them."""
    _js, st, _d, u2, g_rad, g_pdf = case
    ds_p = jax_refs["nee"][1]
    named = _nee_torch(st, u2, g_rad, g_pdf)
    _check(named, ds_p, 3e-2, 3e-2,
           skip=("sun_frame_s", "sun_frame_t", "sun_angles"))
