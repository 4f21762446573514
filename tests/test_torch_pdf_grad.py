"""The attached pdf's gradients (the adjoints K7 and K8 in their plain
versions) against the JAX package, and the wrappers' routing with the pdf
attached.

Both packages run on the CPU from the same numpy-seeded inputs and
cotangents, a cotangent on the pdf as well as on the radiance. The JAX
side takes `jax.vjp` of `_hit_rgb_jnp` / `_sample_eval_rgb_jnp` and, at
the 3e-2 bar of the adjoint kernels, the Pallas kernels K7 and K8 in
interpret mode; the port takes torch autograd through its plain versions,
which is what CPU tensors run and what the CUDA kernels are held against
on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops.pallas import sunsky_kernel as JK

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import sunsky_kernel as TK

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
_FIELDS = ("sky_params", "sky_radiance", "sun_radiance", "sun_frame_n",
           "params.sky_scale", "params.sun_scale",
           "params.sun_half_aperture", "params.disc_softness", "gaussians",
           "sun_angles", "sky_sampling_w", "sun_frame_s", "sun_frame_t")
# cotangents that sum the disc surrogate's ramp lanes
# (tests/test_torch_grad.py::_check_fields)
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
    disc edge (tests/test_torch_grad.py:146-162) and 50 below the
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


def test_hit_adjoint_plain_matches_jax_vjp(case):
    """K7's plain version (autograd of `_hit_rgb_plain` with the pdf
    attached) against jax.vjp of `_hit_rgb_jnp`: state-field cotangents
    within 1e-4 of their scale (the ramp-driven ones 1e-3), dd within 1e-4
    of each lane's scale; the gaussians and the mixture weight get one."""
    js, st, d, _u2, g_rad, g_pdf = case
    ds_j, dd_j = jax.jit(lambda s, d: jax.vjp(JM._hit_rgb_jnp, s, d)[1](
        (g_rad, g_pdf)))(js, d)
    named, dd = _hit_torch(st, d, g_rad, g_pdf)
    _check(named, ds_j, 1e-4, 1e-3)
    dd_j = np.asarray(dd_j)
    scale = np.abs(dd_j).max(-1, keepdims=True) + 1e-3
    assert (np.abs(dd - dd_j) / scale).max() <= 1e-4
    assert np.abs(named["gaussians"]).max() > 0
    assert np.abs(named["sky_sampling_w"]).max() > 0


def test_hit_adjoint_plain_matches_pallas_adjoint(case):
    """Against the TPU kernel K7 (`sunsky_hit_rgb_bwd_pallas`) in interpret
    mode, at the 3e-2 bar of the adjoint kernels (tests/test_pallas.py)."""
    js, st, d, _u2, g_rad, g_pdf = case
    ds_p, dd_p = JK.sunsky_hit_rgb_bwd_pallas(
        js, jnp.asarray(d), jnp.asarray(g_rad), jnp.asarray(g_pdf),
        interpret=True)
    named, dd = _hit_torch(st, d, g_rad, g_pdf)
    _check(named, ds_p, 3e-2, 3e-2)
    assert _rel_max(dd, dd_p) <= 3e-2


def test_nee_adjoint_plain_matches_jax_vjp(case):
    """K8's plain version (autograd of `_sample_eval_rgb_plain`'s radiance
    and of its pdf through the sample's placement, the mixture weight
    detached) against jax.vjp of `_sample_eval_rgb_jnp`: within 1e-4, the
    ramp-driven cotangents 1e-3 and the softness 1e-2 (the two packages'
    samples differ by ulps, tests/test_torch_grad.py:218-222). The sun's
    phi within 1e-3: at a TGMM sample the pdf reads phi_rel, which is the
    sampled angle whatever the sun's phi, so each sky lane's placement and
    pdf terms cancel up to those ulps and only the cone samples' remain."""
    js, st, _d, u2, g_rad, g_pdf = case
    (ds_j,) = jax.jit(lambda s: jax.vjp(
        lambda q: JM._sample_eval_rgb_jnp(q, u2)[1:], s)[1](
            (g_rad, g_pdf)))(js)
    named = _nee_torch(st, u2, g_rad, g_pdf)
    _check(named, ds_j, 1e-4, 1e-3,
           skip=("params.disc_softness", "sun_angles"))
    assert _rel_max(named["params.disc_softness"],
                    ds_j.params.disc_softness) <= 1e-2
    assert _rel_max(named["sun_angles"], ds_j.sun_angles) <= 1e-3
    assert np.abs(named["gaussians"]).max() > 0
    assert np.abs(named["sky_sampling_w"]).max() == 0     # detached


def test_nee_adjoint_plain_matches_pallas_adjoint(case):
    """Against the TPU kernel K8 (`sunsky_nee_rgb_bwd_pallas`) in interpret
    mode at the 3e-2 bar. The cone samples' frame s and t get cotangents
    that cancel to ~1e-11 of the frame n's, and the sun's phi one that
    cancels on the sky samples, below the noise of the TPU kernel's
    polynomial sampler; the jnp test above holds them."""
    js, st, _d, u2, g_rad, g_pdf = case
    ds_p = JK.sunsky_nee_rgb_bwd_pallas(js, jnp.asarray(u2),
                                        jnp.asarray(g_rad),
                                        jnp.asarray(g_pdf), interpret=True)
    named = _nee_torch(st, u2, g_rad, g_pdf)
    _check(named, ds_p, 3e-2, 3e-2,
           skip=("sun_frame_s", "sun_frame_t", "sun_angles"))


# ---------------------------------------------------------------------------
# the wrappers with the pdf attached
# ---------------------------------------------------------------------------


def test_wrappers_with_attached_pdf_take_plain_versions_on_cpu(case):
    """On the CPU the wrappers run the plain versions with the pdf
    attached (RGB and spectral): the same values and the same gradients,
    nothing launched, the kernel library never built."""
    _js, st, d, u2, g_rad, g_pdf = case
    build.reset_launches()
    leaf = _leaf_state(st)
    d_t = torch.tensor(d)
    rad, pdf = TK.sunsky_hit_rgb(leaf, d_t, pdf_detached=False)
    rad_p, pdf_p = TM._hit_rgb_plain(leaf, d_t)
    assert torch.equal(rad, rad_p) and torch.equal(pdf, pdf_p)
    gw = torch.autograd.grad((pdf * torch.tensor(g_pdf)).sum(),
                             [leaf.gaussians, leaf.sky_sampling_w])
    gw_p = torch.autograd.grad((pdf_p * torch.tensor(g_pdf)).sum(),
                               [leaf.gaussians, leaf.sky_sampling_w])
    assert all(torch.equal(a, b) for a, b in zip(gw, gw_p))
    u_t = torch.tensor(u2)
    for a, b in zip(TK.sunsky_nee_rgb(leaf, u_t, pdf_detached=False),
                    TM._sample_eval_rgb_plain(leaf, u_t)):
        assert torch.equal(a, b)
    spec = tt.sunsky_precompute(tt.make_params(
        sun_direction=SUN, mode="spectral", device="cpu"), mode="spectral")
    wl = torch.full((400, 4), 550.0)
    for a, b in zip(TK.sunsky_hit_spec(spec, d_t, wl, pdf_detached=False),
                    TM._hit_spec_plain(spec, d_t, wl)):
        assert torch.equal(a, b)
    for a, b in zip(TK.sunsky_nee_spec(spec, u_t, wl, pdf_detached=False),
                    TM._sample_eval_spec_plain(spec, u_t, wl)):
        assert torch.equal(a, b)
    # the emitter API keeps the pdf attached unless asked to detach it
    assert TM.eval_pdf(leaf, d_t)[1].requires_grad
    assert not TM.eval_pdf(leaf, d_t, pdf_detached=True)[1].requires_grad
    assert TM.sample_eval(spec._replace(
        gaussians=spec.gaussians.clone().requires_grad_()), u_t,
        mode="spectral", wavelengths=wl)[2].requires_grad
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0


@pytest.mark.parametrize("call", ["hit_rgb", "nee_rgb", "hit_spec",
                                  "nee_spec"])
def test_wrappers_with_attached_pdf_refuse_other_devices(case, call):
    """A tensor that is neither on the CPU nor on a CUDA device is refused
    with the pdf attached too, never routed to the plain version."""
    _js, st, *_ = case
    d, u2 = torch.empty((8, 3), device="meta"), torch.empty((8, 2),
                                                            device="meta")
    wl = torch.empty((8, 4), device="meta")
    run = {"hit_rgb": lambda: TK.sunsky_hit_rgb(st, d, pdf_detached=False),
           "nee_rgb": lambda: TK.sunsky_nee_rgb(st, u2, pdf_detached=False),
           "hit_spec": lambda: TK.sunsky_hit_spec(st, d, wl,
                                                  pdf_detached=False),
           "nee_spec": lambda: TK.sunsky_nee_spec(st, u2, wl,
                                                  pdf_detached=False)}
    with pytest.raises(ValueError, match="CUDA"):
        run[call]()
