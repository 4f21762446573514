"""The port's spectral sunsky (`tpusky_torch`) against the JAX package
(the tests of K9-K11's plain versions are in
tests/test_torch_spectral_{eval_hit,sample_eval}.py, files of at most 3
items, with the shared code in `torch_spectral_case.py`).

Both run on the CPU from the same numpy-seeded inputs. The JAX side runs
its jnp path and, for the kernels K9-K11, its Pallas kernels in interpret
mode (as tests/test_pallas.py does); the port runs its plain PyTorch
versions, which the kernel wrappers take for CPU tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops import distr as JD
from tpusky.ops import spectrum as JS
from tpusky.ops.pallas import sunsky_kernel as JK

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.ops import distr as TD
from tpusky_torch.ops import spectrum as TS
from tpusky_torch.ops.cuda import build
from tpusky_torch.ops.cuda import sunsky_kernel as TK

from torch_spectral_case import (  # noqa: F401 (shared names, fixtures)
    SUN, _lanes, _rel, jax_precompute, states)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

_STATE_FIELDS = ("sun_angles", "sun_frame_s", "sun_frame_t", "sun_frame_n",
                 "sky_params", "sky_radiance", "sun_radiance", "sun_ld",
                 "gaussians", "sky_sampling_w")


# ---------------------------------------------------------------------------
# tables, colour pipeline, distributions
# ---------------------------------------------------------------------------


def test_load_tables_spectral_bitwise():
    j = JT.load_tables("spectral")
    t = TT.load_tables("spectral", device="cpu")
    for f in ("sky_params", "sky_rad", "sun_rad", "sun_ld", "tgmm"):
        a, b = getattr(t, f), np.asarray(getattr(j, f))
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    assert tuple(t.sun_rad.shape) == (10, 45, 11, 4)
    assert tuple(t.sun_ld.shape) == (11, 6)
    conv = convert.sunsky_tables(jax.tree.map(np.asarray, j), device="cpu")
    for f in TT.SunskyTables._fields:
        assert torch.equal(getattr(conv, f), getattr(t, f))
    with pytest.raises(ValueError):
        TT.load_tables("bands", device="cpu")


def _wavelengths(shape, seed):
    return np.random.default_rng(seed).uniform(
        300.0, 850.0, shape).astype(np.float32)


_SPECTRUM_CASES = {
    "cie1931_xyz": lambda m, wl, v: m.cie1931_xyz(wl),
    "cie1931_y": lambda m, wl, v: m.cie1931_y(wl),
    "cie_d65": lambda m, wl, v: m.cie_d65(wl),
    "luminance_spectral": lambda m, wl, v: m.luminance_spectral(v, wl),
    "spectrum_to_xyz": lambda m, wl, v: m.spectrum_to_xyz(v, wl),
    "spectrum_to_srgb": lambda m, wl, v: m.spectrum_to_srgb(v, wl),
    "xyz_to_srgb": lambda m, wl, v: m.xyz_to_srgb(v[..., :3]),
    "srgb_to_xyz": lambda m, wl, v: m.srgb_to_xyz(v[..., :3]),
    "srgb_gamma": lambda m, wl, v: m.srgb_gamma(v - 0.2),
    "sample_shifted": lambda m, wl, v: m.sample_shifted(v[..., 0] / 1.3, 4),
    "sample_rgb_spectrum": lambda m, wl, v: m.sample_rgb_spectrum(
        v / 1.3001),
    "pdf_rgb_spectrum": lambda m, wl, v: m.pdf_rgb_spectrum(wl),
}


@pytest.mark.parametrize("name", sorted(_SPECTRUM_CASES))
def test_spectrum_matches_jax(name):
    """Every function of ops/spectrum.py within 1e-5 of the JAX package's
    (relative to the output's largest magnitude) on wavelengths across
    and outside the CIE range."""
    wl = _wavelengths((4096, 4), 0)
    v = np.random.default_rng(1).uniform(0.0, 1.3, (4096, 4)).astype(
        np.float32)
    fn = _SPECTRUM_CASES[name]
    ref = jax.jit(lambda a, b: fn(JS, a, b))(wl, v)
    out = fn(TS, torch.tensor(wl), torch.tensor(v))
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    for a, b in zip(outs, refs):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == np.float32
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)


def test_continuous_distribution_matches_jax():
    values = np.random.default_rng(2).uniform(0.2, 3.0, 10).astype(
        np.float32)
    values[4] = values[5]                      # a flat segment (dy == 0)
    jd = JD.make_continuous(jnp.asarray(values), 360.0, 720.0)
    td = TD.make_continuous(torch.tensor(values), 360.0, 720.0)
    for f in TD.ContinuousDistribution._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6)
    u = np.random.default_rng(3).random(4096, dtype=np.float32)
    pos_j, pdf_j = jax.jit(JD.continuous_sample_pdf)(jd, u)
    pos_t, pdf_t = TD.continuous_sample_pdf(td, torch.tensor(u))
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-5)
    x = np.linspace(340.0, 740.0, 801, dtype=np.float32)
    np.testing.assert_allclose(
        TD.continuous_pdf(td, torch.tensor(x)).numpy(),
        np.asarray(jax.jit(JD.continuous_pdf)(jd, x)), rtol=1e-5, atol=1e-9)
    # the sampled positions follow the density
    assert _rel(pdf_t, TD.continuous_pdf(td, pos_t).numpy(), 1e-6).max() \
        <= 1e-4


def test_irregular_distribution_matches_jax():
    nodes = np.array([360.0, 380.0, 430.0, 500.0, 520.0, 610.0, 700.0,
                      830.0], np.float32)
    values = np.random.default_rng(4).uniform(0.0, 2.0, 8).astype(np.float32)
    jd = JD.make_irregular(jnp.asarray(nodes), jnp.asarray(values))
    td = TD.make_irregular(torch.tensor(nodes), torch.tensor(values))
    for f in TD.IrregularContinuousDistribution._fields:
        np.testing.assert_allclose(getattr(td, f).numpy(),
                                   np.asarray(getattr(jd, f)), rtol=1e-6)
    x = np.linspace(340.0, 850.0, 1021, dtype=np.float32)
    np.testing.assert_allclose(
        TD.irregular_eval(td, torch.tensor(x)).numpy(),
        np.asarray(jax.jit(JD.irregular_eval)(jd, x)), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# precompute, conversion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sun", [SUN, [0.8, -0.3, 0.2]])
@pytest.mark.parametrize("turbidity", [3.0, 3.5])
def test_precompute_spectral_matches_jax(jax_precompute, turbidity, sun):
    """Every array of the spectral state, the sky/sun weight and the
    wavelength distribution within 1e-4 of JAX's, relative to the array's
    largest magnitude. Turbidity 3.0 sits on the lerp's kink. The state
    converted from JAX and the one the port precomputes agree."""
    albedo = np.linspace(0.1, 0.6, 11).astype(np.float32)
    js = jax_precompute(ts.make_params(turbidity=turbidity, albedo=albedo,
                                       sun_direction=sun, mode="spectral"))
    conv = convert.sunsky_state(jax.tree.map(np.asarray, js), device="cpu")
    st = TM.precompute(TT.load_tables("spectral", device="cpu"),
                       TM.make_params(turbidity=turbidity, albedo=albedo,
                                      sun_direction=sun, mode="spectral",
                                      device="cpu"), "spectral")
    assert tuple(st.params.albedo.shape) == (11,)
    pairs = [(getattr(st, f), getattr(conv, f), f) for f in _STATE_FIELDS]
    pairs += [(getattr(st.spectral_distr, f), getattr(conv.spectral_distr, f),
               f) for f in TD.ContinuousDistribution._fields]
    pairs += [(getattr(st.gaussian_distr, f), getattr(conv.gaussian_distr, f),
               f) for f in TD.DiscreteDistribution._fields]
    for a, b, f in pairs:
        a, b = a.numpy(), b.numpy()
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), f


def _leaves(obj):
    """The tensors (and Nones) of a nested NamedTuple, in field order."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


def test_precompute_infers_spectral_mode(states):
    """`sunsky_precompute` without a mode takes the one the params were
    built for, as the reference package's does (an 11-channel albedo means
    spectral): leaf for leaf the call with mode="spectral", and within the
    bar of test_precompute_spectral_matches_jax of JAX's state; RGB params
    still give the RGB state."""
    _, conv = states
    kw = dict(turbidity=5.2, albedo=0.25, sun_direction=SUN, device="cpu")
    params = tt.make_params(**kw, mode="spectral")
    st = tt.sunsky_precompute(params)
    for a, b in zip(_leaves(st), _leaves(tt.sunsky_precompute(
            params, mode="spectral")), strict=True):
        assert (a is None and b is None) or torch.equal(a, b)
    for f in _STATE_FIELDS:
        a, b = getattr(st, f).numpy(), getattr(conv, f).numpy()
        assert a.shape == b.shape, f
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), f
    rgb_params = tt.make_params(**kw)
    rgb = tt.sunsky_precompute(rgb_params)
    assert rgb.sun_ld is None and tuple(rgb.sky_params.shape) == (3, 9)
    for a, b in zip(_leaves(rgb), _leaves(tt.sunsky_precompute(
            rgb_params, mode="rgb")), strict=True):
        assert (a is None and b is None) or torch.equal(a, b)


def test_sample_wavelengths_matches_jax(states):
    js, st = states
    u = np.random.default_rng(5).random(4096, dtype=np.float32)
    wl_j, pdf_j = jax.jit(JM.sample_wavelengths)(js, u)
    wl_t, pdf_t = tt.sample_wavelengths(st, torch.tensor(u))
    np.testing.assert_allclose(wl_t.numpy(), np.asarray(wl_j), rtol=1e-5)
    np.testing.assert_allclose(pdf_t.numpy(), np.asarray(pdf_j), rtol=1e-4)


def test_kernel_table_packing_matches_jax(states):
    js, st = states
    np.testing.assert_allclose(TK._misc_row_spec(st).numpy(),
                               np.asarray(JK._misc_row_spec(js))[0],
                               rtol=1e-6, atol=1e-7)
    tables = TK.pack_tables_spec(st, torch.device("cpu"))
    assert [tuple(t.shape) for t in tables] == [
        (11, 9), (11,), (45, 44), (11, 6), (16,), (14, 20)]


# ---------------------------------------------------------------------------
# the plain versions of K9-K11
# ---------------------------------------------------------------------------


def test_spectral_wrappers_take_plain_versions_on_cpu(states):
    _, st = states
    d, wl = (torch.tensor(x) for x in _lanes(np.asarray(st.sun_frame_n), 4,
                                             7))
    u2 = torch.rand(64, 2, generator=torch.Generator().manual_seed(0))
    build.reset_launches()
    assert torch.equal(TK.sunsky_eval_spec(st, d, wl),
                       TM._eval_spec_plain(st, d, wl))
    for a, b in zip(TK.sunsky_hit_spec(st, d, wl),
                    TM._hit_spec_plain(st, d, wl)):
        assert torch.equal(a, b)
    for a, b in zip(TK.sunsky_nee_spec(st, u2, wl[:64]),
                    TM._sample_eval_spec_plain(st, u2, wl[:64])):
        assert torch.equal(a, b)
    assert all(v == 0 for v in build.launches.values())
    assert build.library.cache_info().currsize == 0


def test_spectral_wrappers_refuse_other_devices(states):
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused, never routed to the plain version; a spectral call without
    wavelengths raises."""
    _, st = states
    wl = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_eval_spec(st, torch.empty((8, 3), device="meta"), wl)
    with pytest.raises(ValueError, match="CUDA"):
        TK.sunsky_nee_spec(st, torch.empty((8, 2), device="meta"), wl)
    with pytest.raises(ValueError, match="wavelengths"):
        TM.eval(st, torch.zeros(8, 3), mode="spectral")


def test_spectral_gradients_on_cpu_are_plain_autograd(states):
    """On the CPU the spectral radiance differentiates through its plain
    version (on the card, its adjoint K12; tests/test_torch_spectral_grad.py
    holds the plain adjoints against the JAX package)."""
    _, st = states
    d, wl = (torch.tensor(x) for x in _lanes(np.asarray(st.sun_frame_n), 4,
                                             8))
    skyp = st.sky_params.clone().requires_grad_()
    rad = TK.sunsky_eval_spec(st._replace(sky_params=skyp), d, wl)
    (g,) = torch.autograd.grad(rad.sum(), [skyp])
    assert torch.isfinite(g).all() and g.abs().max() > 0


# ---------------------------------------------------------------------------
# goldens (the bars of tests/test_sunsky_golden.py)
# ---------------------------------------------------------------------------

_H, _W = 32, 64
_SPEC_WL = np.broadcast_to(np.array([360 + 47 / 2 + i * 47 for i in range(10)],
                                    np.float32), (_H, _W, 10))


def _golden_directions():
    pg, tg = np.meshgrid(np.linspace(0, 2 * np.pi, _W),
                         np.linspace(np.pi, 0, _H))
    v = np.stack([np.cos(pg) * np.sin(tg), np.sin(pg) * np.sin(tg),
                  np.cos(tg)], -1).astype(np.float32)
    return torch.tensor(-v)


def _mean_rel_err(img, ref):
    return float(np.mean(np.abs(img - ref) / (np.abs(ref) + 0.001)))


def _sky(turbidity, albedo, sun):
    params = tt.make_params(turbidity=turbidity, albedo=albedo,
                            sun_direction=sun, sun_scale=0.0,
                            mode="spectral", device="cpu")
    state = tt.sunsky_precompute(params, mode="spectral")
    return tt.sunsky_eval(state, _golden_directions(), mode="spectral",
                          wavelengths=torch.tensor(_SPEC_WL)).numpy()


@pytest.mark.parametrize("eta,turb,key", [
    (np.deg2rad(2), 2, "sky_spec_eta0.035_t2.000_a0.000"),
    (np.deg2rad(20), 5.2, "sky_spec_eta0.349_t5.200_a0.000"),
    (np.deg2rad(45), 9.8, "sky_spec_eta0.785_t9.800_a0.000"),
])
def test_sky_radiance_spectral_golden(golden, eta, turb, key):
    st = np.pi / 2 - eta
    img = _sky(turb, 0.0, [np.sin(st), 0.0, np.cos(st)])
    assert _mean_rel_err(img, golden[key]) <= 0.037


def test_sky_radiance_spectral_irregular_albedo_golden(golden):
    albedo = np.array([0.56, 0.21, 0.58, 0.24, 0.92, 0.42, 0.53, 0.75,
                       0.54, 0.20, 0.46], np.float32)
    eta = np.deg2rad(60)
    img = _sky(4.2, albedo, [np.sin(np.pi / 2 - eta), 0.0,
                             np.cos(np.pi / 2 - eta)])
    assert _mean_rel_err(img, golden["sky_spectrum_special"]) <= 0.03


def test_sun_radiance_spectral_golden(golden):
    """All 80 golden sun spectra (5 turbidities x 4 elevations x 4 gammas)
    at test_sunsky_golden.py:92-126's bar."""
    eps = 1e-4
    half_ap = np.deg2rad(0.5388 / 2.0)
    wavelengths = torch.tensor(np.linspace(310, 800, 15).astype(np.float32))
    tables = TT.load_tables("spectral", device="cpu")
    worst = 0.0
    for turb in np.linspace(1, 10, 5):
        for eta_ray in np.linspace(eps, np.pi / 2 - eps, 4):
            for gamma in np.linspace(0, half_ap - eps, 4):
                phi = np.pi / 5
                theta_ray = np.pi / 2 - eta_ray
                sun_theta = theta_ray - gamma
                if sun_theta < 0:
                    sun_theta = theta_ray + gamma
                sd = [np.cos(phi) * np.sin(sun_theta),
                      np.sin(phi) * np.sin(sun_theta), np.cos(sun_theta)]
                params = TM.make_params(turbidity=turb, albedo=0.0,
                                        sun_direction=sd, sky_scale=0.0,
                                        mode="spectral", device="cpu")
                state = TM.precompute(tables, params, "spectral")
                d = torch.tensor([np.cos(phi) * np.sin(theta_ray),
                                  np.sin(phi) * np.sin(theta_ray),
                                  np.cos(theta_ray)], dtype=torch.float32)
                res = TM.eval(state, d, mode="spectral",
                              wavelengths=wavelengths).numpy()
                key = (f"sun_spectrum_t{turb:.1f}_eta{eta_ray:.2f}"
                       f"_gamma{gamma:.3e}")
                rel = np.mean(np.abs(res - golden[key])
                              / (golden[key] + 1e-6))
                worst = max(worst, rel)
    assert worst <= 1e-2, f"worst mean rel err {worst}"


_ENTRY_POINTS = [convert.sunsky_tables, convert.continuous_distribution]


@pytest.mark.parametrize("fn", _ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_new_entry_points_default_to_the_card(fn):
    import inspect
    assert inspect.signature(fn).parameters["device"].default == "cuda"
