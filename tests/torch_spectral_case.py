"""Shared parts of the port's spectral sunsky tests against the JAX package
(tests/test_torch_spectral.py and the files of at most 3 items beside it,
tests/test_torch_spectral_{eval_hit,sample_eval,distr,state,wrappers,
precompute_t30,precompute_t35}.py and tests/test_torch_spectrum_{cie,
colour,srgb,sampling}.py, which pytest-xdist's `--dist loadfile` hands out
after tests/test_multihost.py): the states, the lanes, the spectrum
cases, and the tests of K9-K11's plain versions, whose JAX and
interpret-mode Pallas compiles take most of the time.

Both run on the CPU from the same numpy-seeded inputs. The JAX side runs
its jnp path and, for the kernels K9-K11, its Pallas kernels in interpret
mode (as tests/test_pallas.py does); the port runs its plain PyTorch
versions, which the kernel wrappers take for CPU tensors.
"""

import jax
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.ops import spectrum as JS
from tpusky.ops.pallas import sunsky_kernel as JK

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.ops import spectrum as TS

SUN = [0.3, 0.2, 0.93]
N = 2048


def _rel(a, b, floor):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b) / (np.abs(b) + floor)


@pytest.fixture(scope="module")
def jax_precompute():
    tables = JT.load_tables("spectral")
    return jax.jit(lambda p: JM.precompute(tables, p, "spectral"))


@pytest.fixture(scope="module")
def states(jax_precompute):
    """(JAX state, the same state converted to the port) at T = 5.2."""
    js = jax_precompute(ts.make_params(turbidity=5.2, albedo=0.25,
                                       sun_direction=SUN, mode="spectral"))
    return js, convert.sunsky_state(jax.tree.map(np.asarray, js),
                                    device="cpu")


def _lanes(sun, nw, seed):
    """N directions (an eighth below the horizon, 128 in and around the
    sun disc) and (N, nw) wavelengths over [300, 760] nm, so that some lie
    outside the tables' [320, 720], a few exactly on its ends."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d[: N // 8, 2] = -np.abs(d[: N // 8, 2])
    d[-128:] = sun + rng.normal(scale=5e-3, size=(128, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wl = rng.uniform(300.0, 760.0, (N, nw)).astype(np.float32)
    wl[:8, 0] = [320.0, 720.0, 360.0, 680.0, 319.99, 720.01, 500.0, 700.0]
    return d.astype(np.float32), wl


# ---------------------------------------------------------------------------
# shared by the files of at most 3 items split from test_torch_spectral.py
# ---------------------------------------------------------------------------

_STATE_FIELDS = ("sun_angles", "sun_frame_s", "sun_frame_t", "sun_frame_n",
                 "sky_params", "sky_radiance", "sun_radiance", "sun_ld",
                 "gaussians", "sky_sampling_w")


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

# the spectrum cases by file (tests/test_torch_spectrum_{cie,colour,srgb,
# sampling}.py), every case in one
SPECTRUM_GROUPS = {
    "cie": ("cie1931_xyz", "cie1931_y", "cie_d65"),
    "colour": ("luminance_spectral", "spectrum_to_xyz", "spectrum_to_srgb"),
    "srgb": ("xyz_to_srgb", "srgb_to_xyz", "srgb_gamma"),
    "sampling": ("sample_shifted", "sample_rgb_spectrum", "pdf_rgb_spectrum"),
}
assert sorted(n for g in SPECTRUM_GROUPS.values() for n in g) == sorted(
    _SPECTRUM_CASES)


def spectrum_case(name):
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


def _leaves(obj):
    """The tensors (and Nones) of a nested NamedTuple, in field order."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


# ---------------------------------------------------------------------------
# the plain versions of K9-K11
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nw", [4, 10])
def test_eval_and_hit_spec_match_jax(states, nw):
    """K9's and K10's plain versions against the jnp path (radiance 1e-4
    relative, floor 1e-3; pdf 1e-3) and against the Pallas kernels in
    interpret mode, whose TPU polynomial trigonometry errs by ~2e-3
    (tests/test_pallas.py:135-168), more at the sun's limb, where the
    disc lanes here sit: >= 99.9% within 2e-3 and all within 1e-2, as
    test_torch_render.py holds the interpret-mode megakernel. Lanes below
    the horizon or outside [320, 720] nm are exact zeros."""
    js, st = states
    d, wl = _lanes(np.asarray(st.sun_frame_n), nw, nw)
    rad_j = np.asarray(jax.jit(JM._eval_spec_jnp)(js, d, wl))
    pdf_j = np.asarray(jax.jit(JM.pdf_direction)(js, d))
    rad_p, pdf_p = (np.asarray(x) for x in
                    JK.sunsky_hit_spec_pallas(js, d, wl, interpret=True))
    rad_e = np.asarray(JK.sunsky_eval_spec_pallas(js, d, wl, interpret=True))
    td, twl = torch.tensor(d), torch.tensor(wl)
    rad = TM._eval_spec_plain(st, td, twl).numpy()
    rad_h, pdf_h = (x.numpy() for x in TM._hit_spec_plain(st, td, twl))
    assert _rel(rad, rad_j, 1e-3).max() <= 1e-4
    assert _rel(rad_h, rad_j, 1e-3).max() <= 1e-4
    assert _rel(pdf_h, pdf_j, 1e-3).max() <= 1e-3
    for a, b in ((rad, rad_e), (rad_h, rad_p), (pdf_h, pdf_p)):
        rel = _rel(a, b, 1e-3)
        assert (rel > 2e-3).mean() <= 1e-3 and rel.max() <= 1e-2
    out = (d[:, 2:] < 0) | (wl < 320.0) | (wl > 720.0)
    assert out.any() and (rad[out] == 0.0).all() and (rad_j[out] == 0.0).all()
    assert (rad[~out] > 0.0).all()
    assert (rad_j[-128:] > 1e3).any()          # the disc lanes hit the sun
    # the public entry points reach the same plain versions on the CPU
    np.testing.assert_array_equal(
        tt.sunsky_eval(st, td, mode="spectral", wavelengths=twl).numpy(), rad)
    rad2, pdf2 = TM.eval_pdf(st, td, mode="spectral", wavelengths=twl)
    assert torch.equal(rad2, torch.tensor(rad_h))
    assert torch.equal(pdf2, torch.tensor(pdf_h))


@pytest.mark.parametrize("nw", [4, 10])
def test_sample_eval_spec_matches_jax(states, nw):
    """K11's plain version: directions within 1e-5 of JAX's sampler but
    for a discrete pick flipped by an ulp, pdf within 1e-3, and radiance
    at the port's own directions within the bars of the RGB NEE test
    (test_torch_sunsky.py:134-145). Against the interpret-mode Pallas
    kernel, whose polynomial erfinv moves a TGMM sample by up to ~5e-4:
    directions within 1e-4 on >= 99.9% of lanes and all within 1e-3, the
    pdf within 2e-3 where they agree (tests/test_pallas.py:170-176)."""
    js, st = states
    _, wl = _lanes(np.asarray(st.sun_frame_n), nw, 10 + nw)
    u2 = np.random.default_rng(20 + nw).random((N, 2), dtype=np.float32)
    d_j, pdf_j = (np.asarray(x) for x in
                  jax.jit(JM.sample_direction)(js, u2))
    d_p, _, pdf_p = (np.asarray(x) for x in
                     JK.sunsky_nee_spec_pallas(js, u2, wl, interpret=True))
    d, rad, pdf = (x.numpy() for x in TM._sample_eval_spec_plain(
        st, torch.tensor(u2), torch.tensor(wl)))
    far = np.abs(d - d_j).max(-1) > 1e-5
    assert far.sum() <= 4, far.sum()
    assert _rel(pdf, pdf_j, 1e-3)[~far].max() <= 1e-3
    far_p = np.abs(d - d_p).max(-1)
    assert (far_p > 1e-4).mean() <= 1e-3 and far_p.max() <= 1e-3
    assert _rel(pdf, pdf_p, 1e-3)[far_p <= 1e-4].max() <= 2e-3
    rad_j = np.asarray(jax.jit(JM._eval_spec_jnp)(js, d, wl))
    rel = _rel(rad, rad_j, 1e-3)
    assert np.median(rel) <= 1e-4 and rel.max() <= 1e-2
    d2, rad2, pdf2 = TM.sample_eval(st, torch.tensor(u2), mode="spectral",
                                    wavelengths=torch.tensor(wl))
    assert np.array_equal(d2.numpy(), d) and np.array_equal(rad2.numpy(), rad)
    assert np.array_equal(pdf2.numpy(), pdf)
