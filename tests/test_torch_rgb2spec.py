"""The port's rgb2spec (`tpusky_torch.ops.rgb2spec`) and sensor response
functions (`tpusky_torch.render.spectra`) against the JAX package's.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.ops import rgb2spec as JR
from tpusky.render import spectra as JSR

from tpusky_torch.ops import rgb2spec as TR
from tpusky_torch.render import spectra as TSR

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

# in-gamut colours, saturated ones, a grey, black, and emitter rows above 1
RGB = np.array([[0.2, 0.5, 0.8], [0.9, 0.1, 0.05], [0.05, 0.8, 0.1],
                [0.5, 0.5, 0.5], [0.0, 0.0, 0.0], [0.99, 0.98, 0.01],
                [12.0, 10.0, 8.0], [40.0, 36.0, 32.0], [0.6, 0.7, 0.9],
                [3.0, 0.2, 0.1]], np.float32)
WL = np.linspace(360.0, 830.0, 64).astype(np.float32)


def test_host_fit_matches_jax():
    """The float64 host fit and its helpers within 1e-12 of the
    reference's (the same numpy arithmetic, copied)."""
    chroma = np.clip(RGB, 0.0, 1.0)
    np.testing.assert_allclose(TR.fit_sigmoid_coeffs(chroma),
                               JR.fit_sigmoid_coeffs(chroma), rtol=0,
                               atol=1e-12)
    c = JR.fit_sigmoid_coeffs(chroma)
    np.testing.assert_allclose(TR.eval_sigmoid_spectrum(c, WL),
                               JR.eval_sigmoid_spectrum(c, WL), atol=1e-12)
    np.testing.assert_allclose(TR.upsample_rgb(RGB, WL),
                               JR.upsample_rgb(RGB, WL), atol=1e-12)
    spec = JR.upsample_rgb(chroma[:3], WL)
    for s in spec:
        np.testing.assert_allclose(TR.rgb_of_spectrum(s, WL),
                                   JR.rgb_of_spectrum(s, WL), atol=1e-12)


def test_device_fit_and_its_jacobian_match_jax():
    """`fit_sigmoid_coeffs_torch` against `fit_sigmoid_coeffs_jnp`: the
    emitter spectra at 64 wavelengths within 1e-4 relative (floor 1e-3
    of the row's peak), and the Jacobian of the spectra to the RGB
    within 1e-3 of jax.jacrev's (relative to its largest entry)."""
    rows = RGB[[0, 1, 6, 9]]
    want, jac_j = (np.asarray(x) for x in jax.jit(lambda r, rows: (
        JR.eval_emitter_coeff_spectrum(JR.fit_sigmoid_coeffs_jnp(r)[:, None],
                                       jnp.asarray(WL)),
        jax.vmap(jax.jacrev(lambda x: JR.upsample_rgb_jnp(
            x, jnp.asarray(WL))))(rows)))(RGB, rows))
    cf = TR.fit_sigmoid_coeffs_torch(torch.tensor(RGB))
    assert cf.shape == (RGB.shape[0], 4)
    got = TR.eval_emitter_coeff_spectrum(cf[:, None, :],
                                         torch.tensor(WL)).numpy()
    peak = np.abs(want).max(-1, keepdims=True)
    assert (np.abs(got - want) <= 1e-4 * np.maximum(np.abs(want),
                                                    1e-3 * peak)).all()
    for r, jj in zip(rows, jac_j):
        jt = torch.autograd.functional.jacobian(
            lambda x: TR.upsample_rgb_torch(x, torch.tensor(WL)),
            torch.tensor(r)).numpy()
        assert jt.shape == jj.shape == (64, 3)
        assert np.abs(jt - jj).max() <= 1e-3 * np.abs(jj).max()


def test_spectra_match_jax():
    """parse_srf, srf_eval, srf_range, the combined distribution, the
    sampled wavelengths and their pdf, and srf_accumulate within 1e-5 of
    the reference's under one jit (the sampled wavelengths on all but 1%
    of lanes, all within 5e-3)."""
    srfs = (TSR.parse_srf({"type": "regular", "lambda_min": 400,
                           "lambda_max": 700,
                           "values": "0.1, 0.8 1.0 0.6 0.2"}),
            TSR.parse_srf({"type": "irregular",
                           "wavelengths": [420, 500, 560, 690],
                           "values": [0.0, 0.9, 0.4, 0.1]}),
            TSR.parse_srf([0.2] * 20 + [1.0] * 20 + [0.3] * 20))
    assert srfs == tuple(JSR.parse_srf(d) for d in (
        {"type": "regular", "lambda_min": 400, "lambda_max": 700,
         "values": "0.1, 0.8 1.0 0.6 0.2"},
        {"type": "irregular", "wavelengths": [420, 500, 560, 690],
         "values": [0.0, 0.9, 0.4, 0.1]}, [0.2] * 20 + [1.0] * 20
        + [0.3] * 20))
    assert TSR.srf_range(srfs) == JSR.srf_range(srfs) == (360.0, 830.0)
    rng = np.random.default_rng(4)
    wl = rng.uniform(350.0, 840.0, (4096, 4)).astype(np.float32)
    u = rng.random(4096, dtype=np.float32)
    v = rng.uniform(0.0, 2.0, (4096, 4)).astype(np.float32)

    @jax.jit
    def ref(wl, u, v):
        return ([JSR.srf_eval(s, wl) for s in srfs],
                JSR.srf_combined_distribution(srfs),
                JSR.srf_sample_wavelengths(srfs, u),
                JSR.srf_accumulate(srfs, wl, v))
    evals_j, dj, (wl_j, pdf_j), acc_j = jax.tree.map(np.asarray,
                                                     ref(wl, u, v))
    for s, e in zip(srfs, evals_j):
        np.testing.assert_allclose(TSR.srf_eval(s, torch.tensor(wl)), e,
                                   atol=1e-5)
    dt = TSR.srf_combined_distribution(srfs, device="cpu")
    for f in ("pdf", "cdf", "integral"):
        np.testing.assert_allclose(getattr(dt, f).numpy(), getattr(dj, f),
                                   rtol=1e-5)
    # the sampled wavelengths: the reference's inversion of a nearly flat
    # segment, (y0 - sqrt(y0^2 + 2 s dy)) / -dy, cancels, and moves a
    # lane by up to a fraction of the 1.84 nm segment on the cdf's last
    # ulp (and XLA contracts it into fused multiply-adds); so 1e-5 holds
    # on all but about 1% of lanes, the pdf (y0 + t dy) moving with them
    wl_t, pdf_t = (x.numpy() for x in TSR.srf_sample_wavelengths(
        srfs, torch.tensor(u)))
    rel = np.abs(wl_t - wl_j) / wl_j
    rel_pdf = np.abs(pdf_t - pdf_j) / pdf_j
    assert ((rel > 1e-5) | (rel_pdf > 1e-5)).mean() <= 1e-2
    assert rel.max() <= 5e-3 and rel_pdf.max() <= 1e-3
    np.testing.assert_allclose(
        TSR.srf_accumulate(srfs, torch.tensor(wl), torch.tensor(v)).numpy(),
        acc_j, atol=1e-5)
