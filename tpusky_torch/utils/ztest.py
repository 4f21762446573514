"""Per-pixel Z-test for statistical render regression.

The port's own copy of the numpy-only `tpusky/utils/ztest.py`, so that
the port's renders are tested without importing the JAX package.
Counterpart of the reference's `z_test` harness
(`src/render/tests/test_renders.py:159-224`): a candidate image (mean of
`spp` samples) is compared against a stored reference mean + variance
image; each pixel's deviation is normalised by the expected standard error
and converted to a two-sided p-value, with a Šidák correction for the
number of simultaneous tests.
"""

from __future__ import annotations

import math

import numpy as np


def _local_contrast(ref):
    """Per-pixel 3x3 neighbourhood max-min of the reference image."""
    pad = np.pad(ref, ((1, 1), (1, 1), (0, 0)), mode="edge")
    mx = ref.copy()
    mn = ref.copy()
    h, w = ref.shape[:2]
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sl = pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
            mx = np.maximum(mx, sl)
            mn = np.minimum(mn, sl)
    return mx - mn


def z_test(mean, sample_count, reference, reference_var, alpha=0.01,
           boundary_model=True):
    """Two-sided per-pixel Z-test.

    mean: (H, W, C) candidate image averaged over `sample_count` samples.
    reference / reference_var: per-pixel mean and *per-sample* variance of
    the reference estimator (e.g. from the moment integrator:
    var = m2 - mean^2). Returns (passed, n_failed, min_p, alpha_corrected).

    boundary_model: pixels cut by a geometric discontinuity (silhouettes,
    emitter edges) carry binomial sub-pixel-coverage noise that a
    finite-spp reference can entirely miss (all reference samples land on
    one side -> stored variance 0, yet a fresh seed straddles the edge).
    The per-sample value there is a two-level mixture with std bounded by
    0.5 * (local contrast), so that bound is added in quadrature to the
    stored variance — zero wherever the reference is locally smooth.
    """
    mean = np.asarray(mean, np.float64)
    reference = np.asarray(reference, np.float64)
    reference_var = np.asarray(reference_var, np.float64)

    # absolute variance floor, exactly like the reference
    # (`test_renders.py:161` `np.maximum(reference_var, 1e-4)`): dark /
    # deterministic pixels and rare heavy-tail events otherwise produce
    # unbounded z-scores the Gaussian model cannot honour
    var = np.maximum(reference_var, 1e-4)
    if boundary_model and reference.ndim == 3:
        var = var + (0.5 * _local_contrast(reference)) ** 2
    sigma = np.sqrt(var / sample_count)
    z = np.abs(mean - reference) / sigma
    # two-sided p-value: erfc(z / sqrt(2))
    p = np.vectorize(math.erfc)(z / math.sqrt(2.0))

    n_tests = p.size
    alpha_corr = 1.0 - (1.0 - alpha) ** (1.0 / n_tests)   # Šidák
    failed = p < alpha_corr
    # the reference accepts when >= 99.75% of pixel tests pass
    # (`test_renders.py:224` `0.9975 * pixel_count`) — a small failing
    # budget absorbs the heavy-tail pixels a Gaussian Z cannot model
    passed = failed.sum() <= (1.0 - 0.9975) * n_tests
    return (bool(passed), int(failed.sum()), float(p.min()),
            float(alpha_corr))


def render_regression(render_fn, moments_fn, spp_candidate=64,
                      spp_reference=256, alpha=0.01):
    """Convenience wrapper: build the reference mean+variance with the
    moment integrator and Z-test a fresh render against it.

    render_fn(seed, spp) -> image; moments_fn(seed, spp) -> (mean, m2).
    """
    ref_mean, ref_m2 = moments_fn(0, spp_reference)
    ref_mean = np.asarray(ref_mean, np.float64)
    var = np.asarray(ref_m2, np.float64) - ref_mean ** 2
    img = np.asarray(render_fn(1, spp_candidate), np.float64)
    return z_test(img, spp_candidate, ref_mean, var, alpha=alpha)
