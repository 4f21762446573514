"""The port's film (`tpusky_torch.render.film`) against the JAX package's:
every reconstruction filter's splat on 8,192 samples, in the renderer's
pixel order and in any order; the gaussian against Mitsuba 3's formula
(`src/rfilters/gaussian.cpp`), which the port follows where the
reference package stops at radius 1 (R10); constant images; the band
accumulation of the specfilm.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tpusky.render import film as JF

from tpusky_torch.render import film as TF

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H, W, SPP = 16, 32, 16          # 8,192 samples
C = 3


def _samples(seed):
    """(uv (N, 2) pixel-ordered, lane i in pixel i // SPP; values (N, C))
    as float32."""
    rng = np.random.default_rng(seed)
    pix = np.repeat(np.arange(H * W), SPP)
    uv = np.stack([pix % W + rng.random(pix.size),
                   pix // W + rng.random(pix.size)], -1).astype(np.float32)
    vals = rng.uniform(-0.5, 2.0, (pix.size, C)).astype(np.float32)
    return uv, vals


def _mitsuba_gaussian_splat(uv, vals):
    """A float64 numpy splat with Mitsuba 3's gaussian: stddev 0.5,
    radius 2, max(0, exp(-x^2 / (2 s^2)) - exp(-r^2 / (2 s^2))), each
    sample into the 4 x 4 pixels whose centres lie within the radius."""
    def g(x):
        return np.maximum(0.0, np.exp(-x * x / 0.5) - np.exp(-4.0 / 0.5))
    acc = np.zeros((H, W, C + 1))
    v1 = np.concatenate([vals, np.ones_like(vals[:, :1])], -1)
    bx = np.floor(uv[:, 0] - 0.5) - 1
    by = np.floor(uv[:, 1] - 0.5) - 1
    for oy in range(4):
        for ox in range(4):
            px, py = bx + ox, by + oy
            wgt = g(px + 0.5 - uv[:, 0]) * g(py + 0.5 - uv[:, 1])
            ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
            np.add.at(acc, (py[ok].astype(int), px[ok].astype(int)),
                      v1[ok] * wgt[ok, None])
    return acc


def test_splat_matches_jax_every_filter():
    """Each filter's (H, W, C+1) accumulation within 1e-5 of the
    reference's `splat` (relative to its largest value): the gaussian
    against `_mitsuba_gaussian_splat`, the others against the JAX
    package, for lanes in the renderer's pixel order (`spp`)."""
    uv, vals = _samples(1)
    refs = jax.jit(lambda uv, vals: {
        rf: JF.splat(JF.Film(H, W, C, rf), uv, vals)
        for rf in TF.FILTERS if rf != "gaussian"})(uv, vals)
    for rf in TF.FILTERS:
        film = TF.Film(H, W, C, rf)
        if rf == "gaussian":
            want = _mitsuba_gaussian_splat(uv.astype(np.float64),
                                           vals.astype(np.float64))
        else:
            want = np.asarray(refs[rf])
        scale = np.abs(want).max()
        out = TF.splat(film, torch.tensor(uv), torch.tensor(vals), spp=SPP)
        assert out.shape == (H, W, C + 1)
        err = np.abs(out.numpy() - want).max()
        assert err <= 1e-5 * scale, (rf, err / scale)


def test_constant_image_stays_constant_and_splat_is_bitwise_repeatable():
    """As tests/test_film.py:23: uniform samples jittered in each pixel
    develop to the constant away from the border, for every filter; two
    splats of the same lanes are bitwise equal."""
    uv, _ = _samples(2)
    vals = torch.full((uv.shape[0], C), 2.0)
    for rf in TF.FILTERS:
        film = TF.Film(H, W, C, rf)
        acc = TF.splat(film, torch.tensor(uv), vals, spp=SPP)
        img = TF.develop(acc).numpy()
        np.testing.assert_allclose(img[4:-4, 4:-4], 2.0, atol=0.02,
                                   err_msg=rf)
        assert torch.equal(acc, TF.splat(film, torch.tensor(uv), vals,
                                         spp=SPP)), rf


def test_band_accumulation_matches_jax():
    """`spectral_band_accumulate` on 8,192 lanes of 4 hero wavelengths,
    some outside the bands, within 1e-6 of the reference's."""
    rng = np.random.default_rng(3)
    wl = rng.uniform(380.0, 720.0, (8192, 4)).astype(np.float32)
    v = rng.uniform(0.0, 3.0, (8192, 4)).astype(np.float32)
    bands = (400.0, 450.0, 520.0, 610.0, 700.0)
    want = np.asarray(JF.spectral_band_accumulate(jnp.asarray(wl),
                                                  jnp.asarray(v), bands))
    out = TF.spectral_band_accumulate(torch.tensor(wl), torch.tensor(v),
                                      bands)
    assert out.shape == (8192, 4)
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-6)
