"""The port's bitmap environment emitter (`EnvMapState`, `make_envmap`,
`envmap_*` and the envmap branches of `env_*`) against the JAX package
on the CPU.

`make_envmap` builds the vertex grid and its Bilinear2D tables within
1e-5 relative of the reference's (running sums round in another order,
tests/test_torch_distr2d.py); lookups, samples and pdfs run on the
reference's own state carried over by `convert.environment`, on 4,096
directions with both poles and the u = 0/1 seam, within 1e-5.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import emitters as JE

from tpusky_torch import convert
from tpusky_torch.render import emitters as TE

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

N = 4096


def _bitmap(patch=True):
    rng = np.random.default_rng(1)
    bm = rng.uniform(0.0, 2.0, (16, 32, 3)).astype(np.float32)
    if patch:
        bm[4:6, 20:23] = 40.0                     # a bright patch
    return bm


def _directions():
    """Random unit directions with both poles and lanes on and beside the
    u = 0/1 seam (phi = 0 from either side)."""
    rng = np.random.default_rng(2)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:6] = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [1, -1e-7, 0],
             [0.6, 1e-7, 0.8], [0.6, -1e-7, -0.8]]
    return d


def _rotation():
    a, b = 0.7, -0.4
    rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]])
    rx = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                   [0, np.sin(b), np.cos(b)]])
    return (rz @ rx).astype(np.float32)


def _close(a, b, what, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max()
    assert err <= tol, (what, err)


def test_envmap_matches_jax():
    """make_envmap's tables; envmap_eval, envmap_sample_direction and
    envmap_pdf_direction; every env_* function under a rotated
    env_to_world; the spectral branch's channel mean; within 1e-5 of the
    larger of the value and 1. The rotated directions differ from the
    reference's by an ulp (its einsum rounds otherwise), which the bright
    patch's edges would amplify past the bar, so the env_* checks use the
    map without it. make_envmap(spectral=True) fits the reference's
    rgb2spec coefficients, which convert carries; another environment
    type raises."""
    bm = _bitmap()
    ej = JE.make_envmap(bm, scale=1.5)
    own = TE.make_envmap(bm, scale=1.5, device="cpu")
    assert torch.equal(own.bitmap, torch.tensor(bm))
    for a, b in zip(own.warp, ej.warp):
        b = np.asarray(b)
        assert (np.abs(a.numpy() - b) / np.maximum(np.abs(b), 1e-6)
                ).max() <= 1e-5
    et = convert.environment(jax.tree.map(np.asarray, ej), device="cpu")
    d = _directions()
    u = np.random.default_rng(3).random((N, 2), dtype=np.float32)
    dj, dt = jnp.asarray(d), torch.tensor(d)
    _close(TE.envmap_eval(et, dt), JE.envmap_eval(ej, dj), "envmap_eval")
    _close(TE.envmap_pdf_direction(et, dt), JE.envmap_pdf_direction(ej, dj),
           "envmap_pdf_direction")
    s_t = TE.envmap_sample_direction(et, torch.tensor(u))
    s_j = JE.envmap_sample_direction(ej, jnp.asarray(u))
    _close(s_t[0], s_j[0], "sampled direction")
    _close(s_t[1], s_j[1], "sampled pdf")

    ej = JE.make_envmap(_bitmap(patch=False), scale=1.5)
    et = convert.environment(jax.tree.map(np.asarray, ej), device="cpu")
    rot = _rotation()
    rj, rt = jnp.asarray(rot), torch.tensor(rot)
    wl = np.random.default_rng(4).uniform(360, 830, (N, 4)).astype(
        np.float32)
    for wl_j, wl_t in ((None, None), (jnp.asarray(wl), torch.tensor(wl))):
        mode = "rgb" if wl_j is None else "spectral"
        _close(TE.env_eval(et, dt, rt, wl_t, mode),
               JE.env_eval(ej, dj, rj, wl_j, mode), f"env_eval {mode}")
        for a, b in zip(TE.env_eval_pdf(et, dt, rt, wl_t, mode),
                        JE.env_eval_pdf(ej, dj, rj, wl_j, mode)):
            _close(a, b, f"env_eval_pdf {mode}")
        for a, b in zip(TE.env_sample_eval(et, rt, torch.tensor(u), wl_t,
                                           mode),
                        JE.env_sample_eval(ej, rj, jnp.asarray(u), wl_j,
                                           mode)):
            _close(a, b, f"env_sample_eval {mode}")
    spec = TE.env_eval(et, dt, rt, torch.tensor(wl), "spectral")
    rgb = TE.env_eval(et, dt, rt)
    assert torch.equal(spec, rgb.mean(-1, keepdim=True).expand(N, 4))
    _close(TE.env_pdf_direction(et, rt, dt), JE.env_pdf_direction(ej, rj, dj),
           "env_pdf_direction")
    for a, b in zip(TE.env_sample_direction(et, rt, torch.tensor(u)),
                    JE.env_sample_direction(ej, rj, jnp.asarray(u))):
        _close(a, b, "env_sample_direction")

    # spectral=True fits each texel on the host, as the reference does,
    # and convert carries an envmap's coefficients; an environment of
    # another type is still refused
    ej_s = JE.make_envmap(bm[:4, :8], spectral=True)
    own_s = TE.make_envmap(bm[:4, :8], spectral=True, device="cpu")
    np.testing.assert_allclose(own_s.coeff.numpy(), np.asarray(ej_s.coeff),
                               rtol=0, atol=1e-6)
    conv = convert.environment(jax.tree.map(np.asarray, ej_s), device="cpu")
    np.testing.assert_array_equal(conv.coeff.numpy(), np.asarray(ej_s.coeff))
    with pytest.raises(NotImplementedError):
        convert.environment(object(), device="cpu")


def test_envmap_bitmap_gradient():
    """The gradient of sum(envmap_eval * cotangent) over 4,096 directions
    with respect to the bitmap against jax.grad, within 1e-5 of its
    largest entry."""
    bm = _bitmap()
    d = _directions()
    cot = np.random.default_rng(5).normal(size=(N, 3)).astype(np.float32)
    ej = JE.make_envmap(bm)

    def loss_j(b):
        return jnp.sum(JE.envmap_eval(ej._replace(bitmap=b), jnp.asarray(d))
                       * cot)
    g_j = np.asarray(jax.grad(loss_j)(ej.bitmap))
    et = convert.environment(jax.tree.map(np.asarray, ej), device="cpu")
    leaf = et.bitmap.clone().requires_grad_(True)
    out = TE.envmap_eval(et._replace(bitmap=leaf), torch.tensor(d))
    (g_t,) = torch.autograd.grad((out * torch.tensor(cot)).sum(), [leaf])
    assert np.abs(g_j).max() > 0
    assert np.abs(g_t.numpy() - g_j).max() <= 1e-5 * np.abs(g_j).max()
