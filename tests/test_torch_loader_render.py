"""Loaded scenes rendered by the port against the JAX package's
`SceneBundle.render` on the CPU: the render scene of
tests/torch_loader_case.py (a bump-mapped ground, a rough gold sphere, a
checkered plastic cube, an OBJ icosphere, a point light under the sunsky;
16x16x2, depth 3) pixel for pixel in RGB and spectral mode, each pixel
the mean of the same two lanes, keyed on `PRNGKey(seed)`; and the
headline scene's `render(params=)` gradient against `jax.grad` of the
same loss. Three JAX programs are compiled in all.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_loader_case as L

torch.set_num_threads(1)

SEED = 3


@pytest.mark.parametrize("mode", ["rgb", "spectral"])
def test_loaded_render_matches_jax(mode, tmp_path):
    """>= 99.9% of the pixels within 1e-3 relative (floor 1e-3) of the
    reference's, the image lit; the bump map turned into a normal map
    and the OBJ read natively on both sides."""
    d = L.render_scene(L.assets(tmp_path))
    jb = L.jax_bundle(d, mode)
    ref = np.asarray(jax.jit(lambda: jb.render(seed=SEED))())
    got = L.port_bundle(d, mode).render(seed=SEED).numpy()
    assert got.shape == ref.shape == (L.H, L.W, 3)
    rel = (np.abs(got - ref) / np.maximum(np.abs(ref), 1e-3)).max(-1)
    assert float((rel > 1e-3).mean()) <= 1e-3, float(rel.max())
    assert ref.mean() > 0.05


def test_params_gradient_matches_jax():
    """d mean(img^2) through `render(params=)` of the headline scene (16x16
    x2, depth 3) to every `traverse()` leaf (the emitter's seven
    parameters, each shape's to_world, reflectance and alpha), against
    `jax.grad` through the reference's `render(params=)`: every leaf
    that gets a gradient there gets a finite one here, within 1e-3 of the
    reference's scale (3e-2 for the sun's direction, aperture and disc
    softness, whose cotangents sum the disc-ramp lanes of the NEE
    samples, PERF.md §2), and a leaf that gets none there (a diffuse
    alpha) gets none here."""
    d = L.headline()
    jb = L.jax_bundle(d)
    p_j = jb.traverse()
    names = sorted(p_j)

    @jax.jit
    def grad_j(leaves):
        def loss(leaves):
            p = dict(zip(names, leaves))
            return jnp.mean(jb.render(seed=SEED, params=p) ** 2)
        return jax.grad(loss)(leaves)
    g_j = [np.asarray(g) for g in grad_j([p_j[n] for n in names])]

    tb = L.port_bundle(d)
    p_t = tb.traverse()
    assert sorted(p_t) == names and len(names) == 13
    leaves = [p_t[n].requires_grad_() for n in names]
    loss = (tb.render(seed=SEED, params=p_t) ** 2).mean()
    g_t = torch.autograd.grad(loss, leaves, allow_unused=True)
    for name, a, b in zip(names, g_t, g_j):
        a = np.zeros_like(b) if a is None else a.numpy()
        assert np.isfinite(a).all(), name
        if np.abs(b).max() == 0:
            assert np.abs(a).max() == 0, name
            continue
        bar = 3e-2 if name in ("emitter.sun_direction",
                               "emitter.sun_half_aperture",
                               "emitter.disc_softness") else 1e-3
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= bar, (name, err)
