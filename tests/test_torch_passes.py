"""`render(key, passes)` binds as the JAX package's: the port's host
threefry `fold_in` is bitwise JAX's, and a render of two passes keyed on
the reference key's words is the reference's image.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render.emitters import ConstantEnv
from tpusky.render.scene import make_scene

from torch_breadth_case import camera, panel, port, translate
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render.sampler import fold_in

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_fold_in_is_jax_bitwise():
    """1,000 (key, data) pairs, keys of PRNGKey and of earlier fold-ins,
    data over the whole uint32 range."""
    rng = np.random.default_rng(11)
    seeds = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    data = rng.integers(0, 2 ** 32, 1000, dtype=np.uint64)
    data[:4] = [0, 1, 2 ** 31, 2 ** 32 - 1]
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    keys = jax.vmap(jax.random.fold_in)(keys, jnp.arange(1000) % 3)
    ref = np.asarray(jax.vmap(lambda k, d: jax.random.key_data(
        jax.random.fold_in(k, d)))(keys, jnp.asarray(data, jnp.uint32)))
    words = np.asarray(jax.random.key_data(keys))
    out = np.stack([fold_in(k, int(d)) for k, d in zip(words, data)])
    assert out.dtype == np.uint32
    np.testing.assert_array_equal(out, ref)


def test_render_passes_matches_jax():
    """render(scene, sensor, film, key, 4, 3, 1000, "rgb", 2) bound
    positionally, the key as its two uint32 words: two passes of 2 spp
    keyed on fold_in(key, p), the reference's image within 1e-4 of its
    scale; one pass of an integer seed refuses passes > 1."""
    rad = np.zeros((3, 3), np.float32)
    rad[2] = [6.0, 5.0, 4.0]
    sc_j = make_scene(
        shapes=[dict(kind=1, to_world=np.diag([10.0, 10.0, 1.0, 1.0]),
                     bsdf_idx=0),
                dict(kind=3, to_world=translate(
                    np.diag([0.5, 0.5, 0.5, 1.0]), [0.0, 0.0, 0.5]),
                    bsdf_idx=1),
                dict(kind=1, to_world=panel(0.6, 2.5), bsdf_idx=2,
                     emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.7, 0.3, 0.2], [0.0, 0.0, 0.0]],
        area_radiance=rad, env=ConstantEnv(jnp.asarray([0.3, 0.35, 0.4])))
    sensor_j = camera(target=(0.0, 0.0, 0.5))
    key = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    film_j = JF.Film(16, 16, 3)
    img_j = np.asarray(JI.render(sc_j, sensor_j, film_j, key, 4, 3, 1000,
                                 "rgb", 2))
    sc, sensor = port(sc_j, sensor_j)
    words = np.asarray(jax.random.key_data(key))
    img = TI.render(sc, sensor, TF.Film(16, 16, 3), words, 4, 3, 1000,
                    "rgb", 2).numpy()
    assert img_j.mean() > 0.05
    assert np.abs(img - img_j).max() <= 1e-4 * max(img_j.max(), 1.0)
    with pytest.raises(ValueError):
        TI.render(sc, sensor, TF.Film(16, 16, 3), 7, 4, 3, 1000, "rgb", 2)
