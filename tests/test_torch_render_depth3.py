"""The port's bounce loop past direct illumination against the JAX
package's render_rows, on the CPU (the scene of tests/test_torch_render.py).

Its own file (of one test) because JAX's compile of the depth-3 path is
most of its time: pytest-xdist's `--dist loadfile` hands out small files
last, so this one runs beside tests/test_multihost.py and adds nothing
to the wall of a run.
"""

import jax
import numpy as np
import pytest
import torch

from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render.bsdf import table_kinds

from test_torch_render import KEY, SEED, _jax_scene
from tpusky_torch import convert
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scenes():
    sc, sensor = _jax_scene()
    return ((sc, sensor),
            (convert.scene(jax.tree.map(np.asarray, sc), device="cpu"),
             convert.perspective(jax.tree.map(np.asarray, sensor),
                                 device="cpu")))


def test_render_rows_depth3_matches_jax(scenes):
    """The bounce loop past direct illumination (one diffuse
    interreflection), per developed image."""
    (sc_j, sensor_j), (sc_t, sensor_t) = scenes
    img_j = np.asarray(jax.jit(lambda sc, se, k: JF.develop(JI.render_rows(
        sc, se, JF.Film(16, 16, 3), k, 2, 3, 1000, "rgb", 0, 16,
        kinds=table_kinds(sc.bsdfs))))(sc_j, sensor_j, KEY))
    img_t = TF.develop(TI.render_rows(sc_t, sensor_t, TF.Film(16, 16, 3),
                                      SEED, 2, 3, 1000, "rgb", 0, 16))
    assert np.abs(img_t.numpy() - img_j).max() < 1e-3 * max(img_j.max(),
                                                            1.0)
