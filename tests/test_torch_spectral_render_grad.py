"""bench.py::bench_spectral_grad's gradient at 16x16x2 through the port's
render_rows against jax.grad of the JAX package's, on the CPU.

Its own file (of one test) because JAX's compile of the spectral
gradient is most of its time: pytest-xdist's `--dist loadfile` hands out
small files last, so this one runs beside tests/test_multihost.py and
adds nothing to the wall of a run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene as jax_make_scene

from test_torch_spectral_grad import SUN, _rel_max
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import scene as TSC

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7


@pytest.fixture(scope="module")
def jax_tables():
    return JT.load_tables("spectral")


@pytest.fixture(scope="module")
def torch_tables():
    return TT.load_tables("spectral", device="cpu")


def test_spectral_render_gradient_matches_jax(jax_tables, torch_tables):
    """d mean(img^2) / d (turbidity, albedo (11,), sun direction) of
    bench_spectral_grad's scene (a diffuse ground, depth 2, 4 hero
    wavelengths) through render_rows(mode="spectral"): within 1e-3 of
    jax.grad for the turbidity and the albedo, 3e-2 for the sun (its
    cotangent sums disc-ramp lanes, tests/test_torch_grad.py:294)."""
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    shapes = [dict(kind=1, to_world=ground, bsdf_idx=0)]
    sc_j = jax_make_scene(shapes=shapes, bsdf_albedos=[[0.5, 0.5, 0.5]])
    sensor_j = JS.make_perspective([4, -4, 2.0], [0, 0, 0.5], fov_x_deg=45)
    kinds = table_kinds(sc_j.bsdfs)
    film_j = JF.Film(H, W, 3)

    @jax.jit
    def grad_j(t, alb, sd):
        def loss(t, alb, sd):
            p = ts.make_params(turbidity=t, albedo=alb,
                               sun_direction=sd / jnp.linalg.norm(sd),
                               mode="spectral")
            sc = sc_j._replace(env=JM.precompute(jax_tables, p, "spectral"))
            img = JF.develop(JI.render_rows(sc, sensor_j, film_j, KEY, SPP,
                                            2, 1000, "spectral", 0, H,
                                            kinds=kinds))
            return jnp.mean(img ** 2)
        return jax.grad(loss, argnums=(0, 1, 2))(t, alb, sd)

    sd0 = np.asarray(SUN, np.float32)
    g_j = [np.asarray(g) for g in grad_j(
        jnp.float32(3.0), jnp.full((11,), 0.3, jnp.float32),
        jnp.asarray(sd0))]

    sc_t = TSC.make_scene(shapes=shapes, bsdf_albedos=[[0.5, 0.5, 0.5]],
                          device="cpu")
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor_j),
                                   device="cpu")
    t = torch.tensor(3.0, requires_grad=True)
    alb = torch.full((11,), 0.3, requires_grad=True)
    sd = torch.tensor(sd0, requires_grad=True)
    p = TM.make_params(turbidity=t, albedo=alb,
                       sun_direction=sd / torch.sqrt((sd ** 2).sum()),
                       mode="spectral", device="cpu")
    sc = sc_t._replace(env=TM.precompute(torch_tables, p, "spectral"))
    img = TF.develop(TI.render_rows(sc, sensor_t, TF.Film(H, W, 3), SEED,
                                    SPP, 2, 1000, "spectral", 0, H,
                                    kinds=TB.table_kinds(sc_t.bsdfs)))
    g_t = [g.numpy() for g in torch.autograd.grad((img ** 2).mean(),
                                                  [t, alb, sd])]
    for name, a, b, tol in zip(("turbidity", "albedo", "sun"), g_t, g_j,
                               (1e-3, 1e-3, 3e-2)):
        assert _rel_max(a, b) <= tol, (name, _rel_max(a, b))
    assert np.abs(g_j[2]).max() > 0 and np.abs(g_j[0]) > 0
