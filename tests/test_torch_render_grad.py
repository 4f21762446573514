"""The gradient of a render through the port's render_rows against
jax.grad of the JAX package's, on the CPU (the three-shape scene of
tests/test_torch_grad.py).

Its own file (of one test) because JAX's compile of the gradient is
most of its time: pytest-xdist's `--dist loadfile` hands out small files
last, so this one runs beside tests/test_multihost.py and adds nothing
to the wall of a run.
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

from test_torch_grad import (ALBEDOS, H, KEY, SEED, SPP, SUN, W,
                             _rel_max, _three_shapes)
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import scene as TSC

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_tables():
    return JT.load_tables("rgb")


@pytest.fixture(scope="module")
def torch_tables():
    return TT.load_tables("rgb", device="cpu")


def test_render_gradient_matches_jax(jax_tables, torch_tables):
    """d mean(img^2) / d (turbidity, albedo, sun_direction, the sphere's
    material albedo) through render_rows: within 1e-3 of jax.grad for the
    turbidity and the albedos, 3e-2 for the sun (its cotangent sums
    disc-ramp lanes of the NEE samples, see _check_fields)."""
    sc_j = jax_make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS)
    sensor_j = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    kinds = table_kinds(sc_j.bsdfs)
    film_j = JF.Film(H, W, 3)

    @jax.jit
    def grad_j(t, alb, sd, mat):
        def loss(t, alb, sd, mat):
            p = ts.make_params(turbidity=t, albedo=alb, sun_direction=sd)
            env = JM.precompute(jax_tables, p, "rgb")
            sc = sc_j._replace(env=env, bsdfs=sc_j.bsdfs._replace(
                albedo=sc_j.bsdfs.albedo.at[1].set(mat)))
            img = JF.develop(JI.render_rows(sc, sensor_j, film_j, KEY, SPP, 2,
                                            1000, "rgb", 0, H, kinds=kinds))
            return jnp.mean(img ** 2)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(t, alb, sd, mat)

    sd0 = np.asarray(SUN, np.float32)
    g_j = [np.asarray(g) for g in grad_j(
        jnp.float32(3.0), jnp.full((3,), 0.3, jnp.float32), jnp.asarray(sd0),
        jnp.asarray(ALBEDOS[1], jnp.float32))]

    sc_t = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                          device="cpu")
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor_j),
                                   device="cpu")
    t = torch.tensor(3.0, requires_grad=True)
    alb = torch.full((3,), 0.3, requires_grad=True)
    sd = torch.tensor(sd0, requires_grad=True)
    mat = torch.tensor(ALBEDOS[1], requires_grad=True)
    p = TM.make_params(turbidity=t, albedo=alb, sun_direction=sd,
                       device="cpu")
    albedo = torch.cat([sc_t.bsdfs.albedo[:1], mat[None]])
    sc = sc_t._replace(env=TM.precompute(torch_tables, p),
                       bsdfs=sc_t.bsdfs._replace(albedo=albedo))
    img = TF.develop(TI.render_rows(sc, sensor_t, TF.Film(H, W, 3), SEED,
                                    SPP, 2, 1000, "rgb", 0, H))
    g_t = [g.numpy() for g in torch.autograd.grad((img ** 2).mean(),
                                                  [t, alb, sd, mat])]
    for name, a, b, tol in zip(("turbidity", "albedo", "sun", "material"),
                               g_t, g_j, (1e-3, 1e-3, 3e-2, 1e-3)):
        assert _rel_max(a, b) <= tol, (name, _rel_max(a, b))
    assert np.abs(g_j[2]).max() > 0 and np.abs(g_j[0]) > 0
