"""One inverse-rendering step of `bench.py::bench_train`, cut to 16x16 at
2 spp, run by the JAX package and by the port from the same parameters,
target image, seed and Adam state: the case of tests/test_torch_train.py
and tests/test_torch_train_losses.py (one JAX compile per loss kind, so
the kinds are split over two files to keep each file short)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.ad import optimizers as JO
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT
from tpusky.parallel.render import make_train_step_single as jax_train_step
from tpusky.render import film as JF
from tpusky.render import sensors as JS
from tpusky.render.scene import make_scene as jax_make_scene

from tpusky_torch import convert
from tpusky_torch.ad import optimizers as TO
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.parallel import render as TP
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(5)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 5
SUN_INIT = np.asarray([0.35, 0.2, 0.91], np.float32)
SUN_INIT = SUN_INIT / np.linalg.norm(SUN_INIT)


def _shapes():
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    return [dict(kind=1, to_world=ground, bsdf_idx=0),
            dict(kind=0, to_world=sphere, bsdf_idx=1)]


def make_setup():
    """JAX and port scene builders (bench.py:353-358: clip and normalise),
    the sensor, the target image rendered by the port at turbidity 6.5
    with the same sun, albedo and seed, and an Adam state two steps in
    (so the step's update depends on the gradient's size, not only its
    sign)."""
    jt = JT.load_tables("rgb")
    tt_ = TT.load_tables("rgb", device="cpu")
    base_j = jax_make_scene(shapes=_shapes(),
                            bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]])
    base_t = convert.scene(jax.tree.map(np.asarray, base_j), device="cpu")
    sensor_j = JS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45)
    sensor_t = convert.perspective(jax.tree.map(np.asarray, sensor_j),
                                   device="cpu")

    def build_j(pd):
        full = ts.make_params(
            turbidity=jnp.clip(pd["t"], 1.0, 10.0),
            albedo=jnp.clip(pd["alb"], 0.0, 1.0),
            sun_direction=pd["sun"] / jnp.linalg.norm(pd["sun"]))
        return base_j._replace(env=JM.precompute(jt, full, "rgb"))

    def build_t(pd):
        full = TM.make_params(
            turbidity=pd["t"].clamp(1.0, 10.0),
            albedo=pd["alb"].clamp(0.0, 1.0),
            sun_direction=pd["sun"] / torch.sqrt((pd["sun"] ** 2).sum()),
            device="cpu")
        return base_t._replace(env=TM.precompute(tt_, full))

    # the target is an input both steps take as it is: the port renders it
    # (its render_rows equals JAX's within 1e-3: test_torch_render.py),
    # which spares each file a JAX compile of the render
    with torch.no_grad():
        target = TF.develop(TI.render_rows(
            build_t({"t": torch.tensor(6.5), "alb": torch.full((3,), 0.3),
                     "sun": torch.tensor(SUN_INIT)}),
            sensor_t, TF.Film(H, W, 3), SEED, SPP, 2, 1000, "rgb", 0,
            H)).numpy()
    params = {"t": np.float32(3.0), "alb": np.full((3,), 0.3, np.float32),
              "sun": SUN_INIT}
    opt = JO.Adam(0.05)
    st = opt.init({k: jnp.asarray(v) for k, v in params.items()})
    rng = np.random.default_rng(4)
    for _ in range(2):
        g = {k: jnp.asarray(0.01 * rng.normal(size=np.shape(v)),
                            jnp.float32) for k, v in params.items()}
        _, st = opt.update(g, st)
    return (build_j, build_t, sensor_j, sensor_t, target, params,
            jax.tree.map(np.asarray, st))


def _adam(module):
    opt = module.Adam(0.05)
    opt.set_learning_rate(t=0.05, alb=0.015, sun=0.01)
    return opt


def check_one_step(setup, loss):
    """One step from the same parameters, target, seed and Adam state: the
    loss within 1e-4 and the updated parameters within 1e-3 of JAX's,
    relative; the first moments (which carry the gradient) within 1e-3 for
    turbidity and albedo, 3e-2 for the sun (its cotangent sums disc-ramp
    lanes of the NEE samples; see tests/test_torch_grad.py)."""
    build_j, build_t, sensor_j, sensor_t, target, params, st = setup
    step_j = jax_train_step(build_j, sensor_j, JF.Film(H, W, 3), SPP,
                            _adam(JO), loss=loss)
    st_j, p_j, loss_j = step_j(jax.tree.map(jnp.asarray, st),
                               {k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(target), KEY)
    step_t = TP.make_train_step_single(build_t, sensor_t, TF.Film(H, W, 3),
                                       SPP, _adam(TO), loss=loss)
    st_t, p_t, loss_t = step_t(convert.adam_state(st, device="cpu"),
                               {k: torch.tensor(v) for k, v in params.items()},
                               torch.tensor(target), SEED)
    assert abs(float(loss_t) - float(loss_j)) <= 1e-4 * abs(float(loss_j))
    for k in params:
        a, b = p_t[k].numpy(), np.asarray(p_j[k])
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), k
        m_t, m_j = st_t[k][0].numpy(), np.asarray(st_j[k][0])
        tol = 3e-2 if k == "sun" else 1e-3
        assert np.abs(m_t - m_j).max() <= tol * np.abs(m_j).max(), k
    assert float(p_t["t"]) != 3.0
