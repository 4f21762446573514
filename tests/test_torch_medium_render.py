"""Participating media through the port's path tracer and its gradient,
lane by lane against the JAX package at 16x16x2 on the CPU.

The fog scene (tests/torch_medium_case.py) holds two overlapping
regions: a homogeneous Henyey-Greenstein sphere and a grid cube with
Rayleigh phase and spectral-MIS free flight, under the sunsky; depth 3,
Russian roulette from depth 2 (so it plays on the merged surface and
medium continuations). RGB lanes under the `independent` sampler,
spectral lanes (one-channel regions, R14) under `stratified`, so the
free-flight, medium-NEE and phase-sample dimensions (100_000 + 4 depth,
+1, +2) are held to the reference's streams for two sampler kinds. The
bars are tests/test_torch_render.py's: >= 99.9% of lanes within 1e-3
relative (floor 1e-3); the gradient within 1e-3 of each gradient's
largest entry.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and it adds nothing to the wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render.bsdf import table_kinds

import tpusky_torch as tt
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

from torch_breadth_case import H, KEY, SPP, W, camera, port, share_outside
from torch_medium_case import WORDS, fog_scene, jax_lanes, port_lanes

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

DEPTH = 3
RR = 2
SUN = [0.3, 0.2, 0.93]


def _check(mode, sampler_kind):
    sc_j, cam = fog_scene(mode), camera()
    ref = jax_lanes(sc_j, cam, DEPTH, RR, mode, sampler_kind)
    sc_t, cam_t = port(sc_j, cam)
    lanes = port_lanes(sc_t, cam_t, DEPTH, RR, mode, sampler_kind)
    share = share_outside(lanes, ref)
    assert share <= 1e-3 and ref.mean() > 0.01, share
    # the media do something: the vacuum's lanes differ
    vacuum = port_lanes(sc_t._replace(medium=None), cam_t, DEPTH, RR, mode,
                        sampler_kind)
    assert abs(vacuum.mean() - lanes.mean()) > 0.05 * lanes.mean()


def test_fog_lanes_match_jax():
    """RGB: both regions of three channels, the independent sampler."""
    _check("rgb", "independent")


def test_fog_spectral_lanes_match_jax():
    """Spectral (the spectral sunsky, hero wavelengths developed to sRGB):
    one-channel regions, the stratified sampler."""
    _check("spectral", "stratified")


def test_fog_gradient_matches_jax():
    """d mean(img^2) / d (turbidity, the sphere region's sigma_t, the
    cube's density grid, the sphere's g) through render_rows against
    jax.grad of the same loss: each within 1e-3 of its largest entry."""
    sc_j, cam = fog_scene(), camera()
    kinds = table_kinds(sc_j.bsdfs)
    tables = jax_load_tables("rgb")
    film_j = JF.Film(H, W, 3)

    @jax.jit
    def grad_j(t, sig, grid, g):
        def loss(t, sig, grid, g):
            p = ts.make_params(turbidity=t, albedo=0.3, sun_direction=SUN)
            a, b = sc_j.medium
            sc = sc_j._replace(env=JM.precompute(tables, p, "rgb"), medium=(
                a._replace(sigma_t=sig, g=g), b._replace(density=grid)))
            img = JF.develop(JI.render_rows(sc, cam, film_j, KEY, SPP, DEPTH,
                                            RR, "rgb", 0, H, kinds=kinds))
            return jnp.mean(img ** 2)
        return jax.grad(loss, argnums=(0, 1, 2, 3))(t, sig, grid, g)
    a_j, b_j = sc_j.medium
    g_j = [np.asarray(x) for x in grad_j(jnp.float32(3.0), a_j.sigma_t,
                                         b_j.density, a_j.g)]

    sc_t, cam_t = port(sc_j, cam)
    a, b = sc_t.medium
    leaves = [torch.tensor(3.0, requires_grad=True),
              a.sigma_t.clone().requires_grad_(),
              b.density.clone().requires_grad_(),
              a.g.clone().requires_grad_()]
    p = TM.make_params(turbidity=leaves[0], albedo=0.3, sun_direction=SUN,
                       device="cpu")
    sc = sc_t._replace(
        env=TM.precompute(tt.load_tables("rgb", device="cpu"), p),
        medium=(a._replace(sigma_t=leaves[1], g=leaves[3]),
                b._replace(density=leaves[2])))
    img = TF.develop(TI.render_rows(sc, cam_t, TF.Film(H, W, 3), WORDS, SPP,
                                    DEPTH, RR, "rgb", 0, H))
    g_t = [x.numpy() for x in torch.autograd.grad((img ** 2).mean(), leaves)]
    for name, x, y in zip(("turbidity", "sigma_t", "grid", "g"), g_t, g_j):
        scale = np.abs(y).max()
        assert scale > 0 and np.isfinite(x).all(), name
        assert np.abs(x - y).max() <= 1e-3 * scale, (name,
                                                     np.abs(x - y).max())
