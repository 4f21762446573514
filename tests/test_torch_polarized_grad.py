"""The gradient of a loss on the Stokes image of the port's
`render_stokes` against `jax.grad` of the same loss through the JAX
package's `_render_stokes_impl`, on the CPU at 8x8x2, depth 3: the
headline sphere as a rough gold conductor on a pplastic ground under the
sunsky, the two kinds whose Mueller weights the reflectance reaches
(JAX's compile of the full scene of `torch_polarized_case` under grad
takes a minute); with respect to the sunsky's turbidity (through the
precompute and the sky lookups, whose pdfs enter detached) and the
material table's RGB reflectance (pplastic's base and coat choice, the
conductor's tint).

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.render import film as JF
from tpusky.render import polarized as JP
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene

import tpusky_torch as tt
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.render import film as TF
from tpusky_torch.render import polarized as TP

from torch_breadth_case import camera, port, sunsky_state, translate
from torch_polarized_case import (AU_ETA, AU_K, EYE, GROUND, KEY, TARGET,
                                  WORDS)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]
H = W = 8
SPP, DEPTH = 2, 3


def test_stokes_gradient_matches_jax():
    """d (mean(S0^2) + mean(S1)) / d (turbidity, reflectance): each within
    1e-3 of its largest entry."""
    sc = make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1)],
        bsdf_kinds=[11, 1], bsdf_albedos=[[0.3, 0.2, 0.1], [1.0, 0.9, 0.8]],
        bsdf_alphas=[0.08, 0.1], bsdf_etas=[AU_ETA] * 2,
        bsdf_ks=[AU_K] * 2, bsdf_iors=[1.49, 1.5], env=sunsky_state())
    cam = camera(EYE, TARGET)
    sc_t, cam_t = port(sc, cam)
    kinds = table_kinds(sc.bsdfs)
    tables = jax_load_tables("rgb")

    @jax.jit
    def grad_j(t, albedo):
        def loss(t, albedo):
            p = ts.make_params(turbidity=t, albedo=0.3, sun_direction=SUN)
            s = sc._replace(env=JM.precompute(tables, p, "rgb"),
                            bsdfs=sc.bsdfs._replace(albedo=albedo))
            img = JP._render_stokes_impl(s, cam, JF.Film(H, W, 3),
                                         jax.random.fold_in(KEY, 0), SPP,
                                         DEPTH, 1000, "independent", kinds,
                                         "rgb")
            return jnp.mean(img[..., 0, :] ** 2) + jnp.mean(img[..., 1, :])
        return jax.grad(loss, argnums=(0, 1))(t, albedo)
    g_j = [np.asarray(x) for x in grad_j(jnp.float32(3.0), sc.bsdfs.albedo)]

    leaves = [torch.tensor(3.0, requires_grad=True),
              sc_t.bsdfs.albedo.clone().requires_grad_()]
    p = TM.make_params(turbidity=leaves[0], albedo=0.3, sun_direction=SUN,
                       device="cpu")
    s = sc_t._replace(env=TM.precompute(tt.load_tables("rgb", device="cpu"),
                                        p),
                      bsdfs=sc_t.bsdfs._replace(albedo=leaves[1]))
    img = TP.render_stokes(s, cam_t, TF.Film(H, W, 3), WORDS, spp=SPP,
                           max_depth=DEPTH)
    loss = (img[..., 0, :] ** 2).mean() + img[..., 1, :].mean()
    g_t = [x.numpy() for x in torch.autograd.grad(loss, leaves)]
    for name, x, y in zip(("turbidity", "reflectance"), g_t, g_j):
        scale = np.abs(y).max()
        assert scale > 0 and np.isfinite(x).all(), name
        assert np.abs(x - y).max() <= 1e-3 * scale, (name,
                                                     np.abs(x - y).max(),
                                                     scale)
