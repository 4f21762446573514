"""The spectral `precompute` of the port (`tpusky_torch`) under autograd,
against `jax.vjp` of the JAX package's, on the CPU from the same
numpy-seeded cotangents: the state fields the spectral kernels read carry
cotangents to the sunsky parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky import tables as JT

from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)

SUN = [0.3, 0.2, 0.93]


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def jax_tables():
    return JT.load_tables("spectral")


@pytest.fixture(scope="module")
def torch_tables():
    return TT.load_tables("spectral", device="cpu")


_PARAMS = ("turbidity", "albedo", "sun_direction", "sky_scale", "sun_scale",
           "sun_half_aperture", "disc_softness")
_STATE = ("sky_params", "sky_radiance", "sun_radiance", "sun_ld",
          "gaussians", "sky_sampling_w", "sun_angles", "sun_frame_s",
          "sun_frame_t", "sun_frame_n")


_TURBIDITIES = (3.0, 3.5)
_ALBEDO = np.linspace(0.1, 0.6, 11).astype(np.float32)


@pytest.fixture(scope="module")
def jax_vjps(jax_tables):
    """{turbidity: (the random cotangents of the state fields, their
    pullback to the parameters by jax.vjp)}. The pullback is one jitted
    program for both turbidities, but the sun's half aperture: its one
    path is the sky/sun weight's 64 x 64 quadrature, whose float32 sums
    jit reassociates (moving that cotangent by 3e-3 against op by op), so
    its cotangent is taken op by op, as the port does, through
    `_estimate_sky_sun_ratio` alone at the jitted state."""
    def fields(p):
        st = JM.precompute(jax_tables, p, "spectral")
        return tuple(getattr(st, f) for f in _STATE)

    @jax.jit
    def pull(p, cts):
        return (JM.precompute(jax_tables, p, "spectral"),
                jax.vjp(fields, p)[1](cts)[0])
    out = {}
    for turbidity in _TURBIDITIES:
        jp = ts.make_params(turbidity=turbidity, albedo=_ALBEDO,
                            sun_direction=SUN, mode="spectral")
        rng = np.random.default_rng(int(10 * turbidity))
        cts = tuple(rng.normal(size=np.shape(x)).astype(np.float32)
                    for x in jax.eval_shape(fields, jp))
        js, g_j = pull(jp, cts)

        def ratio(a, js=js):
            p = js.params._replace(sun_half_aperture=a)
            return JM._estimate_sky_sun_ratio(js._replace(params=p),
                                              "spectral")[0]
        (g_ap,) = jax.vjp(ratio, jp.sun_half_aperture)[1](
            jnp.asarray(cts[_STATE.index("sky_sampling_w")]))
        out[turbidity] = cts, g_j._replace(sun_half_aperture=g_ap)
    return out


@pytest.mark.parametrize("turbidity", _TURBIDITIES)
def test_spectral_precompute_vjp_matches_jax(jax_vjps, torch_tables,
                                             turbidity):
    """A random cotangent on every state field the spectral kernels read,
    pulled back to the parameters: within 1e-4 of jax.vjp, relative to
    each parameter's cotangent scale; the sun's half aperture within 1e-3.
    Its one path is the sky/sun weight's 64 x 64 quadrature, whose float32
    sums the two packages take in different orders: that moves this
    cotangent by 1.8e-4 to 4.6e-4 (under jit, which reassociates them
    further, by 3e-3; the JAX side therefore takes it op by op, as the
    port does). Turbidity 3.0 sits on the lerp's kink. The disc softness
    enters no field: its cotangent is 0 on both sides."""
    cts, g_j = jax_vjps[turbidity]
    p = TM.make_params(turbidity=turbidity, albedo=_ALBEDO,
                       sun_direction=SUN, mode="spectral", device="cpu")
    p = p._replace(**{f: getattr(p, f).clone().requires_grad_()
                      for f in _PARAMS})
    st = TM.precompute(torch_tables, p, "spectral")
    outs = [getattr(st, f) for f in _STATE]
    loss = sum((x * torch.tensor(c)).sum() for x, c in zip(outs, cts)
               if x.requires_grad)
    g_t = torch.autograd.grad(loss, [getattr(p, f) for f in _PARAMS],
                              allow_unused=True)
    for f, g in zip(_PARAMS, g_t):
        g = np.zeros(np.shape(getattr(g_j, f))) if g is None else g.numpy()
        err = _rel_max(g, getattr(g_j, f))
        assert err <= (1e-3 if f == "sun_half_aperture" else 1e-4), (f, err)
