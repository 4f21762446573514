"""Gradients of the port (`tpusky_torch`) against the JAX package.

Both run on the CPU from the same numpy-seeded inputs and cotangents: the
JAX side takes `jax.vjp`/`jax.grad` of its jnp path (the port's reference:
the Pallas adjoints are looser at the disc edge) and, where stated, its
Pallas adjoint kernels in interpret mode; the port takes torch autograd
through its plain versions, which is what CPU tensors run. On the card
the same plain versions are the reference the adjoint kernels K5 and K6
are held against (chip_smoke.py).

The precompute VJP's and the K5/K6 plain adjoints' tests, whose JAX
compiles take most of this file's time, are in files of at most 3 items
(`test_torch_precompute_vjp_t{30,38}.py`,
`test_torch_grad_{eval,nee}_adjoint.py`, shared code in
`torch_grad_case.py`), which pytest-xdist's `--dist loadfile` hands out
after tests/test_multihost.py.
"""

import inspect

import jax
import numpy as np
import pytest
import torch

import tpusky_torch as tt
from tpusky_torch import convert
from tpusky_torch.models.sunsky import model as TM
from tpusky_torch.models.sunsky import tables as TT
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import scene as TSC
from tpusky_torch.render import sensors as TS
from tpusky_torch.render import shapes as TSH
from tpusky_torch.render import texture as TTX

from torch_grad_case import (SUN, _rel_max,  # noqa: F401 (shared names)
                             torch_tables)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def test_disc_edge_gradient_matches_fd(torch_tables):
    """The port's copy of tests/test_ad.py:222-279: the autograd derivative
    of a disc-straddling pixel's mean radiance w.r.t. the sun elevation
    matches central finite differences within 12% (the surrogate ramp
    overestimates the boundary term by ~8%), and it is disc-dominated."""
    ap = 0.5 * np.radians(0.5358)
    el0 = np.radians(30.0)
    n = 4096
    els = np.linspace(el0 - 3.5 * ap, el0 + 3.5 * ap, n)
    d = torch.tensor(np.stack([np.cos(els), np.zeros(n), np.sin(els)], -1),
                     dtype=torch.float32)

    def mean_rad(elev, sun_scale=1.0):
        sd = torch.stack([torch.cos(elev), torch.zeros_like(elev),
                          torch.sin(elev)])
        p = TM.make_params(turbidity=3.0, albedo=0.3, sun_direction=sd,
                           sun_scale=sun_scale, device="cpu")
        return TM._eval_rgb_plain(TM.precompute(torch_tables, p), d).mean()

    elev = torch.tensor(el0, dtype=torch.float32, requires_grad=True)
    (g_ad,) = torch.autograd.grad(mean_rad(elev), elev)
    h = 2e-4
    with torch.no_grad():
        g_fd = (float(mean_rad(elev + h)) - float(mean_rad(elev - h))) / (2 * h)
    g_ad = float(g_ad)
    assert abs(g_ad - g_fd) <= 0.12 * abs(g_fd) + 1e-3, (g_ad, g_fd)
    (g_sky,) = torch.autograd.grad(mean_rad(elev, sun_scale=0.0), elev)
    assert abs(g_ad) > 10 * abs(float(g_sky)), (g_ad, float(g_sky))


# ---------------------------------------------------------------------------
# the render's gradient (bench.py::bench_grad's loss at 32x32x4)
# ---------------------------------------------------------------------------

H = W = 32
SPP = 4
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7


def _three_shapes():
    """The three-shape scene of tests/test_torch_render.py."""
    ground = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
    sphere = np.eye(4, dtype=np.float32)
    sphere[2, 3] = 1.0
    disk = np.eye(4, dtype=np.float32)
    disk[0, 3] = 2.5
    disk[2, 3] = 0.05
    return [dict(kind=1, to_world=ground, bsdf_idx=0),
            dict(kind=0, to_world=sphere, bsdf_idx=1),
            dict(kind=2, to_world=disk, bsdf_idx=1)]


ALBEDOS = [[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]]


def test_cpu_render_impl_gradient_is_the_wavefront(torch_tables):
    """On the CPU `render()` is the wavefront path under autograd: the same
    gradient as `render_rows`, up to the order of autograd's scatter-adds
    on the CPU (repeated runs of one call differ by ~1e-5)."""
    sc_t = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                          device="cpu")
    sensor = TS.make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                                 device="cpu")
    film = TF.Film(16, 16, 3)

    def grad_of(render):
        t = torch.tensor(3.5, requires_grad=True)
        p = TM.make_params(turbidity=t, sun_direction=SUN, device="cpu")
        sc = sc_t._replace(env=TM.precompute(torch_tables, p))
        return torch.autograd.grad((render(sc) ** 2).mean(), t)[0]
    g_render = grad_of(lambda sc: TI.render(sc, sensor, film, SEED, spp=2))
    g_rows = grad_of(lambda sc: TF.develop(TI.render_rows(
        sc, sensor, film, SEED, 2, 2, 1000, "rgb", 0, 16)))
    assert abs(float(g_render - g_rows)) <= 1e-4 * abs(float(g_rows))
    assert float(g_rows) != 0.0


def test_megakernel_flatten_roundtrip():
    """`_Megakernel` passes the scene and sensor to autograd as flat
    tensors; they come back as the same objects."""
    state = TM.precompute(TT.load_tables("rgb", device="cpu"),
                          TM.make_params(device="cpu"))
    sc = TSC.make_scene(shapes=_three_shapes(), bsdf_albedos=ALBEDOS,
                        env=state, device="cpu")
    sensor = TS.make_perspective([4, -4, 2.0], [0, 0, 1.0], device="cpu")
    leaves = []
    struct = (TI._flatten(sc, leaves), TI._flatten(sensor, leaves))
    assert all(isinstance(t, torch.Tensor) for t in leaves)
    sc2, sensor2 = TI._unflatten(struct, leaves)
    assert sc2.shapes.kind == sc.shapes.kind
    assert sc2.env.sun_ld is None and sc2.env.params is not None
    flat2 = []
    TI._flatten(sc2, flat2)
    TI._flatten(sensor2, flat2)
    assert len(flat2) == len(leaves)
    assert all(a is b for a, b in zip(leaves, flat2))


# ---------------------------------------------------------------------------
# entry points run on the card unless asked for the CPU
# ---------------------------------------------------------------------------

_ENTRY_POINTS = [TM.make_params, TT.load_tables, TSC.make_scene,
                 TS.make_perspective, TSH.make_shape_table,
                 TB.make_material_table, TB.make_diffuse_table,
                 convert.sunsky_params, convert.discrete_distribution,
                 convert.sunsky_state, convert.shape_table,
                 convert.material_table, convert.scene, convert.perspective,
                 convert.adam_state, convert.sgd_state,
                 TTX.make_texture_table, convert.texture_table]


@pytest.mark.parametrize("fn", _ENTRY_POINTS, ids=lambda f: f.__qualname__)
def test_entry_point_device_defaults_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_entry_points_without_a_device_need_the_card():
    """Without a card, an entry point called without `device` raises (no
    fallback to the CPU); with one, it lands on the card."""
    if torch.cuda.is_available():
        assert tt.make_params().turbidity.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        tt.make_params()
    with pytest.raises((RuntimeError, AssertionError)):
        TT.load_tables("rgb")
    with pytest.raises((RuntimeError, AssertionError)):
        TS.make_perspective([4, -4, 2.0], [0, 0, 1.0])
