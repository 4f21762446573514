"""The port's RGB render path against the JAX package, lane by lane at
32x32x4 on the CPU: the port's plain wavefront (`render_rows`) against
JAX's jnp wavefront path, and against JAX's `_render_impl` through its
megakernel in interpret mode (as tests/test_megakernel.py runs it). The
scene, the port's render and the sampler tests are in
tests/test_torch_render.py.

At most 3 items, so that pytest-xdist's `--dist loadfile` hands this
file out after tests/test_multihost.py and its JAX compiles (the
wavefront's and the interpret-mode megakernel's) add nothing to the
wall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusky.ops.pallas.megakernel import direct_rgb_megakernel
from tpusky.render import film as JF
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds

from test_torch_render import (H, KEY, SPP, W, _lane_rel,  # noqa: F401
                               port_render, scenes)

# pytest's workers already share the cores: one torch thread each keeps
# the many small CPU ops from contending with the other workers
torch.set_num_threads(1)


def _jax_lanes(sc, sensor, key):
    """Per-lane radiance of JAX's render_rows before the splat: the body
    of `integrator._render_rows_chunk` (integrator.py:804-826, 878-881)."""
    n = H * W * SPP
    lane = jnp.arange(n, dtype=jnp.uint32)
    pixel = lane // SPP
    smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
    u = smp.next(10_000, 2)
    uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                    ((pixel // W).astype(jnp.float32) + u[:, 1]) / H], -1)
    o, d = JS.sample_ray(sensor, uv)
    r = JI._path_sample(sc, o, d, smp, 2, 1000, "rgb", None,
                        kinds=table_kinds(sc.bsdfs))
    return jnp.where(jnp.isfinite(r), r, 0.0)


@pytest.fixture(scope="module")
def jax_wavefront(scenes):
    """(per-lane radiance, developed image) of JAX's wavefront path. The
    image is render_rows' own box splat of these lanes (one spp chunk,
    integrator.py:878-881), so the path is traced and compiled once."""
    sc, sensor = scenes[0]
    film = JF.Film(H, W, 3)

    @jax.jit
    def run(sc, sensor, key):
        lanes = _jax_lanes(sc, sensor, key)
        return lanes, JF.develop(JF.splat_ordered(film, lanes, SPP))
    return tuple(np.asarray(x) for x in run(sc, sensor, KEY))


@pytest.fixture(scope="module")
def jax_megakernel(scenes):
    """(per-lane radiance, developed image) of JAX's `_render_impl` with
    the megakernel in interpret mode. The raw `_render_impl` is traced
    under a jit of its own so that no other test sees this trace."""
    sc, sensor = scenes[0]
    film = JF.Film(H, W, 3)
    kinds = table_kinds(sc.bsdfs)

    @jax.jit
    def run(sc, sensor, key):
        img = JF.develop(JI._render_impl.__wrapped__(
            sc, sensor, film, key, SPP, 2, 1000, "rgb", kinds=kinds))
        return direct_rgb_megakernel(sc, sensor, sc.env, key, SPP, W, H,
                                     interpret=True), img
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPUSKY_MEGAKERNEL_INTERPRET", "1")
        mp.delenv("TPUSKY_DISABLE_PALLAS", raising=False)
        assert JI._megakernel_ok(sc, sensor, film, SPP, 2, "rgb",
                                 "independent", kinds)
        return tuple(np.asarray(x) for x in run(sc, sensor, KEY))


def test_render_rows_matches_jax(port_render, jax_wavefront):
    """Same seed, same estimator: per lane before the splat, >= 99.9% of
    lanes within 1e-3 relative (floor 1e-3); the allowance is for a branch
    flip at a discrete pick (TGMM component, sky/sun strategy) on a
    one-ulp difference. Per developed image, test_megakernel.py:68's bar."""
    lanes, img = port_render
    lanes_j, img_j = jax_wavefront
    assert lanes.shape == lanes_j.shape == (H * W * SPP, 3)
    assert (_lane_rel(lanes, lanes_j) > 1e-3).mean() <= 1e-3
    assert np.abs(img - img_j).max() < 1e-3 * max(img_j.max(), 1.0)
    assert img_j.max() > 0.1


def test_render_rows_matches_jax_megakernel(port_render, jax_megakernel):
    """Against JAX's `_render_impl` through its megakernel. That kernel
    evaluates asin/acos/atan2/erfinv with the TPU polynomials of
    ops/pallas/trig.py, whose error at the sun's limb reaches ~5e-3
    (test_pallas.py:124-132), so per lane: >= 99.9% within 5e-3 and all
    within 1e-2. Per image, the bar of test_megakernel.py:68."""
    lanes, img = port_render
    lanes_m, img_m = jax_megakernel
    rel = _lane_rel(lanes, lanes_m)
    assert (rel > 5e-3).mean() <= 1e-3
    assert rel.max() <= 1e-2
    assert np.abs(img - img_m).max() < 1e-3 * max(img_m.max(), 1.0)
