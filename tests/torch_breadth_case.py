"""Shared by the port's path-tracer breadth tests: scenes built with the
JAX package's constructors, carried into the port by `convert`, and the
per-lane radiance of both wavefronts at 16x16x2.

The `independent` sampler is a pure counter hash, so both draw bitwise
the same uniforms from the same seed and a render compares lane by lane;
the JAX side is the body of its `_render_rows_chunk` before the splat
(tpusky/render/integrator.py:804-826, 862-881), under one jit.
"""

import jax
import jax.numpy as jnp
import numpy as np

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables as jax_load_tables
from tpusky.ops import spectrum as JSP
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds

from tpusky_torch import convert
from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import integrator as TI
from tpusky_torch.render import film as TF

H = W = 16
SPP = 2
KEY = jax.random.PRNGKey(7)
SEED = int(np.asarray(jax.random.key_data(KEY))[-1])    # == 7


def sunsky_state(mode="rgb"):
    return jax.jit(lambda p: JM.precompute(jax_load_tables(mode), p, mode))(
        ts.make_params(turbidity=3.0, albedo=0.3, sun_direction=[0.3, 0.2,
                                                                  0.93],
                       mode=mode))


def translate(m, xyz):
    m = np.asarray(m, np.float32).copy()
    m[:3, 3] = xyz
    return m


def panel(scale, z):
    """A rectangle scaled by `scale` at height z, facing down."""
    m = translate(np.diag([scale, scale, 1.0, 1.0]), [0.0, 0.0, z])
    m[:3, :3] = m[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    return m


def jax_lanes(sc, sensor, depth, rr_depth, mode="rgb"):
    """Per-lane radiance (H * W * SPP, 3) of JAX's wavefront, numpy."""
    kinds = table_kinds(sc.bsdfs)

    @jax.jit
    def run(sc, sensor, key):
        n = H * W * SPP
        lane = jnp.arange(n, dtype=jnp.uint32)
        pixel = lane // SPP
        smp = JI._SamplerCtx("independent", key, pixel, lane % SPP, SPP)
        u = smp.next(10_000, 2)
        uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                        ((pixel // W).astype(jnp.float32) + u[:, 1]) / H],
                       -1)
        o, d = JS.sample_ray(sensor, uv)
        if mode == "spectral":
            u_wl = smp.next(20_000, 1)[..., 0]
            wl, wl_w = JSP.sample_rgb_spectrum(JSP.sample_shifted(u_wl, 4))
            r = JI._path_sample(sc, o, d, smp, depth, rr_depth, mode, wl,
                                kinds=kinds)
            r = JSP.spectrum_to_srgb(r * wl_w, wl)
        else:
            r = JI._path_sample(sc, o, d, smp, depth, rr_depth, mode, None,
                                kinds=kinds)
        return jnp.where(jnp.isfinite(r), r, 0.0)
    return np.asarray(run(sc, sensor, KEY))


def port(sc, sensor):
    """The JAX scene and camera carried into the port, on the CPU."""
    return (convert.scene(jax.tree.map(np.asarray, sc), device="cpu"),
            convert.perspective(jax.tree.map(np.asarray, sensor),
                                device="cpu"))


def port_lanes(sc, sensor, depth, rr_depth, mode="rgb"):
    """Per-lane radiance of the port's wavefront (its plain path on the
    CPU) for the port's scene, numpy."""
    return TI._lane_radiance(sc, sensor, TF.Film(H, W, 3), SEED, SPP, 0,
                             SPP, depth, rr_depth, mode, 0, H,
                             kinds=TB.table_kinds(sc.bsdfs)).numpy()


def share_outside(a, b, bar=1e-3):
    """The share of lanes whose largest channel error relative to b
    (floor 1e-3) exceeds `bar`."""
    rel = (np.abs(a - b) / np.maximum(np.abs(b), 1e-3)).max(-1)
    return float((rel > bar).mean())


def camera(eye=(4.0, -4.0, 2.2), target=(0.0, 0.0, 0.8)):
    return JS.make_perspective(list(eye), list(target), fov_x_deg=50)
