"""Shared by the port's media tests: fog scenes built with the JAX
package's constructors and carried into the port by `convert`, and the
flip-lane counter.

The scenes are the headline sphere on a ground under the sunsky with
two regions: a homogeneous Henyey-Greenstein sphere of three channels
(`medium_sphere`'s sigma_t, albedo and g) over the sphere, and a cube
over the ground holding a density grid made from a numpy seed, Rayleigh
phase, free flight by spectral MIS. In spectral mode both regions have
one channel (R14).
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpusky.ops import spectrum as JSP
from tpusky.render import integrator as JI
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds
from tpusky.render.medium import make_medium
from tpusky.render.scene import make_scene

from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import integrator as TI

from torch_breadth_case import H, KEY, SPP, W, sunsky_state, translate

WORDS = np.asarray(jax.random.key_data(KEY))

GROUND = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
GRID = 8


def density_grid(n=GRID, seed=20):
    """A (n, n, n) density grid in [0.2, 2.2) from a numpy seed."""
    return (0.2 + 2.0 * np.random.default_rng(seed).random((n, n, n))
            ).astype(np.float32)


def fog_media(spectral=False):
    """(sphere region, cube region) of the fog scenes."""
    sig = [1.0] if spectral else [0.8, 1.2, 1.6]
    alb = [0.7] if spectral else [0.7, 0.7, 0.7]
    sphere = make_medium(sig, alb, g=0.3, kind="sphere",
                         to_world=translate(np.diag([1.3, 1.3, 1.3, 1.0]),
                                            [0.0, 0.0, 1.0]))
    cube = make_medium([0.6] if spectral else [0.5, 0.6, 0.8],
                       [0.8] if spectral else [0.9, 0.8, 0.7], kind="cube",
                       density=density_grid(), n_steps=16, phase="rayleigh",
                       channel_mis=True,
                       to_world=translate(np.diag([2.0, 1.5, 0.6, 1.0]),
                                          [0.5, -1.0, 0.6]))
    return sphere, cube


def fog_scene(mode="rgb"):
    """The fog scene: a diffuse sphere on a diffuse ground under the
    sunsky (`mode`), inside the two regions of `fog_media`."""
    return make_scene(
        shapes=[dict(kind=1, to_world=GROUND, bsdf_idx=0),
                dict(kind=0, to_world=translate(np.eye(4), [0, 0, 1.0]),
                     bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]],
        env=sunsky_state(mode), medium=fog_media(mode == "spectral"))


def flips(port, ref, bar, rel_floor=1e-3):
    """(lanes whose largest relative error, floor `rel_floor`, exceeds
    `bar`, as a boolean mask over the leading axis)."""
    port, ref = np.asarray(port), np.asarray(ref)
    err = np.abs(port - ref) / np.maximum(np.abs(ref), rel_floor)
    return err.reshape(err.shape[0], -1).max(-1) > bar


def jax_lanes(sc, sensor, depth, rr_depth, mode="rgb",
              sampler_kind="independent"):
    """Per-lane radiance (H * W * SPP, 3) of JAX's wavefront under
    `sampler_kind`, numpy: the body of its `_render_rows_chunk` before the
    splat (tpusky/render/integrator.py:804-826, 862-881), one jit."""
    kinds = table_kinds(sc.bsdfs)

    @jax.jit
    def run(sc, sensor, key):
        lane = jnp.arange(H * W * SPP, dtype=jnp.uint32)
        pixel = lane // SPP
        smp = JI._SamplerCtx(sampler_kind, key, pixel, lane % SPP, SPP)
        u = smp.next(10_000, 2)
        uv = jnp.stack([((pixel % W).astype(jnp.float32) + u[:, 0]) / W,
                        ((pixel // W).astype(jnp.float32) + u[:, 1]) / H],
                       -1)
        o, d = JS.sample_ray(sensor, uv)
        wl = None
        if mode == "spectral":
            wl, wl_w = JSP.sample_rgb_spectrum(JSP.sample_shifted(
                smp.next(20_000, 1)[..., 0], 4))
        r = JI._path_sample(sc, o, d, smp, depth, rr_depth, mode, wl,
                            kinds=kinds)
        if mode == "spectral":
            r = JSP.spectrum_to_srgb(r * wl_w, wl)
        return jnp.where(jnp.isfinite(r), r, 0.0)
    return np.asarray(run(sc, sensor, KEY))


def port_lanes(sc, sensor, depth, rr_depth, mode="rgb",
               sampler_kind="independent"):
    """The port's lanes (its plain path on the CPU) for the same key."""
    return TI._lane_radiance(sc, sensor, TF.Film(H, W, 3), WORDS, SPP, 0,
                             SPP, depth, rr_depth, mode, 0, H,
                             sampler_kind=sampler_kind,
                             kinds=TB.table_kinds(sc.bsdfs)).numpy()
