"""Shared by the port's polarized-transport tests: the Stokes scene built
with the JAX package's constructors and carried into the port by
`convert`, the per-lane Stokes vectors of both paths at 16x16x2, and the
lane counter.

The scene is the headline sphere, here a rough gold conductor, on a
pplastic ground under the sunsky, with a smooth conductor and a smooth
dielectric sphere, a small dielectric icosphere mesh, three filter
rectangles between the camera and the scene (a linear polarizer at 30
degrees, a quarter-wave retarder at 45 and a circular polarizer), an
area panel and a point light: every polarization-aware kind and every
light strategy of `render_stokes`. `depolarizing=True` makes every
material diffuse and drops the filters and the point light (the S0 ==
scalar check: the scalar path picks one delta light a vertex, the Stokes
path sums them).

The `independent` sampler is a counter hash, so both sides draw bitwise
the same uniforms from the same key; the JAX side is the body of its
`_render_stokes_impl` before the splat
(tpusky/render/polarized.py:619-651), under one jit.
"""

import jax
import jax.numpy as jnp
import numpy as np

from tpusky.ops import mueller as JMU
from tpusky.ops import spectrum as JSP
from tpusky.render import integrator as JI
from tpusky.render import polarized as JP
from tpusky.render import sensors as JS
from tpusky.render.bsdf import table_kinds
from tpusky.render.scene import make_scene

from tpusky_torch.render import bsdf as TB
from tpusky_torch.render import film as TF
from tpusky_torch.render import polarized as TP
from tpusky_torch.utils.meshio import icosphere

from torch_breadth_case import (H, KEY, SPP, W, camera, panel, port,
                                sunsky_state, translate)

WORDS = np.asarray(jax.random.key_data(KEY))
GROUND = np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)
EYE, TARGET = (4.0, -4.0, 2.2), (0.0, 0.0, 0.8)
# the loader's gold (`tpusky/render/loader.py:419`)
AU_ETA, AU_K = [0.143, 0.375, 1.442], [3.983, 2.386, 1.603]


def _sphere(center, radius):
    m = np.diag([radius, radius, radius, 1.0]).astype(np.float32)
    return translate(m, center)


def filter_rects(eye=EYE, target=TARGET, dist=1.2, half=0.22):
    """Three rectangles facing the camera `dist` along its view, each
    about a sixth of a 50-degree view: upper left, upper right, below."""
    eye, target = np.asarray(eye, np.float64), np.asarray(target, np.float64)
    f = (target - eye) / np.linalg.norm(target - eye)
    r = np.cross(f, [0.0, 0.0, 1.0])
    r /= np.linalg.norm(r)
    u = np.cross(r, f)
    out = []
    for dx, dy in ((-0.28, 0.26), (0.28, 0.26), (0.0, -0.28)):
        m = np.eye(4)
        m[:3, 0], m[:3, 1], m[:3, 2] = r * half, u * half, -f
        m[:3, 3] = eye + dist * f + dx * r + dy * u
        out.append(m.astype(np.float32))
    return out


def pol_scene(mode="rgb", colored=False, depolarizing=False):
    """The JAX Stokes scene (see the module docstring)."""
    shapes = [dict(kind=1, to_world=GROUND, bsdf_idx=0),
              dict(kind=0, to_world=_sphere([0.0, 0.0, 1.0], 1.0),
                   bsdf_idx=1),
              dict(kind=0, to_world=_sphere([1.8, 0.9, 0.5], 0.5),
                   bsdf_idx=2),
              dict(kind=0, to_world=_sphere([-1.7, 0.8, 0.6], 0.6),
                   bsdf_idx=3),
              dict(kind=1, to_world=panel(0.8, 4.0), bsdf_idx=7,
                   emitter_idx=0)]
    if not depolarizing:
        shapes += [dict(kind=1, to_world=m, bsdf_idx=4 + i)
                   for i, m in enumerate(filter_rects())]
    n = len(shapes)
    area = np.zeros((n, 3), np.float32)
    area[4] = [5.0, 4.0, 3.0] if colored else [4.0, 4.0, 4.0]
    kinds = [11, 1, 2, 3, 12, 13, 14, 0]
    if depolarizing:
        kinds = [0] * 8
    extras = np.zeros((8, 8), np.float32)
    extras[4, 0] = 30.0                      # polarizer theta
    extras[5, :2] = [45.0, 90.0]             # quarter-wave retarder
    extras[6, 2] = 1.0                       # left-handed circular
    pos, idx = icosphere(1)
    mesh = dict(positions=pos, indices=idx,
                to_world=_sphere([0.9, -1.7, 0.45], 0.45), bsdf_idx=3)
    return make_scene(
        shapes=shapes,
        bsdf_kinds=kinds,
        bsdf_albedos=[[0.3, 0.2, 0.1], [1.0, 1.0, 1.0], [0.9, 0.8, 0.7],
                      [1.0, 1.0, 1.0], [1.0, 1.0, 1.0], [0.9, 0.9, 0.9],
                      [1.0, 1.0, 1.0], [0.5, 0.5, 0.5]],
        bsdf_alphas=[0.08, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1],
        bsdf_etas=[AU_ETA] * 8, bsdf_ks=[AU_K] * 8,
        bsdf_iors=[1.49, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5, 1.5],
        bsdf_extras=extras, env=sunsky_state(mode), area_radiance=area,
        point_lights=(None if depolarizing
                      else np.array([[-2.0, -1.5, 3.0, 6.0, 6.0, 6.0]],
                                    np.float32)),
        meshes=[mesh])


def jax_stokes_lanes(sc, sensor, depth, rr_depth=1000, mode="rgb", key=KEY,
                     h=H, w=W, spp=SPP):
    """Per-lane Stokes vectors (h * w * spp, 3, 4) of JAX's path, numpy."""
    kinds = table_kinds(sc.bsdfs)

    @jax.jit
    def run(sc, sensor, key):
        lane = jnp.arange(h * w * spp, dtype=jnp.uint32)
        pixel = lane // spp
        smp = JI._SamplerCtx("independent", key, pixel, lane % spp, spp)
        u = smp.next(10_000, 2)
        uv = jnp.stack([((pixel % w).astype(jnp.float32) + u[:, 0]) / w,
                        ((pixel // w).astype(jnp.float32) + u[:, 1]) / h],
                       -1)
        o, d = JS.sample_ray(sensor, uv)
        if mode == "spectral":
            wl, wl_w = JSP.sample_rgb_spectrum(JSP.sample_shifted(
                smp.next(20_000, 1)[..., 0], 4))
            spec = JP.path_sample_polarized(sc, o, d, smp, depth, rr_depth,
                                            kinds=kinds, wavelengths=wl)
            st = jnp.stack([JSP.spectrum_to_srgb(spec[..., si] * wl_w, wl)
                            for si in range(4)], -1)
        else:
            st = JP.path_sample_polarized(sc, o, d, smp, depth, rr_depth,
                                          kinds=kinds)
        st = JMU.apply_stokes(JP.sensor_stokes_rotation(sensor, d)[
            ..., None, :, :], st)
        return jnp.where(jnp.isfinite(st), st, 0.0)
    return np.asarray(run(sc, sensor, key))


def port_stokes_lanes(sc, sensor, depth, rr_depth=1000, mode="rgb",
                      seed=WORDS, h=H, w=W, spp=SPP):
    """The port's lanes (its plain path on the CPU), numpy."""
    return TP.stokes_lanes(sc, sensor, TF.Film(h, w, 12), seed, spp, 0, spp,
                           depth, rr_depth, mode,
                           kinds=TB.table_kinds(sc.bsdfs)).detach().numpy()


def stokes_flips(port, ref, bar, floor=1e-3):
    """Lanes of (N, C, 4) Stokes vectors whose largest error, per channel
    relative to the reference's S0 there (floored at `floor`; |S1..S3| <=
    S0), exceeds `bar`."""
    port, ref = np.asarray(port), np.asarray(ref)
    err = np.abs(port - ref) / np.maximum(ref[..., :1], floor)
    return err.reshape(err.shape[0], -1).max(-1) > bar


def case(mode="rgb", colored=False, depolarizing=False):
    """(JAX scene, camera, the port's scene and camera)."""
    sc = pol_scene(mode, colored, depolarizing)
    cam = camera(EYE, TARGET)
    return (sc, cam) + port(sc, cam)


__all__ = ["H", "W", "SPP", "KEY", "WORDS", "case", "stokes_flips",
           "jax_stokes_lanes", "port_stokes_lanes", "pol_scene", "JS"]
