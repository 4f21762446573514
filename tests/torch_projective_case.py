"""Shared cases of the projective-gradient parity tests
(tests/test_torch_projective*.py): tests/test_projective.py's scenes at a
16x16 film, built by the JAX package and converted to the port, and a
seeded positive adjoint image."""

import numpy as np
import jax
import torch

import tpusky as ts
from tpusky.models.sunsky import model as JM
from tpusky.models.sunsky.tables import load_tables
from tpusky.render.film import Film as JFilm
from tpusky.render.scene import make_scene
from tpusky.render.sensors import make_perspective
from tpusky_torch import convert
from tpusky_torch.render.film import Film

H = W = 16
LD = np.asarray([0.35, 0.1, -0.93]) / np.linalg.norm([0.35, 0.1, -0.93])


def sky_env():
    """tests/test_projective.py::_sky_env: the sky alone (precomputed as
    one program: op by op it takes ten times as long)."""
    p = ts.make_params(turbidity=3.0, albedo=0.3,
                       sun_direction=[0.3, 0.2, 0.93], sun_scale=0.0)
    return jax.jit(JM.precompute, static_argnums=2)(load_tables("rgb"), p,
                                                    "rgb")


def sphere_on_ground(env=None, directional=False):
    """A sphere (radius 0.5 at z = 1) over a 12x12 ground, under `env`
    and, if `directional`, the shadow test's delta light."""
    ground = np.diag([6.0, 6.0, 1.0, 1.0]).astype(np.float32)
    sph = np.eye(4, dtype=np.float32)
    sph[:3, :3] *= 0.5
    sph[2, 3] = 1.0
    return make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=0, to_world=sph, bsdf_idx=1)],
        bsdf_albedos=[[0.7, 0.7, 0.7], [0.2, 0.4, 0.7]],
        directional_lights=([list(LD) + [3.0, 3.0, 3.0]] if directional
                            else None), env=env)


def panel_scene(blocker="sphere"):
    """tests/test_projective.py's indirect cases: a blocker (a unit sphere
    at z = 2, or an icosphere(1) mesh there) between a downward area panel
    at z = 4 and a 40x40 ground."""
    panel = np.diag([3.0, 3.0, 1.0, 1.0]).astype(np.float32)
    panel[2, 3] = 4.0
    panel[:3, :3] = panel[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    ground = np.diag([20.0, 20.0, 1.0, 1.0]).astype(np.float32)
    if blocker == "sphere":
        rad = np.zeros((3, 3), np.float32)
        rad[2] = 20.0
        sph = np.eye(4, dtype=np.float32)
        sph[2, 3] = 2.0
        return make_scene(
            shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                    dict(kind=0, to_world=sph, bsdf_idx=1),
                    dict(kind=1, to_world=panel, bsdf_idx=2, emitter_idx=0)],
            bsdf_albedos=[[0.6, 0.6, 0.6], [0.3, 0.3, 0.3],
                          [0.0, 0.0, 0.0]], area_radiance=rad, env=None)
    from tpusky_torch.utils.meshio import icosphere
    pos, idx = icosphere(1)
    t2w = np.eye(4, dtype=np.float32)
    t2w[2, 3] = 2.0
    rad = np.zeros((2, 3), np.float32)
    rad[1] = 20.0
    return make_scene(
        shapes=[dict(kind=1, to_world=ground, bsdf_idx=0),
                dict(kind=1, to_world=panel, bsdf_idx=2, emitter_idx=0)],
        bsdf_albedos=[[0.6, 0.6, 0.6], [0.3, 0.3, 0.3], [0.0, 0.0, 0.0]],
        meshes=[dict(positions=pos, indices=idx, to_world=t2w,
                     bsdf_idx=1)], area_radiance=rad, env=None)


def mesh_under_sky():
    """An icosphere(1) mesh at z = 1 under the sky alone (the primary FD
    test's sphere, as a mesh)."""
    from tpusky_torch.utils.meshio import icosphere
    pos, idx = icosphere(1)
    t2w = np.eye(4, dtype=np.float32)
    t2w[2, 3] = 1.0
    return make_scene(shapes=[], bsdf_albedos=[[0.6, 0.3, 0.2]],
                      meshes=[dict(positions=pos, indices=idx, to_world=t2w,
                                   bsdf_idx=0)], env=sky_env())


def camera(kind="primary"):
    if kind == "primary":
        return make_perspective([2.5, -5, 1.0], [0, 0, 1.0], fov_x_deg=40)
    if kind == "shadow":
        return make_perspective([0, -4.5, 2.6], [0, 0, 0.4], fov_x_deg=45)
    return make_perspective([0.0, -9.0, 6.0], [2.5, 0.0, 0.0], fov_x_deg=40)


def grad_image(seed=0):
    """A seeded positive adjoint image (H, W, 3) of mean 1 / (H W 3)."""
    g = np.random.default_rng(seed).random((H, W, 3)).astype(np.float32)
    return g * np.float32(2.0 / (H * W * 3))


def port(scene, sensor, gi, key):
    """The port's scene, sensor, film, adjoint image and key words."""
    return (convert.scene(scene, device="cpu"),
            convert.sensor(sensor, device="cpu"), Film(H, W, 3),
            torch.as_tensor(gi), np.asarray(jax.random.key_data(key)))


def jfilm():
    return JFilm(H, W, 3)


def check(got, want, bar, what):
    """got (a tensor) within `bar` of want's scale; want not all zero."""
    got = got.detach().numpy()
    want = np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0, what
    err = np.abs(got - want).max() / scale
    assert err <= bar, (what, err)
