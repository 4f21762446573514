"""The golden scenes of `tools/gen_scene_goldens.py` that the PyTorch port
renders, built with the port's own constructors.

Each scene function mirrors its namesake in
`tools/gen_scene_goldens.py:55-227` (the same shapes, materials,
emitters, camera and depth);
`tests/golden/scene_goldens.npz` holds their reference means and
per-sample variances for the per-pixel Z-test
(`tpusky_torch.utils.ztest.z_test`). chip_smoke.py Z-tests all ten on
the card; tests/test_torch_moments.py Z-tests `sunsky_sphere`,
tests/test_torch_breadth_goldens.py the three lit by constant and area
emitters, tests/test_torch_envmap_golden.py `envmap_lit` and
tests/test_torch_medium_golden.py `medium_sphere` on the CPU.

    from tools.torch_scene_goldens import build
    scene, sensor, depth, mode = build("sunsky_sphere", device="cuda")
"""

import os

import numpy as np
import torch

import tpusky_torch as tt
from tpusky_torch.render.bsdf import DIELECTRIC, DIFFUSE, ROUGH_CONDUCTOR
from tpusky_torch.render.emitters import ConstantEnv, make_envmap
from tpusky_torch.render.medium import make_medium
from tpusky_torch.render.scene import make_scene
from tpusky_torch.render.sensors import make_perspective
from tpusky_torch.utils.meshio import icosphere

GOLDENS = os.path.join(os.path.dirname(__file__), os.pardir, "tests",
                       "golden", "scene_goldens.npz")
SUN = [0.3, 0.2, 0.93]


def _ground():
    return np.diag([10.0, 10.0, 1.0, 1.0]).astype(np.float32)


def _unit_sphere_at(z):
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = z
    return m


def _sunsky_env(device, turbidity=3.0, sun_scale=1.0, mode="rgb"):
    return tt.sunsky_precompute(tt.make_params(
        turbidity=turbidity, albedo=0.3, sun_direction=SUN,
        sun_scale=sun_scale, mode=mode, device=device))


def scene_sunsky_sphere(device):
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=0, to_world=_unit_sphere_at(1.0), bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]],
        env=_sunsky_env(device), device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor, 2, "rgb"


def scene_sunsky_sky_only(device):
    """The sky dome alone, no sun disc."""
    scene = make_scene(shapes=[], env=_sunsky_env(device, turbidity=6.0,
                                                  sun_scale=0.0),
                       device=device)
    sensor = make_perspective([0, 0, 1.0], [1, 0, 1.4], fov_x_deg=60,
                              device=device)
    return scene, sensor, 2, "rgb"


def scene_mesh_gi(device):
    """An icosphere of 320 triangles on a plane, depth 3."""
    pos, idx = icosphere(2)
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.3, 0.5, 0.7]],
        meshes=[dict(positions=pos, indices=idx, normals=pos.copy(),
                     to_world=_unit_sphere_at(1.0), bsdf_idx=1)],
        env=_sunsky_env(device), device=device)
    sensor = make_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor, 3, "rgb"


def scene_rough_conductor(device):
    """A rough-conductor ground under the sunsky, depth 4."""
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=0, to_world=_unit_sphere_at(1.0), bsdf_idx=1)],
        bsdf_albedos=[[0.8, 0.8, 0.8], [0.9, 0.7, 0.4]],
        bsdf_kinds=[ROUGH_CONDUCTOR, DIFFUSE], bsdf_alphas=[0.15, 0.0],
        env=_sunsky_env(device), device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 0.6], fov_x_deg=45,
                              device=device)
    return scene, sensor, 4, "rgb"


def scene_spectral_plane(device):
    """The spectral sunsky (4 hero wavelengths -> sRGB), depth 2."""
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=0, to_world=_unit_sphere_at(1.0), bsdf_idx=1)],
        bsdf_albedos=[[0.4, 0.4, 0.4], [0.6, 0.2, 0.2]],
        env=_sunsky_env(device, turbidity=4.0, mode="spectral"),
        device=device)
    sensor = make_perspective([4, -4, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor, 2, "spectral"


def _panel(scale, z):
    """A rectangle emitter scaled by `scale` at height z, facing down."""
    m = np.diag([scale, scale, 1.0, 1.0]).astype(np.float32)
    m[2, 3] = z
    m[:3, :3] = m[:3, :3] @ np.diag([1.0, -1.0, -1.0])
    return m


def scene_constant_cube_gi(device):
    """A cube on a plane under constant light, depth 4."""
    cube = np.diag([0.6, 0.6, 0.6, 1.0]).astype(np.float32)
    cube[2, 3] = 0.6
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=3, to_world=cube, bsdf_idx=1)],
        bsdf_albedos=[[0.6, 0.6, 0.6], [0.7, 0.3, 0.2]],
        env=ConstantEnv(torch.ones(3, device=device)), device=device)
    sensor = make_perspective([3, -3, 2.0], [0, 0, 0.6], fov_x_deg=45,
                              device=device)
    return scene, sensor, 4, "rgb"


def scene_area_light(device):
    """A diffuse plane lit by a rectangle area emitter, no environment."""
    rad = np.zeros((2, 3), np.float32)
    rad[1] = [8.0, 7.0, 6.0]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=1, to_world=_panel(0.8, 2.0), bsdf_idx=1,
                     emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.0, 0.0, 0.0]],
        area_radiance=rad, device=device)
    sensor = make_perspective([3, -3, 1.5], [0, 0, 0.5], fov_x_deg=45,
                              device=device)
    return scene, sensor, 2, "rgb"


def scene_dielectric_sphere(device):
    """A smooth dielectric sphere over a diffuse plane under an area
    panel, depth 6."""
    sphere = np.diag([0.7, 0.7, 0.7, 1.0]).astype(np.float32)
    sphere[2, 3] = 0.9
    rad = np.zeros((3, 3), np.float32)
    rad[2] = [10.0, 9.0, 8.0]
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=0, to_world=sphere, bsdf_idx=1),
                dict(kind=1, to_world=_panel(1.2, 3.0), bsdf_idx=2,
                     emitter_idx=0)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]],
        bsdf_kinds=[DIFFUSE, DIELECTRIC, DIFFUSE], bsdf_iors=[1.0, 1.5, 1.0],
        area_radiance=rad, device=device)
    sensor = make_perspective([3.2, -3.2, 1.6], [0, 0, 0.9], fov_x_deg=45,
                              device=device)
    return scene, sensor, 6, "rgb"


def envmap_lit_bitmap():
    """The 16x32 sky of `envmap_lit`: a vertical gradient in red and
    blue, a horizontal sine in green."""
    ys = np.linspace(0, 1, 16)[:, None]
    xs = np.linspace(0, 1, 32)[None, :]
    return np.stack([0.2 + 2.0 * ys * np.ones_like(xs),
                     0.3 + 1.0 * np.sin(np.pi * xs) * np.ones_like(ys),
                     0.8 - 0.5 * ys * np.ones_like(xs)],
                    -1).astype(np.float32)


def scene_envmap_lit(device):
    """A bitmap environment (the Bilinear2D warp) lighting a sphere on a
    plane, depth 2."""
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0),
                dict(kind=0, to_world=_unit_sphere_at(1.0), bsdf_idx=1)],
        bsdf_albedos=[[0.5, 0.5, 0.5], [0.7, 0.5, 0.3]],
        env=make_envmap(envmap_lit_bitmap(), device=device), device=device)
    sensor = make_perspective([3.5, -3.5, 2.0], [0, 0, 1.0], fov_x_deg=45,
                              device=device)
    return scene, sensor, 2, "rgb"


def scene_medium_sphere(device):
    """A sphere-bounded homogeneous Henyey-Greenstein medium over a
    diffuse plane under constant light, depth 6 (free flight, the
    medium's environment NEE, phase sampling)."""
    med = make_medium([0.8, 1.2, 1.6], [0.7, 0.7, 0.7], g=0.3,
                      to_world=_unit_sphere_at(1.2), kind="sphere",
                      device=device)
    scene = make_scene(
        shapes=[dict(kind=1, to_world=_ground(), bsdf_idx=0)],
        bsdf_albedos=[[0.4, 0.4, 0.4]],
        env=ConstantEnv(torch.tensor([1.0, 0.9, 0.8], device=device)),
        medium=med, device=device)
    sensor = make_perspective([3.5, -3.5, 1.6], [0, 0, 1.2], fov_x_deg=45,
                              device=device)
    return scene, sensor, 6, "rgb"


SCENES = {
    "sunsky_sphere": scene_sunsky_sphere,
    "sky_only": scene_sunsky_sky_only,
    "rough_conductor": scene_rough_conductor,
    "spectral_plane": scene_spectral_plane,
    "mesh_gi": scene_mesh_gi,
    "constant_cube_gi": scene_constant_cube_gi,
    "area_light": scene_area_light,
    "dielectric_sphere": scene_dielectric_sphere,
    "envmap_lit": scene_envmap_lit,
    "medium_sphere": scene_medium_sphere,
}


def build(name, device="cuda"):
    """(scene, sensor, depth, mode) of the golden scene `name`."""
    return SCENES[name](device)


def golden(name):
    """(mean, per-sample variance, size, depth) of `name`'s stored
    golden."""
    with np.load(GOLDENS) as z:
        return (z[f"{name}_mean"], z[f"{name}_var"], int(z["size"]),
                int(z[f"{name}_depth"]))
