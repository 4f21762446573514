"""The golden scenes of `tools/gen_scene_goldens.py` that the PyTorch port
renders, built with the port's own constructors.

Each scene function mirrors its namesake in
`tools/gen_scene_goldens.py:55-175` (the same shapes, materials, sunsky
parameters, camera and depth);
`tests/golden/scene_goldens.npz` holds their reference means and
per-sample variances for the per-pixel Z-test
(`tpusky_torch.utils.ztest.z_test`). chip_smoke.py Z-tests all five on
the card; tests/test_torch_moments.py Z-tests `sunsky_sphere` on the CPU.

    from tools.torch_scene_goldens import build
    scene, sensor, depth, mode = build("sunsky_sphere", device="cuda")
"""

import os

import numpy as np

import tpusky_torch as tt
from tpusky_torch.render.bsdf import DIFFUSE, ROUGH_CONDUCTOR
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


SCENES = {
    "sunsky_sphere": scene_sunsky_sphere,
    "sky_only": scene_sunsky_sky_only,
    "rough_conductor": scene_rough_conductor,
    "spectral_plane": scene_spectral_plane,
    "mesh_gi": scene_mesh_gi,
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
