"""Wrapper of the direct-illumination megakernel K4 (`csrc/megakernel.cu`).

The PyTorch counterpart of `tpusky/ops/pallas/megakernel.py`: one pass
renders a whole depth-2 RGB frame of an eligible scene
(`render/integrator.py::_megakernel_ok`). The kernel reads the scene's
and the sunsky state's raw tensors (the camera's to_world, field of view
and aspect, each shape's to_object, material index and kind, the
materials' albedo and two-sided flag, env_to_world; the RGB state's
fields) and builds its rows once a block: the camera and shape rows,
rotated into the environment's local frame (world' = env_to_world^T
world), so that it rotates no ray, and the state's misc row and gaussian
table. Radiance does not depend on that rotation, but the continuation's
shading frame does, so under a rotated environment the kernel builds that
frame in world coordinates, as the wavefront path does. `scene_rows` is
the plain version of the scene rows, `sunsky_kernel._misc_row` and
`_gauss_rows` of the state's. A frame is one launch and costs the host no
synchronisation: the shape kinds reach the card once per kind tuple and
device (`_kinds_on`).

`megakernel_lanes` returns the per-lane radiance (N, 3) in pixel-major
lane order (lane = pixel * spp + sample); `direct_rgb_megakernel` reduces
it to the film accumulation. For CPU tensors both run the plain version:
the wavefront path with the plain sunsky functions.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ...ops.math import mat3_apply_t
from . import build

_CAM_W = 16
# the staged misc row and gaussian table (csrc/megakernel.cu's rows output)
_MISC_W, _GAUSS_W = 16, 14 * 20


def _camera_row(sensor, env_to_world):
    """(16,): camera rotation (row-major, camera -> env-local), origin,
    tan(fov_x / 2), aspect."""
    e = env_to_world
    rot = mat3_apply_t(e, sensor.to_world[:3, :3].T).T      # E^T R
    origin = mat3_apply_t(e, sensor.to_world[:3, 3])
    tan_half = torch.tan(0.5 * torch.deg2rad(sensor.fov_x_deg))
    row = torch.zeros(_CAM_W, dtype=torch.float32, device=e.device)
    row[0:9] = rot.reshape(9)
    row[9:12] = origin
    row[12] = tan_half
    row[13] = sensor.aspect
    return row


def _shape_rows(shapes, env_to_world):
    """(n, 12): each shape's world->object map [A E (row-major), b], so
    that local = A E w' + b for an env-local point w'."""
    t2o = shapes.to_object
    lin = (t2o[:, :3, :3, None] * env_to_world[None, None]).sum(2)
    return torch.cat([lin.reshape(-1, 9), t2o[:, :3, 3]], 1).contiguous()


def _material_rows(scene):
    """(n, 4): the albedo of each shape's material and its twosided flag."""
    idx = scene.shapes.bsdf_idx
    return torch.cat([scene.bsdfs.albedo[idx],
                      scene.bsdfs.twosided[idx, None].float()], 1).contiguous()


def scene_rows(scene, sensor):
    """The rows K4 stages, by plain tensor ops: camera (16,), shapes
    (n, 12), materials (n, 4)."""
    return (_camera_row(sensor, scene.env_to_world),
            _shape_rows(scene.shapes, scene.env_to_world),
            _material_rows(scene))


@functools.lru_cache(maxsize=64)
def _kinds_on(kinds: tuple, device: torch.device) -> torch.Tensor:
    """The shape kinds (a tuple of Python ints, so the key is exact) as an
    int32 tensor on `device`, copied once from pinned memory: no frame
    waits for the copy (a CPU tensor is the host's own)."""
    kinds = torch.tensor(kinds, dtype=torch.int32)
    if device.type == "cpu":
        return kinds
    return kinds.pin_memory().to(device, non_blocking=True)


def _state_fields(state):
    """The RGB state's tensors K4 reads, in its parameters' order."""
    p = state.params
    return (state.sky_params, state.sky_radiance, state.sun_radiance,
            state.sun_frame_n, state.sun_frame_s, state.sun_frame_t,
            state.sun_angles, state.sky_sampling_w, state.gaussians,
            p.sun_half_aperture, p.sky_scale, p.sun_scale, p.disc_softness)


class Packed(NamedTuple):
    """The scene's, the camera's and the sunsky state's tensors as the
    kernel reads them."""
    to_world: torch.Tensor   # (4, 4) camera -> world
    fov_x_deg: torch.Tensor  # ()
    aspect: torch.Tensor     # ()
    env_to_world: torch.Tensor  # (3, 3)
    to_object: torch.Tensor  # (n, 4, 4)
    bsdf_idx: torch.Tensor   # (n,) int64
    kind: torch.Tensor       # (n,) int32
    albedo: torch.Tensor     # (m, 3)
    twosided: torch.Tensor   # (m,) bool
    state: tuple             # `_state_fields`, float32


def pack(scene, sensor, state) -> Packed:
    """The kernel's inputs (no copies for the port's own tensors). K4 has
    no adjoint: under autograd it runs only inside
    `render/integrator.py::_Megakernel`, whose forward packs with
    gradients off and whose backward replays the wavefront path."""
    device = scene.shapes.to_world.device
    if (tuple(state.sky_params.shape) != (3, 9)
            or tuple(state.sun_radiance.shape) != (45, 72)):
        raise ValueError("direct_rgb_megakernel: needs a state precomputed "
                         "in RGB mode")

    def f32(t):
        return t.to(torch.float32).contiguous()
    packed = Packed(f32(sensor.to_world), f32(sensor.fov_x_deg),
                    f32(sensor.aspect), f32(scene.env_to_world),
                    f32(scene.shapes.to_object),
                    scene.shapes.bsdf_idx.to(torch.int64).contiguous(),
                    _kinds_on(tuple(scene.shapes.kind), device),
                    f32(scene.bsdfs.albedo),
                    scene.bsdfs.twosided.to(torch.bool).contiguous(),
                    tuple(f32(t) for t in _state_fields(state)))
    tensors = (*packed[:-1], *packed.state)
    if any(t.device != device for t in tensors):
        raise ValueError("direct_rgb_megakernel: scene, sensor and state "
                         "must lie on one device")
    if any(t.requires_grad for t in tensors):
        raise ValueError("direct_rgb_megakernel has no adjoint: call it "
                         "with gradients off (render() differentiates it "
                         "by replaying the wavefront path)")
    return packed


def launch(packed: Packed, seed: int, spp: int, width: int, height: int,
           rows: bool = False):
    """Per-lane radiance (width * height * spp, 3); with `rows`, also the
    rows the kernel staged, (camera (16,), shapes (n, 12), materials
    (n, 4), misc (16,), gaussians (14, 20)), as `scene_rows` and
    `sunsky_kernel._misc_row` and `_gauss_rows` compute them."""
    n = width * height * spp
    if n >= 2 ** 31:
        raise ValueError("direct_rgb_megakernel: at most 2^31 - 1 lanes")
    device = packed.to_world.device
    n_shapes = packed.kind.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    s0 = _CAM_W + _MISC_W + _GAUSS_W
    staged = (torch.empty(s0 + 16 * n_shapes, dtype=torch.float32,
                          device=device) if rows else None)
    err = build.library().tsk_direct_rgb_megakernel(
        packed.to_world.data_ptr(), packed.fov_x_deg.data_ptr(),
        packed.aspect.data_ptr(), packed.env_to_world.data_ptr(),
        packed.to_object.data_ptr(), packed.bsdf_idx.data_ptr(),
        packed.kind.data_ptr(), n_shapes, packed.albedo.data_ptr(),
        packed.twosided.data_ptr(), packed.albedo.shape[0],
        *(t.data_ptr() for t in packed.state), int(seed) & 0xFFFFFFFF, spp,
        width, height, out.data_ptr(),
        None if staged is None else staged.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "direct_rgb_megakernel")
    if not rows:
        return out
    shp = s0 + 12 * n_shapes
    return out, (staged[:_CAM_W], staged[s0:shp].view(n_shapes, 12),
                 staged[shp:].view(n_shapes, 4),
                 staged[_CAM_W:_CAM_W + _MISC_W],
                 staged[_CAM_W + _MISC_W:s0].view(14, 20))


def megakernel_lanes(scene, sensor, state, seed: int, spp: int, width: int,
                     height: int):
    """Per-lane radiance (width * height * spp, 3) of a depth-2 frame."""
    device = scene.shapes.to_world.device
    if device.type == "cpu":
        from ...render import integrator
        from ...render.film import Film
        return integrator._lane_radiance(
            scene._replace(env=state), sensor, Film(height, width, 3), seed,
            spp, 0, spp, 2, 1000, "rgb", 0, height, plain=True)
    if device.type != "cuda":
        raise ValueError(f"direct_rgb_megakernel: unsupported device {device}")
    out = launch(pack(scene, sensor, state), seed, spp, width, height)
    build.launches["direct_rgb_megakernel"] += 1
    return out


def direct_rgb_megakernel(scene, sensor, state, seed: int, spp: int,
                          width: int, height: int):
    """Fused direct-illumination frame -> film accumulation (H, W, 4)."""
    from ...render.film import Film, splat_ordered
    lanes = megakernel_lanes(scene, sensor, state, seed, spp, width, height)
    return splat_ordered(Film(height, width, 3), lanes, spp)
