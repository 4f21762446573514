"""Wrapper of the direct-illumination megakernel K4 (`csrc/megakernel.cu`).

The PyTorch counterpart of `tpusky/ops/pallas/megakernel.py`: one pass
renders a whole depth-2 RGB frame of an eligible scene
(`render/integrator.py::_megakernel_ok`). The wrapper packs the camera
and the shapes into small rows, rotated once into the environment's local
frame (world' = env_to_world^T world), so the kernel never rotates a
lane; radiance does not depend on that rotation.

`megakernel_lanes` returns the per-lane radiance (N, 3) in pixel-major
lane order (lane = pixel * spp + sample); `direct_rgb_megakernel` reduces
it to the film accumulation. For CPU tensors both run the plain version:
the wavefront path with the plain sunsky functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.math import mat3_apply_t
from . import build
from .sunsky_kernel import Tables, pack_tables

_CAM_W = 16


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


class Packed(NamedTuple):
    """Scene, camera and sunsky state as the kernel reads them."""
    cam: torch.Tensor       # (16,)
    shp: torch.Tensor       # (n, 12)
    mat: torch.Tensor       # (n, 4)
    kind: torch.Tensor      # (n,) int32
    tables: Tables


def pack(scene, sensor, state) -> Packed:
    device = scene.shapes.to_world.device
    packed = Packed(_camera_row(sensor, scene.env_to_world),
                    _shape_rows(scene.shapes, scene.env_to_world),
                    _material_rows(scene),
                    torch.tensor(scene.shapes.kind, dtype=torch.int32,
                                 device=device),
                    pack_tables(state, device))
    for t in packed[:4]:
        if t.device != device or t.requires_grad:
            raise ValueError("direct_rgb_megakernel: scene, sensor and state "
                             "must be constant tensors on one device")
    return packed


def launch(packed: Packed, seed: int, spp: int, width: int, height: int):
    n = width * height * spp
    if n >= 2 ** 31:
        raise ValueError("direct_rgb_megakernel: at most 2^31 - 1 lanes")
    device = packed.cam.device
    out = torch.empty((n, 3), dtype=torch.float32, device=device)
    err = build.library().tsk_direct_rgb_megakernel(
        packed.cam.data_ptr(), packed.shp.data_ptr(), packed.mat.data_ptr(),
        packed.kind.data_ptr(), packed.kind.shape[0], int(seed) & 0xFFFFFFFF,
        spp, width, height, *packed.tables.pointers(), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "direct_rgb_megakernel")
    return out


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
