"""Wrapper of the triangle-mesh kernel K14 (`csrc/mesh_kernel.cu`).

The PyTorch counterpart of `tpusky/ops/pallas/mesh_kernel.py`:

* `mesh_tables(mesh)`: the kernel's tables (`mesh_tables_pallas`): each
  tile's triangles as component planes (v0, e1, e2), padding triangles
  moved to 3e4 with zero edges, tile and supertile (16 tiles) bounds, the
  tile count padded to a supertile multiple with never-entered boxes. The
  bounds equal the reference's; the layout is the card's own: tile-major
  planes (n_tiles, 9, 128), so a block stages a tile with coalesced loads,
  and bounds as [lo.xyz, 0, hi.xyz, 0] rows, two float4 loads a box.
* `mesh_intersect_kernel(mesh, o, d, tables)` -> (t, b1, b2, tri int32,
  hit): the closest hit of rays o, d (N, 3). A CPU tensor runs the plain
  version (`render/mesh.py::_closest_plain`); a CUDA tensor launches K14
  or raises.

K14 has no adjoint, as the TPU kernel has none: a mesh tensor, `o` or `d`
that requires grad on the card raises NotImplementedError. Vertex
gradients wait for the projective AD module; the sunsky's gradients
through a mesh scene need none, since every mesh query's rays are
constants of the sky parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import build

_TILE = 128
_SUPER = 16
_FAR = 3e4          # where padding triangles and padding tiles' boxes lie


class MeshTables(NamedTuple):
    tv: torch.Tensor           # (n_tiles, 9, 128) v0, e1, e2 planes
    boxes: torch.Tensor        # (n_tiles, 8) [lo.xyz, 0, hi.xyz, 0]
    super_boxes: torch.Tensor  # (n_tiles / 16, 8)


def mesh_tables(mesh) -> MeshTables:
    """The kernel's tables of a MeshTable (`mesh_kernel.py:211-257`)."""
    with torch.no_grad():
        valid = mesh.valid[:, None]
        v0 = torch.where(valid, mesh.v0, _FAR)
        e1 = torch.where(valid, mesh.e1, 0.0)
        e2 = torch.where(valid, mesh.e2, 0.0)
        n_tiles = v0.shape[0] // _TILE
        tv = torch.stack([v0, e1, e2], 1).reshape(n_tiles, _TILE, 9)
        tv = tv.transpose(1, 2)
        va = torch.stack([v0, v0 + e1, v0 + e2], 0)
        big = torch.where(valid, 0.0, torch.inf)
        lo = (va + big).amin(0).reshape(n_tiles, _TILE, 3).amin(1)
        hi = (va - big).amax(0).reshape(n_tiles, _TILE, 3).amax(1)
        lo = torch.where(torch.isfinite(lo), lo, _FAR)
        hi = torch.where(torch.isfinite(hi), hi, _FAR - 1.0)
        # the tile count padded to a supertile multiple; padding tiles hold
        # never-hit triangles and inverted boxes
        pad = -n_tiles % _SUPER
        pad_tv = torch.zeros((pad, 9, _TILE), device=tv.device)
        pad_tv[:, :3] = _FAR
        tv = torch.cat([tv, pad_tv]).contiguous()
        lo = torch.cat([lo, torch.full((pad, 3), _FAR, device=lo.device)])
        hi = torch.cat([hi, torch.full((pad, 3), _FAR - 1.0,
                                       device=hi.device)])
        n_super = (n_tiles + pad) // _SUPER
        slo = lo.reshape(n_super, _SUPER, 3).amin(1)
        shi = hi.reshape(n_super, _SUPER, 3).amax(1)

        def rows(lo3, hi3):
            z = torch.zeros_like(lo3[:, :1])
            return torch.cat([lo3, z, hi3, z], 1).contiguous()
        return MeshTables(tv, rows(lo, hi), rows(slo, shi))


def check_inputs(mesh, o, d, tables: MeshTables):
    """What K14 takes: rays (N, 3) float32, contiguous, on the tables'
    device, at most 2^31 - 1 of them, and nothing that requires grad."""
    if any(t is not None and t.requires_grad for t in (*mesh, o, d)):
        raise NotImplementedError(
            "mesh_intersect has no adjoint on the card (the TPU kernel has "
            "none): vertex gradients wait for the projective AD module")
    for name, x in (("o", o), ("d", d)):
        if x.dim() != 2 or x.shape[1] != 3 or x.shape[0] != o.shape[0]:
            raise ValueError(f"mesh_intersect: {name} must be (N, 3), "
                             f"got {tuple(x.shape)}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError(f"mesh_intersect: {name} must be contiguous "
                             "float32")
    if o.shape[0] >= 2 ** 31:
        raise ValueError("mesh_intersect: at most 2^31 - 1 rays")
    for x in (d, *tables):
        if x.device != o.device:
            raise ValueError(f"mesh_intersect: tensors on {x.device} and "
                             f"{o.device}")
        if x.dtype != torch.float32 or not x.is_contiguous():
            raise ValueError("mesh_intersect: tables must be contiguous "
                             "float32")
    if tables.tv.shape[0] % _SUPER or tables.tv.shape[1:] != (9, _TILE):
        raise ValueError("mesh_intersect: tables not from mesh_tables")


def launch(tables: MeshTables, o, d):
    """K14 on rays o, d (N, 3) -> (t, b1, b2, tri int32)."""
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    b1, b2 = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = build.library().tsk_mesh_intersect(
        o.data_ptr(), d.data_ptr(), n, tables.tv.data_ptr(),
        tables.boxes.data_ptr(), tables.super_boxes.data_ptr(),
        tables.super_boxes.shape[0], t.data_ptr(), b1.data_ptr(),
        b2.data_ptr(), tri.data_ptr(),
        torch.cuda.current_stream(o.device).cuda_stream)
    build.check(err, "mesh_intersect")
    return t, b1, b2, tri


def mesh_intersect_kernel(mesh, o, d, tables: MeshTables = None):
    """Closest hit of rays o, d (N, 3) -> (t, b1, b2, tri int32, hit):
    t = inf, b1 = b2 = 0 and tri = -1 on a miss."""
    if o.device.type == "cpu":
        from ...render.mesh import _closest_plain
        t, b1, b2, tri = _closest_plain(mesh, o, d)
        tri = tri.int()
    elif o.device.type == "cuda":
        if tables is None:
            tables = mesh_tables(mesh)
        check_inputs(mesh, o, d, tables)
        t, b1, b2, tri = launch(tables, o, d)
        build.launches["mesh_intersect"] += 1
    else:
        raise ValueError(f"mesh_intersect: unsupported device {o.device}")
    return t, b1, b2, tri, torch.isfinite(t) & (tri >= 0)
