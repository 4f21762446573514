"""Wrapper of the triangle-mesh kernel K14 (`csrc/mesh_kernel.cu`).

The PyTorch counterpart of `tpusky/ops/pallas/mesh_kernel.py`:

* `mesh_tables(mesh)`: the kernel's tables (`mesh_tables_pallas`): each
  triangle (v0, e1, e2), padding triangles moved to 3e4 with zero edges,
  tile and supertile (16 tiles) bounds, the tile count padded to a
  supertile multiple with never-entered boxes; and the mesh bounds of the
  wavefront sort's key (`render/mesh.py::_key_bounds`). The bounds equal
  the reference's; the layout is the card's own: a triangle is one record
  of 12 floats, [v0.xyz, e1.x | e1.yz, e2.xy | e2.z, 0, 0, 0], three
  float4 loads by the lane that tests it, and a box is a row [lo.xyz, 0,
  hi.xyz, 0], two float4 loads. Beside the reference's tile and supertile
  boxes the kernel has a box for each quarter of a tile (a leaf of 32
  triangles), computed the same way. A render builds the tables once per
  call (`integrator.render_rows`); `builds` counts the builds.
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
import torch.autograd.forward_ad as fwAD

from . import build

_TILE = 128
_SUPER = 16
_FAR = 3e4          # where padding triangles and padding tiles' boxes lie
_LEAF = 32          # triangles a leaf box
_REC = 12           # floats a triangle record

# mesh_tables calls so far: a render builds its tables once
builds = 0


class MeshTables(NamedTuple):
    tris: torch.Tensor         # (n_tiles, 128, 12) triangle records
    leaves: torch.Tensor       # (n_tiles * 4, 8) boxes of 32 triangles
    boxes: torch.Tensor        # (n_tiles, 8) [lo.xyz, 0, hi.xyz, 0]
    super_boxes: torch.Tensor  # (n_tiles / 16, 8)
    key_lo: torch.Tensor       # (3,) the sort key's mesh bounds
    key_hi: torch.Tensor       # (3,)


def mesh_tables(mesh) -> MeshTables:
    """The kernel's tables of a MeshTable (`mesh_kernel.py:211-257`)."""
    global builds
    from ...render.mesh import _key_bounds
    builds += 1
    with torch.no_grad():
        valid = mesh.valid[:, None]
        v0 = torch.where(valid, mesh.v0, _FAR)
        e1 = torch.where(valid, mesh.e1, 0.0)
        e2 = torch.where(valid, mesh.e2, 0.0)
        n_tiles = v0.shape[0] // _TILE
        tris = torch.cat([v0, e1, e2, torch.zeros_like(v0)], 1).reshape(
            n_tiles, _TILE, _REC)
        va = torch.stack([v0, v0 + e1, v0 + e2], 0)
        big = torch.where(valid, 0.0, torch.inf)
        tri_lo, tri_hi = (va + big).amin(0), (va - big).amax(0)
        # the tile count padded to a supertile multiple; padding tiles hold
        # never-hit triangles and inverted boxes
        pad = -n_tiles % _SUPER
        pad_tris = torch.zeros((pad, _TILE, _REC), device=tris.device)
        pad_tris[..., :3] = _FAR
        tris = torch.cat([tris, pad_tris]).contiguous()

        def bounds(size, n):
            """[lo.xyz, 0, hi.xyz, 0] rows of groups of `size` triangles,
            then n never-entered rows of padding."""
            lo = tri_lo.reshape(-1, size, 3).amin(1)
            hi = tri_hi.reshape(-1, size, 3).amax(1)
            lo = torch.where(torch.isfinite(lo), lo, _FAR)
            hi = torch.where(torch.isfinite(hi), hi, _FAR - 1.0)
            lo = torch.cat([lo, torch.full((n, 3), _FAR, device=lo.device)])
            hi = torch.cat([hi, torch.full((n, 3), _FAR - 1.0,
                                           device=hi.device)])
            return lo, hi

        def rows(lo3, hi3):
            z = torch.zeros_like(lo3[:, :1])
            return torch.cat([lo3, z, hi3, z], 1).contiguous()
        lo, hi = bounds(_TILE, pad)
        n_super = (n_tiles + pad) // _SUPER
        slo = lo.reshape(n_super, _SUPER, 3).amin(1)
        shi = hi.reshape(n_super, _SUPER, 3).amax(1)
        return MeshTables(tris, rows(*bounds(_LEAF, pad * _TILE // _LEAF)),
                          rows(lo, hi), rows(slo, shi), *_key_bounds(mesh))


def check_inputs(mesh, o, d, tables: MeshTables):
    """What K14 takes: rays (N, 3) float32, contiguous, on the tables'
    device, at most 2^31 - 1 of them, and nothing that requires grad or
    carries a forward-mode tangent."""
    if any(isinstance(t, torch.Tensor) and (
            t.requires_grad or fwAD.unpack_dual(t).tangent is not None)
           for t in (*mesh, o, d)):
        raise NotImplementedError(
            "K14 has no adjoint (the TPU kernel has none): it takes "
            "detached tensors, and render/mesh.py::_closest differentiates "
            "the hit at the triangle it picks")
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
    n_tiles = tables.tris.shape[0]
    if (n_tiles % _SUPER or tables.tris.shape[1:] != (_TILE, _REC)
            or tables.leaves.shape != (n_tiles * _TILE // _LEAF, 8)
            or tables.boxes.shape != (n_tiles, 8)
            or tables.super_boxes.shape != (n_tiles // _SUPER, 8)):
        raise ValueError("mesh_intersect: tables not from mesh_tables")


def launch(tables: MeshTables, o, d, work: bool = False):
    """K14 on rays o, d (N, 3) -> (t, b1, b2, tri int32), and with `work`
    the tiles and the leaves each ray tested, (N, 2) int32."""
    n = o.shape[0]
    t = torch.empty((n,), dtype=torch.float32, device=o.device)
    b1, b2 = torch.empty_like(t), torch.empty_like(t)
    tri = torch.empty((n,), dtype=torch.int32, device=o.device)
    tested = (torch.empty((n, 2), dtype=torch.int32, device=o.device)
              if work else None)
    err = build.library().tsk_mesh_intersect(
        o.data_ptr(), d.data_ptr(), n, tables.tris.data_ptr(),
        tables.leaves.data_ptr(), tables.boxes.data_ptr(),
        tables.super_boxes.data_ptr(), tables.super_boxes.shape[0],
        t.data_ptr(), b1.data_ptr(), b2.data_ptr(), tri.data_ptr(),
        tested.data_ptr() if work else None,
        torch.cuda.current_stream(o.device).cuda_stream)
    build.check(err, "mesh_intersect")
    return (t, b1, b2, tri) + ((tested,) if work else ())


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
