"""Scene: analytic shapes, triangle meshes, a material table (diffuse and
rough-conductor kinds) and the sunsky sky.

The slice of `tpusky/render/scene.py` the ported paths use. Area, point,
directional and spot emitters, media, SDFs, curves and textures are not
ported yet, so a Scene here cannot hold them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from .bsdf import MaterialTable, make_material_table
from .mesh import MeshTable, make_mesh_table, mesh_test
from .shapes import ShapeTable, make_shape_table, ray_test


class Scene(NamedTuple):
    shapes: ShapeTable
    bsdfs: MaterialTable
    env: Any                         # SunskyState | None
    env_to_world: torch.Tensor       # (3, 3) env local -> world rotation
    mesh: Optional[MeshTable] = None  # every mesh's triangles, or None
    # K14's tables of `mesh` (ops/cuda/mesh_kernel.py::MeshTables), built
    # once per render on the card by `with_mesh_tables`
    mesh_tables: Any = None


def with_mesh_tables(scene: Scene, plain: bool = False) -> Scene:
    """The scene with K14's tables of its mesh, for a render that queries
    the mesh many times: built here when the mesh lies on the card and the
    kernel will run (not `plain`), else the scene as it is."""
    if (scene.mesh is None or scene.mesh_tables is not None or plain
            or scene.mesh.v0.device.type != "cuda"):
        return scene
    from ..ops.cuda.mesh_kernel import mesh_tables
    return scene._replace(mesh_tables=mesh_tables(scene.mesh))


def scene_occluded(scene: Scene, o, d, maxt, plain: bool = False):
    """Shadow-ray predicate over the scene's geometry (analytic shapes and
    triangle meshes); `plain` runs the meshes' plain version on any
    device."""
    occ = ray_test(scene.shapes, o, d, maxt)
    if scene.mesh is not None:
        occ = occ | mesh_test(scene.mesh, o, d, maxt, plain=plain,
                              tables=scene.mesh_tables)
    return occ


def make_scene(shapes=(), bsdf_albedos=((0.5, 0.5, 0.5),), env=None,
               env_to_world=None, bsdf_twosided=None, bsdf_kinds=None,
               bsdf_alphas=None, bsdf_etas=None, bsdf_ks=None,
               bsdf_spectral_albedos=None, meshes=None,
               device="cuda") -> Scene:
    """Assemble a scene from host-side descriptions: shapes are dicts
    accepted by `make_shape_table`; the bsdf_* lists are the columns of
    `make_material_table` (the reference package's keyword names); meshes
    are dicts accepted by `make_mesh_table`, all baked into one table."""
    if len(shapes) == 0:
        # a never-hit placeholder keeps the table non-empty
        ph = np.eye(4)
        ph[:3, 3] = 3e4
        shapes = [dict(kind=0, to_world=ph, bsdf_idx=0)]
    if env_to_world is None:
        env_to_world = np.eye(3, dtype=np.float32)
    return Scene(make_shape_table(shapes, device=device),
                 make_material_table(
                     kinds=bsdf_kinds, albedos=bsdf_albedos,
                     twosided=bsdf_twosided,
                     spectral_albedos=bsdf_spectral_albedos,
                     alphas=bsdf_alphas, etas=bsdf_etas, ks=bsdf_ks,
                     device=device),
                 env, torch.tensor(np.asarray(env_to_world, np.float32),
                                   device=device),
                 make_mesh_table(meshes, device=device) if meshes else None)
