"""Scene: analytic shapes, triangle meshes, a material table, the
environment (sunsky, constant, uniform, envmap or none) and the area, point,
directional and spot emitters (`tpusky/render/scene.py`).

Media, SDFs, curves and textures are not ported yet, so a Scene here
cannot hold them. An emitter field left None holds no emitter.
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
    env: Any    # SunskyState | ConstantEnv | UniformEnv | EnvMapState | None
    env_to_world: torch.Tensor       # (3, 3) env local -> world rotation
    mesh: Optional[MeshTable] = None  # every mesh's triangles, or None
    # K14's tables of `mesh` (ops/cuda/mesh_kernel.py::MeshTables), built
    # once per render on the card by `with_mesh_tables`
    mesh_tables: Any = None
    # (n_shapes, C) radiance a hit on each shape emits; None: none emits
    area_radiance: Optional[torch.Tensor] = None
    area_emitter_shapes: Optional[torch.Tensor] = None  # (n_area,) int64
    point_lights: Optional[torch.Tensor] = None   # (Np, 6) [pos, intensity]
    directional_lights: Optional[torch.Tensor] = None  # (Nd, 6) [dir, irr.]
    spot_lights: tuple = ()                       # emitters.SpotLight each
    # (Np + Nd + Nspot,) each delta light's sampling weight
    # (`scene.cpp:100-119`); None: uniform
    delta_light_weights: Optional[torch.Tensor] = None


def table_len(x) -> int:
    """Rows of an optional emitter table (0 for None)."""
    return 0 if x is None else x.shape[0]


def n_delta_lights(scene: Scene) -> int:
    return (table_len(scene.point_lights)
            + table_len(scene.directional_lights) + len(scene.spot_lights))


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
               bsdf_spectral_albedos=None, meshes=None, area_radiance=None,
               point_lights=None, directional_lights=None, spot_lights=(),
               delta_light_weights=None, bsdf_iors=None,
               bsdf_opacities=None, bsdf_extras=None,
               bsdf_blend_children=None, bsdf_blend_weights=None,
               device="cuda") -> Scene:
    """Assemble a scene from host-side descriptions: shapes are dicts
    accepted by `make_shape_table`; the bsdf_* lists are the columns of
    `make_material_table` (the reference package's keyword names); meshes
    are dicts accepted by `make_mesh_table`, all baked into one table.
    `area_radiance` (n_shapes, 3) is what a hit on each shape emits, a
    shape with `emitter_idx >= 0` being sampled by NEE; point and
    directional lights are (N, 6) rows [position or direction,
    intensity or irradiance]; `spot_lights` are `emitters.SpotLight`s."""
    if len(shapes) == 0:
        # a never-hit placeholder keeps the table non-empty
        ph = np.eye(4)
        ph[:3, 3] = 3e4
        shapes = [dict(kind=0, to_world=ph, bsdf_idx=0)]
    if env_to_world is None:
        env_to_world = np.eye(3, dtype=np.float32)

    def f32(x, cols=None):
        a = np.asarray(x, np.float32)
        return torch.tensor(a if cols is None else a.reshape(-1, cols),
                            device=device)
    area_ids = [i for i, s in enumerate(shapes)
                if s.get("emitter_idx", -1) >= 0]
    if area_ids and area_radiance is None:
        area_radiance = np.zeros((len(shapes), 3), np.float32)
    return Scene(make_shape_table(shapes, device=device),
                 make_material_table(
                     kinds=bsdf_kinds, albedos=bsdf_albedos,
                     twosided=bsdf_twosided,
                     spectral_albedos=bsdf_spectral_albedos,
                     alphas=bsdf_alphas, etas=bsdf_etas, ks=bsdf_ks,
                     iors=bsdf_iors, opacities=bsdf_opacities,
                     extras=bsdf_extras, blend_children=bsdf_blend_children,
                     blend_weights=bsdf_blend_weights, device=device),
                 env, f32(env_to_world),
                 make_mesh_table(meshes, device=device) if meshes else None,
                 None,
                 None if area_radiance is None else f32(area_radiance),
                 torch.tensor(area_ids, dtype=torch.int64, device=device),
                 None if point_lights is None else f32(point_lights, 6),
                 (None if directional_lights is None
                  else f32(directional_lights, 6)),
                 tuple(spot_lights),
                 (None if delta_light_weights is None
                  else f32(delta_light_weights)))
