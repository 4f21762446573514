"""Scene: analytic shapes, a diffuse material table and the sunsky sky.

The slice of `tpusky/render/scene.py` the main path uses. Area, point,
directional and spot emitters, meshes, media, SDFs, curves and textures
are not ported yet, so a Scene here cannot hold them.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from .bsdf import MaterialTable, make_material_table
from .shapes import ShapeTable, make_shape_table, ray_test


class Scene(NamedTuple):
    shapes: ShapeTable
    bsdfs: MaterialTable
    env: Any                         # SunskyState | None
    env_to_world: torch.Tensor       # (3, 3) env local -> world rotation


def scene_occluded(scene: Scene, o, d, maxt):
    """Shadow-ray predicate over the scene's geometry."""
    return ray_test(scene.shapes, o, d, maxt)


def make_scene(shapes=(), bsdf_albedos=((0.5, 0.5, 0.5),), env=None,
               env_to_world=None, bsdf_twosided=None, bsdf_kinds=None,
               device="cuda") -> Scene:
    """Assemble a scene from host-side descriptions: shapes are dicts
    accepted by `make_shape_table`."""
    if len(shapes) == 0:
        # a never-hit placeholder keeps the table non-empty
        ph = np.eye(4)
        ph[:3, 3] = 3e4
        shapes = [dict(kind=0, to_world=ph, bsdf_idx=0)]
    if env_to_world is None:
        env_to_world = np.eye(3, dtype=np.float32)
    return Scene(make_shape_table(shapes, device=device),
                 make_material_table(kinds=bsdf_kinds, albedos=bsdf_albedos,
                                     twosided=bsdf_twosided, device=device),
                 env, torch.tensor(np.asarray(env_to_world, np.float32),
                                   device=device))
